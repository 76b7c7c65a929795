"""Build the native C++ runtime library (g++ -O3 -march=native -shared).

The library is built from `src/chnative.cpp` on the host that loads it, into
`_build/` (listed in .gitignore), under a name keyed by a hash of the
source: a changed source builds anew, an unchanged one is reused.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src", "chnative.cpp")
BUILD_DIR = os.path.join(HERE, "_build")


def lib_path() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libchnative-{digest}.so")


def build(force: bool = False) -> str:
    """Compile unless a library for this source exists; returns its path."""
    lib = lib_path()
    if not force and os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    # concurrent builds each write their own file; the rename is atomic
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           "-std=c++17", SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, lib)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        raise RuntimeError(f"native build failed: {e}")
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


if __name__ == "__main__":
    print(build(force="--force" in sys.argv))
