"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-chip hardware is not available in CI; sharding is validated on
XLA's host-platform virtual devices (the reference validates multi-node
behaviour on single-host pseudo-clusters the same way — SURVEY.md §4).

Tests marked `gpu` need the card: they skip on the CPU and run with
    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""
import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

# Watchdog: when CHTPU_WATCHDOG is set, dump all thread stacks to stderr
# every N seconds — identifies tests that grind without failing.
if os.environ.get("CHTPU_WATCHDOG"):
    import faulthandler
    import sys
    faulthandler.dump_traceback_later(
        int(os.environ["CHTPU_WATCHDOG"]), repeat=True, file=sys.stderr)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips where JAX finds none")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX finds none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev
