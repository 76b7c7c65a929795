"""Disks & object storage abstraction.

Rendering of the reference's storage virtualization
(ref: src/Disks/IDisk.h, src/Disks/ObjectStorages/IObjectStorage.h):

* `IDisk` — a named filesystem-like surface (write/read/list/remove).
* `IObjectStorage` — a flat blob namespace (put/get/delete/list) with no
  rename or append, the S3/Azure/HDFS contract.
* `ObjectStorageDisk` — maps logical file paths onto blobs through a
  metadata layer (the reference's DiskObjectStorage + metadata storage:
  one logical file = an ordered list of blob keys), so anything written
  through the disk API lands on object storage transparently.

Only a local-backed `LocalObjectStorage` ships (no cloud egress in this
environment); the blob contract is what matters — S3 would be a drop-in
`IObjectStorage` with the same five methods.

Integration points: `Session(data_path=...)` persists MergeTree-family
tables through a LocalDisk (storage/persist.py), BACKUP/RESTORE accept
`Disk('name', 'path')` targets, and `system.disks` lists the registry.
"""
from __future__ import annotations

import json
import os
import threading
import uuid
from typing import Dict, List, Optional, Tuple

from ..core.errors import EngineError

__all__ = ["IDisk", "LocalDisk", "IObjectStorage", "LocalObjectStorage",
           "ObjectStorageDisk", "DiskRegistry"]


class IDisk:
    """Named file surface; paths are logical, relative, confined."""
    name: str
    kind: str = "abstract"

    def write_file(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def read_file(self, path: str) -> bytes:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def remove_file(self, path: str) -> None:
        raise NotImplementedError

    def list_files(self) -> List[str]:
        raise NotImplementedError

    def file_size(self, path: str) -> int:
        return len(self.read_file(path))

    def _logical(self, path: str) -> str:
        """Normalize + confine a logical path (no escapes, no absolutes)."""
        norm = os.path.normpath(path.replace("\\", "/")).lstrip("/")
        if norm.startswith("..") or norm in (".", ""):
            raise EngineError(f"Disk path '{path}' escapes the disk root")
        return norm


class LocalDisk(IDisk):
    """Plain directory-backed disk (the reference's DiskLocal)."""
    kind = "local"

    def __init__(self, name: str, root: str):
        self.name = name
        self.root = os.path.realpath(root)
        os.makedirs(self.root, exist_ok=True)

    def _fs(self, path: str) -> str:
        return os.path.join(self.root, self._logical(path))

    def write_file(self, path: str, data: bytes) -> None:
        fs = self._fs(path)
        os.makedirs(os.path.dirname(fs), exist_ok=True)
        tmp = fs + f".tmp.{uuid.uuid4().hex[:8]}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, fs)                # atomic publish, like part commit

    def read_file(self, path: str) -> bytes:
        try:
            with open(self._fs(path), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise EngineError(f"No file '{path}' on disk '{self.name}'")

    def exists(self, path: str) -> bool:
        return os.path.isfile(self._fs(path))

    def remove_file(self, path: str) -> None:
        try:
            os.remove(self._fs(path))
        except FileNotFoundError:
            pass

    def list_files(self) -> List[str]:
        out = []
        for base, _dirs, files in os.walk(self.root):
            for f in files:
                out.append(os.path.relpath(os.path.join(base, f), self.root))
        return sorted(out)


class IObjectStorage:
    """Flat blob namespace: no rename, no append, no directories."""

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def list_keys(self, prefix: str = "") -> List[str]:
        raise NotImplementedError


class LocalObjectStorage(IObjectStorage):
    """Blob store on the local FS (2-hex fan-out dirs), standing in for
    S3/Azure — same contract, zero egress."""

    def __init__(self, root: str):
        self.root = os.path.realpath(root)
        os.makedirs(self.root, exist_ok=True)

    @staticmethod
    def _encode(key: str) -> str:
        # reversible: percent-encode everything outside [A-Za-z0-9.-], so
        # 'a/b' and 'a_b' map to distinct blob file names
        from urllib.parse import quote
        return quote(key, safe=".-")

    def _fs(self, key: str) -> str:
        safe = self._encode(key)
        return os.path.join(self.root, safe[:2] or "00", safe)

    def put(self, key: str, data: bytes) -> None:
        fs = self._fs(key)
        os.makedirs(os.path.dirname(fs), exist_ok=True)
        tmp = fs + f".tmp.{uuid.uuid4().hex[:8]}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, fs)

    def get(self, key: str) -> bytes:
        try:
            with open(self._fs(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise EngineError(f"No blob '{key}' in object storage")

    def delete(self, key: str) -> None:
        try:
            os.remove(self._fs(key))
        except FileNotFoundError:
            pass

    def list_keys(self, prefix: str = "") -> List[str]:
        from urllib.parse import unquote
        out = []
        for base, _dirs, files in os.walk(self.root):
            for f in files:
                if ".tmp." not in f:
                    out.append(unquote(f))
        return sorted(k for k in out if k.startswith(prefix))


class ObjectStorageDisk(IDisk):
    """Logical files over blobs through a metadata layer.

    Each logical file is an ordered list of blob keys (split at
    ``blob_size``); the metadata record itself is a JSON blob under
    ``meta/<path>`` so a fresh process can rebuild the mapping from the
    blob namespace alone — the role of the reference's metadata storage."""
    kind = "object_storage"

    def __init__(self, name: str, store: IObjectStorage,
                 blob_size: int = 4 << 20):
        self.name = name
        self.store = store
        self.blob_size = blob_size
        self._lock = threading.Lock()

    def _meta_key(self, path: str) -> str:
        return "meta/" + self._logical(path)

    def _load_meta(self, path: str) -> Optional[dict]:
        try:
            return json.loads(self.store.get(self._meta_key(path)).decode())
        except EngineError:
            return None

    def write_file(self, path: str, data: bytes) -> None:
        blobs: List[Tuple[str, int]] = []
        for off in range(0, max(len(data), 1), self.blob_size):
            piece = data[off:off + self.blob_size]
            key = f"data/{uuid.uuid4().hex}"
            self.store.put(key, piece)
            blobs.append((key, len(piece)))
        with self._lock:
            old = self._load_meta(path)
            self.store.put(self._meta_key(path), json.dumps(
                {"blobs": blobs, "size": len(data)}).encode())
            if old:                        # overwrite = new blobs + GC old
                for key, _sz in old["blobs"]:
                    self.store.delete(key)

    def read_file(self, path: str) -> bytes:
        meta = self._load_meta(path)
        if meta is None:
            raise EngineError(f"No file '{path}' on disk '{self.name}'")
        return b"".join(self.store.get(k) for k, _sz in meta["blobs"])

    def exists(self, path: str) -> bool:
        return self._load_meta(path) is not None

    def remove_file(self, path: str) -> None:
        with self._lock:
            meta = self._load_meta(path)
            if meta is None:
                return
            self.store.delete(self._meta_key(path))
            for key, _sz in meta["blobs"]:
                self.store.delete(key)

    def list_files(self) -> List[str]:
        return sorted(k[len("meta/"):] for k in
                      self.store.list_keys("meta/"))

    def file_size(self, path: str) -> int:
        meta = self._load_meta(path)
        if meta is None:
            raise EngineError(f"No file '{path}' on disk '{self.name}'")
        return meta["size"]


class DiskRegistry:
    """Named disks for a server/session (the reference's DiskSelector)."""

    def __init__(self):
        self._disks: Dict[str, IDisk] = {}

    def register(self, disk: IDisk) -> None:
        self._disks[disk.name] = disk

    def get(self, name: str) -> IDisk:
        d = self._disks.get(name)
        if d is None:
            raise EngineError(
                f"Unknown disk '{name}'. Registered: "
                f"{', '.join(sorted(self._disks)) or '(none)'}")
        return d

    def names(self) -> List[str]:
        return sorted(self._disks)

    def items(self):
        return sorted(self._disks.items())
