"""Asynchronous INSERT batching (AsynchronousInsertQueue analog).

The reference collects small client inserts into per-(table, settings,
columns) queue shards and flushes a shard when its accumulated payload
reaches async_insert_max_data_size bytes or when
async_insert_busy_timeout_ms elapses, whichever happens first
(ref: src/Interpreters/AsynchronousInsertQueue.cpp — push() groups by
InsertQuery hash, busy timeout scheduled on a background pool).  Clients
with wait_for_async_insert=1 block on a future that resolves when the
batch actually commits; with 0 the insert returns immediately after
enqueueing (fire-and-forget, the reference's "async_insert without wait"
mode).

Why batching matters MORE here than in the reference — every
committed part becomes an operand layout for compiled scans, so thousands
of one-row parts would defeat the chunk-invariant streaming programs.
The queue turns high-rate trickle inserts into a few large parts.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["AsyncInsertQueue"]


class _Entry:
    __slots__ = ("data", "done", "error")

    def __init__(self, data: Dict[str, np.ndarray]):
        self.data = data
        self.done = threading.Event()
        self.error: Optional[BaseException] = None


class _Shard:
    """One pending batch: inserts for one (db, table, column-set)."""

    def __init__(self, key):
        self.key = key
        self.entries: List[_Entry] = []
        self.bytes = 0
        self.first_push = 0.0


def _payload_bytes(data: Dict[str, np.ndarray]) -> int:
    total = 0
    for v in data.values():
        v = np.asarray(v)
        if v.dtype == object:
            total += sum(len(str(x)) + 8 for x in v)
        else:
            total += v.nbytes
    return total


class AsyncInsertQueue:
    """Session-owned queue; `commit` is the synchronous insert tail
    (part creation + MV/projection triggers) supplied by the Session."""

    def __init__(self, commit):
        self._commit = commit
        self._lock = threading.Lock()
        self._shards: Dict[Tuple, _Shard] = {}
        self._timer: Optional[threading.Timer] = None
        self.flushed_batches = 0
        self.flushed_rows = 0

    # -- producer side --------------------------------------------------------
    def push(self, db: str, table: str, data: Dict[str, np.ndarray],
             settings) -> _Entry:
        key = (db, table, tuple(sorted(data.keys())))
        with self._lock:
            shard = self._shards.get(key)
            if shard is None:
                shard = self._shards[key] = _Shard(key)
                shard.first_push = time.monotonic()
            entry = _Entry(data)
            shard.entries.append(entry)
            shard.bytes += _payload_bytes(data)
            full = shard.bytes >= max(settings.async_insert_max_data_size, 1)
            if full:
                del self._shards[key]
            else:
                self._arm_timer(settings.async_insert_busy_timeout_ms)
        if full:
            self._flush_shard(shard)
        return entry

    def wait(self, entry: _Entry, timeout_s: float = 60.0) -> None:
        if not entry.done.wait(timeout_s):
            raise TimeoutError("async insert flush did not complete")
        if entry.error is not None:
            raise entry.error

    # -- flush machinery ------------------------------------------------------
    def _arm_timer(self, busy_timeout_ms: int) -> None:
        # one shared timer at the earliest deadline; re-armed after each fire
        if self._timer is not None:
            return
        delay = max(busy_timeout_ms, 1) / 1000.0
        self._timer = threading.Timer(delay, self._on_timer)
        self._timer.daemon = True
        self._timer.start()

    def _on_timer(self) -> None:
        with self._lock:
            self._timer = None
            shards = list(self._shards.values())
            self._shards.clear()
        for s in shards:
            self._flush_shard(s)

    def flush(self, db: Optional[str] = None,
              table: Optional[str] = None) -> int:
        """Synchronous drain (SYSTEM FLUSH ASYNC INSERT QUEUE).
        -> number of batches flushed."""
        with self._lock:
            keys = [k for k in self._shards
                    if (db is None or k[0] == db)
                    and (table is None or k[1] == table)]
            shards = [self._shards.pop(k) for k in keys]
        for s in shards:
            self._flush_shard(s)
        return len(shards)

    def pending(self) -> List[Tuple[str, str, int, int]]:
        """(db, table, rows, bytes) per pending shard (the reference's
        system.asynchronous_inserts view)."""
        with self._lock:
            out = []
            for s in self._shards.values():
                rows = sum(len(next(iter(e.data.values())))
                           for e in s.entries)
                out.append((s.key[0], s.key[1], rows, s.bytes))
            return out

    def _flush_shard(self, shard: _Shard) -> None:
        from ..core.failpoints import fail_point
        from ..core.thread_fuzzer import fuzz_yield
        fuzz_yield("async_insert_flush_shard")
        db, table, names = shard.key
        try:
            # inside the try: an injected fault must reach waiters through
            # entry.error/entry.done like any other flush failure
            fail_point("async_insert_before_flush")
            if len(shard.entries) == 1:
                merged = shard.entries[0].data
            else:
                merged = {}
                for n in names:
                    parts = [np.asarray(e.data[n]) for e in shard.entries]
                    if any(p.dtype == object for p in parts):
                        parts = [p.astype(object) for p in parts]
                    merged[n] = np.concatenate(parts)
            self._commit(db, table, merged)
            self.flushed_batches += 1
            self.flushed_rows += len(next(iter(merged.values()))) \
                if merged else 0
            err = None
        except BaseException as e:      # noqa: BLE001 — handed to waiters
            err = e
        for entry in shard.entries:
            entry.error = err
            entry.done.set()
