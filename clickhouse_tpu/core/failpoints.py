"""Named fail points — SQL-toggleable fault injection.

Analog of the reference's FailPoint machinery
(ref: src/Common/FailPoint.h:32, SYSTEM ENABLE FAILPOINT): named hooks
compiled into host-side control paths (part writes, merges, replication
log application, exchanges, backups).  Disabled points cost one dict
lookup; enabled points raise, sleep, or fire-once depending on mode.

The device compute path is never instrumented — XLA programs are pure —
so fault injection targets exactly the layer where faults matter here:
host orchestration, storage mutation, and coordination.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional

from .errors import ExecutionError


class FailPointTriggered(ExecutionError):
    """Raised at an enabled error-mode failpoint (FAIL_POINT_TRIGGERED)."""


@dataclasses.dataclass
class _Point:
    name: str
    mode: str = "error"          # error | sleep | once
    sleep_seconds: float = 0.0
    hits: int = 0


class FailPointRegistry:
    """Process-wide registry; sessions share it via the catalog."""

    # Sites instrumented in the engine.  Registered up front so that
    # enabling a typo'd name is an error, like the reference's
    # APPLY_FOR_FAILPOINTS compile-time list.
    KNOWN = (
        "insert_before_commit_part",      # after part build, before catalog add
        "merge_before_commit",            # OPTIMIZE: before replacing parts
        "replica_before_apply_log",       # replication: before applying an entry
        "exchange_before_all_to_all",     # distributed exchange dispatch
        "backup_before_write",            # BACKUP: before writing the archive
        "async_insert_before_flush",      # async INSERT queue flush
        # raft partition injection (coordination/raft.py _rpc): drop all
        # RPCs from/to a node — network partition simulation
        "raft_drop_from_0", "raft_drop_from_1", "raft_drop_from_2",
        "raft_drop_from_3", "raft_drop_from_4",
        "raft_drop_to_0", "raft_drop_to_1", "raft_drop_to_2",
        "raft_drop_to_3", "raft_drop_to_4",
    )

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._enabled: Dict[str, _Point] = {}

    def enable(self, name: str, mode: str = "error",
               sleep_seconds: float = 0.0) -> None:
        if name not in self.KNOWN:
            raise ExecutionError(
                f"Unknown failpoint '{name}'. Known: {', '.join(self.KNOWN)}")
        with self._lock:
            self._enabled[name] = _Point(name, mode, sleep_seconds)

    def disable(self, name: str) -> None:
        with self._lock:
            self._enabled.pop(name, None)

    def disable_all(self) -> None:
        with self._lock:
            self._enabled.clear()

    def snapshot(self):
        with self._lock:
            return [(p.name, p.mode, p.hits) for p in self._enabled.values()]

    def check(self, name: str) -> None:
        """Instrumentation hook — call at the named site."""
        p = self._enabled.get(name)       # racy read is fine: single dict ref
        if p is None:
            return
        with self._lock:
            p = self._enabled.get(name)
            if p is None:
                return
            p.hits += 1
            if p.mode == "once":
                self._enabled.pop(name, None)
        if p.mode == "sleep":
            time.sleep(p.sleep_seconds)
            return
        raise FailPointTriggered(f"Failpoint '{name}' triggered")


GLOBAL_FAILPOINTS = FailPointRegistry()


def fail_point(name: str, registry: Optional[FailPointRegistry] = None) -> None:
    (registry or GLOBAL_FAILPOINTS).check(name)
