"""Cross-process parallel replicas: N processes share ONE shard's scan.

The reference coordinates replicas of a shard over the wire — the
initiator announces parts, replicas request mark ranges, failed replicas'
ranges are reassigned
(src/Storages/MergeTree/ParallelReplicasReadingCoordinator.cpp:778).

This engine's shape of the same contract: the scan's chunk ranges are published
once in the Keeper, and replicas CLAIM ranges with ephemeral znodes —
atomic create is the handout, ephemeral lifetime is the failure detector.
A replica that dies (connection drop, kill) loses its ephemeral claims and
every unfinished range it held becomes claimable again, so the scan always
completes on the survivors.  No extra wire protocol: the coordination
service the engine already runs (networked Keeper / Raft ensemble) carries
the announcements, exactly as it carries the replication log.

    <root>/<scan_id>/ranges/<i>        b"lo:hi[:part]"   (announce, once)
    <root>/<scan_id>/claims/<i>        ephemeral, owner-held
    <root>/<scan_id>/done/<i>          b"" permanent     (complete)
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from ..coordination.keeper import KeeperError, NodeExistsError

__all__ = ["ReplicaScanCoordinator", "coordinated_agg_scan"]

ROOT = "/clickhouse/parallel_replicas"


class ReplicaScanCoordinator:
    """Claim/complete protocol over the Keeper for one scan."""

    def __init__(self, keeper, scan_id: str,
                 ranges: Optional[List[Tuple[int, int, int]]] = None):
        self.keeper = keeper
        self.base = f"{ROOT}/{scan_id}"
        if ranges is not None:
            self.announce(ranges)

    # -- initiator -----------------------------------------------------------
    def announce(self, ranges: List[Tuple[int, int, int]]) -> None:
        """Publish the scan's (part, lo, hi) ranges (first announcer wins;
        late replicas see the same plan)."""
        for p in (ROOT, self.base, f"{self.base}/ranges",
                  f"{self.base}/claims", f"{self.base}/done"):
            try:
                self.keeper.create(p, b"", make_parents=True)
            except (NodeExistsError, KeeperError):
                pass
        for i, (part, lo, hi) in enumerate(ranges):
            try:
                self.keeper.create(f"{self.base}/ranges/{i}",
                                   f"{part}:{lo}:{hi}".encode())
            except (NodeExistsError, KeeperError):
                pass

    # -- replica side --------------------------------------------------------
    def _range_ids(self) -> List[str]:
        try:
            return sorted(self.keeper.get_children(f"{self.base}/ranges"),
                          key=int)
        except KeeperError:
            return []

    def claim_next(self) -> Optional[Tuple[int, Tuple[int, int, int]]]:
        """Atomically claim one unfinished, unclaimed range
        -> (range_id, (part, lo, hi)) or None when all ranges are done or
        held by live replicas."""
        for rid in self._range_ids():
            try:
                if self.keeper.exists(f"{self.base}/done/{rid}"):
                    continue
                # ephemeral create IS the atomic handout: exactly one
                # replica wins; a dead replica's claim vanishes with its
                # session and the range becomes claimable again
                self.keeper.create(f"{self.base}/claims/{rid}", b"",
                                   ephemeral_owner="replica")
            except NodeExistsError:
                continue
            except KeeperError:
                continue
            data, _ = self.keeper.get(f"{self.base}/ranges/{rid}")
            raw = bytes(data).decode() if not isinstance(data, str) else data
            part, lo, hi = (int(x) for x in raw.split(":"))
            return int(rid), (part, lo, hi)
        return None

    def mark_done(self, rid: int) -> None:
        try:
            self.keeper.create(f"{self.base}/done/{rid}", b"")
        except (NodeExistsError, KeeperError):
            pass
        try:
            self.keeper.remove(f"{self.base}/claims/{rid}")
        except KeeperError:
            pass

    def pending(self) -> int:
        done = set()
        try:
            done = set(self.keeper.get_children(f"{self.base}/done"))
        except KeeperError:
            pass
        return len([r for r in self._range_ids() if r not in done])

    def wait_all_done(self, timeout: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.pending() == 0:
                return True
            time.sleep(0.02)
        return False


def coordinated_agg_scan(session, table_name: str, scan_id: str,
                         agg_sql: str, granule_rows: int = 8192,
                         database: Optional[str] = None,
                         fail_after: Optional[int] = None,
                         keeper=None) -> Dict[int, dict]:
    """Run `agg_sql` (a per-range aggregation template with {lo}/{hi}
    placeholders over a rowNumberInAllBlocks-style split) for every range
    this replica manages to claim; -> {range_id: result rows}.

    `fail_after`: test hook — abandon after N completed ranges (claims
    survive until the keeper session drops, modeling a crashed replica).
    """
    db = database or session.catalog.current_database
    t = session.catalog.get_table(db, table_name)
    if keeper is None:
        from ..coordination import get_keeper
        cl = "default"
        if session.settings.keeper_address:
            cl = f"tcp://{session.settings.keeper_address}"
        keeper = get_keeper(cl)
    # mark-range analog: granule boundaries of the sorted key column
    # become half-open KEY ranges (exact when the split key is unique
    # at boundaries — the reference resolves boundary ties by row
    # position, which needs no wire protocol here)
    kcol = (t.order_by or [next(iter(t.schema))])[0]
    ranges: List[Tuple[int, int, int]] = []
    for pi, p in enumerate(t.parts):
        keys = p.columns.get(kcol)
        n = p.num_rows
        if keys is None or n == 0:
            continue
        for s in range(0, n, granule_rows):
            e = min(s + granule_rows, n)
            lo_k = int(keys[s])
            hi_k = int(keys[e - 1]) + 1 if e == n else int(keys[e])
            ranges.append((pi, lo_k, hi_k))
    coord = ReplicaScanCoordinator(keeper, scan_id, ranges)
    out: Dict[int, dict] = {}
    done_count = 0
    while True:
        claim = coord.claim_next()
        if claim is None:
            break
        rid, (part, lo, hi) = claim
        r = session.execute(agg_sql.format(part=part, lo=lo, hi=hi))
        out[rid] = {n2: r.columns[n2] for n2 in r.column_names}
        coord.mark_done(rid)
        done_count += 1
        if fail_after is not None and done_count >= fail_after:
            return out          # abandoned: unfinished claims die with
                                # the keeper session
    return out
