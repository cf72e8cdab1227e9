"""Fleet dispatcher: health-checked least-loaded routing over engine shards
(counterpart: ``repro/distributed/dispatcher.py``, a copy).

N ``ServeEngine`` shards stand behind one
:class:`~repro_torch.launch.fleet.ServeFleet`; this module is its routing
brain: pure bookkeeping (which request lives on which shard, how loaded
each shard is, who may take new work), with no device work.

Routing policy: among LIVE shards, pick the one with the fewest in-flight
requests, breaking ties by fewest reserved KV pages (the shard-local
admission reservation that :class:`~repro_torch.launch.engine.ServeEngine`
maintains), then by shard index for determinism. SUSPECT shards keep their
in-flight work but receive no new routing; if *no* LIVE shard exists the
dispatcher degrades to SUSPECT shards (better a slow shard than a dropped
request) and returns ``None`` only when every shard is DEAD — at which
point the fleet must emit a typed ``shard_lost`` error completion.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.distributed.fault_tolerance import (HealthMonitor,
                                                     ShardState)


class Dispatcher:
    """Assigns request uids to shards under health + load constraints."""

    def __init__(self, monitor: HealthMonitor):
        self.monitor = monitor
        n = len(monitor.states)
        self.assigned: List[set] = [set() for _ in range(n)]
        self.reserved: List[int] = [0] * n
        self.routed = 0
        self._home: Dict[int, int] = {}

    # -- load signals -------------------------------------------------------
    def note_reserved(self, shard: int, pages: int) -> None:
        """Refresh the KV-page reservation signal for one shard (reported
        back with every step heartbeat)."""
        self.reserved[shard] = int(pages)

    def load(self, shard: int) -> int:
        return len(self.assigned[shard])

    # -- routing ------------------------------------------------------------
    def route(self, exclude=()) -> Optional[int]:
        """Least-loaded routable shard, or ``None`` if the fleet is dead
        (``exclude``: shards currently unavailable, e.g. mid-step)."""
        for pool in (ShardState.LIVE, ShardState.SUSPECT):
            cands = [s for s, st in enumerate(self.monitor.states)
                     if st is pool and s not in exclude]
            if cands:
                best = min(cands, key=lambda s: (len(self.assigned[s]),
                                                 self.reserved[s], s))
                return best
        return None

    def assign(self, uid: int, shard: int) -> None:
        self.assigned[shard].add(uid)
        self._home[uid] = shard
        self.routed += 1

    def home(self, uid: int) -> Optional[int]:
        return self._home.get(uid)

    def complete(self, uid: int) -> None:
        """A completion for ``uid`` was drained; drop its load accounting."""
        shard = self._home.pop(uid, None)
        if shard is not None:
            self.assigned[shard].discard(uid)

    def fail_shard(self, shard: int) -> List[int]:
        """The shard is dead: return its outstanding uids (sorted for
        deterministic replay order) and clear their assignment so failover
        can re-route them."""
        uids = sorted(self.assigned[shard])
        self.assigned[shard] = set()
        for uid in uids:
            self._home.pop(uid, None)
        return uids

    @property
    def outstanding(self) -> int:
        return len(self._home)
