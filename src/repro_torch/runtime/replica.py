"""Replica placement and routing for the sharded retrieval fleet.

The follow-up paper (*Storing and Analyzing Historical Graph Data at
Scale*, Khurana & Deshpande 2015) scales DeltaGraph by partitioning the
history across storage servers **with replication**: each partition has
``R`` candidate servers, so a hedged fetch can race a *different copy*
(racing the same store only re-queues behind the same straggler) and a
dead server's partitions fail over without touching anyone else's.

:class:`ReplicaManager` derives everything from one rendezvous ranking
(:func:`repro_torch.runtime.fault.rendezvous_rank`, the same hash that has
driven ``elastic_replan`` since the sharding PR):

* ``replicas_of(p)`` — the first ``R`` alive servers in partition ``p``'s
  ranking.  Rank 0 is the *primary* (identical to ``elastic_replan``'s
  assignment when every server is alive, so enabling replication does not
  reshuffle an existing fleet's primaries).
* **Minimal reassignment** — rendezvous ranking is per-server
  independent: removing a dead server deletes its entry from each
  ranking without reordering the rest, so exactly the partitions it
  served move (each to its old rank-1 replica), and no other partition's
  replica set changes.
* ``route(p, tried=...)`` — failover/hedge routing: the first replica not
  yet tried by this task, falling back to the primary when every replica
  has been tried (the caller may then retry the same server — there is
  genuinely nobody else).
"""
from __future__ import annotations

from .fault import rendezvous_rank


class ReplicaManager:
    """Pure placement logic (no I/O): servers in, rankings out.

    ``alive`` is passed per call by the owner (``ShardedRetriever`` keeps
    liveness in its :class:`~repro_torch.runtime.fault.HeartbeatTracker`), so
    the manager itself never goes stale.
    """

    def __init__(self, servers: list[str], replicas: int = 1) -> None:
        self.servers = list(servers)
        self.replicas = max(1, int(replicas))
        self._rank_memo: dict[tuple, dict[int, list[str]]] = {}

    def _ranks(self, P: int, alive: tuple[str, ...]) -> dict[int, list[str]]:
        memo = self._rank_memo.get(alive)
        if memo is None:
            memo = self._rank_memo[alive] = {}
            if len(self._rank_memo) > 64:     # membership churn is rare
                self._rank_memo.clear()
                self._rank_memo[alive] = memo
        for p in range(P):
            if p not in memo:
                memo[p] = rendezvous_rank(p, list(alive))
        return memo

    def replicas_of(self, p: int, alive: list[str]) -> list[str]:
        """The ``R`` alive candidate servers for partition ``p``, primary
        first."""
        rank = self._ranks(p + 1, tuple(alive))[p]
        return rank[:self.replicas]

    def primary(self, p: int, alive: list[str]) -> str:
        return self.replicas_of(p, alive)[0]

    def assignment(self, P: int, alive: list[str]) -> dict[str, tuple[int, ...]]:
        """``server -> owned partitions`` over primaries — the scatter map.
        With ``replicas == 1`` and a fully-alive fleet this is exactly the
        pre-replication ``elastic_replan`` grouping."""
        ranks = self._ranks(P, tuple(alive))
        by_server: dict[str, list[int]] = {}
        for p in range(P):
            by_server.setdefault(ranks[p][0], []).append(p)
        return {w: tuple(sorted(ps)) for w, ps in by_server.items()}

    def route(self, p: int, alive: list[str],
              tried: set[str] = frozenset()) -> str:
        """Pick the serving replica for one attempt: the highest-ranked
        replica this task has *not* yet tried, else the primary.  This is
        the hedging contract — a duplicate attempt must land on a distinct
        candidate server whenever one exists."""
        cands = self.replicas_of(p, alive)
        for s in cands:
            if s not in tried:
                return s
        return cands[0]

    def plan(self, parts: tuple[int, ...], alive: list[str],
             tried: set[str] = frozenset()) -> dict[int, str]:
        """Routing map ``partition -> server`` for one attempt over a
        task's owned partitions."""
        return {p: self.route(p, alive, tried) for p in parts}
