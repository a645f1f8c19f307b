"""Failure injection for integration tests (the chaos-monkey role).

Operates on the Cluster simulator and on logical pod replica lists: kill a
node (liveness + handler removal), corrupt or drop a keygroup replica,
partition links.  Recovery paths under test: router failover to surviving
deployments, keygroup restore from peer replicas (Enoki replication doubling
as fault tolerance), checkpoint fallback.

Network faults route through the cluster's ``FaultPlane``
(core/network.py): a partition is a NAMED, heal-able cut the replication
transport retries across — snapshots scheduled mid-partition park in their
link outbox and deliver after ``heal`` — instead of the historical
``inf``-latency link swap, whose events stranded at ``arrival=inf``
forever.  Per-link loss/duplication/jitter faults ride the same plane.

``chaos_schedule``/``run_chaos`` form the seeded chaos harness: a
deterministic event schedule (per-round link faults, one multi-round
partition, one crash+restore after the heal) interleaved with a
round-structured write workload, built so a fault-free twin run with the
same seed produces BYTE-IDENTICAL final stores — the invariant the
partition-tolerance suite asserts.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, List, Optional, Set, Tuple

from repro_torch.core.cluster import Cluster
from repro_torch.core.network import Link
from repro_torch.core.store import arena_clone


@dataclasses.dataclass
class FailureInjector:
    cluster: Cluster
    #: optional ElasticMembership (runtime/elastic.py) — when set, kills
    #: route through the full recovery state machine (keygroup rebalance,
    #: checkpoint fallback, delivery-queue drop) instead of the bare
    #: liveness flip, and ``restore_node`` becomes available
    membership: Optional[object] = None

    def kill_node(self, node: str) -> None:
        """Mark dead + drop its handlers: requests must fail over.  With a
        membership attached this is a full crash (rebalance + drop of
        on-the-wire deliveries); bare injectors keep the historical
        minimal kill."""
        if self.membership is not None:
            self.membership.crash(node)
            return
        self.cluster.naming.mark_dead(node)
        self.cluster.nodes[node].handlers.clear()
        self.cluster.nodes[node].batched_handlers.clear()

    def restore_node(self, node: str, t: float = float("inf")) -> None:
        """Bring a killed node back through the membership's catch-up path
        (requires ``membership``)."""
        if self.membership is None:
            raise RuntimeError("restore_node needs a membership "
                               "(FailureInjector(cluster, membership=...))")
        self.membership.restore(node, t)

    def lose_keygroup(self, node: str, kg: str) -> None:
        """Simulate storage loss of one replica."""
        self.cluster.nodes[node].stores.pop(kg, None)
        self.cluster.naming.remove_replica(kg, node)

    def restore_keygroup_from_peer(self, node: str, kg: str) -> bool:
        """Enoki recovery: re-replicate from any surviving replica (§2)."""
        peers = self.cluster.naming.replicas_of(kg)
        alive = set(self.cluster.naming.alive_nodes())
        peers = [p for p in peers if p != node and p in alive]
        if not peers:
            return False
        src = self.cluster.nodes[peers[0]]
        with src.lock:
            # clone, never alias: the peer's next fold or merge writes
            # into its arena in place
            snapshot = arena_clone(src.stores[kg])
        self.cluster.nodes[node].stores[kg] = snapshot
        self.cluster.naming.add_replica(kg, node)
        return True

    # ------------------------------------------------------- network faults
    @staticmethod
    def _pair_name(a: str, b: str) -> str:
        return "cut:" + "|".join(sorted((a, b)))

    def partition(self, a: str, b: str) -> str:
        """Sever the a<->b link through the fault plane.  Replication
        scheduled across the cut parks in its outbox (retried, never
        stranded) and delivers after ``heal`` — unlike the historical
        ``inf``-latency link swap this is fully recoverable."""
        return self.cluster.faults.partition(
            {a}, {b}, name=self._pair_name(a, b))

    def heal(self, a: str, b: str, link: Optional[Link] = None) -> None:
        """Undo ``partition(a, b)``.  ``link`` optionally re-parameterizes
        the physical link (rtt/bandwidth) at the same time."""
        self.cluster.faults.heal(self._pair_name(a, b))
        if link is not None:
            self.cluster.net.links[(a, b)] = link
            self.cluster.net.links[(b, a)] = link

    def partition_groups(self, *groups: Set[str],
                         name: Optional[str] = None) -> str:
        """Split the cluster into named groups (every cross-group link is
        cut); returns the partition's name for ``cluster.faults.heal``."""
        return self.cluster.faults.partition(*groups, name=name)

    def heal_all(self) -> None:
        self.cluster.faults.heal()

    def set_link_fault(self, a: str, b: str, drop_p: float = 0.0,
                       dup_p: float = 0.0, jitter_ms: float = 0.0) -> None:
        """Make the a<->b link lossy: replication transmissions drop with
        ``drop_p`` (retried with backoff), duplicate with ``dup_p``
        (deduped at the receiver), and arrive up to ``jitter_ms`` late."""
        self.cluster.faults.set_fault(a, b, drop_p=drop_p, dup_p=dup_p,
                                      jitter_ms=jitter_ms)

    def clear_link_fault(self, a: str, b: str) -> None:
        self.cluster.faults.clear_fault(a, b)


# ---------------------------------------------------------------------------
# seeded chaos harness
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault action, applied at the START of ``round``."""
    round: int
    action: str          # fault | clear_faults | partition | heal |
                         # crash | restore
    a: str = ""
    b: str = ""
    drop_p: float = 0.0
    dup_p: float = 0.0
    jitter_ms: float = 0.0


@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    """A deterministic chaos schedule plus the workload shape it implies.

    ``quiet_rounds`` is derived from the SCHEDULE, not from runtime state:
    the victim skips writing exactly while it is partitioned or crashed,
    so a fault-free twin run (``apply_faults=False``) issues the identical
    write sequence — the precondition for byte-identical convergence."""
    seed: int
    rounds: int
    nodes: Tuple[str, ...]
    victim: str
    events: Tuple[ChaosEvent, ...]
    quiet_rounds: frozenset     # rounds in which the victim must not write

    def events_at(self, r: int) -> List[ChaosEvent]:
        return [e for e in self.events if e.round == r]

    def writers_for(self, r: int) -> List[str]:
        return [n for n in self.nodes
                if n != self.victim or r not in self.quiet_rounds]


def chaos_schedule(seed: int, rounds: int, nodes: Tuple[str, ...],
                   victim: str) -> ChaosPlan:
    """Build the seeded schedule: per-round lossy-link faults (drop_p <=
    0.2, duplication, small jitter) sampled from ``random.Random(seed)``,
    ONE multi-round partition isolating ``victim``, and ONE crash+restore
    of the victim after the heal.  Same seed => same schedule, always."""
    if rounds < 8:
        raise ValueError("chaos_schedule needs >= 8 rounds to fit the "
                         "partition and crash windows")
    rng = random.Random(seed)
    others = [n for n in nodes if n != victim]
    events: List[ChaosEvent] = []

    # the one multi-round partition: victim cut off for [p0, p1)
    p0 = rounds // 4
    p1 = rounds // 2
    events.append(ChaosEvent(round=p0, action="partition", a=victim))
    events.append(ChaosEvent(round=p1, action="heal"))
    # the one crash/restore, strictly after the heal so the partition and
    # the crash exercise DIFFERENT recovery paths
    c0 = p1 + 1
    c1 = min(rounds - 1, c0 + max(1, rounds // 6))
    events.append(ChaosEvent(round=c0, action="crash", a=victim))
    events.append(ChaosEvent(round=c1, action="restore", a=victim))
    quiet = frozenset(list(range(p0, p1)) + list(range(c0, c1)))

    # per-round lossy-link churn on the surviving links
    for r in range(rounds):
        if rng.random() < 0.4:
            a, b = rng.sample(list(nodes), 2)
            events.append(ChaosEvent(
                round=r, action="fault", a=a, b=b,
                drop_p=round(rng.uniform(0.05, 0.2), 3),
                dup_p=round(rng.uniform(0.0, 0.2), 3),
                jitter_ms=round(rng.uniform(0.0, 3.0), 3)))
        elif rng.random() < 0.3:
            events.append(ChaosEvent(round=r, action="clear_faults"))

    return ChaosPlan(seed=seed, rounds=rounds, nodes=tuple(nodes),
                     victim=victim, events=tuple(events), quiet_rounds=quiet)


def run_chaos(cluster: Cluster, membership, injector: FailureInjector,
              plan: ChaosPlan, write: Callable[[str, int, float], None],
              probe: Optional[Callable[[int, float], None]] = None,
              round_ms: float = 1000.0, apply_faults: bool = True) -> float:
    """Drive one chaos run: apply the round's events, DRAIN the transport
    (so every writer holds all deliverable prior-round snapshots before
    stamping new versions — the ordering that keeps a faulty run's version
    vectors identical to its fault-free twin's), then issue the round's
    writes via ``write(node, round, t)`` and optional ``probe(round, t)``.

    ``apply_faults=False`` runs the fault-free twin: network events
    (fault/partition/heal) are skipped, but crash/restore still apply so
    the two runs share membership history and write sequence.  Per round,
    network events apply FIRST (so a heal's backlog rides this round's
    drain), then the transport drains, then crash/restore — quiescing the
    survivor links before a crash bumps the fencing epoch keeps every
    inter-survivor snapshot deliverable, which is what makes the faulty
    run's version clocks match the twin's.  Returns the final virtual
    time after the closing drain."""
    for r in range(plan.rounds):
        t = r * round_ms
        evs = plan.events_at(r)
        if apply_faults:
            for ev in evs:
                if ev.action == "partition":
                    cut = {n for n in plan.nodes if n != ev.a}
                    injector.partition_groups({ev.a}, cut,
                                              name="chaos-cut")
                elif ev.action == "heal":
                    cluster.faults.heal("chaos-cut")
                elif ev.action == "fault":
                    injector.set_link_fault(ev.a, ev.b, drop_p=ev.drop_p,
                                            dup_p=ev.dup_p,
                                            jitter_ms=ev.jitter_ms)
                elif ev.action == "clear_faults":
                    cluster.faults.clear_faults()
        cluster.drain_transport(t)
        for ev in evs:
            if ev.action == "crash":
                injector.kill_node(ev.a)
            elif ev.action == "restore":
                injector.restore_node(ev.a, t=t)
        for node in plan.writers_for(r):
            if membership is not None and \
                    membership.state.get(node) == "dead":
                continue        # crashed victim cannot write
            write(node, r, t)
        if probe is not None:
            probe(r, t)
    # closing drain: clear residual faults first so every retrying outbox
    # entry can complete, then flush until the transport is idle
    if apply_faults:
        cluster.faults.clear_faults()
        cluster.faults.heal()
    t_end = plan.rounds * round_ms
    cluster.drain_transport(t_end)
    return t_end
