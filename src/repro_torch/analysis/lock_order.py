"""The machine-readable lock hierarchy of the serving stack.

A copy of ``repro.analysis.lock_order``'s lock table and order queries,
so the port builds its ordered locks against the SAME canonical names
without importing the reference package.  The runtime validator
(``lockdep``) reads it; the static lint's tables stay in the reference
(``python -m repro.analysis.lockcheck src/repro_torch`` lints the port).

The order is a partial order (a DAG of direct ``ORDER_EDGES``), not a
total one: two locks with no path between them are simply never nested.
The documented ``on_ready`` delta — the engine's mid-cycle delivery path
takes ``router.lock`` then ``server.cond`` *with the cycle lock held*,
the reverse of the submit-side prose order — is a pair of declared edges
(``engine.cycle_lock -> router.lock`` / ``-> server.cond``) rather than a
blanket suppression: it is deadlock-free precisely because no fold path
ever acquires the cycle lock from under the router lock or the cond, so
the reverse edges must NOT exist, and both checkers enforce exactly that.

Leaf locks protect a few fields each and never wrap another acquisition:
anything may take them, nothing may be taken under them.

This module must not import ``repro_torch.core`` (the core locks import
the validator at module load).
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Optional, Tuple

# --------------------------------------------------------------------------
# the locks: canonical name -> (attribute in the code, what it guards)
# --------------------------------------------------------------------------

LOCKS: Dict[str, Tuple[str, str]] = {
    "server.pump_lock": (
        "FaasServer._pump_lock",
        "whole pump turns (fold -> deliver -> fail-lost)"),
    "server.cond": (
        "FaasServer._cond",
        "future table, orphans, deadline wake-ups"),
    "router.lock": (
        "Router._lock",
        "sessions / in-flight tickets / hedge pairs (host-side folds only)"),
    "engine.cycle_lock": (
        "engine._cycle_lock",
        "serializes flush cycles (all device dispatches)"),
    "engine.qlock": (
        "engine._qlock",
        "window queue, tickets, ready results (never held across dispatch)"),
    "membership.lock": (
        "ElasticMembership._lock",
        "outermost lock of a membership transition"),
    "cluster.node_lock": (
        "_Node.lock",
        "one node's store/clock rebinds (read-dispatch-write)"),
    "cluster.outbox_lock": (
        "Cluster._outbox_lock",
        "per-link replication outboxes + fencing epochs (ack/retry)"),
    "health.lock": (
        "HealthMonitor._lock",
        "heartbeat records and per-observer reachability views"),
    # ---- leaves ----------------------------------------------------------
    "cluster.delivery_lock": (
        "_DeliveryQueue.lock",
        "one node's pending replication deliveries"),
    "network.fault_lock": (
        "FaultPlane._lock",
        "fault specs, named partitions, per-link send counters"),
    "cluster.repl_lock": (
        "Cluster._repl_lock",
        "replication_bytes accounting"),
    "engine.cycle_state_lock": (
        "_Cycle.lock",
        "per-cycle coalesced replication map"),
    "engine.pool_lock": (
        "_NodePool._lock",
        "executor slot table of the parallel pump"),
    "engine.trace_lock": (
        "engine._trace_lock",
        "fold_trace debug recording"),
    "stats.lock": (
        "AtomicStats._lock",
        "counter read-modify-writes (every stats dataclass)"),
    "naming.lock": (
        "NamingService._lock",
        "control-plane registry (pure dict ops)"),
    "checkpoint.lock": (
        "CheckpointManager._lock",
        "writer-thread handoff"),
}

#: Locks that never wrap another acquisition.  Anything may take a leaf;
#: nothing may be acquired while holding one.
LEAF_LOCKS: FrozenSet[str] = frozenset({
    "cluster.delivery_lock",
    "cluster.repl_lock",
    "network.fault_lock",
    "engine.cycle_state_lock",
    "engine.pool_lock",
    "engine.trace_lock",
    "stats.lock",
    "naming.lock",
    "checkpoint.lock",
})

#: Direct outer -> inner edges (the transitive closure is what ``allowed``
#: answers).  The third element annotates WHY the edge exists; edges born
#: from the mid-cycle delivery path carry the "on_ready" tag.
ORDER_EDGES: Tuple[Tuple[str, str, Optional[str]], ...] = (
    ("server.pump_lock", "server.cond", None),
    ("server.pump_lock", "router.lock", None),
    ("server.pump_lock", "engine.cycle_lock", None),
    ("server.cond", "router.lock", None),
    ("router.lock", "engine.qlock", None),
    ("engine.cycle_lock", "engine.qlock", None),
    ("engine.cycle_lock", "cluster.node_lock", None),
    ("engine.cycle_lock", "router.lock", "on_ready"),
    ("engine.cycle_lock", "server.cond", "on_ready"),
    ("membership.lock", "cluster.node_lock", None),
    # bump_fence / drop_pending_deliveries run inside membership
    # transitions; the drain acks (outbox surgery) under the node lock
    ("membership.lock", "cluster.outbox_lock", None),
    # restore() makes the health monitor forget the node's pre-crash
    # silence inside the transition, before liveness flips back (the
    # reference's table lacks this edge; its lockdep never runs there)
    ("membership.lock", "health.lock", None),
    ("cluster.node_lock", "cluster.outbox_lock", None),
    ("cluster.node_lock", "cluster.delivery_lock", None),
    # the transport pump pushes arrivals into the target's delivery queue
    # while walking the link's outbox
    ("cluster.outbox_lock", "cluster.delivery_lock", None),
)

# --------------------------------------------------------------------------
# order queries
# --------------------------------------------------------------------------


def _closure() -> Dict[str, FrozenSet[str]]:
    adj: Dict[str, set] = {}
    for a, b, _ in ORDER_EDGES:
        adj.setdefault(a, set()).add(b)
    out: Dict[str, FrozenSet[str]] = {}
    for start in LOCKS:
        seen: set = set()
        stack = list(adj.get(start, ()))
        while stack:
            n = stack.pop()
            if n in seen:
                continue
            seen.add(n)
            stack.extend(adj.get(n, ()))
        out[start] = frozenset(seen)
    return out


_REACHABLE = _closure()


def allowed(outer: str, inner: str) -> bool:
    """May ``inner`` be acquired while ``outer`` is held?

    Unknown names are permitted (record-only for the runtime validator);
    ``outer == inner`` is NOT answered here — reentrancy is an instance
    property the callers decide (the static lint assumes same-name
    nesting is a reentrant RLock; the runtime validator compares
    identity and treats two distinct peers as a violation).
    """
    if outer not in LOCKS or inner not in LOCKS:
        return True
    if outer in LEAF_LOCKS:
        return False
    if inner in LEAF_LOCKS:
        return True
    return inner in _REACHABLE.get(outer, frozenset())


def assert_dag() -> None:
    """Validate the declaration itself: known endpoints, no outgoing
    edges from leaves, and an acyclic edge set."""
    for a, b, _ in ORDER_EDGES:
        if a not in LOCKS or b not in LOCKS:
            raise AssertionError(f"LOCK_ORDER edge with unknown lock: "
                                 f"{a!r} -> {b!r}")
        if a in LEAF_LOCKS:
            raise AssertionError(f"leaf lock {a!r} has an outgoing edge")
    for name, reach in _REACHABLE.items():
        if name in reach:
            raise AssertionError(f"LOCK_ORDER cycle through {name!r}")


assert_dag()
