"""The machine-readable lock hierarchy of the serving stack.

The port's copy of ``repro.analysis.lock_order``: the lock table, the
order queries, the static lint's tables and the generated docs block, so
the port builds its ordered locks against the SAME canonical names
without importing the reference package.  Both of the port's checkers
read it: ``lockcheck`` (static AST lint; ``python -m
repro_torch.analysis.lockcheck src/repro_torch``) and ``lockdep``
(runtime ordered-lock validator).  The hierarchy block in
``docs/torch_lock_order.md`` is generated from it (``python -m
repro_torch.analysis.lock_order --write``; a test fails on drift).

The tables differ from the reference's in what the port dispatches with:
``TORCH_ROOTS`` (``torch.*`` chains) takes the place of the reference's
jax roots, and ``DISPATCH_CALL_NAMES`` adds the port's own device calls
(the four kernel wrappers, a ``StepCache``'s capture and replay, the
host reads that synchronise with the card).  The order has one edge the
reference's lacks: ``membership.lock -> health.lock`` (below).

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

import argparse
import pathlib
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
# shared checker tables
# --------------------------------------------------------------------------

#: (class name, attribute) -> the lock that must be held to ``+=`` it.
#: These are the deliberate raw-increment sites: hot-path counters whose
#: guard is an existing lock rather than ``AtomicStats.inc``.
GUARDED_FIELDS: Dict[Tuple[str, str], str] = {
    ("BatchedInvocationEngine", "_tickets"): "engine.qlock",
    ("FaasServer", "_submit_gen"): "server.cond",
    ("Cluster", "replication_bytes"): "cluster.repl_lock",
}

#: Classes whose instances are touched from more than one thread: a bare
#: ``self.<attr> += 1`` with no lock held is a lost-update race unless the
#: site (or class) carries a ``# lockcheck: single-threaded`` annotation.
THREADED_CLASSES: FrozenSet[str] = frozenset({
    "BatchedInvocationEngine",
    "_CycleRun",
    "_NodePool",
    "Router",
    "FaasServer",
    "Cluster",
    "_Node",
    "_DeliveryQueue",
    "ElasticMembership",
    "NamingService",
    "FaultPlane",
    "HealthMonitor",
})

#: Lock-attribute names that identify a lock unambiguously, module-wide.
LOCK_ATTRS: Dict[str, str] = {
    "_qlock": "engine.qlock",
    "_cycle_lock": "engine.cycle_lock",
    "_pump_lock": "server.pump_lock",
    "_cond": "server.cond",
    "_repl_lock": "cluster.repl_lock",
    "_trace_lock": "engine.trace_lock",
    "_outbox_lock": "cluster.outbox_lock",
}

#: ``self._lock`` resolves by ENCLOSING CLASS (many classes reuse the
#: attribute name).  Classes absent here have untracked ``_lock``s — the
#: lint skips them rather than guessing (``StepCache``'s is one: it wraps
#: captures and replays, and no ordered lock is taken under it).
CLASS_LOCK_ATTRS: Dict[str, str] = {
    "Router": "router.lock",
    "AtomicStats": "stats.lock",
    "RouterStats": "stats.lock",
    "NamingService": "naming.lock",
    "ElasticMembership": "membership.lock",
    "_NodePool": "engine.pool_lock",
    "CheckpointManager": "checkpoint.lock",
    "FaultPlane": "network.fault_lock",
    "HealthMonitor": "health.lock",
}

#: Calls that reach a device dispatch — forbidden lexically under
#: ``engine.qlock`` (the queue lock must never be held across a dispatch;
#: ``submit`` would wait on the flush in flight).  The reference's verbs,
#: then the port's own: the four kernel wrappers, a ``StepCache``'s
#: capture and replay, and the calls that wait for the card.
DISPATCH_CALL_NAMES: FrozenSet[str] = frozenset({
    "dispatch", "invoke", "invoke_batch", "pump", "flush", "_run_cycle",
    "merge_stores_jit", "merge_snapshots_fused", "arena_clone",
    "block_until_ready", "device_get", "device_put",
    "jit",
    "enoki_merge_rows", "flash_attention_bhsd", "ssd_chunk_bhcp",
    "mlstm_chunk_bhsd", "merge_arena_aligned",
    "replay", "capture_begin", "capture_end", "prepare_folds", "prewarm",
    "synchronize",
})
DISPATCH_CALL_PREFIXES: Tuple[str, ...] = ("_exec_",)
#: module roots whose attribute calls reach the card
TORCH_ROOTS: FrozenSet[str] = frozenset({"torch"})

#: Method/function names that block the calling thread — forbidden under
#: any non-leaf lock (a ``Condition.wait`` on the very condition being
#: held is the one sanctioned pattern; the lint special-cases it).
BLOCKING_CALL_NAMES: FrozenSet[str] = frozenset({
    "sleep", "result", "join", "wait", "wait_for", "shutdown",
})

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

# --------------------------------------------------------------------------
# docs generation (docs/torch_lock_order.md hierarchy block)
# --------------------------------------------------------------------------

DOC_BEGIN = ("<!-- LOCK_ORDER:begin — generated from "
             "src/repro_torch/analysis/lock_order.py; edit the spec and run "
             "`python -m repro_torch.analysis.lock_order --write` -->")
DOC_END = "<!-- LOCK_ORDER:end -->"


def _topo_nonleaf() -> list:
    """Deterministic topological order of the non-leaf locks (Kahn,
    alphabetical tie-break)."""
    nodes = sorted(n for n in LOCKS if n not in LEAF_LOCKS)
    indeg = {n: 0 for n in nodes}
    for a, b, _ in ORDER_EDGES:
        if b in indeg:
            indeg[b] += 1
    order, ready = [], sorted(n for n in nodes if indeg[n] == 0)
    while ready:
        n = ready.pop(0)
        order.append(n)
        for a, b, _ in ORDER_EDGES:
            if a == n and b in indeg:
                indeg[b] -= 1
                if indeg[b] == 0:
                    ready.append(b)
        ready.sort()
    return order


def render_doc_block() -> str:
    """The generated hierarchy block, markers included."""
    lines = [DOC_BEGIN, "", "```text"]
    for name in _topo_nonleaf():
        attr, desc = LOCKS[name]
        lines.append(f"{name:<20} {attr:<26} {desc}")
        succ = sorted((b, note) for a, b, note in ORDER_EDGES if a == name)
        if succ:
            parts = [b + (f" [{note}]" if note else "") for b, note in succ]
            lines.append(f"{'':20} > may nest: " + ", ".join(parts))
    lines.append("")
    lines.append("leaf locks (anything may take one; nothing is ever "
                 "acquired under one):")
    for name in sorted(LEAF_LOCKS):
        attr, desc = LOCKS[name]
        lines.append(f"  {name:<22} {attr:<24} {desc}")
    lines.append("```")
    lines.append("")
    lines.append(DOC_END)
    return "\n".join(lines)


def _default_doc_path() -> pathlib.Path:
    return (pathlib.Path(__file__).resolve().parents[3]
            / "docs" / "torch_lock_order.md")


def extract_doc_block(text: str) -> Optional[str]:
    i, j = text.find(DOC_BEGIN), text.find(DOC_END)
    if i < 0 or j < 0:
        return None
    return text[i:j + len(DOC_END)]


def check_docs(path: Optional[pathlib.Path] = None) -> bool:
    """True when the docs hierarchy block matches the spec."""
    path = path or _default_doc_path()
    return extract_doc_block(path.read_text()) == render_doc_block()


def sync_docs(path: Optional[pathlib.Path] = None) -> None:
    path = path or _default_doc_path()
    text = path.read_text()
    current = extract_doc_block(text)
    if current is None:
        raise SystemExit(f"{path}: LOCK_ORDER markers not found")
    path.write_text(text.replace(current, render_doc_block()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="check or regenerate the docs lock-hierarchy block")
    ap.add_argument("--write", action="store_true",
                    help="rewrite the block in docs/torch_lock_order.md")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 when the docs block drifted (default)")
    ap.add_argument("--path", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    if args.write:
        sync_docs(args.path)
        print("LOCK_ORDER docs block regenerated")
        return 0
    if check_docs(args.path):
        print("LOCK_ORDER docs block up to date")
        return 0
    print("LOCK_ORDER docs block drifted from lock_order.py — run "
          "`python -m repro_torch.analysis.lock_order --write`")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
