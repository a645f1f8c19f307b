"""Discrete-event Enoki cluster (the §4/§5 testbed).

Runs REAL function handlers against REAL store arenas on one device (the
CUDA card unless ``device`` says otherwise), and layers the paper's emulated
network (network.py) on top as virtual time — the same methodology as the
paper's tc-netem testbed, with the network emulated analytically instead of
in the kernel.  The host code is the reference's, copied; arenas are
written in place by folds and merges (core/store.py), so every snapshot
that outlives the live arena is a clone.

Replication is asynchronous, exactly as in FReD — but the wire is the
paper's WAN, not a reliable bus.  A local write to a REPLICATED keygroup
appends an outbox entry per (source, target) link carrying ``(kg, seq,
epoch, snapshot)``; transmission attempts consult the ``FaultPlane``
(drops, duplication, jitter, partitions) and re-offer with capped
exponential backoff until the entry is ACKED by the target's drain.
Delivery is at-least-once on the wire and exactly-once at the store: the
drain dedups by ``seq`` and rejects entries whose fencing ``epoch`` is
stale (a crash/rebalance bumps the keygroup epoch, so a restored node's
pre-crash snapshots cannot resurrect overwritten state).  Arrival times
are stamped at TRANSMIT time from the current link, so snapshots queued
during a partition deliver after ``heal()`` instead of stranding at inf.
Staleness falls out of the event timeline and is measured by the
benchmarks the same way the paper measures it (read time minus the apply
time of the overwriting operation).

Placements (ReplicationPolicy):
  REPLICATED     kv ops hit the node-local replica; async replication to peers
  PEER_FETCH     kv ops hit the owner node's store; remote nodes pay one RTT/op
  CLOUD_CENTRAL  kv ops hit the cloud node's store; everyone else pays RTT/op

Concurrency: every node carries its own lock (guarding that node's store/
clock rebinds) and its own replication delivery queue with a queue lock, so
the engine's parallel pump can execute independent store nodes' groups
concurrently — ``_deliver_until``/``_schedule_replication`` never touch
global state.  Lock order within the cluster: a node's lock may be taken
before that same node's queue lock; queue locks of PEERS are only ever
taken with no node lock held (``_schedule_replication`` runs outside them).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis import lockdep
from repro_torch.configs.base import ReplicationPolicy
from repro_torch.core.engine import AtomicStats, BatchedInvocationEngine
from repro_torch.core.faas import (FunctionSpec, compile_batched_handler,
                                   compile_handler)
from repro_torch.core.keygroup import KeygroupSpec, arena_new
from repro_torch.core.naming import NamingService
from repro_torch.core.network import FaultPlane, NetworkModel, paper_topology
from repro_torch.core.store import (Store, arena_clone,
                                    merge_snapshots_fused, store_assign_slots)
from repro_torch.core.versioning import MAX_NODES
from repro_torch.device import resolve_device, synchronize


def fires_sync_downstream(y) -> bool:
    """The paper's fig-8 filter convention: a leading output element < 0
    suppresses synchronous downstream calls.  Single source of truth for
    both the sequential (`invoke`) and batched (engine) routing paths."""
    arr = np.asarray(y)
    return bool(arr.size == 0 or float(arr.ravel()[0]) >= 0.0)


@dataclasses.dataclass
class InvokeResult:
    output: Any
    response_ms: float          # client-observed request-response latency
    t_sent: float
    t_received: float
    t_applied: float            # when state mutation took effect at the store
    kv_ops: List[Tuple[str, int]]
    node: str
    chain: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ClusterStats(AtomicStats):
    """Delivery-merge and transport accounting — the dispatch-count probe
    the fused-merge tests and the verify smoke assert against, plus the
    ack/retry transport's fault counters.  Mutate via ``inc`` only
    (``stats.lock`` is a leaf in the lock order, safe under node locks)."""
    merge_dispatches: int = 0   # fused delivery merges (ONE device dispatch each)
    merge_snapshots: int = 0    # queued snapshots folded by those dispatches
    merge_aligned: int = 0      # dispatches that took the slot-aligned kernel
    merge_fallback: int = 0     # dispatches on the O(S^2) merge_stores body
    repl_retries: int = 0       # outbox re-offers (backoff after drop/partition)
    repl_dropped: int = 0       # transmissions the fault plane dropped
    repl_duped: int = 0         # duplicate deliveries suppressed at the drain
    epoch_rejections: int = 0   # stale-fencing-epoch deliveries rejected


# -- transport knobs: capped exponential backoff of the replication outbox
REPL_RETRY_BASE_MS = 5.0
REPL_RETRY_CAP_MS = 160.0
# per entry per pump: bounds the retry loop under adversarial drop_p ~ 1.0
# (p <= 0.2 converges in a couple of attempts; 64 straight drops at p=0.2
# has probability ~1e-45)
_MAX_ATTEMPTS_PER_PUMP = 64


@dataclasses.dataclass
class _OutboxEntry:
    """One unacked replication snapshot on a (source, target) link.

    State machine: PENDING (``sent=False``) — transmission attempts sample
    the fault plane; a drop or partition re-offers at ``t_ready + backoff``
    — then SENT once a transmission succeeds (the copy, or copies, are in
    the target's delivery queue with finite arrivals), and the entry is
    removed when the target's drain ACKS ``seq``.  A target crash clears
    both its queue and the entries addressed to it; a SOURCE crash leaves
    its own outgoing entries intact (the at-least-once sender restarts
    with its outbox) — the fencing epoch rejects them if state moved on."""
    kg: str
    seq: int
    epoch: int
    snapshot: Store
    nbytes: int
    t_ready: float              # next transmission attempt (virtual ms)
    t_base: float = 0.0         # original schedule instant: heal() re-arms
                                # parked entries back to it so they deliver
                                # as if freshly scheduled on the healed link
    attempts: int = 0
    sent: bool = False


@dataclasses.dataclass
class _Node:
    name: str
    kind: str                   # "edge" | "cloud"
    node_id: int
    clock: torch.Tensor         # 0-d int32 lamport clock, on the device
    stores: Dict[str, Store] = dataclasses.field(default_factory=dict)
    handlers: Dict[str, Callable] = dataclasses.field(default_factory=dict)
    batched_handlers: Dict[str, Callable] = dataclasses.field(
        default_factory=dict)
    compute_ms: Dict[str, float] = dataclasses.field(default_factory=dict)
    # guards this node's stores and clock: the read-fold-write of one
    # invocation and every merge into its arenas hold it, so concurrent
    # touches of one store node serialize
    lock: threading.RLock = dataclasses.field(
        default_factory=lambda: lockdep.make_rlock("cluster.node_lock"),
        repr=False, compare=False)


@dataclasses.dataclass
class _DeliveryQueue:
    """One node's pending replication deliveries: a heap of
    ``(arrival_t, seq, kg, snapshot, source, epoch)`` behind its own lock,
    so link pumps push into it and the target drains it without any global
    state.  ``applied`` is the dedup ledger of every seq this node ever
    folded (or rejected) — touched only by ``_deliver_until`` under the
    node lock, which serializes drains of one node."""
    heap: List[Tuple[float, int, str, Store, str, int]] = dataclasses.field(
        default_factory=list)
    applied: set = dataclasses.field(default_factory=set)
    lock: threading.Lock = dataclasses.field(
        default_factory=lambda: lockdep.make_lock("cluster.delivery_lock"),
        repr=False, compare=False)


class Cluster:
    def __init__(self, nodes: Dict[str, str], net: Optional[NetworkModel] = None,
                 measure_compute: bool = True, fault_seed: int = 0,
                 device=None):
        # every arena, clock and handler input of this cluster lives here;
        # None means the CUDA card (and raises on a host without one)
        self.device = resolve_device(device)
        self.net = net or paper_topology()
        # the lossy-WAN layer: replication transmissions and heartbeat
        # reachability sample it (seeded => any fault schedule replays)
        self.faults = FaultPlane(self.net, seed=fault_seed)
        self.faults.on_heal = self._rearm_outboxes
        self.naming = NamingService()
        self.nodes: Dict[str, _Node] = {}
        for i, (name, kind) in enumerate(nodes.items()):
            self.nodes[name] = self._new_node(name, kind, i)
            self.naming.register_node(name, kind)
        # per-node pending replication deliveries (each behind its own lock)
        self._queues: Dict[str, _DeliveryQueue] = {
            name: _DeliveryQueue() for name in self.nodes}
        self._seq = itertools.count()
        # per-(source, target) replication outboxes: unacked entries with
        # their retry state.  One lock for the whole table — entries are
        # tiny and the pump holds it only across host-side bookkeeping.
        self._outboxes: Dict[Tuple[str, str], List[_OutboxEntry]] = {}
        self._outbox_lock = lockdep.make_lock("cluster.outbox_lock")
        # per-keygroup fencing epochs (bumped by membership crash/rebalance
        # under membership.lock -> outbox_lock; read lock-free on the
        # schedule/drain paths — a torn read is impossible for a dict of
        # ints and staleness only delays a rejection by one drain)
        self._epochs: Dict[str, int] = {}
        # back-reference set by ElasticMembership.__init__ so the drain can
        # report epoch rejections into MembershipStats
        self.membership = None
        self._repl_lock = lockdep.make_lock(
            "cluster.repl_lock")             # replication_bytes accounting
        self._measure = measure_compute
        self.replication_bytes = 0   # accounting for §Perf
        self.stats = ClusterStats()
        self.specs: Dict[str, FunctionSpec] = {}
        self.policies: Dict[str, KeygroupSpec] = {}
        # canonical key->slot layout per keygroup (deploy-time, grows
        # monotonically) and whether every replica still carries it; an
        # unaligned keygroup PERMANENTLY uses the O(S^2) fallback merge
        self._slot_maps: Dict[str, Dict[int, int]] = {}
        self._aligned: Dict[str, bool] = {}
        self.engine = BatchedInvocationEngine(self)

    def _new_node(self, name: str, kind: str, node_id: int) -> _Node:
        return _Node(name=name, kind=kind, node_id=node_id,
                     clock=torch.zeros((), dtype=torch.int32,
                                       device=self.device))

    def scratch_arena(self, spec: FunctionSpec) -> Store:
        """A fresh throwaway arena for a stateless function's handler."""
        return arena_new(KeygroupSpec(name="_tmp",
                                      value_width=spec.codec_width,
                                      device=self.device), MAX_NODES)

    # ------------------------------------------------------------------ deploy
    def create_keygroup(self, spec: KeygroupSpec, nodes: List[str]) -> None:
        self.naming.create_keygroup(spec)
        self.policies[spec.name] = spec
        for n in nodes:
            self._materialise_keygroup(spec, n)

    def _materialise_keygroup(self, spec: KeygroupSpec, node: str) -> None:
        """Create or replicate a keygroup to ``node`` (§2: deploy-time copy)."""
        existing = self.naming.replicas_of(spec.name)
        nd = self.nodes[node]
        if node in existing:
            return
        if existing:
            # replicate current contents from any live replica — as a
            # CLONE: replicas must never share arena buffers, or a fold at
            # one node would write into the other's store
            src = next(iter(existing))
            with self.nodes[src].lock:
                snapshot = self.nodes[src].stores[spec.name]
            nd.stores[spec.name] = arena_clone(snapshot)
        else:
            nd.stores[spec.name] = self.blank_arena(spec.name, spec)
        self.naming.add_replica(spec.name, node)

    def blank_arena(self, kg: str, kspec: Optional[KeygroupSpec] = None
                    ) -> Store:
        """A fresh arena for ``kg`` with the keygroup's canonical slot
        layout pre-applied.  Restores/rebalances (runtime/elastic,
        runtime/failure) MUST use this instead of a raw ``arena_new`` so a
        rebuilt replica stays slot-aligned with its peers."""
        kspec = kspec or self.policies[kg]
        arena = arena_new(kspec, MAX_NODES)
        amap = self._slot_maps.get(kg)
        if amap:
            arena, ok = store_assign_slots(arena, amap)
            assert ok, kg   # fresh arena: the layout always applies
        return arena

    def deploy(self, spec: FunctionSpec, nodes: List[str],
               policy: ReplicationPolicy = ReplicationPolicy.REPLICATED,
               owner: Optional[str] = None, value_width: Optional[int] = None,
               example_input=None) -> None:
        """Deploy a function (and its keygroups) to ``nodes`` — §2 flow."""
        self.specs[spec.name] = spec
        self.naming.register_function(spec.name, spec.keygroups)
        example = (example_input if example_input is not None
                   else np.zeros((1,), np.float32))
        for kg_name in spec.keygroups:
            kspec = self.policies.get(kg_name) or KeygroupSpec(
                name=kg_name, policy=policy,
                value_width=value_width or spec.codec_width, owner=owner,
                device=self.device)
            self.policies[kg_name] = kspec
            self.naming.create_keygroup(kspec)
            # store placement depends on policy
            if kspec.policy == ReplicationPolicy.REPLICATED:
                placement = nodes
            elif kspec.policy == ReplicationPolicy.PEER_FETCH:
                placement = [kspec.owner or nodes[0]]
            else:  # CLOUD_CENTRAL
                placement = [kspec.owner or self._cloud_node()]
            for n in placement:
                self._materialise_keygroup(kspec, n)
        for n in nodes:
            nd = self.nodes[n]
            nd.handlers[spec.name] = compile_handler(
                spec, nd.node_id, example, device=self.device)
            nd.batched_handlers[spec.name] = compile_batched_handler(
                spec, nd.node_id, example, device=self.device)
            self.naming.add_deployment(spec.name, n)
            if self._measure:
                nd.compute_ms[spec.name] = self._measure_compute(spec, nd, example)
            else:
                nd.compute_ms[spec.name] = 0.0
        if spec.keygroups:
            # canonical slot pre-assignment: the handler's key set is
            # static (literal strings hashed at trace time), so stamp it
            # into every replica now — delivery merges then take the
            # elementwise slot-aligned kernel instead of the O(S^2) probe
            bh = self.nodes[nodes[0]].batched_handlers[spec.name]
            self._register_keys(spec.keygroups[0],
                                getattr(bh, "key_hashes", ()))

    def _register_keys(self, kg: str, hashes) -> None:
        """Assign each new key hash the next free canonical slot and apply
        the layout to every replica of ``kg`` (``store_assign_slots``).

        If the layout cannot apply — arena overflow, or a dynamic write
        already claimed a conflicting slot — the keygroup permanently
        falls back to the layout-agnostic ``merge_stores`` path:
        correctness never depends on alignment, only the merge cost does.
        """
        hashes = tuple(dict.fromkeys(int(h) for h in hashes))
        if not hashes or self._aligned.get(kg) is False:
            return
        kspec = self.policies.get(kg)
        slots = kspec.slots if kspec else 64
        amap = self._slot_maps.setdefault(kg, {})
        fresh = [h for h in hashes if h not in amap]
        if len(amap) + len(fresh) > slots:
            self._aligned[kg] = False   # more static keys than slots
            return
        used = set(amap.values())
        nxt = 0
        for h in fresh:
            while nxt in used:
                nxt += 1
            amap[h] = nxt
            used.add(nxt)
        new = {h: amap[h] for h in fresh}
        ok_all = True
        for node in self.naming.replicas_of(kg):
            nd = self.nodes[node]
            with nd.lock:
                arena, ok = store_assign_slots(nd.stores[kg], new)
                if not ok:
                    ok_all = False
                    break
                nd.stores[kg] = arena
        self._aligned[kg] = ok_all

    def _cloud_node(self) -> str:
        for n, nd in self.nodes.items():
            if nd.kind == "cloud":
                return n
        return next(iter(self.nodes))

    def _measure_compute(self, spec: FunctionSpec, nd: _Node, example) -> float:
        """Median wall-time of the handler on this device (warm starts).

        The handler writes into the arena it is given, so the 11 runs go
        to a CLONE of the state, never the live arena."""
        kg = spec.keygroups[0] if spec.keygroups else None
        if kg and kg in nd.stores:
            store = nd.stores[kg]
        elif kg:
            # store placed remotely (PEER_FETCH/CLOUD_CENTRAL): measure against
            # any replica's state — compute cost is placement-independent.
            replica = next(iter(self.naming.replicas_of(kg)))
            store = self.nodes[replica].stores[kg]
        else:
            store = self.scratch_arena(spec)
        store = arena_clone(store)
        h = nd.handlers[spec.name]
        h(store, nd.clock, example)  # warm
        ts = []
        for _ in range(10):
            t0 = time.perf_counter()
            h(store, nd.clock, example)
            synchronize(self.device)
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    # --------------------------------------------------------------- timeline
    # -- fencing epochs ------------------------------------------------------
    def fence_epoch(self, kg: str) -> int:
        """Current fencing epoch of ``kg`` (0 until the first crash or
        rebalance touches it).  Snapshots are stamped with it at schedule
        time; the drain rejects anything older."""
        return self._epochs.get(kg, 0)

    def bump_fence(self, kg: str) -> int:
        """Advance ``kg``'s fencing epoch (membership calls this on every
        crash/rebalance involving the keygroup).  Outstanding snapshots
        stamped with the old epoch are rejected at delivery — a restored
        node cannot resurrect pre-crash state past the rebalance; it
        re-syncs through the catch-up path instead."""
        with self._outbox_lock:
            e = self._epochs.get(kg, 0) + 1
            self._epochs[kg] = e
            return e

    # -- the ack/retry transport --------------------------------------------
    @staticmethod
    def _backoff_ms(attempts: int) -> float:
        return min(REPL_RETRY_BASE_MS * (2.0 ** attempts), REPL_RETRY_CAP_MS)

    def _pump_entries(self, src: str, dst: str,
                      entries: List[_OutboxEntry], t: float) -> None:
        """Attempt transmission of every PENDING entry of one link whose
        retry timer is due (``t_ready <= t``).  Called with the outbox lock
        held; pushes successful copies into ``dst``'s delivery queue with
        arrival stamped from the CURRENT link state (transmit time + one
        way + sampled jitter) — partition-era entries re-time after heal.

        A partitioned link costs ONE re-offer per pump (its state cannot
        change within the call — heal() happens between pumps); lossy
        links retry inline up to the per-pump attempt budget."""
        base_t = t if np.isfinite(t) else 0.0
        for e in entries:
            if e.sent:
                continue
            budget = _MAX_ATTEMPTS_PER_PUMP
            while not e.sent and e.t_ready <= t and budget > 0:
                budget -= 1
                attempt_t = e.t_ready if np.isfinite(e.t_ready) else base_t
                if self.faults.partitioned(src, dst):
                    e.t_ready = base_t + self._backoff_ms(e.attempts)
                    e.attempts += 1
                    self.stats.inc("repl_retries")
                    break
                tx = self.faults.transmit(src, dst)
                if not tx.ok:
                    e.t_ready = attempt_t + self._backoff_ms(e.attempts)
                    e.attempts += 1
                    self.stats.inc("repl_dropped")
                    self.stats.inc("repl_retries")
                    continue
                arrival0 = attempt_t + self.net.one_way_ms(src, dst)
                q = self._queues[dst]
                with q.lock:
                    for j in range(tx.copies):
                        heapq.heappush(
                            q.heap, (arrival0 + tx.jitter_ms[j], e.seq,
                                     e.kg, e.snapshot, src, e.epoch))
                e.sent = True

    def _rearm_outboxes(self) -> None:
        """heal() hook: reset every PENDING entry on a now-reachable link
        back to its original schedule instant (``t_base``, fresh backoff).
        Without this a partition-era retry timer sits at "last pump time +
        backoff", and a flush at that same virtual horizon could never
        reach it — the snapshot would strand exactly like the historical
        ``inf``-arrival events.  Re-armed entries deliver at
        ``t_base + one_way`` as if freshly scheduled on the healed link."""
        with self._outbox_lock:
            for (src, dst), entries in self._outboxes.items():
                if self.faults.partitioned(src, dst):
                    continue
                for e in entries:
                    if not e.sent and e.t_ready > e.t_base:
                        e.t_ready = e.t_base
                        e.attempts = 0

    def _pump_inbound(self, node: str, t: float) -> None:
        """Drive the retry state machine of every link INTO ``node`` up to
        virtual time ``t`` — the receive half of the transport, run by the
        target's drain so no extra scheduler thread exists."""
        with self._outbox_lock:
            for (src, dst), entries in self._outboxes.items():
                if dst == node and entries:
                    self._pump_entries(src, dst, entries, t)

    def _ack(self, node: str, acks: List[Tuple[str, int]]) -> None:
        """Remove drained entries from their (source, ``node``) outboxes —
        the delivery ack.  A rejected (stale-epoch) or deduped delivery
        acks too: the sender must stop re-offering either way."""
        by_src: Dict[str, set] = {}
        for src, seq in acks:
            by_src.setdefault(src, set()).add(seq)
        with self._outbox_lock:
            for src, seqs in by_src.items():
                key = (src, node)
                entries = self._outboxes.get(key)
                if entries:
                    self._outboxes[key] = [e for e in entries
                                           if e.seq not in seqs]

    def _deliver_until(self, node: str, t: float) -> None:
        """Pump the transport for ``node``'s inbound links, then apply all
        deliveries with arrival <= t in (arrival, seq) order — network
        delivery order, so a later snapshot is always merged after an
        earlier one regardless of how the pending heap happens to be laid
        out.  Duplicate seqs (link-level duplication, or a retransmit
        racing its own ack) are suppressed via the queue's ``applied``
        ledger, and entries carrying a stale fencing epoch are rejected;
        both still ACK so the sender stops re-offering.

        The K due snapshots of each keygroup fold with ONE fused merge
        (``merge_snapshots_fused``) written into the live arena — one
        ``enoki_merge_rows`` kernel launch when the keygroup's canonical
        layout held up, the O(S²) ``merge_stores`` fold otherwise.  Either
        way the result is bit-identical to a per-snapshot loop in the same
        order.

        Thread-safe: ``node``'s own lock and queue lock serialize the
        drain (the outbox lock nests inside the node lock for the ack),
        so deliveries to different nodes run concurrently under the
        parallel pump."""
        self._pump_inbound(node, t)
        nd = self.nodes[node]
        q = self._queues[node]
        with nd.lock:
            with q.lock:
                due = [ev for ev in q.heap if ev[0] <= t]
                if not due:
                    return
                keep = [ev for ev in q.heap if ev[0] > t]
                # the filtered keep-list is no longer a valid heap for
                # later heappush
                heapq.heapify(keep)
                q.heap = keep
            per_kg: Dict[str, List[Store]] = {}
            acks: List[Tuple[str, int]] = []
            dups = stale = 0
            for arrival, seq, kg, snapshot, source, epoch in sorted(
                    due, key=lambda e: e[:2]):
                acks.append((source, seq))
                if seq in q.applied:
                    dups += 1
                    continue
                q.applied.add(seq)
                if epoch < self._epochs.get(kg, 0):
                    stale += 1      # fenced: state moved on past the sender
                    continue
                if kg not in nd.stores:
                    continue    # replica crashed away mid-flight: stale
                per_kg.setdefault(kg, []).append(snapshot)
            for kg, snaps in per_kg.items():
                aligned = self._aligned.get(kg, False)
                nd.stores[kg] = merge_snapshots_fused(
                    nd.stores[kg], snaps, aligned=aligned)
                self.stats.inc("merge_dispatches")
                self.stats.inc("merge_snapshots", len(snaps))
                self.stats.inc("merge_aligned" if aligned
                               else "merge_fallback")
            if dups:
                self.stats.inc("repl_duped", dups)
            if stale:
                self.stats.inc("epoch_rejections", stale)
                m = self.membership
                if m is not None:
                    m.stats.inc("epoch_rejections", stale)
            self._ack(node, acks)

    def _schedule_replication(self, kg: str, source: str, t_apply: float) -> None:
        spec = self.policies[kg]
        if spec.policy != ReplicationPolicy.REPLICATED:
            return
        with self.nodes[source].lock:
            # a queued snapshot must never alias the live arena: the
            # source's next fold writes into it (on every device)
            snapshot = arena_clone(self.nodes[source].stores[kg])
        nbytes = sum(x.numel() * x.element_size() for x in snapshot[:4])
        epoch = self._epochs.get(kg, 0)
        alive = set(self.naming.alive_nodes())
        targets = [peer for peer in self.naming.replicas_of(kg)
                   if peer != source and peer in alive]
                    # a dead replica receives nothing; a restore re-syncs
                    # it from a live peer snapshot instead.  SUSPECT peers
                    # DO receive entries — their outboxes simply retry
                    # until the partition heals (replicas are not torn
                    # down on suspicion).
        t0 = t_apply if np.isfinite(t_apply) else 0.0
        with self._outbox_lock:
            for peer in targets:
                entries = self._outboxes.setdefault((source, peer), [])
                entries.append(_OutboxEntry(
                    kg=kg, seq=next(self._seq), epoch=epoch,
                    snapshot=snapshot, nbytes=nbytes, t_ready=t0,
                    t_base=t0))
                # eager first attempt at schedule time: on a healthy link
                # this lands the old fire-and-forget arrival
                # (t_apply + one_way) exactly
                self._pump_entries(source, peer, entries, t0)
            with self._repl_lock:
                self.replication_bytes += nbytes * len(targets)

    def drop_pending_deliveries(self, node: str) -> int:
        """Discard every undelivered replication event addressed to
        ``node``: its delivery queue AND the unacked outbox entries its
        peers still hold for it (a crashed replica loses what was on the
        wire TO it; the crashed node's own OUTGOING entries survive — the
        at-least-once sender keeps its outbox across a restart, and the
        fencing epoch rejects whatever went stale).  Returns the number of
        dropped events (queued arrivals + never-transmitted entries; a
        transmitted entry is already counted by its queued copy)."""
        q = self._queues[node]
        with q.lock:
            n = len(q.heap)
            q.heap = []
        with self._outbox_lock:
            for key in [k for k in self._outboxes if k[1] == node]:
                n += sum(1 for e in self._outboxes.pop(key) if not e.sent)
        return n

    def transport_idle(self) -> bool:
        """True when nothing is in flight: every delivery queue is empty
        and every outbox entry still unacked sits on a PARTITIONED link
        (those cannot make progress until heal)."""
        with self._outbox_lock:
            for (src, dst), entries in self._outboxes.items():
                if entries and not self.faults.partitioned(src, dst):
                    return False
        for q in self._queues.values():
            with q.lock:
                if q.heap:
                    return False
        return True

    def drain_transport(self, t: float = 0.0, max_rounds: int = 200,
                        step_ms: float = 1000.0) -> bool:
        """Flush replication repeatedly, advancing virtual time from ``t``
        by ``step_ms`` per round, until the transport is idle (retries on
        lossy links need time to elapse for their backoff timers).  Returns
        False when non-partitioned work remains after ``max_rounds`` —
        never the case for drop_p < 1 links at the default budget."""
        for i in range(max_rounds):
            self.flush_replication(t + i * step_ms)
            if self.transport_idle():
                return True
        return self.transport_idle()

    def add_node(self, name: str, kind: str = "edge") -> None:
        """Register a NEW node at runtime (elastic join).  The node starts
        with no stores or handlers — membership catch-up replicates
        keygroups and deploys handlers before it serves (runtime/elastic)."""
        if name in self.nodes:
            raise ValueError(f"node {name!r} already exists")
        node_id = max(nd.node_id for nd in self.nodes.values()) + 1
        if node_id >= MAX_NODES:
            raise ValueError(f"cluster is at MAX_NODES={MAX_NODES}")
        self.nodes[name] = self._new_node(name, kind, node_id)
        self._queues[name] = _DeliveryQueue()
        self.naming.register_node(name, kind)

    def pending_replication(self, node: Optional[str] = None
                            ) -> List[Tuple[float, str, str]]:
        """Read-only view of undelivered replication events as
        ``(arrival_t, keygroup, target_node)`` tuples, sorted by arrival —
        the public replacement for poking the (now per-node) delivery
        queues directly."""
        out = []
        for name, q in self._queues.items():
            if node is not None and name != node:
                continue
            with q.lock:
                out.extend((ev[0], ev[2], name) for ev in q.heap)
        # plus outbox entries not yet transmitted (partitioned or retrying
        # links): surfaced with their next-attempt time as the horizon
        with self._outbox_lock:
            for (_, dst), entries in self._outboxes.items():
                if node is not None and dst != node:
                    continue
                out.extend((e.t_ready, e.kg, dst)
                           for e in entries if not e.sent)
        return sorted(out)

    # ----------------------------------------------------------------- invoke
    def _resolve_placement(self, spec: FunctionSpec, node: str
                           ) -> Tuple[Optional[str], str, float]:
        """(keygroup, store_node, per_op_rtt_ms) for an invocation at
        ``node`` — which replica the kv ops hit and what each op costs."""
        kg = spec.keygroups[0] if spec.keygroups else None
        if kg is None:
            return None, node, 0.0
        kspec = self.policies[kg]
        if kspec.policy == ReplicationPolicy.REPLICATED:
            return kg, node, 0.0
        owner = (kspec.owner or
                 (self._cloud_node()
                  if kspec.policy == ReplicationPolicy.CLOUD_CENTRAL
                  else node))
        per_op_ms = 0.0 if owner == node else self.net.rtt_ms(node, owner)
        return kg, owner, per_op_ms

    def _op_network_ms(self, node: str, store_node: str, per_op_ms: float,
                       ops: List[Tuple[str, int]]) -> float:
        """Per-op network charges for remote store placements (§4.1: the
        +200ms of 4 kv ops against a cloud store)."""
        if per_op_ms <= 0.0:
            return 0.0
        link = self.net.link(node, store_node)
        return sum(per_op_ms + link.transfer_ms(nbytes) for _, nbytes in ops)

    def invoke(self, fn_name: str, node: str, x, t_send: float = 0.0,
               client: str = "client", payload_bytes: int = 64) -> InvokeResult:
        """One-off invocation: a SINGLETON frame through the batched
        engine's scheduler, drained synchronously.

        There is no separate sequential pipeline any more — the engine's
        flush cycle (store fold, per-request virtual timeline, coalesced
        replication snapshot, downstream call chains, dead-node reroute)
        is the one implementation both paths share, so every stat,
        eviction rule and hedging hook applies identically whether a
        request arrives alone or in a window.  A singleton cycle charges
        the exact same network/compute timeline the old inline path did
        (the engine's latency-parity tests pin this); ``output`` holds a
        host numpy row like ``invoke_batch``'s results do."""
        [res] = self.engine.dispatch(fn_name, node, [x], [t_send],
                                     client=client,
                                     payload_bytes=payload_bytes)
        return res

    def invoke_batch(self, fn_name: str, node: str, xs,
                     t_sends: Optional[List[float]] = None,
                     client: str = "client",
                     payload_bytes: int = 64) -> List[InvokeResult]:
        """Invoke ``fn_name`` at ``node`` for every input in ``xs`` with ONE
        batched device dispatch (per bucket chunk) instead of len(xs) Python
        round-trips — the §4.2 throughput hot path.

        The emulated network is threaded per request (each entry of
        ``t_sends`` keeps its own arrival/response timeline).  For the
        invoked function itself, store-update semantics match len(xs)
        sequential ``invoke`` calls exactly (scan-fold, last-writer-wins,
        identical clocks).  Downstream call chains follow the engine's
        flush-cycle model instead: callees run after the caller chunks of
        the cycle (chunks cap at the largest bucket, 256 by default) and
        coalesce per callee ACROSS chunks, so a callee that reads state its
        caller writes sees the post-chunk value, not its own request's
        prefix (see core/engine.py and docs/batched_engine.md for this and
        the replication-coalescing trade-off).  Returns per-request
        InvokeResults in input order;
        ``output`` holds host numpy rows (the batch is materialised once),
        exactly like ``invoke``'s singleton frames.
        """
        return self.engine.dispatch(fn_name, node, xs, t_sends,
                                    client=client,
                                    payload_bytes=payload_bytes)

    def is_read_only(self, fn_name: str) -> bool:
        """Whether invoking ``fn_name`` is free of state mutation ANYWHERE
        in its call graph: its own deploy-time op trace plus every
        transitive callee's.  This is the hedge-safety gate — a hedged
        retry re-runs the WHOLE downstream chain, so a stateless caller
        with a mutating callee (e.g. a fig-8 filter in front of a writer)
        is NOT safe to re-invoke even though its own trace is empty."""
        seen = set()
        stack = [fn_name]
        while stack:
            fn = stack.pop()
            if fn in seen:
                continue
            seen.add(fn)
            if not self._handler_read_only(fn):     # raises if fn_name
                return False                        # itself is undeployed
            spec = self.specs[fn]
            for callee in (*spec.calls, *spec.async_calls):
                if callee not in self.specs:
                    return False    # unknown callee: cannot prove safety
                stack.append(callee)
        return True

    def _handler_read_only(self, fn_name: str) -> bool:
        """The per-handler flag from the deploy-time op trace (identical at
        every deployment since the trace is static)."""
        for n in self.naming.deployments_of(fn_name):
            h = self.nodes[n].handlers.get(fn_name)
            if h is not None:
                return bool(getattr(h, "read_only", False))
        raise KeyError(f"{fn_name} not deployed anywhere")

    def _nearest_deployment(self, fn_name: str, from_node: str) -> str:
        """Nearest ROUTABLE deployment — dead nodes never receive new
        work, and SUSPECT nodes (minority-view partition) stop receiving
        it too, so a downstream wave whose usual target crashed or went
        unreachable fails over to the nearest surviving replica instead of
        dispatching into the void."""
        alive = set(self.naming.routable_nodes())
        nodes = [n for n in self.naming.deployments_of(fn_name)
                 if n in alive and fn_name in self.nodes[n].handlers]
        if not nodes:
            raise KeyError(f"no live deployment of {fn_name}")
        return min(nodes, key=lambda n: self.net.rtt_ms(from_node, n))

    def set_compute_ms(self, node: str, fn_name: str, ms: float) -> None:
        """Override the per-invocation compute charge of ``fn_name`` at
        ``node`` in the virtual timeline — the knob benchmarks/tests use to
        model an overloaded STRAGGLER replica (the hedging scenario): the
        nearest deployment stays nearest by RTT but serves slowly."""
        if fn_name not in self.nodes[node].compute_ms:
            raise KeyError(f"{fn_name!r} is not deployed at {node!r}")
        self.nodes[node].compute_ms[fn_name] = float(ms)

    # -------------------------------------------------------------- debugging
    def store_of(self, kg: str, node: str) -> Store:
        return self.nodes[node].stores[kg]

    def flush_replication(self, t: float = float("inf")) -> None:
        for n in self.nodes:
            self._deliver_until(n, t)
