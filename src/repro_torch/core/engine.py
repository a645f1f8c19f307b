"""Batched invocation engine — coalescing concurrent FaaS requests.

The paper's throughput evaluation (§4.2) is bounded by per-invocation
overhead, not compute: ``Cluster.invoke`` pays a full Python round-trip and
a fresh device dispatch per request.  This engine coalesces concurrent
invocations of the same ``(function, node)`` pair into ONE batched call of
the deploy-time batched handler (``faas.compile_batched_handler``): a masked
sequential fold runs the requests in order against the arena (read-only
handlers share the arena instead), so per-key last-writer-wins semantics,
version stamping, and the final vector clock match N sequential ``invoke``
calls exactly.  This module is the reference engine's host code, copied;
its device touch points are the staging copy (``_stage_chunk``, copied by
the batched handler into its graph's static buffers), the padding mask
(``_valid_mask``), ``prewarm`` (which captures every fold graph before
serving) and the output transfer.

The emulated network stays PER-REQUEST: each request keeps its own
``t_send``/arrival/response timeline, the same client→node link charges, and
the same per-op round-trip charges for remote placements — only the compute
dispatch is shared.

Three APIs:

* ``engine.dispatch(fn, node, xs, t_sends, ...)`` — explicit batch, results
  in request order (what ``Cluster.invoke_batch`` delegates to);
* ``engine.submit(...)`` / ``engine.flush()`` — enqueue requests one at a
  time from independent callers; ``flush`` drains everything queued in ONE
  flush cycle and returns results keyed by ticket;
* ``engine.submit(...)`` / ``engine.pump(until_t)`` with ``window_ms`` set —
  the background-flusher model: each ``(function, node, client)`` group
  accumulates into an arrival-time WINDOW that closes ``window_ms`` of
  virtual time after its first request arrives (or immediately, when it
  fills to ``max_batch`` — full buckets flush early); ``pump(until_t)``
  drains every window whose deadline has passed.  A request therefore never
  waits past ``window_ms``, and requests flushed at the deadline are charged
  the wait (their ``t_applied`` anchors at the window close, the batched
  analogue of a real coalescing server's arrival-time batching).  A wall-
  clock driver plugs a virtual-time source with ``use_clock`` (``pump()``
  then advances to the clock's current instant) and sleeps until
  ``next_deadline()`` instead of polling — see ``launch/faas_server.py``.

A flush cycle dispatches its per-``(fn, node)`` groups as INDEPENDENT
PARALLEL TIMELINES (§4.3's multi-node picture):

* replication deliveries fold in up to a shared high-water mark per store
  node — the latest arrival any group of the cycle brings to that node —
  before any group executes, so groups never observe a half-delivered peer;
* writes of the cycle schedule ONE coalesced replication snapshot per
  written keygroup per store node (post-cycle contents, latest apply time),
  instead of one snapshot per group;
* groups of the same cycle do NOT see each other's same-cycle writes via
  replication (parallel timelines): cross-group visibility starts at the
  next cycle, exactly like concurrent batches on distinct real nodes;
* downstream calls coalesce ACROSS caller chunks: every caller chunk of the
  cycle that fires the same ``(callee, target node)`` from the same CALLER
  NODE contributes its requests to one merged batch per wave (callers on
  different nodes keep separate batches — they pay different hops), so a
  fan-in callee (fig 8) is dispatched once per caller node per cycle
  instead of once per caller function/chunk.

Batches are padded up to bucket sizes (default 1/8/64/256), a bounded set
of shapes; padded slots are masked out of the fold and oversize batches are
folded chunk-by-chunk at the largest bucket.

Failure contract (at-most-once): the queue (all windows for ``flush``, due
windows for ``pump``) is validated BEFORE anything dispatches — an
undeployed function/node raises KeyError with every window left intact.  If
a dispatch itself raises mid-cycle, the FAILING group is dropped, not
requeued — its store effects may already have committed; windows that never
started dispatching go back on the queue (serial pump; under the parallel
pump every group of the cycle has already started, so clean groups complete
and failing ones drop), and results of groups that completed cleanly are
retained and returned by the NEXT ``flush``/``pump``.
``discard(ticket)``/``pending()`` are the public queue-surgery API for
recovering from a poisoned request (see docs/batched_engine.md).

Concurrency (the per-frame dataflow scheduler): a flush cycle no longer
barriers per downstream wave.  Every unit of dispatch work — a top-level
window's group or a merged downstream batch — is sealed as a TASK with a
global seal sequence number and executed on its store node's LANE (the
per-store-node single-worker executors of ``use_workers(n)``).  The
readiness rule is per frame: a frame dispatches the moment (a) its input
batch is sealed and (b) its store node's prior fold has committed — lane
FIFO in seal order IS the fold clock, so a straggling store node delays
only the frames that fold into it while every other lane keeps flowing.
Downstream COMPOSITION stays wave-synchronized (which requests merge into
which batch is decided from all frames that can still fire a call — the
determinism contract: ``workers=4`` produces the identical ticket→result
map as ``workers=1``), but leaf frames — no ``calls``/``async_calls`` and
no ancestor that can still pop a callee — never gate composition: their
lanes stream to completion independently, and each top-level window's
results are handed to ``on_ready`` the moment its last frame finalizes
(mid-cycle incremental delivery; ``wave_barrier=True`` restores the old
everything-at-cycle-end behaviour for A/B comparison).  Replication
snapshots still coalesce in a serial merge after the last task commits.
Two engine locks keep ``submit`` (the client hot path) off the dispatch
path: ``_qlock`` guards the window queue/tickets/ready-results and is only
ever held for host-side bookkeeping; ``_cycle_lock`` serializes whole
flush cycles (device work runs under it, never under ``_qlock``).  The
lock hierarchy is ``repro_torch.analysis.lock_order``.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import math
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import (Any, Callable, Dict, List, Optional, Sequence, Set,
                    Tuple)

import numpy as np
import torch

from repro_torch.analysis import lockdep
from repro_torch.core.store import to_numpy
from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.device import synchronize

DEFAULT_BUCKETS = (1, 8, 64, 256)


@functools.lru_cache(maxsize=None)
def _valid_mask(bucket: int, n: int, device: torch.device) -> torch.Tensor:
    """Device-resident bucket-padding mask for ``n`` valid requests in a
    ``bucket``-sized chunk, cached process-wide per device: warm chunks
    stop allocating and transferring a fresh (bucket,) bool tensor per
    dispatch (the VALUES are a bounded set).  Read-only: the fold only
    indexes it."""
    return torch.from_numpy(np.arange(bucket) < n).to(device)


def _host_leaf(x) -> np.ndarray:
    return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


MAX_CALL_DEPTH = 32     # downstream-chain guard (cycles in calls/async_calls)
MIN_PARALLEL_REQUESTS = 64      # cycles smaller than this run inline even
                                # with workers set: executor handoff adds
                                # latency a small latency-sensitive cycle
                                # (a serving loop's) cannot amortize —
                                # measured on the reference host, cycles
                                # of ~32 requests lose to inline; the
                                # win shows from ~hundreds of requests
                                # per cycle across >=2 store nodes


@dataclasses.dataclass(eq=False)        # identity semantics: ps hold arrays
class _Pending:
    ticket: int
    fn: str
    node: str
    x: Any
    t_send: float
    t_arrive: float
    client: str
    payload_bytes: int
    # reroute accounting is per-request-TERMINAL: however many times this
    # request moves off dead nodes (eviction sweeps, dispatch-time liveness
    # rechecks), it bumps ``stats.reroutes`` at most once
    rerouted: bool = False


@dataclasses.dataclass(eq=False)        # identity semantics for in/remove
class _Window:
    """One open arrival-time window of a (fn, node, client, payload) group."""
    key: Tuple[str, str, str, int]
    deadline: float                 # inf when window_ms is None
    ps: List[_Pending] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Cycle:
    """Per-flush-cycle shared state (parallel-timeline bookkeeping).

    ``hwm`` is written only by the serial collect stage and read by the
    (possibly parallel) exec stage; ``repl`` is written by concurrent group
    executions, so its updates go through ``lock`` — the merged value is a
    max, so the outcome is order-independent."""
    hwm: Dict[str, float] = dataclasses.field(default_factory=dict)
    # (kg, store_node) -> latest apply time of a write this cycle
    repl: Dict[Tuple[str, str], float] = dataclasses.field(default_factory=dict)
    lock: threading.Lock = dataclasses.field(
        default_factory=lambda: lockdep.make_lock("engine.cycle_state_lock"),
        repr=False)


@dataclasses.dataclass
class _Frame:
    """One dispatched chunk-batch inside a cycle, plus its downstream state.

    ``chains``/``t_downs`` mutate as subframes finalize; ``results`` is set
    once the frame itself finalizes (todo drained, no outstanding slots).
    """
    fn: str
    node: str
    client: str
    payload_bytes: int
    depth: int
    t_sends: List[float]
    hop_ms: float
    outputs: List[Any]
    t_applieds: List[float]
    chains: List[List[str]]
    t_downs: List[float]
    ops: List[Tuple[str, int]]
    todo: List[Tuple[str, bool]]                    # remaining (callee, async)
    fires: List[bool]                               # sync-downstream gate
    parents: List[Optional[Tuple["_Frame", int, bool]]]
    outstanding: int = 0
    results: Optional[List[Any]] = None

    @property
    def n(self) -> int:
        return len(self.t_sends)


@dataclasses.dataclass(eq=False)
class _Task:
    """One sealed unit of dispatch work on a store-key lane: a top-level
    window's group, or one merged downstream batch.  ``seq`` is the global
    seal sequence — every lane executes its tasks in ``seq`` order (the
    lane executors are single-worker, so submission order is FIFO), which
    is the per-frame readiness rule's fold clock: a task runs only after
    its store node's prior fold committed.  ``relevant`` marks tasks whose
    frames can still change downstream COMPOSITION (they have callees to
    pop, or an ancestor does) — only those gate the next wave's batch
    merge; leaf tasks stream to completion independently."""
    seq: int
    store_key: str
    args: tuple                     # _exec_group(*args)
    window: Optional[_Window]       # top-level origin (None for downstream)
    relevant: bool
    frames: Optional[List[_Frame]] = None
    error: Optional[BaseException] = None


@dataclasses.dataclass
class AtomicStats:
    """Base for stats dataclasses whose counters are bumped from multiple
    threads (parallel pump workers, client submit threads, the serving
    loop).  ``inc`` is the one mutation path — a plain ``+=`` is a
    read-modify-write race under the executor pump and silently loses
    counts (``lockcheck`` flags raw increments).  The lock is a leaf in
    ``repro.analysis.lock_order``: nothing else is ever acquired while
    holding it."""
    _lock: threading.Lock = dataclasses.field(
        default_factory=lambda: lockdep.make_lock("stats.lock"),
        repr=False, compare=False)

    def inc(self, name: str, n: int = 1) -> int:
        with self._lock:
            v = getattr(self, name) + n
            setattr(self, name, v)
            return v


@dataclasses.dataclass
class EngineStats(AtomicStats):
    submitted: int = 0
    cycles: int = 0
    windows_flushed: int = 0
    requests_flushed: int = 0
    auto_flushes: int = 0           # windows that filled to max_batch
    deadline_flushes: int = 0       # windows drained by pump at their deadline
    dispatches: int = 0             # device-level chunk dispatches (all waves)
    downstream_coalesced: int = 0   # downstream requests that rode a batch
                                    # merged across >1 caller frame
    replication_coalesced: int = 0  # per-group snapshots saved by cycle
                                    # coalescing
    reroutes: int = 0               # requests moved off a dead node to a
                                    # surviving deployment (queued windows
                                    # at eviction + frames at dispatch);
                                    # counted at most ONCE per request, no
                                    # matter how many times it moves
    dropped_dead: int = 0           # requests dropped because NO live
                                    # deployment remained (fail-fast under
                                    # the at-most-once contract)


class _NodePool:
    """The parallel pump's executor pool: ONE single-worker executor per
    store node, shared across cycles.  Same-store-node groups land on the
    same worker in submission order, so every per-store fold keeps the
    exact order the serial pump would use — which is what makes the
    parallel pump's ticket→result map identical to the serial one.  At
    most ``workers`` distinct executors exist; store nodes beyond that
    share them round-robin by first touch (deterministic given the
    engine's deterministic submission order)."""

    def __init__(self, workers: int):
        self.workers = max(1, int(workers))
        self._execs: List[ThreadPoolExecutor] = []
        self._slot: Dict[str, int] = {}
        self._lock = lockdep.make_lock("engine.pool_lock")

    def submit(self, node: str, fn, *args):
        with self._lock:
            i = self._slot.get(node)
            if i is None:
                i = self._slot[node] = len(self._slot) % self.workers
            if i >= len(self._execs):
                self._execs.append(ThreadPoolExecutor(
                    max_workers=1,
                    thread_name_prefix=f"engine-pump-{i}"))
            ex = self._execs[i]
        return ex.submit(fn, *args)

    def shutdown(self) -> None:
        with self._lock:
            execs, self._execs = self._execs, []
            self._slot.clear()
        for ex in execs:
            ex.shutdown(wait=True)


class BatchedInvocationEngine:
    def __init__(self, cluster, bucket_sizes: Sequence[int] = DEFAULT_BUCKETS,
                 window_ms: Optional[float] = None,
                 max_batch: Optional[int] = None,
                 clock: Optional[Callable[[], float]] = None,
                 workers: Optional[int] = None):
        self.cluster = cluster
        self.buckets = tuple(sorted(set(int(b) for b in bucket_sizes)))
        self.window_ms = window_ms
        self.max_batch = max_batch
        self.clock = clock
        self.workers = workers
        self.stats = EngineStats()
        self._windows: List[_Window] = []
        self._tickets = 0
        # results awaiting pickup: auto-flushed windows, plus groups that
        # dispatched cleanly before a later group raised mid-cycle
        self._ready: Dict[int, Any] = {}
        # the network model is static, so the client->node hop of a
        # (client, node, payload) triple is a constant: cache it (submit is
        # the per-request hot path of the background flusher)
        self._hops: Dict[Tuple[str, str, int], float] = {}
        # lock order: declared in repro_torch/analysis/lock_order.py.  _qlock
        # guards the queue state (_windows/_tickets/_ready) and is never
        # held across a dispatch; _cycle_lock serializes flush cycles
        # (all device dispatches) and nests _qlock/node locks inside it
        self._qlock = lockdep.make_rlock("engine.qlock")
        self._cycle_lock = lockdep.make_rlock("engine.cycle_lock")
        self._pool: Optional[_NodePool] = None
        # persistent host staging buffers for chunk stacking, keyed
        # (bucket, leaf index, leaf shape, dtype) and THREAD-LOCAL: the
        # parallel pump's lanes never share one, and a buffer is free for
        # reuse the moment its chunk dispatched (the batched handler copies
        # host memory into its fold graph's static device buffers).  Warm
        # cycles therefore make zero fresh staging allocations
        self._staging = threading.local()
        # cycles below this many requests run inline even with workers
        # set (handoff latency vs throughput trade); tests override it to
        # force the pool path on small streams
        self.min_parallel_requests = MIN_PARALLEL_REQUESTS
        # incremental delivery hook: called from the cycle coordinator (the
        # pump caller's thread, under _cycle_lock) with {ticket: result}
        # the moment a top-level window's last frame finalizes — delivered
        # tickets are EXCLUDED from the pump/flush return.  None keeps the
        # classic collect-everything-then-return behaviour.  The callback
        # may take locks BELOW _cycle_lock in the documented hierarchy
        # (router lock, server cond) but must never re-enter the engine's
        # flush path
        self.on_ready: Optional[Callable[[Dict[int, Any]], None]] = None
        # compat knob for A/B benchmarks: True restores the old wave
        # barrier's observable timing — every composition waits on every
        # task of the prior wave and nothing is delivered before the
        # cycle's end (values are identical either way)
        self.wave_barrier = False
        # debug/property-test hook: record (store_key, seal_seq) at the
        # moment each task starts executing, so tests can assert that
        # dispatch order respects per-store-node fold (seal) order
        self.trace_folds = False
        self.fold_trace: List[Tuple[str, int]] = []
        self._trace_lock = lockdep.make_lock("engine.trace_lock")

    def _hop_ms(self, client: str, node: str, payload_bytes: int) -> float:
        key = (client, node, payload_bytes)
        hop = self._hops.get(key)
        if hop is None:
            link = self.cluster.net.link(client, node)
            hop = (self.cluster.net.one_way_ms(client, node)
                   + link.transfer_ms(payload_bytes))
            self._hops[key] = hop
        return hop

    def configure(self, window_ms: Optional[float] = None,
                  max_batch: Optional[int] = None) -> "BatchedInvocationEngine":
        """Set the background-flusher knobs (chainable).  ``window_ms`` is
        the arrival-time window in virtual ms; ``max_batch`` caps a window
        and triggers flush-on-full."""
        if window_ms is not None and window_ms < 0:
            raise ValueError("window_ms must be >= 0")
        if max_batch is not None and max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.window_ms = window_ms
        self.max_batch = max_batch
        return self

    # ---------------------------------------------------------------- workers
    def use_workers(self, workers: Optional[int]) -> "BatchedInvocationEngine":
        """Set the parallel-pump width (chainable).  ``workers`` caps the
        number of per-store-node executors a flush cycle's exec stage may
        use; ``None``/``1`` keeps the serial in-line pump.  Changing the
        width never changes results (the determinism contract) — only how
        many independent store nodes dispatch concurrently."""
        if workers is not None and workers < 1:
            raise ValueError("workers must be >= 1")
        # _cycle_lock first: a flush cycle mid-dispatch on another thread
        # must never have its pool shut down under it
        with self._cycle_lock:
            stale = None
            with self._qlock:
                if (self._pool is not None
                        and (workers or 1) != self._pool.workers):
                    stale, self._pool = self._pool, None
                self.workers = workers
            if stale is not None:
                # pool workers never take engine locks, so the join cannot
                # deadlock; holding the cycle lock is the point (no cycle
                # mid-dispatch may have its pool yanked)
                stale.shutdown()    # lockcheck: ok[blocking-under-lock]
        return self

    def _get_pool(self) -> Optional[_NodePool]:
        """The shared executor pool, or None for the serial pump."""
        if self.workers is None or self.workers <= 1:
            return None
        with self._qlock:
            if self._pool is None:
                self._pool = _NodePool(self.workers)
            return self._pool

    def close(self) -> None:
        """Release the executor pool's threads (idempotent).  Queued
        windows and ready results survive — only the workers go away; the
        next parallel cycle would lazily rebuild them.  Waits for any
        cycle in flight (cycle lock) rather than yanking its pool."""
        with self._cycle_lock:
            with self._qlock:
                pool, self._pool = self._pool, None
            if pool is not None:
                # same contract as use_workers: workers take no engine locks
                pool.shutdown()     # lockcheck: ok[blocking-under-lock]

    # ------------------------------------------------------------------ clock
    def use_clock(self, clock: Optional[Callable[[], float]]
                  ) -> "BatchedInvocationEngine":
        """Plug a virtual-time source (a zero-arg callable returning ms).
        With a clock set, ``pump()`` with no argument advances to the
        clock's *current* time instead of infinity — the hook a wall-clock
        serving loop uses to map real time onto the virtual timeline."""
        self.clock = clock
        return self

    def now(self) -> float:
        """Current virtual time per the plugged clock.  Without one it is
        ``+inf`` — the single convention ``pump()`` (and ``Router.pump``)
        resolve an omitted ``until_t`` through: an unclocked pump drains
        everything, the pre-clock behaviour."""
        return self.clock() if self.clock is not None else math.inf

    def next_deadline(self) -> Optional[float]:
        """Earliest finite window deadline still queued, or ``None`` when no
        timed window is open.  A serving driver sleeps exactly until this
        instant instead of polling ``pump``; a new ``submit`` can only move
        the horizon EARLIER (windows never extend), so the driver re-queries
        after every enqueue."""
        with self._qlock:
            deadlines = [w.deadline for w in self._windows
                         if math.isfinite(w.deadline)]
        return min(deadlines) if deadlines else None

    # ------------------------------------------------------------- coalescing
    def submit(self, fn: str, node: str, x, t_send: float = 0.0,
               client: str = "client", payload_bytes: int = 64) -> int:
        """Enqueue one invocation; returns a ticket redeemed by ``flush`` or
        ``pump``.  With ``window_ms`` set, the request joins its group's open
        window (or opens a new one closing ``window_ms`` after this
        request's arrival); a window that fills to ``max_batch`` dispatches
        immediately (flush-on-full) and its results await the next
        ``pump``/``flush``.  Thread-safe: queue surgery happens under the
        queue lock; a flush-on-full dispatch runs OUTSIDE it (under the
        cycle lock), so concurrent submits never wait on a dispatch."""
        self.stats.inc("submitted")
        t_arrive = t_send + self._hop_ms(client, node, payload_bytes)
        full = None
        with self._qlock:
            t = self._tickets
            self._tickets += 1
            p = _Pending(t, fn, node, x, t_send, t_arrive, client,
                         payload_bytes)
            key = (fn, node, client, payload_bytes)
            w = self._open_window(key, t_arrive)
            w.ps.append(p)
            if self.max_batch is not None and len(w.ps) >= self.max_batch:
                # full bucket flushes early: the batch executes when its
                # last member arrives, no deadline wait.  Validate BEFORE
                # taking the window off the queue so a KeyError really
                # does leave it intact
                self._validate([w])
                self._windows.remove(w)
                full = w
        if full is not None:
            self.stats.inc("auto_flushes")
            out = self._run_cycle([full], [None])
            with self._qlock:
                self._ready.update(out)
        return t

    def _open_window(self, key: Tuple, t_arrive: float) -> _Window:
        for w in self._windows:
            # joinable iff this request makes the close (t_arrive <=
            # deadline) AND the close is within window_ms of ITS arrival —
            # an out-of-order early request must not inherit a later
            # opener's deadline and wait past window_ms
            if (w.key == key and t_arrive <= w.deadline
                    and (self.window_ms is None
                         or w.deadline <= t_arrive + self.window_ms)
                    and (self.max_batch is None
                         or len(w.ps) < self.max_batch)):
                return w
        deadline = (math.inf if self.window_ms is None
                    else t_arrive + self.window_ms)
        w = _Window(key=key, deadline=deadline)
        self._windows.append(w)
        return w

    def hold_results(self, results: Dict[int, Any]) -> None:
        """Put already-redeemed results back for a later ``pump``/``flush``
        pickup.  Routers draining the shared engine use this to hand back
        tickets they do not own (another router's submissions)."""
        with self._qlock:
            self._ready.update(results)

    def pending(self) -> List[Dict[str, Any]]:
        """Read-only view of queued requests (public replacement for poking
        ``_queue``): one dict per request with ticket/fn/node/client/t_send
        and the window deadline it is waiting on."""
        out = []
        with self._qlock:
            for w in self._windows:
                for p in w.ps:
                    out.append({"ticket": p.ticket, "fn": p.fn,
                                "node": p.node, "client": p.client,
                                "t_send": p.t_send, "deadline": w.deadline})
        return out

    def discard(self, ticket: int) -> bool:
        """Drop a queued request (e.g. a poisoned one after a failed flush)
        without dispatching it.  Returns whether the ticket was queued."""
        with self._qlock:
            for w in self._windows:
                for p in w.ps:
                    if p.ticket == ticket:
                        w.ps.remove(p)
                        if not w.ps:
                            self._windows.remove(w)
                        return True
        return False

    def _evict_dead(self) -> Tuple[int, int]:
        """Sweep queued windows targeting non-ROUTABLE nodes — DEAD
        (health-driven removal or an injected crash) or SUSPECT (parked by
        a minority-view partition; replicas intact but no new work) — and
        convert each pending request into either a rerouted window at the
        nearest surviving deployment or a fail-fast drop when no live
        deployment remains.  Returns ``(rerouted, dropped)``.

        Called at the top of every ``pump``/``flush`` — before
        ``_validate`` — so a crashed node never hangs the serving thread:
        rerouted requests keep their tickets (they re-enter the window
        queue with a recomputed arrival at the new target and flush on a
        later turn), dropped tickets simply vanish from ``pending()``,
        which is exactly what ``Router._fold`` / ``FaasServer.reconcile``
        read to surface ``RequestLost``.  Only liveness triggers eviction;
        an undeployed function on a LIVE node still raises the usual
        ``_validate`` KeyError with the queue left intact."""
        c = self.cluster
        rerouted = dropped = fresh = 0
        with self._qlock:
            dead = [w for w in self._windows
                    if w.key[1] in c.nodes
                    and not c.naming.is_routable(w.key[1])]
            if not dead:
                return (0, 0)
            self._windows = [w for w in self._windows if w not in dead]
            for w in dead:
                for p in w.ps:
                    try:
                        alt = c._nearest_deployment(p.fn, p.client)
                    except KeyError:
                        dropped += 1        # no live deployment: fail fast
                        continue
                    p.node = alt
                    p.t_arrive = p.t_send + self._hop_ms(
                        p.client, alt, p.payload_bytes)
                    w2 = self._open_window(
                        (p.fn, alt, p.client, p.payload_bytes), p.t_arrive)
                    w2.ps.append(p)
                    rerouted += 1
                    if not p.rerouted:      # per-request-terminal ledger: a
                        p.rerouted = True   # request that keeps moving off
                        fresh += 1          # dying nodes counts ONCE
        if fresh:
            self.stats.inc("reroutes", fresh)
        if dropped:
            self.stats.inc("dropped_dead", dropped)
        return (rerouted, dropped)

    def _validate(self, windows: Sequence[_Window]) -> None:
        for w in windows:
            for p in w.ps:
                nd = self.cluster.nodes.get(p.node)
                if (p.fn not in self.cluster.specs or nd is None
                        or p.fn not in nd.batched_handlers):
                    raise KeyError(
                        f"cannot flush: function {p.fn!r} is not deployed at "
                        f"node {p.node!r} (queue left intact)")

    def flush(self) -> Dict[int, Any]:
        """Dispatch everything queued — deadlines ignored — as one flush
        cycle, and return ``{ticket: InvokeResult}`` (plus any results held
        over from auto-flushed windows or a previously failed cycle).

        Coalescing is per ``(fn, node, client)`` group: submission order is
        preserved WITHIN a group, and groups of the cycle run as parallel
        timelines (see module docstring) — requests of *different* functions
        sharing a keygroup may observe each other's writes in group order
        rather than submission order (the usual trade of a coalescing
        server).  Callers needing strict cross-function ordering should
        flush between submissions."""
        self._evict_dead()
        with self._qlock:
            self._validate(self._windows)
            windows, self._windows = self._windows, []
        cycle_out = (self._run_cycle(windows, [None] * len(windows))
                     if windows else {})
        # held-over results are only consumed on a clean cycle (a raising
        # cycle stashes its own partial results into _ready instead)
        with self._qlock:
            out = dict(self._ready)
            self._ready = {}
        out.update(cycle_out)
        return out

    def pump(self, until_t: Optional[float] = None) -> Dict[int, Any]:
        """Advance the background flusher to virtual time ``until_t``: every
        window whose deadline has passed dispatches, all due windows in ONE
        flush cycle.  Requests flushed here are charged the wait until their
        window's close.  Returns ``{ticket: InvokeResult}`` for everything
        that completed (including earlier flush-on-full results).

        With ``until_t`` omitted, a plugged clock (``use_clock``) supplies
        the current virtual time; without one, everything drains
        (``until_t = inf``, the pre-clock behaviour)."""
        if until_t is None:
            until_t = self.now()
        self._evict_dead()
        with self._qlock:
            due = [w for w in self._windows if w.deadline <= until_t]
            self._validate(due)     # raises with the queue left intact
            if due:
                self._windows = [w for w in self._windows if w not in due]
        cycle_out = {}
        if due:
            self.stats.inc("deadline_flushes", len(due))
            floors = [w.deadline if math.isfinite(w.deadline) else None
                      for w in due]
            cycle_out = self._run_cycle(due, floors)
        with self._qlock:
            out = dict(self._ready)
            self._ready = {}
        out.update(cycle_out)
        return out

    # --------------------------------------------------------------- dispatch
    def dispatch(self, fn_name: str, node: str, xs: Sequence,
                 t_sends: Optional[Sequence[float]] = None,
                 client: str = "client", payload_bytes: int = 64) -> List[Any]:
        """Invoke ``fn_name`` at ``node`` for every input in ``xs`` with one
        device dispatch per chunk.  Returns per-request InvokeResults in
        input order.  (One explicit batch == a single-window flush cycle.)"""
        n = len(xs)
        if t_sends is None:
            t_sends = [0.0] * n
        if len(t_sends) != n:
            raise ValueError(f"{n} inputs but {len(t_sends)} send times")
        # one ledger for every invocation path: dispatch counts its
        # requests as submitted so submitted == flushed + dropped holds
        # engine-wide (the stress test asserts the exact conservation)
        self.stats.inc("submitted", n)
        w = _Window(key=(fn_name, node, client, payload_bytes),
                    deadline=math.inf)
        hop = self._hop_ms(client, node, payload_bytes)
        for i, (x, t) in enumerate(zip(xs, t_sends)):
            w.ps.append(_Pending(i, fn_name, node, x, t, t + hop, client,
                                 payload_bytes))
        # deliver=False: the caller drains this cycle synchronously, so
        # results must come back here, not stream out through on_ready
        by_ticket = self._run_cycle([w], [None], deliver=False)
        return [by_ticket[i] for i in range(n)]

    # ------------------------------------------------------------ flush cycle
    def _store_key(self, fn: str, node: str) -> str:
        """The pipeline key of a group: the store node its kv ops hit (the
        serving node itself for stateless functions, which read that
        node's clock).  Groups with the same key share a pool worker so
        their store folds keep submission order."""
        kg, store_node, _ = self.cluster._resolve_placement(
            self.cluster.specs[fn], node)
        return store_node if kg is not None else node

    def _run_cycle(self, windows: Sequence[_Window],
                   floors: Sequence[Optional[float]],
                   deliver: bool = True) -> Dict[int, Any]:
        """Dispatch ``windows`` as one cycle of parallel per-(fn, node)
        timelines and return {ticket: InvokeResult} for everything NOT
        already streamed out through ``on_ready``.

        Three stages: (1) serial collect — per-store-node delivery
        high-water marks from every window of the cycle; (2) the dataflow
        scheduler (``_CycleRun``) — tasks sealed in a deterministic global
        sequence execute on per-store-node lanes, downstream batches are
        composed as their callers' frames resolve, and completed windows
        deliver the moment their last frame finalizes; (3) serial merge —
        coalesced replication snapshots are scheduled after the last task
        commits.  Cycles are serialized by ``_cycle_lock``; stage 2 is the
        only place device dispatches happen.  ``deliver=False`` keeps all
        results in the return value (the synchronous ``dispatch`` path)."""
        with self._cycle_lock:
            c = self.cluster
            self.stats.inc("cycles")
            cycle = _Cycle()
            # ---- stage 1 (serial): shared deliver high-water mark — the
            # latest arrival any group of this cycle brings to each store
            # node (the cycle executes once its last member has arrived)
            for w, floor in zip(windows, floors):
                fn, node, _, _ = w.key
                kg, store_node, _ = c._resolve_placement(c.specs[fn], node)
                if kg is None:
                    continue
                hi = max(max(p.t_arrive for p in w.ps), floor or -math.inf)
                cycle.hwm[store_node] = max(
                    cycle.hwm.get(store_node, -math.inf), hi)

            # ---- stage 2: the per-frame dataflow scheduler
            run = _CycleRun(self, cycle, deliver)
            out = run.run(windows, floors)

            # ---- stage 3 (serial merge): ONE coalesced replication
            # snapshot per written keygroup per node, with the post-cycle
            # contents at the latest apply time.  Sorted for a
            # deterministic event order regardless of which lane
            # finished first
            for (kg, store_node) in sorted(cycle.repl):
                c._schedule_replication(kg, store_node,
                                        cycle.repl[(kg, store_node)])

            if run.errors:
                with self._qlock:
                    self._ready.update(out)
                # the lowest-seal-sequence failure: window errors in window
                # order first, then the failing wave's earliest batch
                raise min(run.errors)[1]
            return out

    def _finalize_ready(self, frames: List[_Frame]) -> bool:
        """Finalize every frame with no remaining work, cascading upward
        (finalizing a subframe may unblock and finalize its parent).
        Returns whether anything finalized."""
        any_final = False
        progressed = True
        while progressed:
            progressed = False
            for f in frames:
                if f.results is None and not f.todo and f.outstanding == 0:
                    self._finalize(f)
                    progressed = any_final = True
        return any_final

    def _finalize(self, f: _Frame) -> None:
        from repro_torch.core.cluster import InvokeResult
        results = []
        for i in range(f.n):
            t_done = max(f.t_applieds[i], f.t_downs[i])
            t_received = t_done + f.hop_ms
            results.append(InvokeResult(
                output=f.outputs[i], response_ms=t_received - f.t_sends[i],
                t_sent=f.t_sends[i], t_received=t_received,
                t_applied=f.t_applieds[i], kv_ops=list(f.ops), node=f.node,
                chain=f.chains[i]))
        f.results = results
        for i, par in enumerate(f.parents):
            if par is None:
                continue
            pf, pi, is_async = par
            pf.chains[pi].extend(f.chains[i])
            if not is_async:
                pf.t_downs[pi] = results[i].t_received
            pf.outstanding -= 1

    # ----------------------------------------------------------- batch exec
    def _exec_group(self, fn_name: str, node: str, xs: Sequence,
                    t_sends: Sequence[float], client: str, payload_bytes: int,
                    floor: Optional[float], cycle: _Cycle, depth: int,
                    parents: Sequence,
                    pendings: Optional[Sequence[_Pending]] = None
                    ) -> List[_Frame]:
        cap = self.buckets[-1]
        frames = []
        for lo in range(0, len(xs), cap):
            frames.append(self._exec_chunk(
                fn_name, node, xs[lo:lo + cap], t_sends[lo:lo + cap], client,
                payload_bytes, floor, cycle, depth, parents[lo:lo + cap],
                pendings[lo:lo + cap] if pendings is not None else None))
        return frames

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return n  # chunking caps n at the largest bucket already

    def _stage_chunk(self, xs, bucket: int):
        """Stack per-request host inputs into PERSISTENT per-(bucket, leaf)
        staging buffers — the np.stack/np.concatenate of the old path
        allocated fresh host arrays on every chunk.  Buffers live in
        thread-local storage (the parallel pump's lanes never share one)
        and are safe to reuse the moment the chunk dispatched: the batched
        handler copies them (synchronously) into its fold graph's static
        device buffers, or into fresh tensors on the CPU, before this
        thread stages again.  Padded slots repeat the first row, exactly
        like the old path."""
        n = len(xs)
        leaves0, treedef = tree_flatten(xs[0])
        bufs = getattr(self._staging, "bufs", None)
        if bufs is None:
            bufs = self._staging.bufs = {}
        flat = [leaves0] + [tree_flatten(x)[0] for x in xs[1:]]
        out = []
        for j, leaf0 in enumerate(leaves0):
            a0 = _host_leaf(leaf0)
            key = (bucket, j, a0.shape, a0.dtype.str)
            buf = bufs.get(key)
            if buf is None:
                buf = bufs[key] = np.empty((bucket,) + a0.shape, a0.dtype)
            buf[0] = a0
            for i in range(1, n):
                buf[i] = _host_leaf(flat[i][j])
            if bucket > n:
                buf[n:] = buf[0]
            out.append(buf)
        return tree_unflatten(treedef, out)

    def prewarm(self, buckets: Optional[Sequence[int]] = None,
                merge_ks: Sequence[int] = (1, 2, 4, 8)) -> int:
        """Make every (bucket × keygroup-geometry) serving shape ready
        before serving, as the reference's prewarm compiles every jit
        entry: the fold graphs (``prepare_folds``), and the fused delivery
        merge once per REPLICATED keygroup per K in ``merge_ks`` into a
        zeroed accumulator: direct kernel launches, as at serve time (its
        snapshots are fresh clones every cycle, so no graph could be
        reused), which builds and loads the merge kernel.  Returns the
        number of warm-up executions issued (the reference's count).  Call
        after ``deploy`` and before serving; safe to call again after
        later deploys (a shape already captured is not captured again)."""
        from repro_torch.configs.base import ReplicationPolicy
        from repro_torch.core.store import merge_snapshots_fused

        c = self.cluster
        with self._cycle_lock:
            count = self.prepare_folds(buckets)
            for kg_name, kspec in c.policies.items():
                if kspec.policy != ReplicationPolicy.REPLICATED:
                    continue
                replicas = c.naming.replicas_of(kg_name)
                if not replicas:
                    continue
                node0 = next(iter(replicas))
                with c.nodes[node0].lock:
                    proto = c.nodes[node0].stores[kg_name]
                aligned = c._aligned.get(kg_name, False)
                for k in merge_ks:
                    acc = tree_map(torch.zeros_like, proto)
                    merge_snapshots_fused(acc, (proto,) * k, aligned=aligned)
                    synchronize(c.device)
                    count += 1
        return count

    def prepare_folds(self, buckets: Optional[Sequence[int]] = None,
                      stores_on: Optional[Set[str]] = None) -> int:
        """Make every deployed batched handler's fold entry per bucket
        against the arena it folds into now (with ``stores_on``, only the
        handlers whose arena lives on one of those nodes): on CUDA a graph
        capture (``bstep.prepare``; the capture's warm-up runs on a clone,
        so the live arena is never written), on the CPU one run on a
        clone.  A key already cached costs nothing, and the membership
        calls this for the nodes a transition puts new arenas on (a
        re-home, a top-up, a hand-off, a restore's catch-up), so the first
        requests that follow replay instead of capturing.  Returns the
        (handler × bucket) pairs visited."""
        c = self.cluster
        count = 0
        for node, nd in list(c.nodes.items()):
            with nd.lock:
                handlers = list(nd.batched_handlers.items())
            for fn, bh in handlers:
                example = getattr(bh, "example", None)
                if example is None:
                    continue    # test double without deploy metadata
                spec = c.specs[fn]
                kg, store_node, _ = c._resolve_placement(spec, node)
                if stores_on is not None and store_node not in stores_on:
                    continue
                for b in (buckets or self.buckets):
                    xs = self._stage_chunk([example] * b, b)
                    valid = _valid_mask(b, b, c.device)
                    if kg is not None:
                        snd = c.nodes[store_node]
                        with snd.lock:
                            bh.prepare(snd.stores[kg], snd.clock, xs,
                                       valid, independent=False)
                    else:
                        bh.prepare(c.scratch_arena(spec), nd.clock, xs,
                                   valid, independent=True)
                    synchronize(c.device)
                    count += 1
        return count

    def _exec_chunk(self, fn_name: str, node: str, xs, t_sends, client: str,
                    payload_bytes: int, floor: Optional[float], cycle: _Cycle,
                    depth: int, parents,
                    pendings: Optional[Sequence[_Pending]] = None) -> _Frame:
        """Run the main batched dispatch of one chunk (store effects +
        per-request timeline); downstream routing is the cycle driver's job."""
        from repro_torch.core.cluster import fires_sync_downstream

        if depth > MAX_CALL_DEPTH:
            raise RecursionError(
                f"downstream call chain exceeded {MAX_CALL_DEPTH} levels at "
                f"{fn_name!r} — cycle in calls/async_calls?")
        c = self.cluster
        spec = c.specs[fn_name]
        n = len(xs)
        if node in c.nodes and not c.naming.is_routable(node):
            # the target died (or went SUSPECT) between collection and
            # dispatch (a pool job racing an injected crash): convert to a
            # rerouted frame at the nearest surviving deployment — nothing
            # of this chunk has committed yet, so retrying elsewhere keeps
            # at-most-once.  No
            # survivor -> KeyError, and the group drops under the cycle's
            # normal failure path (tickets vanish; the server fails them
            # fast as RequestLost)
            node = c._nearest_deployment(fn_name, client)
            if pendings is None:        # downstream frames have no ticket:
                self.stats.inc("reroutes", n)   # single-shot, count as-is
            else:
                # top-level requests carry the per-request-terminal flag: a
                # request already counted by an eviction sweep does not
                # count again when its NEW target also dies before dispatch
                fresh = [p for p in pendings if not p.rerouted]
                for p in fresh:
                    p.rerouted = True
                if fresh:
                    self.stats.inc("reroutes", len(fresh))
        nd = c.nodes[node]
        bhandler = nd.batched_handlers[fn_name]
        self.stats.inc("dispatches")

        hop_ms = self._hop_ms(client, node, payload_bytes)
        t_arrives = [t + hop_ms for t in t_sends]
        if floor is not None:
            # the window closed at ``floor``: early arrivals waited for it
            t_arrives = [max(t, floor) for t in t_arrives]

        kg, store_node, per_op_ms = c._resolve_placement(spec, node)
        if kg is not None:
            # fold deliveries up to the cycle's shared high-water mark for
            # this store node (never below this chunk's own last arrival)
            hw = max(max(t_arrives), cycle.hwm.get(store_node, -math.inf))
            c._deliver_until(store_node, hw)
            snd = c.nodes[store_node]
        else:
            snd = None

        # pad to the bucket and run the one batched call (host-side numpy
        # staging; the handler copies each leaf ONCE into its fold graph's
        # static device buffers).  Stacking is per pytree leaf so tuple/
        # dict handler inputs keep their structure, exactly as with invoke;
        # the staging buffers and the padding mask are persistent (see
        # _stage_chunk/_valid_mask) so a warm chunk allocates nothing fresh
        # on the host
        bucket = self._bucket(n)
        xs_host = self._stage_chunk(xs, bucket)
        valid = _valid_mask(bucket, n, c.device)

        if kg is not None:
            # hold the STORE node's lock across read-dispatch-write so the
            # fold is atomic against any other toucher of this store
            # (per-node pool workers already serialize engine work; the
            # lock also covers a sequential ``invoke`` racing the pump).
            # The handler's ys and clock are copies out of its graph, made
            # before it returns, so no later replay can overwrite them
            with snd.lock:
                store, clock = snd.stores[kg], snd.clock
                new_store, new_clock, ys, ops = bhandler(
                    store, clock, xs_host, valid, independent=False)
                snd.stores[kg] = new_store
                snd.clock = new_clock
        else:
            new_store, new_clock, ys, ops = bhandler(
                c.scratch_arena(spec), nd.clock, xs_host, valid,
                independent=True)

        # per-request timeline: identical charges to Cluster.invoke
        compute = nd.compute_ms.get(fn_name, 0.0)
        op_net = c._op_network_ms(node, store_node, per_op_ms, ops)
        t_applieds = [t + compute + op_net for t in t_arrives]

        wrote = any(k in ("set", "delete") for k, _ in ops)
        if kg is not None and wrote:
            # defer to the cycle: ONE coalesced snapshot per (kg, node).
            # The stats bump moves OUTSIDE cycle.lock: it takes the stats
            # lock, and cycle.lock is a leaf in LOCK_ORDER (the checkers
            # flag lock acquisition under a leaf)
            rkey = (kg, store_node)
            with cycle.lock:
                coalesced = rkey in cycle.repl
                cycle.repl[rkey] = max(cycle.repl.get(rkey, -math.inf),
                                       max(t_applieds))
            if coalesced:
                self.stats.inc("replication_coalesced")

        # one transfer per output leaf for the whole batch, then host-side
        # numpy row views (InvokeResult.output is a host array, as in the
        # reference)
        ys_host = tree_map(to_numpy, ys)
        outputs = [tree_map(lambda a: a[i], ys_host) for i in range(n)]
        fires = ([fires_sync_downstream(y) for y in outputs]
                 if spec.calls else [True] * n)
        todo = ([(cal, False) for cal in spec.calls]
                + [(cal, True) for cal in spec.async_calls])
        return _Frame(
            fn=fn_name, node=node, client=client, payload_bytes=payload_bytes,
            depth=depth, t_sends=list(t_sends), hop_ms=hop_ms,
            outputs=outputs, t_applieds=t_applieds,
            chains=[[fn_name] for _ in range(n)], t_downs=list(t_applieds),
            ops=list(ops), todo=todo, fires=fires, parents=list(parents))


class _CycleRun:    # lockcheck: single-threaded — counters below are
    # coordinator-thread-only: _seal/_process/_drop_fifo all run on the
    # pump caller's thread (workers only _execute and enqueue to done_q)
    """One flush cycle's dataflow scheduler, driven by the pump caller's
    thread under the engine's cycle lock (the coordinator).

    Execution is PER-FRAME: every task (a top-level window group or a
    merged downstream batch) is sealed with a global sequence number and
    handed to its store node's lane — a single-worker executor, so lane
    order IS seal order, which is the fold-clock half of the readiness
    rule (a frame dispatches once its store node's prior fold committed).
    Composition stays deterministic: the next wave of downstream batches
    is merged only once every COMPOSITION-RELEVANT task has committed —
    one whose frames (or their ancestors) can still pop a callee.  Leaf
    tasks never gate composition, so a straggling store node delays only
    the frames that fold into it; completed top-level windows deliver the
    moment their last frame finalizes (``engine.on_ready``).

    Serial mode (no pool / one store key / cycle under
    ``min_parallel_requests``) runs the same seal sequence from a deque on
    the coordinator itself — identical values, no handoff latency."""

    def __init__(self, eng: "BatchedInvocationEngine", cycle: _Cycle,
                 deliver: bool):
        self.eng = eng
        self.cycle = cycle
        self.deliver = deliver
        self.pool: Optional[_NodePool] = None
        self.fifo: "collections.deque[_Task]" = collections.deque()
        self.done_q: "queue.SimpleQueue[_Task]" = queue.SimpleQueue()
        self.next_seq = 0
        self.inflight = 0               # sealed, not yet processed
        self.pending_relevant = 0       # composition-relevant in flight
        self.frames_by_seq: Dict[int, List[_Frame]] = {}
        self.tops: List[_Task] = []     # completed-but-undelivered windows
        self.errors: List[Tuple[int, BaseException]] = []
        self.aborted = False            # downstream failure: stop composing
        self.out: Dict[int, Any] = {}   # undelivered {ticket: result}

    # -------------------------------------------------------------- main loop
    def run(self, windows: Sequence[_Window],
            floors: Sequence[Optional[float]]) -> Dict[int, Any]:
        eng = self.eng
        c = eng.cluster
        keys = [eng._store_key(w.key[0], w.key[1]) for w in windows]
        total = sum(len(w.ps) for w in windows)
        pool = eng._get_pool()
        # one mode per cycle: lanes would race an inline dispatch on the
        # same store, so either every task rides the pool or none does
        if (pool is not None and len(set(keys)) > 1
                and total >= eng.min_parallel_requests):
            self.pool = pool
        for w, floor, key in zip(windows, floors, keys):
            fn, node, client, payload = w.key
            spec = c.specs[fn]
            args = (fn, node, [p.x for p in w.ps], [p.t_send for p in w.ps],
                    client, payload, floor, self.cycle, 0,
                    [None] * len(w.ps), list(w.ps))
            self._seal(args, key, window=w,
                       relevant=bool(eng.wave_barrier or spec.calls
                                     or spec.async_calls))
        while True:
            self._drain_completed()
            if self.pending_relevant or self.fifo:
                self._wait_one()
                continue
            if self.aborted:
                break
            try:
                reqs = self._compose()
            except Exception as e:      # no live deployment of a callee
                self.errors.append((self.next_seq, e))
                break
            if not reqs:
                break
            self._seal_wave(reqs)
        # every composition is done: drain the remaining leaf lanes —
        # each window still delivers the moment its lane commits
        while self.inflight:
            self._wait_one()
        self._finalize_and_deliver()
        if not self.errors:
            stuck = [f for f in self._frames() if f.results is None]
            if stuck:
                raise RuntimeError(
                    f"flush cycle deadlocked with {len(stuck)} unfinalized "
                    f"frames (first: {stuck[0].fn!r}) — engine invariant bug")
        return self.out

    # ------------------------------------------------------------ lane plumbing
    def _seal(self, args: tuple, store_key: str, window: Optional[_Window],
              relevant: bool) -> _Task:
        t = _Task(seq=self.next_seq, store_key=store_key, args=args,
                  window=window, relevant=relevant)
        self.next_seq += 1
        self.inflight += 1
        if relevant:
            self.pending_relevant += 1
        if self.pool is None:
            self.fifo.append(t)
        else:
            self.pool.submit(store_key, self._pool_body, t)
        return t

    def _execute(self, t: _Task) -> None:
        eng = self.eng
        if eng.trace_folds:
            with eng._trace_lock:
                eng.fold_trace.append((t.store_key, t.seq))
        try:
            t.frames = eng._exec_group(*t.args)
        except Exception as e:      # recorded, not raised: the lane's later
            t.error = e             # tasks still run (at-most-once)

    def _pool_body(self, t: _Task) -> None:
        self._execute(t)
        self.done_q.put(t)

    def _drain_completed(self) -> None:
        if self.pool is None:
            return
        while True:
            try:
                t = self.done_q.get_nowait()
            except queue.Empty:
                return
            self._process(t)

    def _wait_one(self) -> None:
        if self.pool is None:
            t = self.fifo.popleft()
            self._execute(t)
        else:
            t = self.done_q.get()
        self._process(t)

    def _drop_fifo(self) -> List[_Task]:
        dropped = []
        while self.fifo:
            s = self.fifo.popleft()
            self.inflight -= 1
            if s.relevant:
                self.pending_relevant -= 1
            dropped.append(s)
        return dropped

    def _process(self, t: _Task) -> None:
        self.inflight -= 1
        if t.relevant:
            self.pending_relevant -= 1
        if t.error is not None:
            self.errors.append((t.seq, t.error))
            if t.window is None:
                # a downstream batch failed: no further wave composes (the
                # wave loop always aborted here); serially, the unexecuted
                # rest of the wave is dropped outright
                self.aborted = True
                if self.pool is None:
                    self._drop_fifo()
            elif self.pool is None:
                # serial top-level contract: windows that never started
                # dispatching go back on the queue intact
                requeue = self._drop_fifo()
                if requeue:
                    with self.eng._qlock:
                        self.eng._windows.extend(s.window for s in requeue)
            return
        self.frames_by_seq[t.seq] = t.frames
        if t.window is not None:
            self.tops.append(t)
        self._finalize_and_deliver()

    # --------------------------------------------------------------- finalize
    def _frames(self) -> List[_Frame]:
        """Every committed frame in seal order — the deterministic
        iteration order composition (and its fold order) hangs on."""
        out: List[_Frame] = []
        for seq in sorted(self.frames_by_seq):
            out.extend(self.frames_by_seq[seq])
        return out

    def _finalize_and_deliver(self) -> None:
        self.eng._finalize_ready(self._frames())
        self._deliver_tops()

    def _deliver_tops(self) -> None:
        for t in [t for t in self.tops
                  if all(f.results is not None for f in t.frames)]:
            self.tops.remove(t)
            self._deliver_window(t)

    def _deliver_window(self, t: _Task) -> None:
        eng = self.eng
        w = t.window
        rs: List[Any] = []
        for f in t.frames:
            rs.extend(f.results)
        eng.stats.inc("windows_flushed")
        eng.stats.inc("requests_flushed", len(w.ps))
        res = {p.ticket: r for p, r in zip(w.ps, rs)}
        cb = eng.on_ready
        if self.deliver and cb is not None and not eng.wave_barrier:
            try:
                cb(res)
                return          # streamed out: not in the cycle's return
            except Exception:
                pass            # a broken callback must not lose results:
                                # fall back to the classic return path
        self.out.update(res)

    # ------------------------------------------------------------ composition
    def _compose(self) -> Optional[Dict[Tuple, List]]:
        """Merge the next wave's downstream batches: fire the next callee
        of each unblocked frame, coalescing same-(callee, target, caller
        node, payload) requests across caller frames.  Returns ``None``
        when nothing can move any more (the cycle's chains are done)."""
        eng = self.eng
        c = eng.cluster
        frames = self._frames()
        while True:
            finalized = eng._finalize_ready(frames)
            if finalized:
                self._deliver_tops()
            reqs: Dict[Tuple, List[Tuple[Any, float, Tuple]]] = {}
            popped = False
            for f in frames:
                if f.results is not None or f.outstanding:
                    continue
                while f.todo:
                    callee, is_async = f.todo[0]
                    idxs = (list(range(f.n)) if is_async
                            else [i for i in range(f.n) if f.fires[i]])
                    if not idxs:
                        f.todo.pop(0)       # nobody fires: skip this callee
                        popped = True
                        continue
                    f.todo.pop(0)
                    popped = True
                    target = c._nearest_deployment(callee, f.node)
                    lst = reqs.setdefault(
                        (callee, target, f.node, f.payload_bytes), [])
                    for i in idxs:
                        lst.append((f.outputs[i], f.t_downs[i],
                                    (f, i, is_async)))
                    f.outstanding = len(idxs)
                    break                   # one callee per frame per wave
            if reqs:
                return reqs
            # no fires this pass: a frame may still have drained its todo
            # by skipping (all callees filtered) — loop once more so the
            # finalize pass picks it up; quiesce when nothing moves
            if not finalized and not popped:
                return None

    def _seal_wave(self, reqs: Dict[Tuple, List]) -> None:
        eng = self.eng
        c = eng.cluster
        for (callee, target, caller, payload), lst in reqs.items():
            callers = {id(slot[0]) for _, _, slot in lst}
            if len(callers) > 1:
                eng.stats.inc("downstream_coalesced", len(lst))
            depth = 1 + max(slot[0].depth for _, _, slot in lst)
            spec = c.specs[callee]
            relevant = bool(
                eng.wave_barrier or spec.calls or spec.async_calls
                or any(self._chain_may_pop(slot[0]) for _, _, slot in lst))
            args = (callee, target, [x for x, _, _ in lst],
                    [t for _, t, _ in lst], caller, payload, None,
                    self.cycle, depth, [slot for _, _, slot in lst])
            self._seal(args, eng._store_key(callee, target), window=None,
                       relevant=relevant)

    @staticmethod
    def _chain_may_pop(f: _Frame) -> bool:
        """Whether finalizing a new child of ``f`` could still change
        downstream composition: some frame on the ancestor chain has a
        callee left to pop.  When nothing up the chain can pop, the child
        batch is a pure leaf — its lane streams to completion without
        gating the next wave (the straggler-independence rule)."""
        seen = set()
        stack: List[_Frame] = [f]
        while stack:
            g = stack.pop()
            if id(g) in seen:
                continue
            seen.add(id(g))
            if g.todo:
                return True
            for par in g.parents:
                if par is not None:
                    stack.append(par[0])
        return False
