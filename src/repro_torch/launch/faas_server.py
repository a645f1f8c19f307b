"""Wall-clock serving loop: host the batched invocation engine as a server.

Everything below ``launch/`` up to now drives the engine in VIRTUAL time —
explicit ``pump(until_t)`` calls.  ``FaasServer`` closes the loop for real
deployments: client threads (or asyncio tasks) ``submit`` requests whose
send instants are taken from a wall clock, a single serving thread maps
that wall clock onto the engine's virtual timeline (``engine.use_clock``),
and instead of polling it sleeps EXACTLY until the next scheduled instant —
``router.next_deadline()``, the earlier of the engine's next window close
and the next windowed-hedge fire time.  A new submission can only move
that horizon earlier, so the condition variable doubles as the wakeup: a
submit notifies the loop, the loop re-queries, and the sleep re-arms.

Timeline mapping: virtual time (ms) = wall time since ``start()`` ×
``time_scale``.  ``time_scale=1`` serves in real time; larger values
compress the emulated network's milliseconds for tests and benchmarks
(a 5 ms window at ``time_scale=100`` closes after 50 µs of wall time).

Concurrency model (PR 4: the concurrent dispatch pipeline): the server no
longer serializes every engine touch under one global lock.  The engine
and router carry their own synchronization — a queue lock for submit-side
bookkeeping, a cycle lock serializing dispatches, per-store-node locks in
the cluster — so a client ``submit`` never waits for a pump's device dispatch
in flight, and with ``workers`` > 1 the engine executes a cycle's
independent per-store-node groups concurrently.  The server keeps ONLY a
condition variable: it guards the future table and deadline wake-ups.
Because a submitted ticket can complete (via a racing pump) before its
future is registered, the loop parks such results in an orphan buffer and
``submit`` claims them at registration time — no result is ever dropped.

Two client front-ends share one server:

* threads — ``submit`` returns a ``ServedRequest`` (a stdlib future);
* asyncio — ``async_submit`` returns an awaitable resolving on the same
  serving loop, so ONE process hosts many logical clients without a
  thread per client (``serve_open_loop_async``/``serve_closed_loop_async``
  are the matching drivers).

    cluster.deploy(...)
    with FaasServer(cluster, window_ms=8.0, hedge_after_ms=4.0,
                    time_scale=50.0, workers=4) as srv:
        futs = [srv.submit("fn", x, session_id="s") for x in xs]
        outs = [f.result(timeout=5.0) for f in futs]

This module is the reference server with its imports rewired: it touches no
device itself.  ``membership`` stays duck-typed (any object with ``poll()``
returning the nodes it crashed).
"""
from __future__ import annotations

import asyncio
import dataclasses
import math
import threading
import time
from concurrent import futures
from typing import Any, Dict, List, Optional

from repro_torch.analysis import lockdep
from repro_torch.core.cluster import Cluster, InvokeResult
from repro_torch.core.engine import AtomicStats
from repro_torch.core.router import Router


class RequestLost(RuntimeError):
    """The request's ticket can no longer complete (dropped by a failed
    flush cycle or discarded) — at-most-once, the client should re-submit."""


class ServedRequest(futures.Future):
    """Future for one submitted request (resolved by the serving loop):
    a stdlib ``concurrent.futures.Future`` carrying the ticket and the
    request's virtual send instant."""

    def __init__(self, ticket: int, fn: str, t_send: float):
        super().__init__()
        self.ticket = ticket
        self.fn = fn
        self.t_send = t_send            # virtual send instant (ms)


@dataclasses.dataclass
class ServerStats(AtomicStats):
    submitted: int = 0
    served: int = 0
    lost: int = 0                   # futures failed (at-most-once drops)
    pumps: int = 0                  # pump passes that delivered results
    wakeups: int = 0                # loop iterations (submits + deadlines)
    cycle_errors: int = 0           # exceptions a flush cycle raised
    nodes_crashed: int = 0          # membership polls that took a node dark


class FaasServer:
    """Wall-clock host for ``BatchedInvocationEngine`` (thread or asyncio
    clients; one serving thread; optional parallel pump via ``workers``)."""

    def __init__(self, cluster: Cluster, window_ms: float = 8.0,
                 max_batch: Optional[int] = None,
                 hedge_after_ms: Optional[float] = None,
                 client: str = "client", time_scale: float = 1.0,
                 workers: Optional[int] = None,
                 membership=None, health_poll_ms: float = 50.0,
                 offload_ewma_ms: Optional[float] = None):
        if time_scale <= 0:
            raise ValueError("time_scale must be > 0")
        if window_ms is None or not math.isfinite(window_ms) or window_ms < 0:
            # None is the engine's no-windowing sentinel, and inf/nan give
            # windows that never come due: every future would hang until
            # stop().  The server needs a real close instant to sleep to
            raise ValueError("FaasServer requires a finite window_ms >= 0")
        self.cluster = cluster
        self.router = Router(cluster, client=client,
                             hedge_after_ms=hedge_after_ms,
                             offload_ewma_ms=offload_ewma_ms)
        # optional ElasticMembership (runtime/elastic.py): the serving loop
        # polls it every turn — a health-reported death crashes the node
        # through the recovery state machine, the next pump's dead-node
        # eviction reroutes or fail-fasts its queued tickets, and the
        # loop's sleeps are CAPPED at health_poll_ms (virtual) so a quiet
        # server still notices a silent node within one poll interval
        self.membership = membership
        self.health_poll_ms = health_poll_ms
        self.time_scale = time_scale
        self.stats = ServerStats()
        self.response_ms: List[float] = []      # virtual latency per serve
        self.window_ms = window_ms
        self.max_batch = max_batch
        self.workers = workers
        # the ONE server-side lock: future table, orphaned results, and the
        # serving loop's deadline wake-ups.  Dispatches never run under it
        self._cond = lockdep.make_condition("server.cond")
        # serializes whole pump TURNS (router.pump/reconcile -> deliver ->
        # fail-lost): a ticket the router just folded is momentarily
        # untracked but undelivered, and a concurrent fail-lost pass in
        # that gap would fail a request that succeeded.  Ordered ABOVE
        # _cond; client submits never take it
        self._pump_lock = lockdep.make_lock("server.pump_lock")
        self._futures: Dict[int, ServedRequest] = {}
        # bumped (under _cond) by every submit: the serving loop re-pumps
        # instead of sleeping when a submit landed DURING its pump turn —
        # such a submit may have auto-flushed a result into the engine's
        # ready set just after the turn's pump drained it, and its
        # notify_all finds no waiter (the classic lost wakeup)
        self._submit_gen = 0
        # results that surfaced before their future was registered (a pump
        # can race submit between ticket issue and registration)
        self._orphans: Dict[int, InvokeResult] = {}
        self._epoch: Optional[float] = None
        self._running = False
        self._thread: Optional[threading.Thread] = None
        # the cluster's shared engine is only touched between start() and
        # stop(): prior knobs/clock/workers are saved then, restored after
        self._saved_engine_state = None

    # ------------------------------------------------------------------ clock
    def now(self) -> float:
        """Current VIRTUAL time (ms): wall time since start × time_scale."""
        if self._epoch is None:
            return 0.0
        return (time.perf_counter() - self._epoch) * 1e3 * self.time_scale

    def _to_wall_s(self, virtual_ms: float) -> float:
        return virtual_ms / (1e3 * self.time_scale)

    # -------------------------------------------------------------- lifecycle
    def start(self) -> "FaasServer":
        if self._running:
            return self
        eng = self.cluster.engine
        self._saved_engine_state = (eng.window_ms, eng.max_batch, eng.clock,
                                    eng.workers, eng.on_ready)
        eng.configure(window_ms=self.window_ms, max_batch=self.max_batch)
        eng.use_clock(self.now)
        eng.use_workers(self.workers)
        # dataflow-scheduler delivery: a window's results surface the
        # moment its last frame finalizes (mid-cycle), so a fast store
        # node's futures resolve while a straggler node's frames are
        # still executing — the serving loop's pump only picks up
        # leftovers (held-back foreign results, barriered cycles)
        eng.on_ready = self._on_engine_ready
        self._epoch = time.perf_counter()
        self._running = True
        self._thread = threading.Thread(target=self._serve_loop,
                                        name="faas-server", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the loop; with ``drain`` every still-queued window is pumped
        out (charged its full wait, as if the deadline passed) so no future
        is left hanging."""
        with self._cond:
            self._running = False
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if drain:
            with self._pump_lock:
                try:
                    # hedge=False: every wait ends right now, a duplicate
                    # could never complete earlier than its primary
                    results = self.router.pump(math.inf, hedge=False)
                except Exception:
                    # same contract as the serving loop: redeem what the
                    # failed cycle stashed, fail the dropped tickets
                    self.stats.inc("cycle_errors")
                    results = self.router.reconcile()
                with self._cond:
                    self._deliver(results)
                    self._fail_lost()
                    # anything still registered raced the drain: no pump
                    # will run again, so fail it rather than hang the
                    # client
                    for t in list(self._futures):
                        self._fail(self._futures.pop(t),
                                   f"ticket {t} unresolved at shutdown")
        # hand the CLUSTER's shared engine back exactly as we found it
        # (knobs, clock and pump width) — the server's wall clock must not
        # outlive it
        if self._saved_engine_state is not None:
            (window_ms, max_batch, clock, workers,
             on_ready) = self._saved_engine_state
            self.cluster.engine.configure(window_ms=window_ms,
                                          max_batch=max_batch)
            self.cluster.engine.use_clock(clock)
            self.cluster.engine.use_workers(workers)
            self.cluster.engine.on_ready = on_ready
            self._saved_engine_state = None

    def __enter__(self) -> "FaasServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ----------------------------------------------------------------- client
    def submit(self, fn_name: str, x, session_id: Optional[str] = None,
               payload_bytes: int = 64) -> ServedRequest:
        """Enqueue one request with the CURRENT wall instant as its virtual
        send time; wakes the serving loop so its sleep re-arms against the
        (possibly earlier) new deadline.  Thread-safe, and the enqueue
        itself runs OUTSIDE the server lock — a submit never waits for a
        pump's dispatch in flight."""
        with self._cond:
            if not self._running:       # fail fast instead of enqueueing
                # into a drained engine and hanging the future
                raise RuntimeError(
                    "server not started (use start() or `with`)")
        t_send = self.now()
        try:
            ticket = self.router.submit(fn_name, x, t_send=t_send,
                                        session_id=session_id,
                                        payload_bytes=payload_bytes)
        except Exception:
            # a full window auto-flushes ON THIS THREAD and the cycle
            # can raise, dropping the window (at-most-once).  Settle
            # the damage before re-raising to this caller: redeem what
            # the cycle stashed, fail the dropped tickets' futures —
            # one whole pump turn, under the pump lock like the loop's
            self.stats.inc("cycle_errors")
            with self._pump_lock:
                results = self.router.reconcile()
                with self._cond:
                    self._submit_gen += 1
                    self._deliver(results)
                    self._fail_lost()
                    self._cond.notify_all()
            raise
        fut = ServedRequest(ticket, fn_name, t_send)
        self.stats.inc("submitted")
        stopping = False
        with self._cond:
            self._submit_gen += 1
            orphan = self._orphans.pop(ticket, None)
            if orphan is not None:
                # a pump completed the ticket before we registered: claim
                self._resolve(fut, orphan)
            elif not self._running:
                stopping = True     # settled below, outside _cond (the
                                    # pump lock sits above it)
            else:
                # register even if the router momentarily does not track
                # the ticket: a pump turn in its folded-but-undelivered
                # gap resolves it on delivery, and a genuinely dropped
                # ticket is failed by the next turn's _fail_lost
                self._futures[ticket] = fut
            self._cond.notify_all()
        if stopping:
            # raced stop(): the drain may already have run, so no pump
            # will ever redeem this ticket.  Still queued -> discard and
            # fail fast.  NOT queued -> it auto-flushed on this very
            # thread (max_batch) and its committed result sits in the
            # engine's ready set: claim it rather than strand it as a
            # forever-recycling foreign result
            if self.cluster.engine.discard(ticket):
                with self._cond:
                    self._fail(fut, f"ticket {ticket} submitted while "
                                    f"the server was stopping")
            else:
                with self._pump_lock:
                    results = self.router.reconcile()   # redeems ready
                    with self._cond:                    # results only
                        res = results.pop(ticket, None)
                        if res is not None:
                            self._resolve(fut, res)
                        else:
                            self._fail(fut, f"ticket {ticket} dropped "
                                            f"while the server was "
                                            f"stopping")
                        self._deliver(results)
                        self._fail_lost()
        return fut

    # ---------------------------------------------------------------- asyncio
    async def async_submit(self, fn_name: str, x,
                           session_id: Optional[str] = None,
                           payload_bytes: int = 64) -> InvokeResult:
        """``submit`` for asyncio clients: awaits the InvokeResult (or
        raises ``RequestLost``).  The enqueue itself runs on the loop's
        default thread-pool executor — a full window auto-flushes a whole
        device dispatch inside ``submit``, which must never stall the event
        loop's other logical clients.  Many clients live as tasks on one
        loop — no thread per client."""
        loop = asyncio.get_running_loop()
        fut = await loop.run_in_executor(
            None, lambda: self.submit(fn_name, x, session_id=session_id,
                                      payload_bytes=payload_bytes))
        return await asyncio.wrap_future(fut)

    # ------------------------------------------------------------ serving loop
    def _serve_loop(self) -> None:
        while True:
            with self._cond:
                if not self._running:
                    return
                self.stats.inc("wakeups")
                gen0 = self._submit_gen
            if self.membership is not None:
                # health plane first: a node that timed out crashes NOW,
                # so this very turn's pump evicts its queued windows
                # (reroute or fail-fast) instead of dispatching into it
                crashed = self.membership.poll()
                if crashed:
                    self.stats.inc("nodes_crashed", len(crashed))
            # one pump TURN under the pump lock (fold -> deliver -> fail
            # lost stays atomic against the submit error path), OUTSIDE
            # the server lock: submits stay non-blocking while the engine
            # dispatches (the engine's own locks do the rest)
            with self._pump_lock:
                try:
                    results = self.router.pump(self.now())
                except Exception:
                    # a failed flush cycle dropped its group
                    # (at-most-once); surviving windows stay queued.  The
                    # router never saw a result set, so reconcile: redeem
                    # what the cycle stashed and prune the dropped
                    # tickets — their futures fail below, not hang
                    self.stats.inc("cycle_errors")
                    results = self.router.reconcile()
                with self._cond:
                    self._deliver(results)
                    self._fail_lost()
            with self._cond:
                if not self._running:
                    return
                if self._submit_gen != gen0:
                    # a submit landed during the pump turn: its result may
                    # already sit in the engine's ready set (inline auto-
                    # flush) and its notify found no waiter — pump again
                    # instead of arming a sleep that nothing would wake
                    continue
                # with a membership attached, never sleep past one health
                # poll interval — a dead node produces no submit to wake us
                cap = (self._to_wall_s(self.health_poll_ms)
                       if self.membership is not None else None)
                nxt = self.router.next_deadline()
                if nxt is None:
                    self._cond.wait(timeout=cap)    # submit, stop, or poll
                    continue
                delay = self._to_wall_s(nxt - self.now())
                if cap is not None:
                    delay = min(delay, cap)
                if delay > 0:
                    # sleep EXACTLY until the next window close/hedge fire;
                    # a submit notifies and the loop re-arms
                    self._cond.wait(timeout=delay)

    def _on_engine_ready(self, results: Dict[int, InvokeResult]) -> None:
        """Mid-cycle delivery hook (``engine.on_ready``): called on the
        thread running the flush cycle, with the engine cycle lock held,
        the moment one window's results finalize.  Folds them through the
        router (midcycle semantics: no pruning, no partner-dead hedge
        settlement — see ``Router.fold_now``) and resolves futures right
        away.  Lock order stays acyclic: cycle lock > router lock >
        server cond; no path below takes an engine lock."""
        mine = self.router.fold_now(results)
        if mine:
            with self._cond:
                self._deliver(mine)

    def _resolve(self, fut: ServedRequest, res: InvokeResult) -> None:
        """Complete one future (under the server lock).  A client may have
        CANCELLED it (asyncio task cancellation propagates through
        wrap_future) — claim it first, or the set would raise
        InvalidStateError and kill the serving thread."""
        if not fut.set_running_or_notify_cancel():
            return                          # client gave up: drop quietly
        self.stats.inc("served")
        # the router re-stamps hedge winners against the primary's
        # send instant, so response_ms IS the client-observed latency
        self.response_ms.append(res.response_ms)
        fut.set_result(res)

    def _fail(self, fut: ServedRequest, why: str) -> None:
        """Fail one future as lost, cancellation-safe like ``_resolve``."""
        if not fut.set_running_or_notify_cancel():
            return
        self.stats.inc("lost")
        fut.set_exception(RequestLost(f"{why} ({fut.fn!r})"))

    def _deliver(self, results: Dict[int, InvokeResult]) -> None:
        if results:
            self.stats.inc("pumps")
        for ticket, res in results.items():
            fut = self._futures.pop(ticket, None)
            if fut is None:
                # completed before submit registered its future: park the
                # result; submit claims it at registration time
                self._orphans[ticket] = res
                continue
            self._resolve(fut, res)

    def _fail_lost(self) -> None:
        """Fail futures whose tickets the router no longer tracks (dropped
        by a failed cycle or discarded) — they can never resolve.  Only
        ever called with the pump lock held, so no ticket can be in the
        folded-but-undelivered gap of a concurrent pump turn."""
        if not self._futures:
            return
        for t in [t for t in self._futures if not self.router.tracks(t)]:
            self._fail(self._futures.pop(t),
                       f"ticket {t} dropped before completing")


# ---------------------------------------------------------------------------
# workload drivers: threads
# ---------------------------------------------------------------------------

def serve_open_loop(server: FaasServer, fn_name: str, make_input,
                    n_requests: int, rate_per_ms: float = 1.0,
                    timeout_s: float = 30.0,
                    session_id: Optional[str] = None) -> List[Any]:
    """Open-loop driver: submissions at a fixed arrival rate
    (``rate_per_ms`` per VIRTUAL millisecond, i.e. wall rate ×
    ``server.time_scale``), regardless of completions — the paper's open
    workload.  Returns all InvokeResults in submission order."""
    spacing_s = 1.0 / (rate_per_ms * 1e3 * server.time_scale)
    futs = []
    for i in range(n_requests):
        futs.append(server.submit(fn_name, make_input(i),
                                  session_id=session_id))
        time.sleep(spacing_s)
    return [f.result(timeout=timeout_s) for f in futs]


def serve_closed_loop(server: FaasServer, fn_name: str, make_input,
                      n_requests: int, concurrency: int = 4,
                      timeout_s: float = 30.0,
                      session_prefix: Optional[str] = None) -> List[Any]:
    """Closed-loop driver: ``concurrency`` client threads, each submitting
    its next request as soon as the previous one completes (the paper's
    §4.2 closed workload).  Returns all InvokeResults."""
    results: List[Any] = []
    errors: List[BaseException] = []
    lock = threading.Lock()
    counter = iter(range(n_requests))

    def client(cid: int):
        sid = f"{session_prefix}{cid}" if session_prefix else None
        while True:
            with lock:
                i = next(counter, None)
            if i is None:
                return
            try:
                fut = server.submit(fn_name, make_input(i), session_id=sid)
                res = fut.result(timeout=timeout_s)
            except BaseException as e:    # surfaced after join, not stderr
                with lock:
                    errors.append(e)
                return
            with lock:
                results.append(res)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


# ---------------------------------------------------------------------------
# workload drivers: asyncio (many logical clients, one thread)
# ---------------------------------------------------------------------------

async def serve_open_loop_async(server: FaasServer, fn_name: str, make_input,
                                n_requests: int, rate_per_ms: float = 1.0,
                                timeout_s: float = 30.0,
                                session_id: Optional[str] = None
                                ) -> List[Any]:
    """Open-loop driver on the CURRENT event loop: fixed virtual arrival
    rate, all requests in flight as awaitables.  Returns InvokeResults in
    submission order."""
    spacing_s = 1.0 / (rate_per_ms * 1e3 * server.time_scale)
    aws = []
    for i in range(n_requests):
        # ensure_future so the submission actually fires NOW (the arrival
        # process), not when gather first awaits it
        aws.append(asyncio.ensure_future(
            server.async_submit(fn_name, make_input(i),
                                session_id=session_id)))
        await asyncio.sleep(spacing_s)
    return await asyncio.wait_for(asyncio.gather(*aws), timeout=timeout_s)


async def serve_closed_loop_async(server: FaasServer, fn_name: str,
                                  make_input, n_requests: int,
                                  concurrency: int = 4,
                                  timeout_s: float = 30.0,
                                  session_prefix: Optional[str] = None
                                  ) -> List[Any]:
    """Closed-loop driver with ``concurrency`` LOGICAL clients as asyncio
    tasks on one thread — each awaits its completion before submitting the
    next request.  The asyncio analogue of ``serve_closed_loop``."""
    results: List[Any] = []
    counter = iter(range(n_requests))

    async def client(cid: int):
        sid = f"{session_prefix}{cid}" if session_prefix else None
        while True:
            i = next(counter, None)     # single-threaded loop: no race
            if i is None:
                return
            results.append(await server.async_submit(
                fn_name, make_input(i), session_id=sid))

    await asyncio.wait_for(
        asyncio.gather(*(client(c) for c in range(concurrency))),
        timeout=timeout_s)
    return results
