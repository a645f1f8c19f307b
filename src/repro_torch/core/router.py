"""Client-side router: nearest-replica selection, session affinity, hedging.

The paper's clients "directly access their local, lightweight edge FaaS
instances" (§6) — the router codifies that: pick the lowest-latency live
deployment that satisfies the session's consistency requirement, with an
optional hedged second request as straggler mitigation (runtime tier).

EVERY invocation path runs through the batched engine's dataflow
scheduler: ``invoke`` submits a singleton ticket and pumps the engine
until it resolves, so one-off and batched requests share one queue, one
set of windows, one hedging mechanism and one stats ledger (there is no
separate post-hoc hedge anymore — a singleton's "window" closes at
``+inf`` without ``window_ms``, which makes every queued singleton
hedge-eligible the moment its ``hedge_after_ms`` deadline passes).

Correctness notes (the two bugs PR 2 fixed):

* hedging re-invokes the function, so it is only safe for READ-ONLY
  handlers — re-running a mutating handler applies its writes and
  replication events twice.  The router checks the deploy-time op trace
  (``faas.compile_handler``'s ``read_only`` flag) and suppresses the hedge
  for mutating handlers (counted in ``stats.hedges_suppressed``);
* session tokens must observe the STORE node's version vector and clock,
  not the serving node's: under ``PEER_FETCH``/``CLOUD_CENTRAL`` the write
  lands at the owner/cloud store while ``res.node`` is the edge node the
  client talked to.  Placement is resolved via
  ``cluster._resolve_placement`` so reads-your-writes holds under every
  placement.

The router also fronts the batched invocation engine: ``submit`` enqueues a
request (same nearest-replica/session pick as ``invoke``), and
``pump``/``flush`` drain the engine's arrival-time windows, folding each
completed result back into its session.

Straggler mitigation extends to the batched path as a WINDOWED HEDGE
(``hedge_after_ms``): when a read-only request's arrival-time window
outlives its hedge deadline (``t_send + hedge_after_ms``), ``pump`` fires a
duplicate ticket at the nearest OTHER replica at the hedge instant.  The
pair resolves to the earlier completion — reported under the primary
ticket — and the loser is discarded from the queue if it never dispatched
(at-most-once: a hedge only ever duplicates read-only work).  Hedge fire
times are part of ``next_deadline()`` so a serving loop wakes for them.

Hedge TARGET policy: every completion feeds a per-replica EWMA of observed
latency (``stats.ewma_ms``); when a hedge fires, the duplicate goes to the
lowest-EWMA session-satisfying replica — the tail-at-scale heuristic of
preferring the replica that has actually been answering fastest — falling
back to the nearest other replica while no replica has a sample yet.

Thread-safety: the router's own bookkeeping (sessions, in-flight tickets,
hedge pairs) lives behind one router lock, held only for host-side folds —
``engine.pump``'s device dispatches always run OUTSIDE it, so submitting
threads never wait on a dispatch in flight (see docs/batched_engine.md,
"Concurrency contract").

This module is the reference router with its imports rewired; the
replicas' version vectors are read back from the device as numpy for the
session checks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from repro_torch.analysis import lockdep
from repro_torch.core.cluster import Cluster, InvokeResult
from repro_torch.core.consistency import Session
from repro_torch.core.engine import AtomicStats
from repro_torch.core.versioning import MAX_NODES


@dataclasses.dataclass
class RouterStats(AtomicStats):
    requests: int = 0
    hedges_fired: int = 0
    hedge_wins: int = 0
    hedges_suppressed: int = 0      # mutating handler: hedge would double-write
    redirects_for_consistency: int = 0
    offloads: int = 0               # picks redirected off a saturated node
                                    # by the local-decision offload policy
    # per-replica EWMA of client-observed completion latency (ms) — the
    # hedge-target policy's signal; see observe_latency
    ewma_ms: Dict[str, float] = dataclasses.field(default_factory=dict)

    def observe_latency(self, node: str, ms: float, alpha: float) -> None:
        """Fold one completion into ``node``'s latency EWMA (atomic).
        ``alpha`` is the caller's smoothing factor (the router passes its
        ``EWMA_ALPHA`` — the one source of truth)."""
        with self._lock:
            prev = self.ewma_ms.get(node)
            self.ewma_ms[node] = (ms if prev is None
                                  else alpha * ms + (1.0 - alpha) * prev)


@dataclasses.dataclass
class _InFlight:
    """Everything the router needs to re-route a queued ticket (hedging)
    and to fold its eventual result into the right session."""
    fn: str
    session_id: Optional[str]
    x: object
    t_send: float
    node: str
    payload_bytes: int
    hedge_decided: bool = False     # the fire/suppress choice is made ONCE


@dataclasses.dataclass(eq=False)
class _Hedge:
    """A hedged pair: the primary ticket and its duplicate.  Registered in
    ``Router._hedges`` under BOTH tickets; resolves to the earlier
    completion, reported under the primary."""
    primary: int
    hedge: int
    primary_res: Optional[InvokeResult] = None
    hedge_res: Optional[InvokeResult] = None


class Router:
    #: smoothing factor of the per-replica latency EWMA (hedge targeting)
    EWMA_ALPHA = 0.2

    def __init__(self, cluster: Cluster, client: str = "client",
                 hedge_after_ms: Optional[float] = None,
                 offload_ewma_ms: Optional[float] = None):
        self.cluster = cluster
        self.client = client
        self.hedge_after_ms = hedge_after_ms
        # local-decision offload threshold (Cicconetti et al.,
        # arXiv:2203.06385): a pick whose target's latency EWMA exceeds
        # this redirects to the fastest-answering other replica — edge
        # overflow drains to cloud replicas with no central coordinator,
        # because the signal is the client's own completion observations
        self.offload_ewma_ms = offload_ewma_ms
        self.stats = RouterStats()
        self.sessions: Dict[str, Session] = {}
        # engine tickets in flight through this router (primary tickets only)
        self._inflight: Dict[int, _InFlight] = {}
        # hedged pairs, keyed by BOTH member tickets (same _Hedge object)
        self._hedges: Dict[int, _Hedge] = {}
        # deploy-time traces are static, so read-only-ness per fn is too:
        # cache it off the hedging hot path (is_read_only walks call graphs)
        self._ro_cache: Dict[str, bool] = {}
        # results a synchronous ``invoke`` drained for OTHER tickets of
        # this router while pumping for its own: parked here (instead of
        # handing them back to the engine as foreign, which would recycle
        # them forever) and merged into the next fold's return
        self._claimed: Dict[int, InvokeResult] = {}
        # guards sessions/_inflight/_hedges; held for host-side folds only,
        # never across an engine dispatch — pump/hedge submits release it
        # first, so router.lock nests only engine.qlock (and, mid-cycle,
        # is itself taken under the cycle lock on the on_ready delivery
        # path).  Declared in repro/analysis/lock_order.py
        self._lock = lockdep.make_rlock("router.lock")

    # ------------------------------------------------------------------ picks
    def candidates(self, fn_name: str) -> List[str]:
        # routable = alive and not SUSPECT: a node parked suspect by the
        # membership (minority-view partition) keeps its replicas but
        # stops being picked until its reachability clears
        alive = set(self.cluster.naming.routable_nodes())
        nodes = [n for n in self.cluster.naming.deployments_of(fn_name)
                 if n in alive]
        return sorted(nodes,
                      key=lambda n: self.cluster.net.rtt_ms(self.client, n))

    def pick(self, fn_name: str, session: Optional[Session] = None) -> str:
        cands = self.candidates(fn_name)
        if not cands:
            raise KeyError(f"no live deployment of {fn_name}")
        spec = self.cluster.specs[fn_name]
        chosen = cands[0]
        if session is not None and spec.keygroups:
            for n in cands:
                if self._satisfies(spec, n, session):
                    if n != cands[0]:
                        self.stats.inc("redirects_for_consistency")
                    chosen = n
                    break
            # nobody satisfies yet -> nearest replica; caller may retry
        return self._maybe_offload(chosen, cands, spec, session)

    def _maybe_offload(self, chosen: str, cands: List[str], spec,
                       session: Optional[Session]) -> str:
        """Local-decision offload: if the chosen node's completion-latency
        EWMA says it is saturated (above ``offload_ewma_ms``), redirect to
        the fastest-answering OTHER candidate that still satisfies the
        session — unsampled replicas count as fast (give them a first
        request rather than pile onto a known-slow node).  The decision is
        purely client-local, made from this router's own observations."""
        if self.offload_ewma_ms is None:
            return chosen
        ewma = self.stats.ewma_ms
        cur = ewma.get(chosen)
        if cur is None or cur <= self.offload_ewma_ms:
            return chosen
        best, best_ms = None, cur
        for n in cands:
            if n == chosen:
                continue
            if (session is not None and spec.keygroups
                    and not self._satisfies(spec, n, session)):
                continue
            ms = ewma.get(n, 0.0)
            if ms < best_ms:
                best, best_ms = n, ms
        if best is None:
            return chosen           # everyone else is as slow or stale
        self.stats.inc("offloads")
        return best

    def _satisfies(self, spec, node: str, session: Session) -> bool:
        """Whether serving ``spec`` at ``node`` can satisfy the session.
        The version vector that decides lives at the STORE the candidate's
        kv ops would actually hit (placement-resolved, as in ``_observe``):
        under PEER_FETCH/CLOUD_CENTRAL that is the owner/cloud node, not
        the serving candidate — checking the candidate's own (empty)
        stores made every session read fall through, or bogusly redirect
        to the owner replica."""
        kg, store_node, _ = self.cluster._resolve_placement(spec, node)
        snd = self.cluster.nodes[store_node]
        if kg not in snd.stores:
            return False
        return session.can_read_from(snd.stores[kg].vv.cpu().numpy())

    def _session(self, session_id: Optional[str]) -> Optional[Session]:
        if session_id is None:
            return None
        return self.sessions.setdefault(session_id,
                                        Session(num_nodes=MAX_NODES))

    # ----------------------------------------------------------------- invoke
    def invoke(self, fn_name: str, x, t_send: float = 0.0,
               session_id: Optional[str] = None,
               payload_bytes: int = 64) -> InvokeResult:
        """One-off invocation through the SAME engine path as
        ``submit``/``pump``: submits a singleton ticket and pumps the
        engine (by ``next_deadline``, so every due hedge fires at its
        instant) until the ticket resolves.  This retires the separate
        sequential code path: the singleton rides the dataflow scheduler,
        shares the dead-node eviction and stats ledger, folds into its
        session through ``_fold``, and — with ``hedge_after_ms`` set —
        gets the WINDOWED hedge (``_maybe_hedge``/``_hedge_target``, the
        lowest-EWMA session-satisfying replica) instead of a bespoke
        post-hoc duplicate.  Results other tickets of this router
        surfaced during the drain are parked in ``_claimed`` for their
        owner's next ``pump``/``flush``."""
        ticket = self.submit(fn_name, x, t_send=t_send,
                             session_id=session_id,
                             payload_bytes=payload_bytes)
        while True:
            with self._lock:
                res = self._claimed.pop(ticket, None)
            if res is not None:
                return res
            nxt = self.next_deadline()
            out = self.pump(math.inf if nxt is None else nxt)
            res = out.pop(ticket, None)
            if out:
                with self._lock:
                    self._claimed.update(out)
            if res is not None:
                return res
            if not self.tracks(ticket):
                # dropped by a failed flush cycle / dead-node fail-fast:
                # at-most-once, surface the loss instead of spinning
                raise KeyError(f"ticket {ticket} ({fn_name!r}) was "
                               f"dropped before completing")

    def _observe(self, session: Session, fn_name: str,
                 res: InvokeResult) -> None:
        """Fold a completed invocation into the session token.

        The version vector and clock are taken from the STORE node the kv
        ops actually hit (placement-resolved), not from ``res.node``: under
        PEER_FETCH/CLOUD_CENTRAL the serving edge node holds no replica and
        the write landed at the owner/cloud store."""
        spec = self.cluster.specs[fn_name]
        kg, store_node, _ = self.cluster._resolve_placement(spec, res.node)
        if kg is None:
            return
        snd = self.cluster.nodes[store_node]
        if kg not in snd.stores:
            return
        session.observe_read(snd.stores[kg].vv.cpu().numpy())
        wrote = any(k in ("set", "delete") for k, _ in res.kv_ops)
        if wrote:
            # the write's version stamp carries the SERVING node's id (the
            # handler is compiled with it) but the clock that advanced is
            # the STORE node's — the pair the store's vv actually recorded
            session.observe_write(self.cluster.nodes[res.node].node_id,
                                  int(snd.clock))

    # ---------------------------------------------------------------- batched
    def submit(self, fn_name: str, x, t_send: float = 0.0,
               session_id: Optional[str] = None,
               payload_bytes: int = 64) -> int:
        """Enqueue one invocation on the cluster's batched engine, routed
        through the same nearest-replica/session pick as ``invoke``.  The
        returned ticket is redeemed by ``pump``/``flush``, which also fold
        the result back into the session.  With ``hedge_after_ms`` set,
        read-only requests whose window outlives the hedge deadline are
        hedged at the next ``pump`` (windowed hedge, see module docstring).
        Thread-safe: many client threads may submit concurrently while the
        serving thread pumps — the engine enqueue (which can auto-flush a
        full window, a whole dispatch cycle) runs OUTSIDE the router lock.
        A result that surfaces before the ticket registers is handed back
        to the engine as foreign and redeemed by the next pump."""
        with self._lock:
            session = self._session(session_id)
            node = self.pick(fn_name, session)
            self.stats.inc("requests")
        ticket = self.cluster.engine.submit(fn_name, node, x,
                                            t_send=t_send,
                                            client=self.client,
                                            payload_bytes=payload_bytes)
        with self._lock:
            self._inflight[ticket] = _InFlight(fn_name, session_id, x, t_send,
                                               node, payload_bytes)
        return ticket

    def pump(self, until_t: Optional[float] = None,
             hedge: bool = True) -> Dict[int, InvokeResult]:
        """Advance the engine's background flusher to ``until_t`` (the
        engine clock's current time when omitted and a clock is plugged)
        and fold every completed request of this router into its session.
        Fires due windowed hedges first, so a hedge submitted at its fire
        instant can still join this pump's flush cycle; pass
        ``hedge=False`` when draining at shutdown — every wait is about to
        end anyway, so firing duplicates would only waste dispatches.
        Returns only THIS router's tickets — results of tickets submitted
        by other callers of the shared engine are handed back for their
        owner's next pump/flush."""
        eng = self.cluster.engine
        if until_t is None:
            until_t = eng.now()     # the one clock-resolution convention
        if hedge:
            self._maybe_hedge(until_t)
        results = eng.pump(until_t)     # dispatch OUTSIDE the router lock
        with self._lock:
            return self._fold(results)

    def flush(self) -> Dict[int, InvokeResult]:
        """Drain the engine regardless of window deadlines (own tickets
        only, like ``pump``).  No hedges fire: flushing ends every wait
        immediately, so no window outlives its hedge deadline."""
        results = self.cluster.engine.flush()
        with self._lock:
            return self._fold(results)

    def fold_now(self, results: Dict[int, InvokeResult]
                 ) -> Dict[int, InvokeResult]:
        """Fold results delivered MID-CYCLE by the engine's dataflow
        scheduler (``engine.on_ready``: a window's results surface the
        moment its last frame finalizes, while the flush cycle is still
        running).  Same session/hedge/EWMA bookkeeping as a pump's fold,
        with two midcycle restrictions (see ``_fold``): no in-flight
        pruning, and no partner-dead hedge settlement — both judgements
        need the cycle-end view of the queue."""
        with self._lock:
            return self._fold(results, midcycle=True)

    def tracks(self, ticket: int) -> bool:
        """Whether ``ticket`` can still produce a result through this
        router (in flight, or a member of an unresolved hedged pair).  A
        serving loop fails the request's future once this turns False."""
        with self._lock:
            return ticket in self._inflight or ticket in self._hedges

    def reconcile(self) -> Dict[int, InvokeResult]:
        """Settle state after a flush cycle RAISED: the failing group's
        tickets are gone from the engine but ``_fold`` never ran.  Pumping
        to ``-inf`` dispatches nothing — it only redeems results the
        failed cycle already stashed (groups that completed cleanly) — and
        the fold prunes tickets that can no longer complete, so a serving
        loop can fail their futures instead of hanging them."""
        results = self.cluster.engine.pump(-math.inf)
        with self._lock:
            return self._fold(results)

    def next_deadline(self) -> Optional[float]:
        """Earliest virtual instant at which this router has scheduled
        work: the engine's next window close, or an in-flight read-only
        ticket's hedge fire time, whichever comes first.  ``None`` when
        nothing is queued — the wall-clock serving loop sleeps exactly
        until this instant."""
        due = []
        if (d := self.cluster.engine.next_deadline()) is not None:
            due.append(d)
        with self._lock:
            due.extend(hd for _, _, hd in self._hedgeable())
        return min(due) if due else None

    def _read_only(self, fn_name: str) -> bool:
        ro = self._ro_cache.get(fn_name)
        if ro is None:
            ro = self._ro_cache[fn_name] = self.cluster.is_read_only(fn_name)
        return ro

    def _hedgeable(self) -> List:
        """(ticket, meta, hedge instant) for every READ-ONLY in-flight
        ticket still queued in a window that outlives its hedge deadline,
        with the fire decision still open — the ONE eligibility rule
        shared by ``next_deadline`` (when to wake) and ``_maybe_hedge``
        (what to fire).  A mutating ticket is decided (suppressed) the
        first time it qualifies, so the serving loop never schedules a
        wakeup at a hedge instant that cannot fire."""
        if self.hedge_after_ms is None or not self._inflight:
            return []
        queued = {p["ticket"]: p["deadline"]
                  for p in self.cluster.engine.pending()}
        out = []
        for t, m in self._inflight.items():
            if m.hedge_decided:
                continue
            dl = queued.get(t)
            hd = m.t_send + self.hedge_after_ms
            if dl is None or dl <= hd:
                continue            # dispatched, or window beats the hedge
            if not self._read_only(m.fn):
                m.hedge_decided = True      # can never hedge: decide now
                self.stats.inc("hedges_suppressed")
                continue
            out.append((t, m, hd))
        return out

    def _maybe_hedge(self, until_t: float) -> None:
        """Fire the windowed hedge for every queued read-only ticket whose
        window outlives its hedge deadline (``t_send + hedge_after_ms``),
        once the pump horizon has reached that instant.  The duplicate is
        submitted to the hedge-target replica (lowest EWMA) that can still
        satisfy the request's session, with the hedge instant as its send
        time — deterministic in virtual time, independent of pump cadence.
        Each fire DECIDES under the router lock immediately before its
        own engine submit, which runs outside the lock (it can auto-flush
        a whole dispatch on a full window, like ``submit``) — so a submit
        that raises mid-pass leaves the REMAINING tickets undecided and
        they retry at the next pump instead of silently losing their
        hedge."""
        with self._lock:
            due = [(t, m) for t, m, hd in self._hedgeable()
                   if until_t >= hd]
        for ticket, m in due:
            with self._lock:
                if m.hedge_decided:
                    continue        # raced another pump: decided there
                m.hedge_decided = True  # one fire decision per ticket
                alt = self._hedge_target(m)
                if alt is None:
                    continue        # no second replica can serve this one
                self.stats.inc("hedges_fired")
                hd = m.t_send + self.hedge_after_ms
            ht = self.cluster.engine.submit(m.fn, alt, m.x, t_send=hd,
                                            client=self.client,
                                            payload_bytes=m.payload_bytes)
            with self._lock:
                pair = _Hedge(primary=ticket, hedge=ht)
                self._hedges[ticket] = self._hedges[ht] = pair

    def _hedge_target(self, m: _InFlight) -> Optional[str]:
        """Where the duplicate goes: among the replicas other than the
        primary's that can serve the request (honouring the session's
        consistency requirement exactly like ``pick``, so a hedge never
        wins with a stale read), prefer the one with the LOWEST latency
        EWMA — the replica that has actually been answering fastest.
        While no eligible replica has a sample yet, fall back to the
        nearest one (the candidates come RTT-sorted)."""
        session = (self.sessions.get(m.session_id)
                   if m.session_id is not None else None)
        spec = self.cluster.specs[m.fn]
        eligible = []
        for n in self.candidates(m.fn):
            if n == m.node:
                continue
            if (session is None or not spec.keygroups
                    or self._satisfies(spec, n, session)):
                eligible.append(n)
        if not eligible:
            return None
        ewma = self.stats.ewma_ms
        sampled = [n for n in eligible if n in ewma]
        if sampled:
            return min(sampled, key=lambda n: ewma[n])
        return eligible[0]

    def _fold(self, results: Dict[int, InvokeResult],
              midcycle: bool = False) -> Dict[int, InvokeResult]:
        mine: Dict[int, InvokeResult] = {}
        if self._claimed:
            # results a synchronous invoke drained for this router's other
            # tickets: already folded — just surface them to this caller
            mine.update(self._claimed)
            self._claimed.clear()
        foreign: Dict[int, InvokeResult] = {}
        touched: List[_Hedge] = []
        for ticket, res in results.items():
            pair = self._hedges.get(ticket)
            if pair is not None:
                if ticket == pair.primary:
                    pair.primary_res = res
                else:
                    pair.hedge_res = res
                if pair not in touched:
                    touched.append(pair)
                continue
            if ticket not in self._inflight:
                foreign[ticket] = res     # another submitter's: not ours
                continue
            mine[ticket] = res
            self._finish(ticket, res)
        queued = {p["ticket"]: p["deadline"]
                  for p in self.cluster.engine.pending()}
        for pair in touched:
            res = self._try_resolve_hedge(pair, queued, midcycle=midcycle)
            if res is not None:
                mine[pair.primary] = res
        if foreign:
            self.cluster.engine.hold_results(foreign)
        # prune in-flight tickets that can no longer complete: not in this
        # drain and no longer queued — dropped by a failed cycle's
        # at-most-once contract or discarded via engine.discard.  NEVER
        # midcycle: a ticket being dispatched by the running cycle is
        # neither queued nor in this partial drain, yet it is about to
        # complete — pruning it here would fail every in-flight future the
        # moment the first window of a cycle delivered
        if self._inflight and not midcycle:
            for t in [t for t in self._inflight
                      if t not in results and t not in queued]:
                pair = self._hedges.get(t)
                if pair is not None:
                    if pair in touched or pair.hedge in queued:
                        continue    # just handled / duplicate still possible
                    held = pair.primary_res or pair.hedge_res
                    if held is not None:
                        # partner died while we held a completion: settle
                        mine[pair.primary] = self._settle(
                            pair, held, held is pair.hedge_res)
                    else:           # both members dead: unredeemable
                        del self._hedges[pair.primary]
                        del self._hedges[pair.hedge]
                        del self._inflight[t]
                else:
                    del self._inflight[t]
        return mine

    def _try_resolve_hedge(self, pair: _Hedge, queued: Dict[int, float],
                           midcycle: bool = False
                           ) -> Optional[InvokeResult]:
        """Settle a hedged pair on the EARLIER completion.  With only one
        member complete, the pair settles early iff the partner provably
        cannot beat it — without flush-on-full a queued partner completes
        no sooner than its window's close, so a present result at or
        before that close wins and the loser is discarded before it ever
        dispatches (with ``max_batch`` set the window could fill and
        dispatch early, so the pair waits for the partner instead).
        Returns ``None`` while genuinely undecided."""
        pr, hr = pair.primary_res, pair.hedge_res
        if pr is not None and hr is not None:
            hedge_won = hr.t_received < pr.t_received
            return self._settle(pair, hr if hedge_won else pr, hedge_won)
        present, missing = (pr, pair.hedge) if hr is None else (hr, pair.primary)
        deadline = queued.get(missing)
        if deadline is None:
            if midcycle:
                # the partner is not queued but the cycle is still
                # RUNNING: it may be dispatching right now, its result one
                # on_ready delivery away.  Wait — the cycle-end fold (or
                # its prune path) settles the pair if the partner truly
                # died
                return None
            # partner dead (failed cycle / discarded): present completes
            return self._settle(pair, present, hr is not None)
        if (self.cluster.engine.max_batch is None
                and present.t_received <= deadline):
            # the no-sooner-than-the-close bound only holds without
            # flush-on-full: with max_batch set the partner's window could
            # fill and dispatch BEFORE its deadline, so wait for it instead
            self.cluster.engine.discard(missing)    # loser never dispatches
            return self._settle(pair, present, hr is not None)
        return None

    def _settle(self, pair: _Hedge, winner: InvokeResult,
                hedge_won: bool) -> InvokeResult:
        # EVERY completion of the pair feeds its replica's latency EWMA
        # with its OWN (pre-restamp) latency — the loser included, so a
        # straggler that keeps losing hedges still teaches the policy it
        # is slow (dropping losers is survivorship bias), and the winner's
        # sample is its true service latency, not the client-observed
        # value inflated by the window wait before the hedge fired
        for res in (pair.primary_res, pair.hedge_res):
            if res is not None:
                self.stats.observe_latency(res.node, res.response_ms,
                                           self.EWMA_ALPHA)
        if hedge_won:
            self.stats.inc("hedge_wins")
            # re-stamp the winner against the PRIMARY's send instant: the
            # hedge's own t_send is the later fire time, and the client
            # observes latency from its original submission
            t0 = self._inflight[pair.primary].t_send
            winner = dataclasses.replace(
                winner, t_sent=t0, response_ms=winner.t_received - t0)
        del self._hedges[pair.primary], self._hedges[pair.hedge]
        self._finish(pair.primary, winner, observe_latency=False)
        return winner

    def _finish(self, ticket: int, res: InvokeResult,
                observe_latency: bool = True) -> None:
        m = self._inflight.pop(ticket)
        if observe_latency:     # hedged pairs observed both members in
            self.stats.observe_latency(res.node, res.response_ms,
                                       self.EWMA_ALPHA)      # _settle
        session = (self.sessions.get(m.session_id)
                   if m.session_id is not None else None)
        if session is not None:
            self._observe(session, m.fn, res)
