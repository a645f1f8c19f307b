"""Twin of ``tests/test_faas_server.py``: windowed hedging (fired only for
read-only handlers past the hedge deadline, the earlier completion wins,
an undispatched loser is discarded, a session's consistency holds, the
target is the lowest-EWMA replica), the latency EWMAs and both levels'
``next_deadline`` run through both packages with the reference's
assertions on each, and the port's results, hedge and router stats, EWMAs,
horizons and engine stats equal the reference's bit for bit.  The
wall-clock server (real threads and sleeps, a node killed mid-serving, a
submit/stop race) is asserted on the port with the reference's margins.
The port's lockdep is armed over every test."""
import math
import threading
import time

import jax
import numpy as np
import pytest

from torch_parity import PKGS, PORT, twin
from torch_parity import port_lockdep  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")


def _register(pkg):
    fn, xp = pkg.enoki_function, pkg.xp

    @fn(name="tfs_bump", keygroups=["tfskg"], codec_width=4)
    def bump(kv, x):
        cur, found = kv.get("c")
        new = xp.where(found, cur[0] + 1.0, 1.0)
        kv.set("c", xp.vec([new, 0.0, 0.0, 0.0], x))
        return xp.vec([new], x)

    @fn(name="tfs_peek", keygroups=["tfskg"], codec_width=4)
    def peek(kv, x):
        cur, found = kv.get("c")
        return cur[:1]


for _pkg in PKGS:
    _register(_pkg)


def _cluster(pkg):
    return pkg.Cluster({"edge": "edge", "edge2": "edge", "cloud": "cloud"},
                       measure_compute=False)


def _deploy_both(pkg, c, nodes=("edge", "edge2")):
    c.deploy(pkg.get_function("tfs_bump"), list(nodes),
             policy=pkg.Policy.REPLICATED)
    c.deploy(pkg.get_function("tfs_peek"), list(nodes),
             policy=pkg.Policy.REPLICATED)
    c.invoke("tfs_bump", "edge", np.zeros((1,), np.float32))   # seed state
    c.flush_replication()


def _x():
    return np.zeros(4, np.float32)


def _count(pkg, c, node):
    contents = pkg.store_contents(c.nodes[node].stores["tfskg"])
    return list(contents.values())[0][2][0] if contents else 0.0


def _pump_all(router, n):
    """Drive pump deadline by deadline, as the serving loop does."""
    out = {}
    while len(out) < n:
        nd = router.next_deadline()
        if nd is None:
            out.update(router.pump(math.inf))
            break
        out.update(router.pump(nd))
    return out


def _served(pkg, window_ms=20.0, hedge_after_ms=5.0, straggler=None,
            **engine):
    c = _cluster(pkg)
    _deploy_both(pkg, c)
    if straggler is not None:
        c.set_compute_ms("edge", "tfs_peek", straggler)
    c.engine.configure(window_ms=window_ms, **engine)
    return c, pkg.Router(c, hedge_after_ms=hedge_after_ms)


# ---------------------------------------------------------------------------
# windowed hedging
# ---------------------------------------------------------------------------

def hedge_wins_on_straggler(pkg):
    c, router = _served(pkg, straggler=50.0)
    t = router.submit("tfs_peek", _x(), t_send=0.0)
    out = _pump_all(router, 1)
    assert set(out) == {t}
    assert router.stats.hedges_fired == 1
    assert router.stats.hedge_wins == 1
    assert out[t].node == "edge2"
    assert out[t].t_sent == 0.0
    assert out[t].response_ms == pytest.approx(out[t].t_received)
    assert router.stats.ewma_ms["edge"] > router.stats.ewma_ms["edge2"]
    assert router.stats.ewma_ms["edge2"] < out[t].response_ms
    c2, plain = _served(pkg, hedge_after_ms=None, straggler=50.0)
    t2 = plain.submit("tfs_peek", _x(), t_send=0.0)
    ref = _pump_all(plain, 1)
    assert out[t].t_received < ref[t2].t_received
    assert router._inflight == {} and router._hedges == {}
    return {"out": out, "ref": ref, "stats": router.stats,
            "engine": c.engine.stats}


def test_windowed_hedge_wins_on_straggler_and_takes_earlier_completion():
    twin(hedge_wins_on_straggler)


def hedge_loser_discarded(pkg):
    c, router = _served(pkg)
    base_dispatch = c.engine.stats.dispatches
    t = router.submit("tfs_peek", _x(), t_send=0.0)
    out = _pump_all(router, 1)
    assert set(out) == {t}
    assert out[t].node == "edge"
    assert router.stats.hedges_fired == 1
    assert router.stats.hedge_wins == 0
    assert c.engine.stats.dispatches == base_dispatch + 1
    assert c.engine.pending() == []
    assert router._inflight == {} and router._hedges == {}
    return {"out": out, "stats": router.stats, "engine": c.engine.stats}


def test_windowed_hedge_loser_discarded_before_dispatch():
    twin(hedge_loser_discarded)


def hedge_only_read_only(pkg):
    c, router = _served(pkg)
    t = router.submit("tfs_bump", _x(), t_send=0.0)
    out = _pump_all(router, 1)
    assert set(out) == {t}
    assert router.stats.hedges_fired == 0
    assert router.stats.hedges_suppressed == 1
    c.flush_replication()
    assert _count(pkg, c, "edge") == _count(pkg, c, "edge2") == 2.0
    return {"out": out, "stats": router.stats, "c": c}


def test_hedge_only_fires_for_read_only_handlers():
    twin(hedge_only_read_only)


def hedge_not_fired_when_window_beats_deadline(pkg):
    c, router = _served(pkg, window_ms=4.0, hedge_after_ms=30.0)
    t = router.submit("tfs_peek", _x(), t_send=0.0)
    out = _pump_all(router, 1)
    assert set(out) == {t}
    assert router.stats.hedges_fired == 0
    assert router.stats.hedges_suppressed == 0
    return {"out": out, "stats": router.stats}


def test_hedge_not_fired_when_window_beats_the_deadline():
    twin(hedge_not_fired_when_window_beats_deadline)


def hedge_deterministic_across_cadence(pkg):
    outs, stats = [], []
    for coarse in (False, True):
        c, router = _served(pkg, straggler=50.0)
        t = router.submit("tfs_peek", _x(), t_send=0.0)
        out = router.pump(math.inf) if coarse else _pump_all(router, 1)
        outs.append(out[t])
        stats.append((router.stats.hedges_fired, router.stats.hedge_wins))
    assert stats[0] == stats[1] == (1, 1)
    assert outs[0].t_received == outs[1].t_received
    assert outs[0].node == outs[1].node == "edge2"
    return {"outs": outs, "stats": stats}


def test_windowed_hedge_deterministic_across_pump_cadence():
    twin(hedge_deterministic_across_cadence)


def hedge_waits_for_partner_under_flush_on_full(pkg):
    c, router = _served(pkg, max_batch=8)
    t = router.submit("tfs_peek", _x(), t_send=0.0)
    assert router.pump(5.0) == {}
    assert router.stats.hedges_fired == 1
    assert router.pump(21.0) == {}
    assert len(c.engine.pending()) == 1
    out = _pump_all(router, 1)
    assert set(out) == {t}
    assert out[t].node == "edge"
    assert router.stats.hedge_wins == 0
    assert router._inflight == {} and router._hedges == {}
    return {"out": out, "stats": router.stats, "engine": c.engine.stats}


def test_hedge_waits_for_partner_under_flush_on_full():
    twin(hedge_waits_for_partner_under_flush_on_full)


def hedge_respects_session_consistency(pkg):
    c, router = _served(pkg)
    res = c.invoke("tfs_bump", "edge2", np.zeros((1,), np.float32))
    session = router._session("s")
    router._observe(session, "tfs_bump", res)
    t = router.submit("tfs_peek", _x(), t_send=0.0, session_id="s")
    assert router.pick("tfs_peek", session) == "edge2"
    out = _pump_all(router, 1)
    assert set(out) == {t}
    assert router.stats.hedges_fired == 0
    assert out[t].node == "edge2"
    assert float(np.asarray(out[t].output)[0]) == 2.0
    return {"res": res, "out": out, "stats": router.stats}


def test_hedge_respects_session_consistency():
    twin(hedge_respects_session_consistency)


def hedge_target_prefers_lowest_ewma(pkg):
    picks = []
    for ewma, expect in (({}, "edge2"),
                         ({"edge2": 80.0, "cloud": 2.0}, "cloud"),
                         ({"edge2": 3.0, "cloud": 90.0}, "edge2")):
        c = _cluster(pkg)
        c.deploy(pkg.get_function("tfs_bump"), ["edge", "edge2", "cloud"])
        c.deploy(pkg.get_function("tfs_peek"), ["edge", "edge2", "cloud"])
        c.invoke("tfs_bump", "edge", np.zeros((1,), np.float32))
        c.flush_replication()
        c.engine.configure(window_ms=20.0)
        router = pkg.Router(c, hedge_after_ms=5.0)
        router.stats.ewma_ms.update(ewma)
        t = router.submit("tfs_peek", _x(), t_send=0.0)
        assert router.pump(5.0) == {}
        assert router.stats.hedges_fired == 1
        queued = {p["ticket"]: p["node"] for p in c.engine.pending()}
        hedge_nodes = [nd for tk, nd in queued.items() if tk != t]
        assert hedge_nodes == [expect], (ewma, hedge_nodes)
        out = _pump_all(router, 1)
        assert set(out) == {t}
        picks.append({"hedge": hedge_nodes, "out": out,
                      "stats": router.stats})
    return picks


def test_hedge_target_prefers_lowest_ewma_replica():
    twin(hedge_target_prefers_lowest_ewma)


def completions_feed_ewma(pkg):
    c = _cluster(pkg)
    _deploy_both(pkg, c)
    router = pkg.Router(c)
    r1 = router.invoke("tfs_peek", _x(), t_send=0.0)
    assert router.stats.ewma_ms[r1.node] == pytest.approx(r1.response_ms)
    r2 = router.invoke("tfs_peek", _x(), t_send=10.0)
    a = pkg.Router.EWMA_ALPHA
    assert router.stats.ewma_ms[r2.node] == pytest.approx(
        a * r2.response_ms + (1 - a) * r1.response_ms)
    c.engine.configure(window_ms=5.0)
    t = router.submit("tfs_peek", _x(), t_send=20.0)
    out = _pump_all(router, 1)
    assert router.stats.ewma_ms[out[t].node] == pytest.approx(
        a * out[t].response_ms
        + (1 - a) * (a * r2.response_ms + (1 - a) * r1.response_ms))
    return {"r1": r1, "r2": r2, "out": out, "stats": router.stats}


def test_completions_feed_per_replica_latency_ewma():
    twin(completions_feed_ewma)


# ---------------------------------------------------------------------------
# next_deadline
# ---------------------------------------------------------------------------

def engine_next_deadline_monotone(pkg):
    c = _cluster(pkg)
    _deploy_both(pkg, c)
    c.engine.configure(window_ms=10.0)
    assert c.engine.next_deadline() is None
    c.engine.submit("tfs_peek", "edge", _x(), t_send=0.0)
    d1 = c.engine.next_deadline()
    assert d1 is not None
    c.engine.submit("tfs_peek", "edge", _x(), t_send=2.0)
    assert c.engine.next_deadline() == d1
    c.engine.submit("tfs_peek", "edge", _x(), t_send=50.0)
    assert c.engine.next_deadline() == d1
    first = c.engine.pump(d1)
    d2 = c.engine.next_deadline()
    assert d2 is not None and d2 > d1
    second = c.engine.pump(d2)
    assert c.engine.next_deadline() is None
    assert c.engine.pending() == []
    return {"d": [d1, d2], "first": first, "second": second,
            "stats": c.engine.stats}


def test_engine_next_deadline_monotone_across_pumps():
    twin(engine_next_deadline_monotone)


def router_next_deadline_covers_hedges(pkg):
    c, router = _served(pkg)
    router.submit("tfs_peek", _x(), t_send=0.0)
    window_close = c.engine.next_deadline()
    d1 = router.next_deadline()
    assert d1 == pytest.approx(5.0)
    assert d1 < window_close
    router.pump(d1)
    d2 = router.next_deadline()
    assert d2 == window_close
    router.pump(d2)
    d3 = router.next_deadline()
    assert d3 is None or d3 > d2
    out = _pump_all(router, 1)
    assert router.next_deadline() is None
    return {"d": [window_close, d1, d2, d3], "out": out,
            "stats": router.stats}


def test_router_next_deadline_covers_hedge_fire_times():
    twin(router_next_deadline_covers_hedges)


def unclocked_pump_drains(pkg):
    c = _cluster(pkg)
    _deploy_both(pkg, c)
    c.engine.configure(window_ms=5.0)
    t = c.engine.submit("tfs_peek", "edge", _x(), t_send=0.0)
    out = c.engine.pump()
    assert set(out) == {t}
    return out


def test_unclocked_pump_without_argument_still_drains_everything():
    twin(unclocked_pump_drains)


# ---------------------------------------------------------------------------
# the wall-clock server: the reference's properties on the port
# ---------------------------------------------------------------------------

def _port_cluster():
    c = _cluster(PORT)
    _deploy_both(PORT, c)
    return c


def test_faas_server_smoke_bounded_and_deterministic():
    """Every future resolves within the bound, the counter advances once a
    request, and the session holds reads-your-writes."""
    FaasServer = PORT.server.FaasServer
    c = _port_cluster()
    for b in (1, 8, 64):
        c.invoke_batch("tfs_bump", "edge", [_x()] * b)
    seeded = _count(PORT, c, "edge")
    n = 12
    t0 = time.perf_counter()
    with FaasServer(c, window_ms=5.0, time_scale=200.0) as srv:
        futs = [srv.submit("tfs_bump", _x(), session_id="s")
                for _ in range(n)]
        outs = [f.result(timeout=30.0) for f in futs]
    assert time.perf_counter() - t0 < 30.0
    assert all(f.done() for f in futs)
    assert srv.stats.served == n and srv.stats.lost == 0
    vals = sorted(float(np.asarray(r.output)[0]) for r in outs)
    assert vals == [seeded + 1.0 + i for i in range(n)]
    c.flush_replication()
    assert _count(PORT, c, "edge") == seeded + n
    session = srv.router.sessions["s"]
    assert session.can_read_from(np.asarray(c.store_of("tfskg", "edge").vv))
    assert all(r.response_ms <= 1.0 + 5.0 + 1.0 for r in outs)


def test_faas_server_submit_requires_start():
    FaasServer = PORT.server.FaasServer
    c = _port_cluster()
    srv = FaasServer(c, window_ms=5.0)
    with pytest.raises(RuntimeError, match="not started"):
        srv.submit("tfs_peek", _x())
    with pytest.raises(ValueError, match="window_ms"):
        FaasServer(c, window_ms=None)


def test_faas_server_stop_drains_queued_windows():
    FaasServer = PORT.server.FaasServer
    c = _port_cluster()
    srv = FaasServer(c, window_ms=10_000.0, time_scale=1.0).start()
    fut = srv.submit("tfs_peek", _x())
    srv.stop(drain=True)
    assert fut.done()
    assert float(np.asarray(fut.result(timeout=1.0).output)[0]) >= 1.0
    assert c.engine.clock is None


def test_faas_server_lost_ticket_fails_future():
    FaasServer, RequestLost = PORT.server.FaasServer, PORT.server.RequestLost
    c = _port_cluster()
    srv = FaasServer(c, window_ms=10_000.0, time_scale=1.0).start()
    fut = srv.submit("tfs_peek", _x())
    with srv._cond:
        assert c.engine.discard(fut.ticket)
        srv._cond.notify_all()
    srv.stop(drain=True)
    with pytest.raises(RequestLost):
        fut.result(timeout=1.0)
    assert srv.stats.lost == 1


def test_faas_server_node_death_mid_serving_reroutes_or_fails_fast():
    """A replica killed while the server is live: every request completes
    at the survivor or fails fast, and the accounting balances."""
    FaasServer, RequestLost = PORT.server.FaasServer, PORT.server.RequestLost
    c = _port_cluster()
    m = PORT.runtime.ElasticMembership(c)
    inj = PORT.runtime.FailureInjector(c, membership=m)
    for b in (1, 8, 64):
        c.invoke_batch("tfs_bump", "edge", [_x()] * b)
    n = 16
    t0 = time.perf_counter()
    with FaasServer(c, window_ms=5.0, time_scale=200.0, membership=m) as srv:
        futs = [srv.submit("tfs_bump", _x()) for _ in range(n)]
        inj.kill_node("edge2")
        served = lost = 0
        for f in futs:
            try:
                f.result(timeout=30.0)
                served += 1
            except RequestLost:
                lost += 1
    assert time.perf_counter() - t0 < 30.0
    assert all(f.done() for f in futs)
    assert served + lost == n
    assert srv.stats.served == served and srv.stats.lost == lost
    assert served == n and lost == 0
    c.flush_replication(1e12)
    assert m.state["edge2"] == "dead"


def test_faas_server_submit_stop_race_under_injected_death():
    """Client threads hammer submit while a node dies and the server stops:
    every future obtained settles, and nothing is stranded."""
    FaasServer, RequestLost = PORT.server.FaasServer, PORT.server.RequestLost
    c = _port_cluster()
    m = PORT.runtime.ElasticMembership(c)
    inj = PORT.runtime.FailureInjector(c, membership=m)
    for b in (1, 8):
        c.invoke_batch("tfs_bump", "edge", [_x()] * b)
    srv = FaasServer(c, window_ms=5.0, time_scale=200.0, max_batch=1,
                     membership=m).start()
    futs, submit_refused = [], []
    flock = threading.Lock()
    stop_submitting = threading.Event()

    def client():
        while not stop_submitting.is_set():
            try:
                f = srv.submit("tfs_bump", _x())
            except RuntimeError:
                submit_refused.append(1)
                return
            except Exception:
                continue
            with flock:
                futs.append(f)

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    inj.kill_node("edge2")
    time.sleep(0.05)
    stop_submitting.set()
    srv.stop(drain=True)
    for t in threads:
        t.join(timeout=10.0)
    assert not any(t.is_alive() for t in threads)
    served = lost = 0
    for f in futs:
        assert f.done()
        try:
            f.result(timeout=0.0)
            served += 1
        except (RequestLost, RuntimeError):
            lost += 1
    assert served + lost == len(futs)
    assert srv.stats.submitted == len(futs)
    assert srv.stats.served == served
    assert not srv._orphans
    assert not srv._futures
