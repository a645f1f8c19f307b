"""Twin of ``tests/test_router_session.py``: hedging never double-applies
a write (the read-only gate), session tokens observe the STORE node's clock
under remote placements, ``Router.pick`` resolves placements before
redirecting, and the batched submit/pump/flush path folds results into
sessions — each scenario through both packages, with the reference's
assertions on each, and the port's results, session requirements, router
and engine stats and replicas equal to the reference's bit for bit."""
import jax
import numpy as np

from torch_parity import PKGS, twin
from torch_parity import port_lockdep  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")


def _register(pkg):
    fn, xp = pkg.enoki_function, pkg.xp

    @fn(name="trs_counter", keygroups=["trscnt"], codec_width=4)
    def counter(kv, x):
        cur, found = kv.get("c")
        new = xp.where(found, cur[0] + 1.0, 1.0)
        kv.set("c", xp.vec([new, 0.0, 0.0, 0.0], x))
        return xp.vec([new], x)

    @fn(name="trs_peek", keygroups=["trscnt"], codec_width=4)
    def peek(kv, x):
        cur, found = kv.get("c")
        return cur[:1]


for _pkg in PKGS:
    _register(_pkg)


def _cluster(pkg):
    return pkg.Cluster({"edge": "edge", "edge2": "edge", "cloud": "cloud"},
                       measure_compute=False)


def _zero():
    return np.zeros((1,), np.float32)


def _count(pkg, c, node):
    contents = pkg.store_contents(c.nodes[node].stores["trscnt"])
    return list(contents.values())[0][2][0] if contents else 0.0


def _out(r):
    return float(np.asarray(r.output)[0])


def _requirement(session):
    return np.asarray(session.requirement())


# ---------------------------------------------------------------------------
# hedging vs mutating handlers
# ---------------------------------------------------------------------------

def hedge_on_mutating_counter(pkg):
    c_hedged, c_plain = _cluster(pkg), _cluster(pkg)
    for c in (c_hedged, c_plain):
        c.deploy(pkg.get_function("trs_counter"), ["edge", "edge2"],
                 policy=pkg.Policy.REPLICATED)
    hedged = pkg.Router(c_hedged, hedge_after_ms=0.0)
    r = hedged.invoke("trs_counter", _zero())
    plain = pkg.Router(c_plain)
    r_plain = plain.invoke("trs_counter", _zero())
    assert _out(r) == _out(r_plain) == 1.0
    assert hedged.stats.hedges_suppressed == 1
    assert hedged.stats.hedges_fired == 0
    c_hedged.flush_replication()
    c_plain.flush_replication()
    for node in ("edge", "edge2"):
        assert _count(pkg, c_hedged, node) == _count(pkg, c_plain, node) == 1.0
    return {"r": r, "r_plain": r_plain, "stats": hedged.stats,
            "c": c_hedged}


def test_hedge_on_mutating_counter_does_not_change_count():
    twin(hedge_on_mutating_counter)


def hedge_fires_for_read_only(pkg):
    c = _cluster(pkg)
    for fn in ("trs_counter", "trs_peek"):
        c.deploy(pkg.get_function(fn), ["edge", "edge2"],
                 policy=pkg.Policy.REPLICATED)
    assert c.is_read_only("trs_peek")
    assert not c.is_read_only("trs_counter")
    router = pkg.Router(c, hedge_after_ms=0.0)
    a = router.invoke("trs_counter", _zero())
    b = router.invoke("trs_peek", _zero())
    assert router.stats.hedges_fired == 1
    assert router.stats.hedges_suppressed == 1
    c.flush_replication()
    assert _count(pkg, c, "edge") == _count(pkg, c, "edge2") == 1.0
    return {"a": a, "b": b, "stats": router.stats, "c": c}


def test_hedge_still_fires_for_read_only_handlers():
    twin(hedge_fires_for_read_only)


# ---------------------------------------------------------------------------
# session clocks under remote placements
# ---------------------------------------------------------------------------

def reads_your_writes_under_cloud_central(pkg):
    c = _cluster(pkg)
    c.deploy(pkg.get_function("trs_counter"), ["edge", "edge2"],
             policy=pkg.Policy.CLOUD_CENTRAL, owner="cloud")
    router = pkg.Router(c)
    r = router.invoke("trs_counter", _zero(), session_id="s1")
    assert r.node == "edge"
    session = router.sessions["s1"]
    cloud, edge = c.nodes["cloud"], c.nodes["edge"]
    req = _requirement(session)
    assert int(cloud.clock) > 0
    assert int(edge.clock) == 0
    assert req[edge.node_id] == int(cloud.clock)
    assert req.sum() == req[edge.node_id]
    assert session.can_read_from(np.asarray(c.store_of("trscnt", "cloud").vv))
    r2 = router.invoke("trs_counter", _zero(), session_id="s1",
                       t_send=r.t_received)
    assert _out(r2) == 2.0
    return {"r": r, "r2": r2, "req": req, "c": c, "stats": router.stats}


def test_session_reads_your_writes_under_cloud_central():
    twin(reads_your_writes_under_cloud_central)


def session_observes_store_node_under_peer_fetch(pkg):
    c = _cluster(pkg)
    c.deploy(pkg.get_function("trs_counter"), ["edge"],
             policy=pkg.Policy.PEER_FETCH, owner="edge2")
    router = pkg.Router(c)
    r = router.invoke("trs_counter", _zero(), session_id="s")
    assert r.node == "edge"
    owner = c.nodes["edge2"]
    req = _requirement(router.sessions["s"])
    assert int(owner.clock) > 0
    assert req[c.nodes["edge"].node_id] == int(owner.clock)
    assert router.sessions["s"].can_read_from(
        np.asarray(c.store_of("trscnt", "edge2").vv))
    return {"r": r, "req": req, "c": c}


def test_session_observes_store_node_under_peer_fetch():
    twin(session_observes_store_node_under_peer_fetch)


# ---------------------------------------------------------------------------
# session routing under remote placements (Router.pick)
# ---------------------------------------------------------------------------

def pick_under_peer_fetch(pkg):
    c = _cluster(pkg)
    c.deploy(pkg.get_function("trs_counter"), ["edge", "edge2"],
             policy=pkg.Policy.PEER_FETCH, owner="edge2")
    router = pkg.Router(c)
    r = router.invoke("trs_counter", _zero(), session_id="s")
    assert r.node == "edge"
    session = router.sessions["s"]
    assert router.pick("trs_counter", session) == "edge"
    assert router.stats.redirects_for_consistency == 0
    r2 = router.invoke("trs_counter", _zero(), session_id="s",
                       t_send=r.t_received)
    assert r2.node == "edge"
    assert _out(r2) == 2.0
    return {"r": r, "r2": r2, "stats": router.stats, "c": c}


def test_pick_resolves_placement_no_bogus_redirect_under_peer_fetch():
    twin(pick_under_peer_fetch)


def pick_under_cloud_central(pkg):
    c = _cluster(pkg)
    c.deploy(pkg.get_function("trs_counter"), ["edge", "edge2"],
             policy=pkg.Policy.CLOUD_CENTRAL, owner="cloud")
    router = pkg.Router(c)
    router.invoke("trs_counter", _zero(), session_id="s")
    session = router.sessions["s"]
    assert _requirement(session).sum() > 0
    assert router.pick("trs_counter", session) == "edge"
    assert router.stats.redirects_for_consistency == 0
    return {"req": _requirement(session), "stats": router.stats}


def test_pick_resolves_placement_under_cloud_central():
    twin(pick_under_cloud_central)


def pick_redirects_under_replicated(pkg):
    c = _cluster(pkg)
    c.deploy(pkg.get_function("trs_counter"), ["edge", "edge2"],
             policy=pkg.Policy.REPLICATED)
    router = pkg.Router(c)
    res = c.invoke("trs_counter", "edge2", _zero())
    session = router._session("s")
    router._observe(session, "trs_counter", res)
    assert router.pick("trs_counter", session) == "edge2"
    assert router.stats.redirects_for_consistency == 1
    c.flush_replication()
    assert router.pick("trs_counter", session) == "edge"
    return {"res": res, "req": _requirement(session), "stats": router.stats,
            "c": c}


def test_pick_still_redirects_to_fresher_replica_under_replicated():
    twin(pick_redirects_under_replicated)


# ---------------------------------------------------------------------------
# batched router path
# ---------------------------------------------------------------------------

def _counter_cluster(pkg, nodes=("edge", "edge2")):
    c = _cluster(pkg)
    c.deploy(pkg.get_function("trs_counter"), list(nodes),
             policy=pkg.Policy.REPLICATED)
    return c


def submit_pump_folds_sessions(pkg):
    c = _counter_cluster(pkg)
    c.engine.configure(window_ms=5.0)
    router = pkg.Router(c)
    tks = [router.submit("trs_counter", _zero(), t_send=float(i),
                         session_id="s1") for i in range(3)]
    assert router.pump(0.0) == {}
    out = router.pump(1000.0)
    assert set(out) == set(tks)
    assert sorted(_out(out[t]) for t in tks) == [1.0, 2.0, 3.0]
    session = router.sessions["s1"]
    edge = c.nodes["edge"]
    assert _requirement(session)[edge.node_id] == int(edge.clock) > 0
    assert session.can_read_from(np.asarray(c.store_of("trscnt", "edge").vv))
    assert router._inflight == {}
    return {"out": out, "req": _requirement(session), "c": c,
            "stats": router.stats, "engine": c.engine.stats}


def test_router_submit_pump_folds_sessions():
    twin(submit_pump_folds_sessions)


def two_routers_sharing_engine(pkg):
    c = _counter_cluster(pkg, ("edge",))
    r1, r2 = pkg.Router(c), pkg.Router(c)
    ta = r1.submit("trs_counter", _zero(), session_id="a")
    tb = r2.submit("trs_counter", _zero(), t_send=1.0, session_id="b")
    out1 = r1.flush()
    assert set(out1) == {ta}
    out2 = r2.pump(0.0)
    assert set(out2) == {tb}
    assert _requirement(r1.sessions["a"]).sum() > 0
    assert _requirement(r2.sessions["b"]).sum() > 0
    assert r1._inflight == {} and r2._inflight == {}
    return {"out1": out1, "out2": out2,
            "a": _requirement(r1.sessions["a"]),
            "b": _requirement(r2.sessions["b"])}


def test_two_routers_sharing_engine_keep_their_tickets():
    twin(two_routers_sharing_engine)


def inflight_pruned_after_discard(pkg):
    c = _counter_cluster(pkg, ("edge",))
    router = pkg.Router(c)
    t = router.submit("trs_counter", _zero(), session_id="s")
    assert c.engine.discard(t)
    assert router.flush() == {}
    assert router._inflight == {}
    return {"stats": router.stats, "engine": c.engine.stats}


def test_inflight_pruned_after_discard():
    twin(inflight_pruned_after_discard)


def router_flush_drains_engine(pkg):
    c = _counter_cluster(pkg, ("edge",))
    router = pkg.Router(c)
    t1 = router.submit("trs_counter", _zero(), session_id="a")
    t2 = router.submit("trs_counter", _zero(), t_send=1.0, session_id="b")
    out = router.flush()
    assert set(out) == {t1, t2}
    for sid in ("a", "b"):
        assert _requirement(router.sessions[sid]).sum() > 0
    return {"out": out, "a": _requirement(router.sessions["a"]),
            "b": _requirement(router.sessions["b"])}


def test_router_flush_drains_engine():
    twin(router_flush_drains_engine)
