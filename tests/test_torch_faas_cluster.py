"""Twin of ``tests/test_faas_cluster.py``: Listing 1's semantics, warm
handlers, placement latency (fig 3), replication staleness (fig 6),
peer fetch, router failover, a keygroup restored from a peer and the
staleness ``WriteLog`` — each scenario through both packages with the
reference's assertions on each, and the port's results (every timeline
field), replicas, clocks and stats equal to the reference's bit for bit."""
import jax
import numpy as np
import pytest

from torch_parity import PKGS, twin
from torch_parity import port_lockdep  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")


def _register(pkg):
    fn, xp = pkg.enoki_function, pkg.xp

    @fn(name="tfc_counter", keygroups=["tfccnt"], codec_width=4)
    def counter(kv, x):
        cur, found = kv.get("count")
        new = xp.where(found, cur[0] + 1.0, 1.0)
        kv.set("count", xp.vec([new, 0.0, 0.0, 0.0], x))
        return xp.vec([new], x)

    @fn(name="tfc_movavg", keygroups=["tfcavg"], codec_width=16)
    def moving_average(kv, x):
        """The paper's §4.1 function: 4 kv ops an invocation."""
        ptr, found = kv.get("ptr")
        idx = xp.where(found, ptr[0], 0.0)
        kv.set("v", xp.cat([xp.atleast_1d(x)[:1], xp.zeros(15, x)]))
        window, _ = kv.scan(["v"])
        kv.set("ptr", xp.vec([idx + 1.0], x))
        return xp.vec([window[:, 0].mean()], x)


for _pkg in PKGS:
    _register(_pkg)


def _cluster(pkg):
    return pkg.Cluster({"edge": "edge", "edge2": "edge", "cloud": "cloud"},
                       measure_compute=False)


def _zero():
    return np.zeros((1,), np.float32)


def _out(r):
    return float(np.asarray(r.output)[0])


def listing1_semantics(pkg):
    c = _cluster(pkg)
    c.deploy(pkg.get_function("tfc_counter"), ["edge"])
    r1 = c.invoke("tfc_counter", "edge", _zero())
    r2 = c.invoke("tfc_counter", "edge", _zero(), t_send=r1.t_received)
    assert _out(r1) == 1.0
    assert _out(r2) == 2.0, "state persists across calls"
    return {"r": [r1, r2], "c": c}


def test_listing1_semantics():
    twin(listing1_semantics)


def warm_start_no_recompile(pkg):
    c = _cluster(pkg)
    c.deploy(pkg.get_function("tfc_counter"), ["edge"])
    h1 = c.nodes["edge"].handlers["tfc_counter"]
    r = c.invoke("tfc_counter", "edge", _zero())
    assert c.nodes["edge"].handlers["tfc_counter"] is h1
    return r


def test_warm_start_no_recompile():
    twin(warm_start_no_recompile)


def fig3_cloud_store_adds_latency(pkg):
    edge, cloud = _cluster(pkg), _cluster(pkg)
    edge.deploy(pkg.get_function("tfc_movavg"), ["edge"],
                policy=pkg.Policy.REPLICATED)
    cloud.deploy(pkg.get_function("tfc_movavg"), ["edge"],
                 policy=pkg.Policy.CLOUD_CENTRAL, owner="cloud")
    r_edge = edge.invoke("tfc_movavg", "edge", np.ones((1,), np.float32))
    r_cloud = cloud.invoke("tfc_movavg", "edge", np.ones((1,), np.float32))
    delta = r_cloud.response_ms - r_edge.response_ms
    assert len(r_cloud.kv_ops) == 4
    assert 195.0 <= delta <= 215.0, f"expected about +200 ms, got {delta}"
    return {"edge": r_edge, "cloud": r_cloud}


def test_fig3_cloud_store_adds_latency():
    twin(fig3_cloud_store_adds_latency)


def fig6_replication_staleness(pkg):
    c = _cluster(pkg)
    c.deploy(pkg.get_function("tfc_counter"), ["edge", "edge2"],
             policy=pkg.Policy.REPLICATED)
    w = c.invoke("tfc_counter", "edge", _zero())
    r_early = c.invoke("tfc_counter", "edge2", _zero(),
                       t_send=w.t_applied - 9.0)
    assert _out(r_early) == 1.0
    r_late = c.invoke("tfc_counter", "edge2", _zero(),
                      t_send=w.t_applied + 50.0)
    assert _out(r_late) == 2.0
    return {"r": [w, r_early, r_late], "c": c}


def test_fig6_replication_staleness():
    twin(fig6_replication_staleness)


def peer_fetch_pays_rtt(pkg):
    c = _cluster(pkg)
    c.deploy(pkg.get_function("tfc_counter"), ["edge", "edge2"],
             policy=pkg.Policy.PEER_FETCH, owner="edge")
    r_local = c.invoke("tfc_counter", "edge", _zero())
    r_remote = c.invoke("tfc_counter", "edge2", _zero(),
                        t_send=r_local.t_received)
    assert r_remote.response_ms > r_local.response_ms + 30.0
    return {"r": [r_local, r_remote], "c": c}


def test_peer_fetch_pays_rtt_on_read():
    twin(peer_fetch_pays_rtt)


def router_failover_and_session(pkg):
    c = _cluster(pkg)
    c.deploy(pkg.get_function("tfc_counter"), ["edge", "edge2"],
             policy=pkg.Policy.REPLICATED)
    router = pkg.Router(c, client="client")
    r1 = router.invoke("tfc_counter", _zero(), session_id="s1")
    assert r1.node == "edge"
    pkg.runtime.FailureInjector(c).kill_node("edge")
    r2 = router.invoke("tfc_counter", _zero(), session_id="s1",
                       t_send=r1.t_received)
    assert r2.node == "edge2", "router must fail over to the live replica"
    return {"r": [r1, r2], "stats": router.stats}


def test_router_failover_and_session():
    twin(router_failover_and_session)


def keygroup_restore_from_peer(pkg):
    c = _cluster(pkg)
    c.deploy(pkg.get_function("tfc_counter"), ["edge", "edge2"],
             policy=pkg.Policy.REPLICATED)
    c.invoke("tfc_counter", "edge", _zero())
    c.flush_replication()
    inj = pkg.runtime.FailureInjector(c)
    inj.lose_keygroup("edge2", "tfccnt")
    assert inj.restore_keygroup_from_peer("edge2", "tfccnt")
    r = c.invoke("tfc_counter", "edge2", _zero(), t_send=100.0)
    assert _out(r) == 2.0, "the restored replica holds the earlier state"
    return {"r": r, "c": c}


def test_keygroup_restore_from_peer():
    twin(keygroup_restore_from_peer)


def staleness_writelog(pkg):
    log = pkg.core.WriteLog()
    log.add(10.0, 1)
    log.add(20.0, 2)
    got = [log.staleness_of_read(25.0, 2), log.staleness_of_read(25.0, 1),
           log.latest_at(15.0)]
    assert got == [0.0, 5.0, 1]
    return {"got": got, "records": log.records}


def test_staleness_writelog():
    twin(staleness_writelog)


def writelog_out_of_order_adds(pkg):
    log = pkg.core.WriteLog()
    for t, p in [(20.0, 2), (5.0, 1), (35.0, 4), (28.0, 3)]:
        log.add(t, p)
    assert log.records == [(5.0, 1), (20.0, 2), (28.0, 3), (35.0, 4)]
    got = [log.latest_at(1.0), log.latest_at(30.0), log.latest_at(100.0),
           log.staleness_of_read(30.0, 1), log.staleness_of_read(40.0, 2),
           log.staleness_of_read(30.0, 3), log.staleness_of_read(19.0, 1)]
    assert got == [None, 3, 4, 10.0, 12.0, 0.0, 0.0]
    return {"got": got, "records": log.records}


def test_staleness_writelog_out_of_order_adds():
    twin(writelog_out_of_order_adds)


def writelog_non_comonotonic(pkg):
    log = pkg.core.WriteLog()
    for t, p in [(10.0, 5), (20.0, 3), (30.0, 6)]:
        log.add(t, p)
    got = [log.staleness_of_read(35.0, 3), log.staleness_of_read(35.0, 5),
           log.staleness_of_read(35.0, 6), log.latest_at(25.0)]
    assert got == [25.0, 5.0, 0.0, 3]
    return {"got": got, "records": log.records}


def test_staleness_writelog_non_comonotonic_feed_stays_exact():
    twin(writelog_non_comonotonic)
