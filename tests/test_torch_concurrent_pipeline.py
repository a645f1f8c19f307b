"""Twin of ``tests/test_concurrent_pipeline.py``: the parallel pump
(``use_workers``, one executor per store node) is invisible — ``workers=4``
gives the ticket→result map, stores and clocks of ``workers=1`` — in both
packages, and the port's maps, stores, clocks and stats equal the
reference's bit for bit.  The wall-clock scenarios (racing submitter
threads, asyncio clients, a cancelled future) assert the reference's
properties on the port, with the reference's margins.  The port's lockdep
is armed over every test, as ``tests/conftest.py`` arms the reference's
over this suite."""
import asyncio
import math
import threading
import time

import jax
import numpy as np
import pytest

from torch_parity import PKGS, PORT, record, result_of, twin
from torch_parity import port_lockdep  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")


def _register(pkg):
    fn = pkg.enoki_function

    @fn(name="tcp_mix", keygroups=["tcpkg"], codec_width=8)
    def mix(kv, x):
        cur, found = kv.get("acc")
        kv.set("acc", cur + x)
        return cur[:2] + x[:2]

    @fn(name="tcp_peek", keygroups=["tcpkg"], codec_width=8)
    def peek(kv, x):
        cur, found = kv.get("acc")
        return cur[:2]

    @fn(name="tcp_central", keygroups=["tcpcloudkg"], codec_width=8)
    def central(kv, x):
        cur, _ = kv.get("n")
        kv.set("n", cur + 1.0)
        return cur[:1]

    @fn(name="tcp_src", keygroups=[], calls=["tcp_sink"], codec_width=8)
    def src(kv, x):
        return x[:2]

    @fn(name="tcp_sink", keygroups=["tcpsinkkg"], codec_width=8)
    def sink(kv, x):
        cur, _ = kv.get("n")
        kv.set("n", cur + 1.0)
        return x[:1]

    @fn(name="tcp_nc_add", keygroups=["tcpnckg"], codec_width=8)
    def nc_add(kv, x):
        cur, _ = kv.get("n")
        kv.set("n", cur + 1.0)
        return x[:1]

    @fn(name="tcp_nc_mul", keygroups=["tcpnckg"], codec_width=8)
    def nc_mul(kv, x):
        cur, _ = kv.get("n")
        kv.set("n", cur * 2.0 + 1.0)
        return x[:1]

    @fn(name="tcp_call_add", keygroups=[], calls=["tcp_nc_add"],
        codec_width=8)
    def call_add(kv, x):
        return x[:1]

    @fn(name="tcp_call_mul", keygroups=[], calls=["tcp_nc_mul"],
        codec_width=8)
    def call_mul(kv, x):
        return x[:1]


for _pkg in PKGS:
    _register(_pkg)

NODES = {"edge": "edge", "edge2": "edge", "cloud": "cloud"}


def _x(v=1.0):
    return np.full(8, v, np.float32)


def _cluster(pkg):
    c = pkg.Cluster(NODES, measure_compute=False)
    rep = pkg.Policy.REPLICATED
    c.deploy(pkg.get_function("tcp_mix"), ["edge", "edge2"], policy=rep)
    c.deploy(pkg.get_function("tcp_peek"), ["edge", "edge2"], policy=rep)
    c.deploy(pkg.get_function("tcp_central"), ["edge"],
             policy=pkg.Policy.CLOUD_CENTRAL)
    c.deploy(pkg.get_function("tcp_sink"), ["edge"])
    c.deploy(pkg.get_function("tcp_src"), ["edge"])
    return c


def _submit_stream(c, n=24):
    tks = []
    for i in range(n):
        node = ("edge", "edge2")[i % 2]
        client = ("client", "client2")[(i // 2) % 2]
        fn = ("tcp_mix", "tcp_peek", "tcp_central", "tcp_src")[i % 4]
        at = "edge" if fn in ("tcp_central", "tcp_src") else node
        tks.append(c.engine.submit(fn, at, _x(float(i)), t_send=i * 0.7,
                                   client=client))
    return tks


def _key(r):
    """The reference's ``_result_key``, on host values."""
    d = result_of(r)
    return (d["output"].tobytes(), d["t_sent"], d["t_received"],
            d["t_applied"], d["response_ms"], d["node"], tuple(d["chain"]),
            tuple(d["kv_ops"]))


def _run_pipeline(pkg, workers):
    c = _cluster(pkg)
    c.engine = pkg.Engine(c, window_ms=5.0, workers=workers)
    c.engine.min_parallel_requests = 1
    tks = _submit_stream(c)
    out = {}
    out.update(c.engine.pump(8.0))
    out.update(c.engine.pump(16.0))
    out.update(c.engine.pump(math.inf))
    assert set(out) == set(tks)
    c.flush_replication()
    c.engine.close()
    return c, {t: _key(r) for t, r in out.items()}


def parallel_pump_matches_serial(pkg):
    c1, m1 = _run_pipeline(pkg, 1)
    c4, m4 = _run_pipeline(pkg, 4)
    assert m1 == m4
    for kg, nodes in (("tcpkg", ("edge", "edge2")), ("tcpcloudkg", ("cloud",)),
                      ("tcpsinkkg", ("edge",))):
        for nd in nodes:
            assert pkg.stores_equal(c1.nodes[nd].stores[kg],
                                    c4.nodes[nd].stores[kg]), (kg, nd)
    for nd in NODES:
        assert int(c1.nodes[nd].clock) == int(c4.nodes[nd].clock)
    assert (c1.engine.stats.replication_coalesced
            == c4.engine.stats.replication_coalesced)
    assert c1.engine.stats.dispatches == c4.engine.stats.dispatches
    return {"m1": m1, "c1": c1, "c4": c4, "s1": c1.engine.stats,
            "s4": c4.engine.stats}


def test_parallel_pump_matches_serial_results():
    twin(parallel_pump_matches_serial)


def wave_batches_fold_in_serial_order(pkg):
    stores, maps, clusters = [], [], []
    for workers in (1, 4):
        c = pkg.Cluster(NODES, measure_compute=False)
        central = pkg.Policy.CLOUD_CENTRAL
        c.deploy(pkg.get_function("tcp_nc_add"), ["edge2"], policy=central)
        c.deploy(pkg.get_function("tcp_nc_mul"), ["edge"], policy=central)
        c.deploy(pkg.get_function("tcp_call_add"), ["edge2"])
        c.deploy(pkg.get_function("tcp_call_mul"), ["edge"])
        c.deploy(pkg.get_function("tcp_mix"), ["edge", "edge2"])
        c.engine = pkg.Engine(c, window_ms=5.0, workers=workers)
        c.engine.min_parallel_requests = 1
        tks = [c.engine.submit("tcp_mix", "edge", _x(), t_send=0.0),
               c.engine.submit("tcp_call_add", "edge2", _x(), t_send=0.1),
               c.engine.submit("tcp_call_mul", "edge", _x(), t_send=0.2),
               c.engine.submit("tcp_mix", "edge2", _x(), t_send=0.3)]
        out = c.engine.pump(math.inf)
        assert set(out) == set(tks)
        c.engine.close()
        stores.append(pkg.store_contents(c.nodes["cloud"].stores["tcpnckg"]))
        maps.append({t: _key(r) for t, r in out.items()})
        clusters.append(c)
    assert stores[0] == stores[1]
    assert maps[0] == maps[1]
    return {"map": maps[0], "clusters": clusters}


def test_wave_batches_on_shared_store_fold_in_serial_order():
    twin(wave_batches_fold_in_serial_order)


def parallel_pump_flush_on_full(pkg):
    maps, stats = [], []
    for workers in (1, 4):
        c = _cluster(pkg)
        c.engine = pkg.Engine(c, window_ms=100.0, max_batch=4,
                              workers=workers)
        tks = [c.engine.submit("tcp_mix", ("edge", "edge2")[i % 2],
                               _x(float(i)), t_send=float(i))
               for i in range(10)]
        out = c.engine.pump(math.inf)
        assert set(out) == set(tks)
        assert c.engine.stats.auto_flushes == 2
        c.engine.close()
        maps.append({t: _key(r) for t, r in out.items()})
        stats.append(c.engine.stats)
    assert maps[0] == maps[1]
    return {"map": maps[0], "stats": stats}


def test_parallel_pump_flush_on_full_matches_serial():
    twin(parallel_pump_flush_on_full)


def next_deadline_progresses(pkg):
    c = _cluster(pkg)
    c.engine = pkg.Engine(c, window_ms=10.0, workers=4)
    c.engine.min_parallel_requests = 1
    c.set_compute_ms("edge", "tcp_peek", 40.0)
    router = pkg.Router(c, hedge_after_ms=4.0)
    tks = [router.submit("tcp_peek", _x(), t_send=i * 7.0) for i in range(6)]
    out, last, steps, horizon = {}, -math.inf, 0, []
    while (nd := router.next_deadline()) is not None:
        assert nd > last, f"horizon stalled at {nd}"
        last = nd
        horizon.append(nd)
        out.update(router.pump(nd))
        steps += 1
        assert steps < 64, "pump loop failed to terminate"
    out.update(router.pump(math.inf))
    assert len(out) == 6
    c.engine.close()
    return {"horizon": horizon, "out": [out[t] for t in tks],
            "router": router.stats, "engine": c.engine.stats}


def test_next_deadline_strictly_progresses_under_executor_pump():
    twin(next_deadline_progresses)


def stats_inc_exact(pkg):
    stats = pkg.EngineStats()
    n_threads, per_thread = 8, 500

    def bump():
        for _ in range(per_thread):
            stats.inc("submitted")
            stats.inc("requests_flushed", 2)

    threads = [threading.Thread(target=bump) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert stats.submitted == n_threads * per_thread
    assert stats.requests_flushed == 2 * n_threads * per_thread
    return stats


def test_stats_inc_is_exact_under_contention():
    twin(stats_inc_exact)


# ---------------------------------------------------------------------------
# wall clock: the reference's properties on the port
# ---------------------------------------------------------------------------

def _serve_cluster():
    c = PORT.Cluster(NODES, measure_compute=False)
    rep = PORT.Policy.REPLICATED
    c.deploy(PORT.get_function("tcp_mix"), ["edge", "edge2"], policy=rep)
    c.deploy(PORT.get_function("tcp_peek"), ["edge", "edge2"], policy=rep)
    x = _x()
    for b in (1, 8, 64):
        c.invoke_batch("tcp_mix", "edge", [x] * b)
        c.invoke_batch("tcp_peek", "edge", [x] * b)
    c.flush_replication()
    return c


def _count(c, node):
    contents = PORT.store_contents(c.nodes[node].stores["tcpkg"])
    return list(contents.values())[0][2][0] if contents else 0.0


def test_server_stress_racing_submitters():
    """Racing submitter threads: every future resolves, no ticket lost or
    served twice, the counter advances once per write, the ledgers
    balance."""
    FaasServer = PORT.server.FaasServer
    c = _serve_cluster()
    seeded = _count(c, "edge")
    n_threads, per_thread = 6, 12
    total = n_threads * per_thread
    results, errors = [], []
    lock = threading.Lock()
    flushed_before = c.engine.stats.requests_flushed
    with FaasServer(c, window_ms=5.0, time_scale=200.0, workers=4) as srv:
        def client(cid):
            try:
                futs = [srv.submit("tcp_mix", _x(), session_id=f"s{cid}")
                        for _ in range(per_thread)]
                rs = [f.result(timeout=60.0) for f in futs]
            except BaseException as e:
                with lock:
                    errors.append(e)
                return
            with lock:
                results.extend((f.ticket, r) for f, r in zip(futs, rs))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_threads)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert time.perf_counter() - t0 < 60.0
    assert errors == []
    assert len(results) == total
    assert len({tk for tk, _ in results}) == total
    c.flush_replication()
    assert _count(c, "edge") == _count(c, "edge2") == seeded + total
    assert srv.stats.submitted == total
    assert srv.stats.served == total
    assert srv.stats.lost == 0
    assert srv.router.stats.requests == total
    assert c.engine.stats.requests_flushed - flushed_before == total
    eng = c.engine.stats
    assert eng.submitted == eng.requests_flushed + eng.dropped_dead
    assert eng.reroutes == 0
    assert eng.dropped_dead == 0
    assert srv.router.stats.ewma_ms
    assert all(v > 0 for v in srv.router.stats.ewma_ms.values())


def test_asyncio_front_end_many_logical_clients():
    """Many logical clients on one event loop through ``async_submit``."""
    FaasServer = PORT.server.FaasServer
    serve_closed_loop_async = PORT.server.serve_closed_loop_async
    c = _serve_cluster()
    seeded = _count(c, "edge")
    n = 24

    async def drive(srv):
        r0 = await srv.async_submit("tcp_peek", _x())
        assert float(record(r0)["output"][0]) == seeded
        return await serve_closed_loop_async(
            srv, "tcp_mix", lambda i: _x(), n_requests=n, concurrency=8,
            timeout_s=60.0, session_prefix="ac")

    with FaasServer(c, window_ms=5.0, time_scale=200.0, workers=2) as srv:
        results = asyncio.run(drive(srv))
    assert len(results) == n
    assert srv.stats.lost == 0
    c.flush_replication()
    assert _count(c, "edge") == seeded + n
    assert srv.router.sessions["ac0"] is not None


def test_cancelled_future_does_not_kill_the_serving_loop():
    """A cancelled future (directly, or by an asyncio timeout) does not
    crash the serving thread when its result arrives."""
    FaasServer = PORT.server.FaasServer
    c = _serve_cluster()
    with FaasServer(c, window_ms=50.0, time_scale=50.0, workers=2) as srv:
        doomed = srv.submit("tcp_peek", _x())
        assert doomed.cancel()
        fut = srv.submit("tcp_peek", _x())
        assert fut.result(timeout=30.0) is not None

        async def impatient():
            try:
                await asyncio.wait_for(
                    srv.async_submit("tcp_peek", _x()), timeout=1e-4)
            except asyncio.TimeoutError:
                pass
        asyncio.run(impatient())
        assert srv.submit("tcp_peek", _x()).result(timeout=30.0) is not None
    assert srv.stats.lost == 0


def use_workers_validation(pkg):
    c = _cluster(pkg)
    with pytest.raises(ValueError, match="workers"):
        c.engine.use_workers(0)
    c.engine.use_workers(2)
    t = c.engine.submit("tcp_peek", "edge", _x())
    first = c.engine.flush()
    assert set(first) == {t}
    c.engine.close()
    c.engine.close()
    t2 = c.engine.submit("tcp_peek", "edge", _x())
    second = c.engine.flush()
    assert set(second) == {t2}
    c.engine.close()
    return {"first": first, "second": second, "stats": c.engine.stats}


def test_use_workers_validation_and_close_idempotent():
    twin(use_workers_validation)
