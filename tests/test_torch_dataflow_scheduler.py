"""Twin of ``tests/test_dataflow_scheduler.py``: the per-frame dataflow
scheduler.  A straggling store node delays only its own frames (fast
windows stream out through ``engine.on_ready``; wall clock, so asserted on
the port with the reference's margins); ``wave_barrier`` restores
cycle-end delivery; every store node executes in seal order
(``trace_folds``/``fold_trace``) with the parallel scheduler's results
equal to the serial one's; and a request moved twice off dead nodes is
counted once.  The deterministic scenarios run through both packages and
the port's seal order, results and stats equal the reference's."""
import time

import jax
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from torch_parity import PKGS, PORT, record, twin
from torch_parity import port_lockdep  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")

_NODES = ["edge", "edge2", "edge3"]


def _register(pkg):
    fn = pkg.enoki_function

    @fn(name="tdfs_leaf", keygroups=[], codec_width=4)
    def leaf(kv, x):
        return x[:2]

    @fn(name="tdfs_parent", keygroups=[], calls=["tdfs_sink"], codec_width=4)
    def parent(kv, x):
        return x[:2]

    @fn(name="tdfs_sink", keygroups=["tdfskg"], codec_width=4)
    def sink(kv, x):
        cur, _ = kv.get("n")
        kv.set("n", cur + 1.0)
        return x[:1]


for _pkg in PKGS:
    _register(_pkg)


def _x(v=1.0):
    return np.full(4, v, np.float32)


def _leaf_cluster(pkg):
    c = pkg.Cluster({n: "edge" for n in _NODES}, measure_compute=False)
    c.deploy(pkg.get_function("tdfs_leaf"), _NODES,
             policy=pkg.Policy.REPLICATED)
    for n in _NODES:
        c.invoke("tdfs_leaf", n, _x())
    return c


def _slow_wrap(c, node, fn, sleep_s):
    """Slow one lane for real: wrap the node's batched handler in a
    sleep (``set_compute_ms`` is virtual only)."""
    nd = c.nodes[node]
    orig = nd.batched_handlers[fn]
    done = [None]

    def slow(*a, **kw):
        time.sleep(sleep_s)
        out = orig(*a, **kw)
        done[0] = time.perf_counter()
        return out

    nd.batched_handlers[fn] = slow
    return done


def test_fast_nodes_stream_past_straggler():
    """One store node 10x+ slower: the fast nodes' windows are delivered
    (``on_ready``) before the slow node's handler has finished."""
    c = _leaf_cluster(PORT)
    eng = c.engine
    slow_done = _slow_wrap(c, "edge3", "tdfs_leaf", sleep_s=0.25)
    deliveries = []
    eng.on_ready = lambda res: deliveries.append(
        (time.perf_counter(), set(res)))
    eng.configure(window_ms=5.0).use_workers(4)
    eng.min_parallel_requests = 1
    tks = {n: eng.submit("tdfs_leaf", n, _x()) for n in _NODES}
    out = eng.pump(1e9)
    assert out == {}
    assert slow_done[0] is not None
    delivered = {}
    for stamp, tickets in deliveries:
        for t in tickets:
            delivered[t] = stamp
    assert set(delivered) == set(tks.values())
    for n in ("edge", "edge2"):
        assert delivered[tks[n]] < slow_done[0], \
            f"{n}'s window waited for the straggler"
    eng.close()


def wave_barrier_delivery(pkg):
    c = _leaf_cluster(pkg)
    eng = c.engine
    _slow_wrap(c, "edge3", "tdfs_leaf", sleep_s=0.05)
    fired = []
    eng.on_ready = lambda res: fired.append(set(res))
    eng.wave_barrier = True
    eng.configure(window_ms=5.0).use_workers(4)
    eng.min_parallel_requests = 1
    tks = {n: eng.submit("tdfs_leaf", n, _x()) for n in _NODES}
    out = eng.pump(1e9)
    assert fired == []
    assert set(out) == set(tks.values())
    eng.close()
    return {"out": out, "stats": eng.stats}


def test_wave_barrier_restores_cycle_end_delivery():
    twin(wave_barrier_delivery)


# ---------------------------------------------------------------------------
# property: dispatch order respects per-store-node seal order, both packages
# ---------------------------------------------------------------------------

def _traced_cluster(pkg, workers):
    c = pkg.Cluster({n: "edge" for n in _NODES}, measure_compute=False)
    c.deploy(pkg.get_function("tdfs_sink"), _NODES,
             policy=pkg.Policy.REPLICATED)
    c.deploy(pkg.get_function("tdfs_parent"), _NODES,
             policy=pkg.Policy.REPLICATED)
    c.engine.configure(window_ms=5.0)
    if workers:
        c.engine.use_workers(workers)
        c.engine.min_parallel_requests = 1
    c.engine.trace_folds = True
    return c


_TRACED = {}


def _get_traced(pkg, workers):
    if (pkg.name, workers) not in _TRACED:
        _TRACED[(pkg.name, workers)] = _traced_cluster(pkg, workers)
    return _TRACED[(pkg.name, workers)]


def fold_order(pkg, plan):
    outs, traces = {}, {}
    for workers in (None, 4):
        eng = _get_traced(pkg, workers).engine
        eng.fold_trace.clear()
        tickets = []
        for i, (node, k) in enumerate(plan):
            for j in range(k):
                tickets.append(eng.submit("tdfs_parent", node,
                                          _x(float(i + j)), t_send=float(i)))
        res = eng.pump(1e9)
        assert set(res) == set(tickets)
        last = {}
        for key, seq in eng.fold_trace:
            assert last.get(key, -1) < seq, \
                f"lane {key!r} executed seq {seq} after {last[key]}"
            last[key] = seq
        outs[workers] = [res[t] for t in tickets]
        traces[workers] = [tuple(e) for e in eng.fold_trace]
    for a, b in zip(record(outs[None]), record(outs[4])):
        np.testing.assert_array_equal(a["output"], b["output"])
    return {"serial": outs[None], "parallel": outs[4],
            "serial_trace": traces[None]}


@settings(max_examples=8, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(_NODES), st.integers(1, 3)),
                min_size=1, max_size=5))
def test_fold_order_respects_per_store_seal_order(plan):
    """Per store node, tasks execute in seal order, the parallel
    scheduler's results equal the serial one's, and the port's seal order
    and results equal the reference's on the same plan."""
    twin(fold_order, plan)


# ---------------------------------------------------------------------------
# reroute accounting
# ---------------------------------------------------------------------------

def reroute_counted_once(pkg):
    c = _leaf_cluster(pkg)
    eng = c.engine
    eng.configure(window_ms=50.0)
    base = eng.stats.reroutes
    tks = [eng.submit("tdfs_leaf", "edge", _x(float(i)), t_send=0.0)
           for i in range(3)]
    c.naming.mark_dead("edge")
    eng.pump(0.0)
    assert eng.stats.reroutes - base == 3
    c.naming.mark_dead("edge2")
    out = eng.pump(1e9)
    assert set(out) == set(tks)
    assert all(out[t].node == "edge3" for t in tks)
    assert eng.stats.reroutes - base == 3
    assert eng.stats.dropped_dead == 0
    return {"out": out, "stats": eng.stats}


def test_reroute_counted_once_per_request():
    twin(reroute_counted_once)
