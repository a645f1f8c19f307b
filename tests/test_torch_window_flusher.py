"""Twin of ``tests/test_window_flusher.py``: arrival-time windows,
flush-on-full, pump draining only due windows, cross-node flush cycles,
cross-caller downstream coalescing, coalesced replication snapshots and
``Cluster._deliver_until``'s delivery order, each scenario through both
packages with the reference's assertions on each, and the port's record
(results, timelines, stores, clocks, engine and cluster stats) equal to
the reference's bit for bit."""
import math

import jax
import numpy as np
import pytest

import repro.core.cluster as ref_cluster_mod
import repro_torch.core.cluster as port_cluster_mod
from torch_parity import PKGS, REF, record, twin
from torch_parity import port_lockdep  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")


def _register(pkg):
    fn = pkg.enoki_function

    @fn(name="twf_mix", keygroups=["twfkg"], codec_width=8)
    def mix(kv, x):
        cur, found = kv.get("acc")
        kv.set("acc", cur + x)
        return cur[:2] + x[:2]

    @fn(name="twf_set", keygroups=["twfsetkg"], codec_width=4)
    def set_(kv, x):
        kv.set("v", x)
        return x[:1]

    @fn(name="twf_peek", keygroups=["twfkg"], codec_width=8)
    def peek(kv, x):
        cur, found = kv.get("acc")
        return cur[:2]

    @fn(name="twf_src_a", keygroups=[], calls=["twf_sink"], codec_width=4)
    def src_a(kv, x):
        return x[:2]

    @fn(name="twf_src_b", keygroups=[], calls=["twf_sink"], codec_width=4)
    def src_b(kv, x):
        return x[:2]

    @fn(name="twf_sink", keygroups=["twfsinkkg"], codec_width=4)
    def sink(kv, x):
        cur, _ = kv.get("n")
        kv.set("n", cur + 1.0)
        return x[:1]


for _pkg in PKGS:
    _register(_pkg)

KINDS = {"edge": "edge", "edge2": "edge", "cloud": "cloud"}


def _cluster(pkg, nodes=("edge", "edge2", "cloud")):
    return pkg.Cluster({n: KINDS[n] for n in nodes}, measure_compute=False)


def _x(v=1.0):
    return np.full(8, v, np.float32)


def _solo(pkg):
    solo = _cluster(pkg)
    solo.deploy(pkg.get_function("twf_mix"), ["edge"])
    return solo.invoke("twf_mix", "edge", _x(), t_send=0.0)


def _mix_cluster(pkg, **engine):
    c = _cluster(pkg)
    c.deploy(pkg.get_function("twf_mix"), ["edge"])
    c.engine.configure(**engine)
    return c


# ---------------------------------------------------------------------------
# window semantics
# ---------------------------------------------------------------------------

def request_never_waits_past_window_ms(pkg):
    r0 = _solo(pkg)
    c = _mix_cluster(pkg, window_ms=5.0)
    t1 = c.engine.submit("twf_mix", "edge", _x(), t_send=0.0)
    t2 = c.engine.submit("twf_mix", "edge", _x(), t_send=2.0)
    assert c.engine.pump(0.0) == {}
    out = c.engine.pump(1000.0)
    assert set(out) == {t1, t2}
    assert out[t1].response_ms == pytest.approx(r0.response_ms + 5.0)
    assert out[t2].response_ms < r0.response_ms + 5.0
    assert out[t2].response_ms > r0.response_ms
    assert out[t1].t_applied == pytest.approx(out[t2].t_applied)
    return {"r0": r0, "out": out, "stats": c.engine.stats}


def test_request_never_waits_past_window_ms():
    twin(request_never_waits_past_window_ms)


def full_bucket_flushes_early(pkg):
    c = _mix_cluster(pkg, window_ms=1000.0, max_batch=4)
    ts = [float(i) for i in range(4)]
    tks = [c.engine.submit("twf_mix", "edge", _x(i), t_send=t)
           for i, t in enumerate(ts)]
    assert c.engine.stats.auto_flushes == 1
    assert c.engine.pending() == []
    t5 = c.engine.submit("twf_mix", "edge", _x(9.0), t_send=4.0)
    assert [p["ticket"] for p in c.engine.pending()] == [t5]
    out = c.engine.pump(0.0)
    assert set(out) == set(tks)
    ref = _mix_cluster(pkg)
    bat = ref.invoke_batch("twf_mix", "edge", [_x(i) for i in range(4)],
                           t_sends=ts)
    for tk, b in zip(tks, bat):
        assert out[tk].t_received == b.t_received
        assert out[tk].response_ms == b.response_ms
        np.testing.assert_array_equal(record(out[tk])["output"],
                                      record(b)["output"])
    return {"out": out, "bat": bat, "stats": c.engine.stats}


def test_full_bucket_flushes_early():
    twin(full_bucket_flushes_early)


def auto_flush_validation_leaves_window_intact(pkg):
    c = _mix_cluster(pkg, window_ms=100.0, max_batch=2)
    t1 = c.engine.submit("not_deployed", "edge", _x())
    with pytest.raises(KeyError, match="not_deployed"):
        c.engine.submit("not_deployed", "edge", _x())
    assert len(c.engine.pending()) == 2
    assert c.engine.discard(t1)
    return {"pending": c.engine.pending(), "stats": c.engine.stats}


def test_auto_flush_validation_leaves_window_intact():
    twin(auto_flush_validation_leaves_window_intact)


def out_of_order_arrival_opens_its_own_window(pkg):
    r0 = _solo(pkg)
    c = _mix_cluster(pkg, window_ms=5.0)
    late = c.engine.submit("twf_mix", "edge", _x(), t_send=10.0)
    early = c.engine.submit("twf_mix", "edge", _x(), t_send=0.0)
    assert len(c.engine.pending()) == 2
    out = c.engine.pump(1000.0)
    assert out[early].response_ms == pytest.approx(r0.response_ms + 5.0)
    assert out[late].response_ms == pytest.approx(r0.response_ms + 5.0)
    return {"out": out, "stats": c.engine.stats}


def test_out_of_order_arrival_opens_its_own_window():
    twin(out_of_order_arrival_opens_its_own_window)


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_stateless_handlers_are_read_only_for_hedging(pkg):
    """An empty op trace is trivially safe to re-invoke, per handler."""
    assert pkg.handler_read_only([])
    assert pkg.handler_read_only([("get", 4), ("scan", 8)])
    assert not pkg.handler_read_only([("get", 4), ("set", 8)])


def read_only_gate_covers_downstream_calls(pkg):
    c = _cluster(pkg, ("edge", "cloud"))
    for fn in ("twf_sink", "twf_src_a", "twf_mix", "twf_peek"):
        c.deploy(pkg.get_function(fn), ["edge"])
    gate = {fn: c.is_read_only(fn)
            for fn in ("twf_src_a", "twf_sink", "twf_mix", "twf_peek")}
    assert gate == {"twf_src_a": False, "twf_sink": False, "twf_mix": False,
                    "twf_peek": True}
    return gate


def test_read_only_gate_covers_downstream_calls():
    twin(read_only_gate_covers_downstream_calls)


def pump_drains_only_due_windows(pkg):
    c = _mix_cluster(pkg, window_ms=5.0)
    early = c.engine.submit("twf_mix", "edge", _x(), t_send=0.0)
    late = c.engine.submit("twf_mix", "edge", _x(), t_send=100.0)
    assert len(c.engine.pending()) == 2
    out = c.engine.pump(50.0)
    assert set(out) == {early}
    assert [p["ticket"] for p in c.engine.pending()] == [late]
    out2 = c.engine.pump(math.inf)
    assert set(out2) == {late}
    assert c.engine.pending() == []
    assert c.engine.stats.deadline_flushes == 2
    return {"out": out, "out2": out2, "stats": c.engine.stats}


def test_pump_drains_only_due_windows():
    twin(pump_drains_only_due_windows)


def flush_ignores_deadlines(pkg):
    r0 = _solo(pkg)
    c = _mix_cluster(pkg, window_ms=50.0)
    t1 = c.engine.submit("twf_mix", "edge", _x(), t_send=0.0)
    out = c.engine.flush()
    assert out[t1].response_ms == pytest.approx(r0.response_ms)
    return out


def test_flush_ignores_deadlines_and_charges_no_wait():
    twin(flush_ignores_deadlines)


# ---------------------------------------------------------------------------
# cross-node flush cycles
# ---------------------------------------------------------------------------

def cross_node_flush_parity(pkg):
    xs = [_x(float(i)) for i in range(8)]
    ts = [5.0 + i * 0.05 if i % 2 == 0 else i * 0.05 for i in range(8)]
    nodes = ["edge" if i % 2 == 0 else "edge2" for i in range(8)]
    c1, c2 = _cluster(pkg), _cluster(pkg)
    for c in (c1, c2):
        c.deploy(pkg.get_function("twf_mix"), ["edge", "edge2"],
                 policy=pkg.Policy.REPLICATED)
    tks = [c1.engine.submit("twf_mix", nd, x, t_send=t)
           for nd, x, t in zip(nodes, xs, ts)]
    out = c1.engine.flush()
    assert c1.engine.stats.cycles == 1
    ref = {}
    for nd in ("edge", "edge2"):
        idxs = [i for i in range(8) if nodes[i] == nd]
        rs = c2.invoke_batch("twf_mix", nd, [xs[i] for i in idxs],
                             t_sends=[ts[i] for i in idxs])
        for i, r in zip(idxs, rs):
            ref[i] = r
    for i, tk in enumerate(tks):
        a, b = out[tk], ref[i]
        np.testing.assert_array_equal(record(a)["output"],
                                      record(b)["output"])
        assert (a.t_applied, a.t_received, a.node) == \
            (b.t_applied, b.t_received, b.node)
    c1.flush_replication()
    c2.flush_replication()
    for nd in ("edge", "edge2"):
        assert (pkg.store_contents(c1.nodes[nd].stores["twfkg"])
                == pkg.store_contents(c2.nodes[nd].stores["twfkg"]))
        assert int(c1.nodes[nd].clock) == int(c2.nodes[nd].clock)
    return {"out": out, "c1": c1, "stats": c1.engine.stats}


def test_cross_node_flush_parity_vs_sequential_per_node():
    twin(cross_node_flush_parity)


def cross_caller_downstream_coalescing(pkg):
    c = _cluster(pkg, ("edge", "cloud"))
    for fn in ("twf_sink", "twf_src_a", "twf_src_b"):
        c.deploy(pkg.get_function(fn), ["edge"])
    x = np.ones(4, np.float32)
    tks = [c.engine.submit("twf_src_a", "edge", x, t_send=float(i))
           for i in range(3)]
    tks += [c.engine.submit("twf_src_b", "edge", x, t_send=3.0 + i)
            for i in range(2)]
    out = c.engine.flush()
    assert c.engine.stats.dispatches == 3
    assert c.engine.stats.downstream_coalesced == 5
    assert all(out[t].chain[-1] == "twf_sink" for t in tks)
    contents = pkg.store_contents(c.nodes["edge"].stores["twfsinkkg"])
    assert list(contents.values())[0][2][0] == 5.0
    ref = _cluster(pkg, ("edge", "cloud"))
    for fn in ("twf_sink", "twf_src_a"):
        ref.deploy(pkg.get_function(fn), ["edge"])
    r0 = ref.invoke("twf_src_a", "edge", x, t_send=0.0)
    assert out[tks[0]].response_ms == pytest.approx(r0.response_ms)
    return {"out": out, "c": c, "stats": c.engine.stats}


def test_cross_caller_downstream_coalescing():
    twin(cross_caller_downstream_coalescing)


def cycle_coalesces_replication_snapshots(pkg):
    c = _cluster(pkg)
    c.deploy(pkg.get_function("twf_mix"), ["edge", "edge2"],
             policy=pkg.Policy.REPLICATED)
    for i in range(2):
        c.engine.submit("twf_mix", "edge", _x(float(i)), t_send=float(i))
    for i in range(2):
        c.engine.submit("twf_mix", "edge", _x(10.0 + i), t_send=2.0 + i,
                        client="client2")
    c.engine.flush()
    assert len(c.pending_replication()) == 1
    assert c.engine.stats.replication_coalesced == 1
    c.flush_replication()
    assert (pkg.store_contents(c.nodes["edge"].stores["twfkg"])
            == pkg.store_contents(c.nodes["edge2"].stores["twfkg"]))
    return {"c": c, "stats": c.engine.stats}


def test_cycle_coalesces_replication_snapshots():
    twin(cycle_coalesces_replication_snapshots)


# ---------------------------------------------------------------------------
# replication delivery order (Cluster._deliver_until)
# ---------------------------------------------------------------------------

def _heap_ok(events):
    return all(events[i] <= events[j]
               for i in range(len(events))
               for j in (2 * i + 1, 2 * i + 2) if j < len(events))


def deliver_until_applies_in_arrival_order(pkg, monkeypatch):
    mod = ref_cluster_mod if pkg is REF else port_cluster_mod
    c = _cluster(pkg)
    c.deploy(pkg.get_function("twf_set"), ["edge", "edge2"],
             policy=pkg.Policy.REPLICATED)
    for i, t in enumerate((0.0, 100.0, 200.0)):
        c.invoke("twf_set", "edge", np.full(4, float(i + 1), np.float32),
                 t_send=t)
    q = c._queues["edge2"]
    assert len(q.heap) == 3
    e1, e2, e3 = sorted(q.heap, key=lambda e: (e[0], e[1]))
    q.heap = [e3, e1, e2]                    # scrambled raw order
    merged_arrivals = []
    real_fused = mod.merge_snapshots_fused

    def spying_fused(acc, snaps, *, aligned):
        merged_arrivals.extend(next(ev[0] for ev in (e1, e2, e3)
                                    if ev[3] is s) for s in snaps)
        return real_fused(acc, snaps, aligned=aligned)

    monkeypatch.setattr(mod, "merge_snapshots_fused", spying_fused)
    c._deliver_until("edge2", float("inf"))
    monkeypatch.undo()
    assert merged_arrivals == [e1[0], e2[0], e3[0]]
    assert q.heap == []
    assert c.pending_replication("edge2") == []
    val = pkg.store_contents(c.nodes["edge2"].stores["twfsetkg"]
                             ).popitem()[1][2]
    assert val[0] == 3.0
    return {"arrivals": merged_arrivals, "c": c}


def test_deliver_until_applies_in_arrival_order(monkeypatch):
    twin(deliver_until_applies_in_arrival_order, monkeypatch)


def deliver_until_reheapifies_keep_list(pkg):
    c = _cluster(pkg)
    c.deploy(pkg.get_function("twf_set"), ["edge", "edge2", "cloud"],
             policy=pkg.Policy.REPLICATED)
    for i, t in enumerate((0.0, 50.0, 100.0, 150.0)):
        c.invoke("twf_set", "edge", np.full(4, float(i), np.float32),
                 t_send=t)
    q = c._queues["edge2"]
    assert len(q.heap) == 4
    assert len(c._queues["cloud"].heap) == 4
    q.heap = sorted(q.heap, key=lambda e: (e[0], e[1]), reverse=True)
    cutoff = sorted(ev[0] for ev in q.heap)[1]
    c._deliver_until("edge2", cutoff)
    assert len(q.heap) == 2
    assert _heap_ok([e[:2] for e in q.heap])
    assert len(c._queues["cloud"].heap) == 4
    c.invoke("twf_set", "edge", np.full(4, 9.0, np.float32), t_send=200.0)
    assert _heap_ok([e[:2] for e in q.heap])
    c.flush_replication()
    assert c.pending_replication() == []
    assert (pkg.store_contents(c.nodes["edge2"].stores["twfsetkg"])
            == pkg.store_contents(c.nodes["edge"].stores["twfsetkg"]))
    return c


def test_deliver_until_reheapifies_keep_list():
    twin(deliver_until_reheapifies_keep_list)
