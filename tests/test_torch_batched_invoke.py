"""Twin of ``tests/test_batched_invoke.py``: each scenario of the reference
suite runs through both packages (``torch_parity.twin``), asserts the
reference's properties on each, and the port's record (results and every
timeline field, replicas, clocks, engine and cluster stats) equals the
reference's bit for bit.  Handler arithmetic is float32 adds, which round
alike in both frameworks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import PKGS, PORT, REF, record, twin
from torch_parity import port_lockdep  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")


def _register(pkg):
    fn, xp = pkg.enoki_function, pkg.xp

    @fn(name="tbi_mix", keygroups=["tbimixkg"], codec_width=8)
    def mix(kv, x):
        cur, found = kv.get("acc")
        kv.set("acc", cur + x)
        tot, _ = kv.scan(["acc"])
        return xp.vec([cur[0] + x[0], tot[0, 0]], x)

    @fn(name="tbi_peek", keygroups=["tbimixkg"], codec_width=8)
    def peek(kv, x):
        cur, found = kv.get("acc")
        return cur[:2] + x[:2]

    @fn(name="tbi_async_src", keygroups=[], async_calls=["tbi_async_sink"],
        codec_width=4)
    def async_src(kv, x):
        return x[:2]

    @fn(name="tbi_async_sink", keygroups=["tbiasinkkg"], codec_width=4)
    def async_sink(kv, x):
        cur, _ = kv.get("n")
        kv.set("n", cur + 1.0)
        return x[:1]

    @fn(name="tbi_pair", keygroups=["tbipairkg"], codec_width=4)
    def pair(kv, x):
        a, b = x
        cur, _ = kv.get("s")
        kv.set("s", cur + a[:4])
        return a[:2] + b[:2]

    @fn(name="tbi_gate", keygroups=[], calls=["tbi_async_sink"],
        codec_width=4)
    def gate(kv, x):
        return x[:2]

    @fn(name="tbi_cycle_a", keygroups=[], calls=["tbi_cycle_b"],
        codec_width=4)
    def cycle_a(kv, x):
        return x[:2]

    @fn(name="tbi_cycle_b", keygroups=[], calls=["tbi_cycle_a"],
        codec_width=4)
    def cycle_b(kv, x):
        return x[:2]


for _pkg in PKGS:
    _register(_pkg)

NODES = {"edge": "edge", "edge2": "edge", "cloud": "cloud"}


def _cluster(pkg, policy="REPLICATED", owner=None):
    c = pkg.Cluster(NODES, measure_compute=False)
    c.deploy(pkg.get_function("tbi_mix"), ["edge", "edge2"],
             policy=getattr(pkg.Policy, policy), owner=owner)
    return c


def _same_state(c1, c2):
    """The reference's ``_assert_same_state``: every node's arenas and
    clock equal (stats left out: sequential and batched runs merge
    differently)."""
    a, b = record(c1), record(c2)
    a.pop("stats"), b.pop("stats")
    for k in a:
        if isinstance(a[k], tuple):
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert a[k] == b[k], k


def _same_outputs(seq, bat):
    assert len(seq) == len(bat)
    for a, b in zip(seq, bat):
        np.testing.assert_array_equal(np.asarray(record(a)["output"]),
                                      np.asarray(record(b)["output"]))


def _first_value(pkg, c, node, kg):
    return list(pkg.store_contents(c.nodes[node].stores[kg])
                .values())[0][2][0]


# ---------------------------------------------------------------------------

def batch_equals_sequential(pkg, policy, owner):
    xs = [np.arange(8, dtype=np.float32) + i for i in range(64)]
    ts = [i * 0.25 for i in range(64)]
    c_seq, c_bat = _cluster(pkg, policy, owner), _cluster(pkg, policy, owner)
    seq = [c_seq.invoke("tbi_mix", "edge", x, t_send=t)
           for x, t in zip(xs, ts)]
    bat = c_bat.invoke_batch("tbi_mix", "edge", xs, t_sends=ts)
    assert len(bat) == 64
    for a, b in zip(record(seq), record(bat)):
        np.testing.assert_array_equal(a.pop("output"), b.pop("output"))
        assert a == b
    c_seq.flush_replication()
    c_bat.flush_replication()
    _same_state(c_seq, c_bat)
    return {"seq": seq, "bat": bat, "c_seq": c_seq, "c_bat": c_bat}


@pytest.mark.parametrize("policy,owner", [("REPLICATED", None),
                                          ("PEER_FETCH", "edge"),
                                          ("CLOUD_CENTRAL", "cloud")])
def test_batch_equals_sequential_all_placements(policy, owner):
    twin(batch_equals_sequential, policy, owner)


def per_request_network_timing(pkg):
    c = _cluster(pkg)
    ts = [0.0, 7.5, 40.0, 41.25]
    rs = c.invoke_batch("tbi_mix", "edge", [np.ones(8, np.float32)] * 4,
                        t_sends=ts)
    for t, r in zip(ts, rs):
        assert r.t_sent == t
        assert r.t_received == pytest.approx(t + rs[0].response_ms)
    assert rs[0].response_ms > 0.0
    return rs


def test_per_request_network_timing():
    twin(per_request_network_timing)


def bucket_padding_is_masked_out(pkg):
    xs = [np.full(8, float(i), np.float32) for i in range(5)]
    c_seq, c_bat = _cluster(pkg), _cluster(pkg)
    seq = [c_seq.invoke("tbi_mix", "edge", x, t_send=float(i))
           for i, x in enumerate(xs)]
    bat = c_bat.invoke_batch("tbi_mix", "edge", xs,
                             t_sends=[float(i) for i in range(5)])
    assert len(bat) == 5
    _same_outputs(seq, bat)
    c_seq.flush_replication()
    c_bat.flush_replication()
    _same_state(c_seq, c_bat)
    return {"bat": bat, "c_bat": c_bat}


def test_bucket_padding_is_masked_out():
    twin(bucket_padding_is_masked_out)


def read_only_batch(pkg):
    c = _cluster(pkg)
    c.deploy(pkg.get_function("tbi_peek"), ["edge"])
    assert c.nodes["edge"].batched_handlers["tbi_peek"].read_only
    assert not c.nodes["edge"].batched_handlers["tbi_mix"].read_only
    c.invoke("tbi_mix", "edge", np.ones(8, np.float32))
    before = pkg.store_contents(c.nodes["edge"].stores["tbimixkg"])
    clock_before = int(c.nodes["edge"].clock)
    rs = c.invoke_batch("tbi_peek", "edge",
                        [np.full(8, float(i), np.float32) for i in range(16)],
                        t_sends=[float(i) for i in range(16)])
    seq = [c.invoke("tbi_peek", "edge", np.full(8, float(i), np.float32),
                    t_send=float(i)) for i in range(16)]
    _same_outputs(seq, rs)
    assert pkg.store_contents(c.nodes["edge"].stores["tbimixkg"]) == before
    assert int(c.nodes["edge"].clock) == clock_before
    return {"rs": rs, "seq": seq, "c": c}


def test_read_only_batch_uses_vmap_and_leaves_state_alone():
    twin(read_only_batch)


def oversize_batch(pkg):
    n = 300   # > the largest bucket (256): folded chunk by chunk
    xs = [np.full(8, 1.0, np.float32)] * n
    c_seq, c_bat = _cluster(pkg), _cluster(pkg)
    for i in range(n):
        c_seq.invoke("tbi_mix", "edge", xs[i], t_send=float(i))
    bat = c_bat.invoke_batch("tbi_mix", "edge", xs,
                             t_sends=[float(i) for i in range(n)])
    assert len(bat) == n
    c_seq.flush_replication()
    c_bat.flush_replication()
    _same_state(c_seq, c_bat)
    return {"bat": bat, "c_bat": c_bat}


def test_oversize_batch_chunks_at_largest_bucket():
    twin(oversize_batch)


def submit_flush_coalesces(pkg):
    c = _cluster(pkg)
    c.deploy(pkg.get_function("tbi_peek"), ["edge"])
    tickets = []
    for i in range(6):
        fn = "tbi_mix" if i % 2 == 0 else "tbi_peek"
        tickets.append((c.engine.submit(fn, "edge",
                                        np.full(8, float(i), np.float32),
                                        t_send=float(i)), fn))
    results = c.engine.flush()
    assert len(results) == 6
    for t, fn in tickets:
        assert results[t].chain == [fn]
        assert results[t].t_sent == float(tickets.index((t, fn)))
    assert c.engine.flush() == {}
    return {"results": results, "stats": c.engine.stats}


def test_submit_flush_coalesces_by_function_and_node():
    twin(submit_flush_coalesces)


def async_only_downstream(pkg):
    c = pkg.Cluster({"edge": "edge", "cloud": "cloud"},
                    measure_compute=False)
    c.deploy(pkg.get_function("tbi_async_sink"), ["edge"])
    c.deploy(pkg.get_function("tbi_async_src"), ["edge"])
    x = np.ones(4, np.float32)
    r = c.invoke("tbi_async_src", "edge", x)
    assert r.chain == ["tbi_async_src", "tbi_async_sink"]
    rb = c.invoke_batch("tbi_async_src", "edge", [x] * 3,
                        t_sends=[10.0, 11.0, 12.0])
    for sub in rb:
        assert sub.chain == ["tbi_async_src", "tbi_async_sink"]
        assert sub.response_ms == pytest.approx(r.response_ms)
    assert _first_value(pkg, c, "edge", "tbiasinkkg") == 4.0
    return {"r": r, "rb": rb, "c": c}


def test_async_only_downstream_fires_in_both_paths():
    twin(async_only_downstream)


def pytree_inputs_keep_structure(pkg):
    example = (np.zeros(4, np.float32), np.zeros(2, np.float32))
    cs = []
    for _ in range(2):
        c = pkg.Cluster({"edge": "edge", "cloud": "cloud"},
                        measure_compute=False)
        c.deploy(pkg.get_function("tbi_pair"), ["edge"],
                 example_input=example)
        cs.append(c)
    xs = [(np.full(4, float(i), np.float32),
           np.full(2, 10.0 * i, np.float32)) for i in range(6)]
    seq = [cs[0].invoke("tbi_pair", "edge", x, t_send=float(i))
           for i, x in enumerate(xs)]
    bat = cs[1].invoke_batch("tbi_pair", "edge", xs,
                             t_sends=[float(i) for i in range(6)])
    _same_outputs(seq, bat)
    _same_state(cs[0], cs[1])
    return {"seq": seq, "bat": bat, "c": cs[1]}


def test_pytree_inputs_keep_structure():
    twin(pytree_inputs_keep_structure)


def flush_survives_bad_group(pkg):
    c = _cluster(pkg)
    ok = c.engine.submit("tbi_mix", "edge", np.ones(8, np.float32))
    bad = c.engine.submit("not_deployed", "edge", np.ones(8, np.float32))
    before = pkg.store_contents(c.nodes["edge"].stores["tbimixkg"])
    with pytest.raises(KeyError, match="not_deployed"):
        c.engine.flush()
    assert pkg.store_contents(c.nodes["edge"].stores["tbimixkg"]) == before
    assert len(c.engine.pending()) == 2
    assert c.engine.discard(bad)
    assert not c.engine.discard(bad)
    assert [p["ticket"] for p in c.engine.pending()] == [ok]
    results = c.engine.flush()
    assert ok in results and results[ok].chain == ["tbi_mix"]
    return {"results": results, "c": c, "stats": c.engine.stats}


def test_flush_survives_bad_group():
    twin(flush_survives_bad_group)


def flush_mid_dispatch_failure(pkg):
    c = _cluster(pkg)
    c.deploy(pkg.get_function("tbi_pair"), ["edge"],
             example_input=(np.zeros(4, np.float32),
                            np.zeros(2, np.float32)))
    ok = c.engine.submit("tbi_mix", "edge", np.ones(8, np.float32))
    # a later group that passes deployment validation but fails in the
    # handler: a plain array where it unpacks a 2-tuple
    c.engine.submit("tbi_pair", "edge", np.ones(8, np.float32), t_send=1.0)
    with pytest.raises(Exception):
        c.engine.flush()
    assert c.engine.pending() == []
    results = c.engine.flush()
    assert ok in results and results[ok].chain == ["tbi_mix"]
    return {"results": results, "c": c}


def test_flush_mid_dispatch_failure_keeps_dispatched_results():
    twin(flush_mid_dispatch_failure)


def _gate_cluster(pkg):
    c = pkg.Cluster({"edge": "edge", "cloud": "cloud"},
                    measure_compute=False)
    c.deploy(pkg.get_function("tbi_async_sink"), ["edge"])
    c.deploy(pkg.get_function("tbi_gate"), ["edge"])
    return c


def mixed_fire_sync_downstream(pkg):
    xs = [np.full(4, v, np.float32) for v in (1.0, -1.0, 2.0, -3.0, 4.0)]
    ts = [float(i) for i in range(5)]
    c = _gate_cluster(pkg)
    bat = c.invoke_batch("tbi_gate", "edge", xs, t_sends=ts)
    c2 = _gate_cluster(pkg)
    seq = [c2.invoke("tbi_gate", "edge", x, t_send=t)
           for x, t in zip(xs, ts)]
    for a, b in zip(seq, bat):
        assert a.chain == b.chain
        assert a.response_ms == b.response_ms
    _same_outputs(seq, bat)
    assert [r.chain for r in bat] == [
        ["tbi_gate", "tbi_async_sink"], ["tbi_gate"],
        ["tbi_gate", "tbi_async_sink"], ["tbi_gate"],
        ["tbi_gate", "tbi_async_sink"]]
    _same_state(c, c2)
    return {"bat": bat, "seq": seq, "c": c}


def test_mixed_fire_sync_downstream_matches_sequential():
    twin(mixed_fire_sync_downstream)


def all_filtered_sync_downstream(pkg):
    c = _gate_cluster(pkg)
    xs = [np.full(4, -1.0, np.float32)] * 3
    rs = c.invoke_batch("tbi_gate", "edge", xs, t_sends=[0.0, 1.0, 2.0])
    assert len(rs) == 3
    assert all(r.chain == ["tbi_gate"] for r in rs)
    tk = c.engine.submit("tbi_gate", "edge", xs[0])
    out = c.engine.flush()
    assert out[tk].chain == ["tbi_gate"]
    return {"rs": rs, "out": out}


def test_all_filtered_sync_downstream_still_returns_results():
    twin(all_filtered_sync_downstream)


def downstream_cycle_raises(pkg):
    c = pkg.Cluster({"edge": "edge", "cloud": "cloud"},
                    measure_compute=False)
    c.deploy(pkg.get_function("tbi_cycle_a"), ["edge"])
    c.deploy(pkg.get_function("tbi_cycle_b"), ["edge"])
    with pytest.raises(RecursionError, match="cycle"):
        c.invoke_batch("tbi_cycle_a", "edge", [np.ones(4, np.float32)])
    return c


def test_downstream_cycle_raises_cleanly():
    twin(downstream_cycle_raises)


def kv_set_fold_matches_sequential_sets(pkg):
    st = pkg.store
    kw = {} if pkg is REF else {"device": "cpu"}
    store = st.store_new(16, 4, 64, **kw)
    if pkg is PORT:
        clock = torch.zeros((), dtype=torch.int32)
        rows = torch.stack([torch.full((4,), float(i + 1)) for i in range(4)])
    else:
        clock = jnp.zeros((), jnp.int32)
        rows = jnp.stack([jnp.full((4,), float(i + 1)) for i in range(4)])
    fnv1a = pkg.core.fnv1a
    keys = [fnv1a(k) for k in ("a", "b", "a", "c")]
    lens = [4, 4, 4, 4]
    s_seq, c_seq = store, clock
    for h, row, ln in zip(keys, rows, lens):
        s_seq, c_seq, _ = st.kv_set(s_seq, h, row, ln, c_seq, node_id=2)
    s_seq = tuple(np.array(record(x)) for x in s_seq)   # port: in place
    s_fold, c_fold, oks = st.kv_set_fold(
        st.store_new(16, 4, 64, **kw), keys, rows, lens, clock, node_id=2)
    assert bool(oks.all())
    assert int(c_seq) == int(c_fold)
    for a, b in zip(s_seq, record(tuple(s_fold))):
        np.testing.assert_array_equal(a, b)
    contents = st.store_contents(s_fold)
    np.testing.assert_array_equal(
        np.asarray(contents[fnv1a("a")][2], np.float32),
        np.full((4,), 3.0, np.float32))
    return {"fold": tuple(s_fold), "clock": c_fold, "oks": oks}


def test_kv_set_fold_matches_sequential_sets():
    twin(kv_set_fold_matches_sequential_sets)
