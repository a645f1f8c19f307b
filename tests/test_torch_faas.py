"""The port's batched fold against sequential invocations and against the
reference: for mutating, read-only, stateless and downstream-calling
handlers (torch twins of ``jnp`` handlers), B sequential ``invoke``s equal
one ``invoke_batch``, and both equal the reference's ``invoke_batch`` —
outputs, every timeline field, every replica and every clock.

Handler arithmetic here is float32 adds and multiplies by 2, which round
identically in both frameworks, so outputs compare exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Cluster as RefCluster
from repro.core import enoki_function as ref_function
from repro.core import get_function as ref_get
from repro_torch.core import Cluster, enoki_function, get_function
from torch_parity import assert_same_port_stores, assert_same_store  # noqa: F401
from torch_parity import port_lockdep  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")


# -- reference handlers (jnp) ------------------------------------------------
@ref_function(name="tp_mix", keygroups=["tp_kg"], codec_width=8)
def ref_mix(kv, x):
    cur, _ = kv.get("acc")
    kv.set("acc", cur + x)
    tot, _ = kv.scan(["acc"])
    return jnp.stack([cur[0] + x[0], tot[0, 0]])


@ref_function(name="tp_peek", keygroups=["tp_kg"], codec_width=8)
def ref_peek(kv, x):
    cur, _ = kv.get("acc")
    return cur[:2] + x[:2]


@ref_function(name="tp_mixdel", keygroups=["tp_kg"], codec_width=8)
def ref_mixdel(kv, x):
    a, found = kv.get("a")
    kv.set("a", a + x)
    kv.set("b", x * 2.0)
    kv.delete("b")
    return jnp.where(found, a[:1], -x[:1])


@ref_function(name="tp_stateless", keygroups=[], codec_width=8)
def ref_stateless(kv, x):
    return x[:2] * 2.0


@ref_function(name="tp_sink", keygroups=["tp_sinkkg"], codec_width=4)
def ref_sink(kv, x):
    cur, _ = kv.get("n")
    kv.set("n", cur + 1.0)
    return x[:1]


@ref_function(name="tp_async_src", keygroups=[], async_calls=["tp_sink"],
              codec_width=4)
def ref_async_src(kv, x):
    return x[:2]


@ref_function(name="tp_gate", keygroups=[], calls=["tp_sink"], codec_width=4)
def ref_gate(kv, x):
    return x[:2]


# -- torch twins ---------------------------------------------------------------
@enoki_function(name="tp_mix", keygroups=["tp_kg"], codec_width=8)
def port_mix(kv, x):
    cur, _ = kv.get("acc")
    kv.set("acc", cur + x)
    tot, _ = kv.scan(["acc"])
    return torch.stack([cur[0] + x[0], tot[0, 0]])


@enoki_function(name="tp_peek", keygroups=["tp_kg"], codec_width=8)
def port_peek(kv, x):
    cur, _ = kv.get("acc")
    return cur[:2] + x[:2]


@enoki_function(name="tp_mixdel", keygroups=["tp_kg"], codec_width=8)
def port_mixdel(kv, x):
    a, found = kv.get("a")
    kv.set("a", a + x)
    kv.set("b", x * 2.0)
    kv.delete("b")
    return torch.where(found, a[:1], -x[:1])


@enoki_function(name="tp_stateless", keygroups=[], codec_width=8)
def port_stateless(kv, x):
    return x[:2] * 2.0


@enoki_function(name="tp_sink", keygroups=["tp_sinkkg"], codec_width=4)
def port_sink(kv, x):
    cur, _ = kv.get("n")
    kv.set("n", cur + 1.0)
    return x[:1]


@enoki_function(name="tp_async_src", keygroups=[], async_calls=["tp_sink"],
                codec_width=4)
def port_async_src(kv, x):
    return x[:2]


@enoki_function(name="tp_gate", keygroups=[], calls=["tp_sink"], codec_width=4)
def port_gate(kv, x):
    return x[:2]


NODES = {"edge": "edge", "edge2": "edge", "cloud": "cloud"}
WIDTH = {"tp_mix": 8, "tp_peek": 8, "tp_mixdel": 8, "tp_stateless": 8,
         "tp_async_src": 4, "tp_gate": 4}
TIMELINE = ("response_ms", "t_sent", "t_received", "t_applied", "kv_ops",
            "node", "chain")


def _deploy(c, get):
    c.deploy(get("tp_mix"), ["edge", "edge2"])
    c.deploy(get("tp_peek"), ["edge", "edge2"])
    c.deploy(get("tp_mixdel"), ["edge", "edge2"])
    c.deploy(get("tp_stateless"), ["edge"])
    c.deploy(get("tp_sink"), ["edge"])
    c.deploy(get("tp_async_src"), ["edge"])
    c.deploy(get("tp_gate"), ["edge"])
    return c


def _same_results(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        np.testing.assert_array_equal(np.asarray(ra.output),
                                      np.asarray(rb.output))
        for f in TIMELINE:
            assert getattr(ra, f) == getattr(rb, f), f


def _same_state(ref, port):
    for name in NODES:
        for kg in ("tp_kg", "tp_sinkkg"):
            rs = ref.nodes[name].stores.get(kg)
            ps = port.nodes[name].stores.get(kg)
            assert (rs is None) == (ps is None), (name, kg)
            if rs is not None:
                if isinstance(rs.keys, torch.Tensor):     # port vs port
                    assert_same_port_stores(rs, ps, f"{name}/{kg}")
                else:
                    assert_same_store(rs, ps, f"{name}/{kg}")
        assert int(ref.nodes[name].clock) == int(port.nodes[name].clock)


@pytest.mark.parametrize("fn", list(WIDTH))
def test_batch_equals_sequential_equals_reference(fn):
    ref = _deploy(RefCluster(NODES, measure_compute=False), ref_get)
    seq = _deploy(Cluster(NODES, measure_compute=False, device="cpu"),
                  get_function)
    bat = _deploy(Cluster(NODES, measure_compute=False, device="cpu"),
                  get_function)
    w = WIDTH[fn]
    # some state to read, and negative leading elements for the gate
    warm = np.arange(8, dtype=np.float32)
    for c in (ref, seq, bat):
        c.invoke("tp_mix", "edge", warm, t_send=0.0)
    xs = [np.arange(w, dtype=np.float32) * (1 - 2 * (i % 3 == 1)) + i
          for i in range(6)]
    ts = [1.0 + i * 0.5 for i in range(6)]

    want = ref.invoke_batch(fn, "edge", xs, t_sends=ts)
    got_bat = bat.invoke_batch(fn, "edge", xs, t_sends=ts)
    got_seq = [seq.invoke(fn, "edge", x, t_send=t) for x, t in zip(xs, ts)]
    _same_results(want, got_bat)
    _same_results(got_seq, got_bat)
    for c in (ref, seq, bat):
        c.flush_replication()
    _same_state(ref, bat)
    _same_state(seq, bat)


def test_read_only_and_stateless_leave_state_alone():
    """Read-only folds hand back the caller's arena and clock untouched;
    a stateless handler's arena is a throwaway."""
    c = _deploy(Cluster(NODES, measure_compute=False, device="cpu"),
                get_function)
    c.invoke("tp_mix", "edge", np.ones(8, np.float32))
    nd = c.nodes["edge"]
    assert nd.batched_handlers["tp_peek"].read_only
    assert not nd.batched_handlers["tp_mix"].read_only
    store, clock = nd.stores["tp_kg"], int(nd.clock)
    before = [t.clone() for t in store]
    c.invoke_batch("tp_peek", "edge", [np.ones(8, np.float32)] * 5)
    c.invoke_batch("tp_stateless", "edge", [np.ones(8, np.float32)] * 5)
    assert nd.stores["tp_kg"] is store and int(nd.clock) == clock
    for a, b in zip(before, store):
        assert torch.equal(a, b)
