"""Twin of ``tests/test_crdt_properties.py``: every merge is a CRDT join
(commutative, associative, idempotent) and anti-entropy (``converge``)
reaches the same replicas whatever the merge order.  Each drawn example
runs through both packages: the reference's properties are asserted on
the port, and every port result (registers, counters, arenas, keygroups)
equals the reference's bit for bit."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from repro.core import crdt as ref_crdt
from repro.core import replication as ref_rep
from repro.core import store as ref_store
from repro.core.keygroup import TensorKeygroup as RefKG
from repro.core.versioning import fnv1a
from repro_torch.core import crdt
from repro_torch.core import replication as rep
from repro_torch.core import store as port_store
from repro_torch.core.keygroup import TensorKeygroup
from repro_torch.core.versioning import MAX_NODES
from torch_parity import assert_same_store, to_np
from torch_parity import port_lockdep  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")

SETTINGS = dict(max_examples=25, deadline=None)

arrays = st.lists(st.floats(-100, 100, allow_nan=False, width=32),
                  min_size=4, max_size=4).map(
    lambda xs: np.asarray(xs, np.float32))
versions = st.lists(st.integers(0, 1000), min_size=4, max_size=4).map(
    lambda xs: np.asarray(xs, np.int32))


def _regs(v, t):
    """The same register in both packages."""
    return (ref_crdt.LWWRegister(jnp.asarray(v), jnp.asarray(t)),
            crdt.LWWRegister(torch.from_numpy(v.copy()),
                             torch.from_numpy(t.copy())))


def _same(ref, port):
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(to_np(a), to_np(b))


@given(arrays, versions, arrays, versions)
@settings(**SETTINGS)
def test_lww_commutative(v1, t1, v2, t2):
    (ra, pa), (rb, pb) = _regs(v1, t1), _regs(v2, t2)
    ab, ba = crdt.lww_merge(pa, pb), crdt.lww_merge(pb, pa)
    _same(ref_crdt.lww_merge(ra, rb), ab)
    _same(ref_crdt.lww_merge(rb, ra), ba)
    np.testing.assert_array_equal(ab.version.numpy(), ba.version.numpy())
    tie = t1 == t2
    np.testing.assert_array_equal(ab.value.numpy()[~tie],
                                  ba.value.numpy()[~tie])


@given(arrays, versions, arrays, versions, arrays, versions)
@settings(**SETTINGS)
def test_lww_associative(v1, t1, v2, t2, v3, t3):
    (ra, pa), (rb, pb), (rc, pc) = _regs(v1, t1), _regs(v2, t2), _regs(v3, t3)
    left = crdt.lww_merge(crdt.lww_merge(pa, pb), pc)
    right = crdt.lww_merge(pa, crdt.lww_merge(pb, pc))
    _same(ref_crdt.lww_merge(ref_crdt.lww_merge(ra, rb), rc), left)
    _same(ref_crdt.lww_merge(ra, ref_crdt.lww_merge(rb, rc)), right)
    np.testing.assert_array_equal(left.version.numpy(), right.version.numpy())


@given(arrays, versions)
@settings(**SETTINGS)
def test_lww_idempotent(v, t):
    ra, pa = _regs(v, t)
    aa = crdt.lww_merge(pa, pa)
    _same(ref_crdt.lww_merge(ra, ra), aa)
    np.testing.assert_array_equal(aa.value.numpy(), v)
    np.testing.assert_array_equal(aa.version.numpy(), t)


counters = st.lists(st.integers(0, 1000), min_size=4, max_size=4).map(
    lambda xs: np.asarray(xs, np.int32))


@given(counters, counters, counters)
@settings(**SETTINGS)
def test_gcounter_semilattice(a, b, c):
    ra, rb, rc = (ref_crdt.GCounter(jnp.asarray(x)) for x in (a, b, c))
    pa, pb, pc = (crdt.GCounter(torch.from_numpy(x.copy())) for x in (a, b, c))
    ab, ba = crdt.gcounter_merge(pa, pb), crdt.gcounter_merge(pb, pa)
    _same(ref_crdt.gcounter_merge(ra, rb), ab)
    np.testing.assert_array_equal(ab.counts.numpy(), ba.counts.numpy())
    left = crdt.gcounter_merge(crdt.gcounter_merge(pa, pb), pc)
    right = crdt.gcounter_merge(pa, crdt.gcounter_merge(pb, pc))
    _same(ref_crdt.gcounter_merge(ref_crdt.gcounter_merge(ra, rb), rc), left)
    np.testing.assert_array_equal(left.counts.numpy(), right.counts.numpy())
    aa = crdt.gcounter_merge(pa, pa)
    np.testing.assert_array_equal(aa.counts.numpy(), a)
    assert int(crdt.gcounter_value(left)) == \
        int(ref_crdt.gcounter_value(ref_crdt.gcounter_merge(
            ref_crdt.gcounter_merge(ra, rb), rc)))


@given(st.lists(st.tuples(st.integers(0, 3), st.integers(-50, 50)),
                min_size=0, max_size=12))
@settings(**SETTINGS)
def test_pncounter_value_converges(ops):
    """Ops at different replicas merged in two orders: the values agree,
    equal the sequential sum, and every replica equals the reference's."""
    replicas = [crdt.pncounter_new(4, device="cpu") for _ in range(4)]
    ref = [ref_crdt.pncounter_new(4) for _ in range(4)]
    for node, amount in ops:
        replicas[node] = crdt.pncounter_add(replicas[node], node, amount)
        ref[node] = ref_crdt.pncounter_add(ref[node], node, amount)
    for r, p in zip(ref, replicas):
        _same(r, p)
    m1 = functools.reduce(crdt.pncounter_merge, replicas)
    m2 = functools.reduce(crdt.pncounter_merge, reversed(replicas))
    _same(functools.reduce(ref_crdt.pncounter_merge, ref), m1)
    assert int(crdt.pncounter_value(m1)) == int(crdt.pncounter_value(m2)) \
        == sum(a for _, a in ops)


@given(st.lists(st.tuples(st.integers(0, 2), st.sampled_from("abcd"),
                          st.floats(-10, 10, allow_nan=False, width=32)),
                min_size=1, max_size=10),
       st.permutations([0, 1, 2]))
@settings(max_examples=15, deadline=None)
def test_store_anti_entropy_converges_any_order(writes, order):
    """The paper's §4.3 guarantee: replicas converge after anti-entropy
    whatever the merge order, and the port's replicas equal the
    reference's slot for slot."""
    ref = [ref_store.store_new(8, 2, MAX_NODES) for _ in range(3)]
    port = [port_store.store_new(8, 2, MAX_NODES, device="cpu")
            for _ in range(3)]
    ref_clocks = [jnp.zeros((), jnp.int32) for _ in range(3)]
    clocks = [torch.zeros((), dtype=torch.int32) for _ in range(3)]
    for node, key, val in writes:
        row = np.zeros((2,), np.float32)
        row[0] = val
        ref[node], ref_clocks[node], _ = ref_store.kv_set(
            ref[node], fnv1a(key), jnp.asarray(row), 1, ref_clocks[node],
            node)
        port[node], clocks[node], _ = port_store.kv_set(
            port[node], fnv1a(key), torch.from_numpy(row), 1, clocks[node],
            node)
    for r, p in zip(ref, port):
        assert_same_store(r, p)
    merged = rep.converge([port[i] for i in order], rep.merge_arena, "full")
    want = ref_rep.converge([ref[i] for i in order], ref_store.merge_stores,
                            "full")
    for r, p in zip(want, merged):
        assert_same_store(r, p)
    contents = [port_store.store_contents(s) for s in merged]
    assert contents[0] == contents[1] == contents[2]
    merged2 = rep.converge(port, rep.merge_arena, "full")
    assert port_store.store_contents(merged2[0]) == contents[0]


@given(st.integers(2, 5))
@settings(max_examples=8, deadline=None)
def test_ring_gossip_converges(n):
    kgs = [TensorKeygroup({"w": torch.full((3,), float(i))},
                          torch.tensor(i, dtype=torch.int32), "lww")
           for i in range(n)]
    ref = [RefKG({"w": jnp.full((3,), float(i))}, jnp.asarray(i, jnp.int32),
                 "lww") for i in range(n)]
    out = rep.converge(kgs, lambda a, b: a.merged_with(b), topology="ring")
    want = ref_rep.converge(ref, lambda a, b: a.merged_with(b),
                            topology="ring")
    for r, p in zip(want, out):
        np.testing.assert_array_equal(to_np(r.tree["w"]), to_np(p.tree["w"]))
        assert int(r.version) == int(p.version)
    tops = [float(k.tree["w"][0]) for k in out]
    assert tops == [float(n - 1)] * n, "ring gossip must reach the newest"
