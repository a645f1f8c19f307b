"""``repro_torch.core.store`` against ``repro.core.store`` on the same
seeded inputs: single-key ops, the slot probe, the three merges, slot
stamping and the carry round trip.  Every leaf compares bit-exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.store as R
import repro_torch.core.store as P
from repro_torch.core import carry
from repro_torch.kernels.enoki_merge.kernel import enoki_merge_rows
from torch_parity import (assert_same_port_stores, assert_same_store,  # noqa: F401
                          port_lockdep, port_to_ref, ref_to_port, to_np)

jax.config.update("jax_platform_name", "cpu")

S, V, N, NODE = 8, 4, 4, 3


def _clock(v=0):
    return jnp.int32(v), torch.tensor(v, dtype=torch.int32)


@pytest.mark.parametrize("seed", range(4))
def test_op_sequence_matches_reference(seed):
    """set/get/delete/scan/set_fold over 12 keys in an 8-slot arena
    (overflow and tombstones included), op by op."""
    rng = np.random.default_rng(seed)
    rs, ps = R.store_new(S, V, N), P.store_new(S, V, N, device="cpu")
    rc, pc = _clock()
    for _ in range(40):
        kind = rng.choice(["set", "set", "get", "delete", "scan", "fold"])
        h = int(1000 + rng.integers(0, 12))
        if kind == "set":
            row = rng.normal(size=V).astype(np.float32)
            ln = int(rng.integers(0, V + 1))
            rs, rc, rok = R.kv_set(rs, h, jnp.asarray(row), ln, rc, NODE)
            ps, pc, pok = P.kv_set(ps, h, torch.from_numpy(row), ln, pc, NODE)
            assert bool(rok) == bool(pok)
        elif kind == "get":
            for a, b in zip(R.kv_get(rs, h), P.kv_get(ps, h)):
                np.testing.assert_array_equal(to_np(a), to_np(b))
        elif kind == "delete":
            rs, rc, rok = R.kv_delete(rs, h, rc, NODE)
            ps, pc, pok = P.kv_delete(ps, h, pc, NODE)
            assert bool(rok) == bool(pok)
        elif kind == "scan":
            hs = [int(1000 + x) for x in rng.integers(0, 12, 3)]
            for a, b in zip(R.kv_scan(rs, hs), P.kv_scan(ps, hs)):
                np.testing.assert_array_equal(to_np(a), to_np(b))
        else:
            hs = [int(1000 + x) for x in rng.integers(0, 12, 3)]
            rows = rng.normal(size=(3, V)).astype(np.float32)
            lns = [int(x) for x in rng.integers(0, V + 1, 3)]
            rs, rc, roks = R.kv_set_fold(rs, hs, jnp.asarray(rows), lns, rc,
                                         NODE)
            ps, pc, poks = P.kv_set_fold(ps, hs, torch.from_numpy(rows), lns,
                                         pc, NODE)
            np.testing.assert_array_equal(to_np(roks), to_np(poks))
        assert int(rc) == int(pc)
        assert_same_store(rs, ps, kind)
    assert R.store_contents(rs) == P.store_contents(ps)


def test_locate_tie_rule():
    """First matching slot wins, else the first empty slot; a full arena
    without the key refuses (ok=False) — as the reference's probe."""
    keys = np.array([0, 0, 7, 0, 9, 7, 0, 0], np.int32)
    full = np.array([4, 7, 5, 7, 6, 8, 2, 3], np.int32)
    expect = {(0, 7): [2, 1, 1], (0, 5): [0, 0, 1], (1, 7): [1, 1, 1],
              (1, 11): [0, 0, 0]}     # (arena, hash) -> [slot, found, ok]
    for i, ks in enumerate((keys, full)):
        rs = R.store_new(S, V, N)._replace(keys=jnp.asarray(ks))
        ps = P.store_new(S, V, N, device="cpu")._replace(
            keys=torch.from_numpy(ks.copy()))
        for h in (7, 9, 5, 11):
            got = [int(x) for x in P._locate(ps, h)]
            assert got == [int(x) for x in R._locate(rs, h)], (ks, h)
            assert got == expect.get((i, h), got)


def _random_arena(rng, pool):
    """An unaligned arena: distinct keys from ``pool`` in random slots."""
    keys = np.zeros(S, np.int32)
    live = rng.random(S) < 0.7
    keys[live] = rng.choice(pool, live.sum(), replace=False)
    return R.store_new(S, V, N)._replace(
        keys=jnp.asarray(keys),
        values=jnp.asarray(rng.normal(size=(S, V)).astype(np.float32)),
        lengths=jnp.asarray(rng.integers(-1, V + 1, S).astype(np.int32)),
        versions=jnp.asarray(rng.integers(0, 6, S).astype(np.int32)),
        vv=jnp.asarray(rng.integers(0, 50, N).astype(np.int32)))


@pytest.mark.parametrize("seed", range(6))
def test_merge_stores_matches_reference(seed):
    rng = np.random.default_rng(seed)
    pool = np.arange(100, 112, dtype=np.int32)
    a, b = _random_arena(rng, pool), _random_arena(rng, pool)
    assert_same_store(R.merge_stores(a, b),
                      P.merge_stores(ref_to_port(a), ref_to_port(b)))


def _aligned(rng, count):
    """``count`` replicas under one canonical layout (the deploy contract
    of ``store_assign_slots``): pre-assigned, live or deleted slots with
    tie-heavy versions, as ``tests/test_store_aligned.py`` builds them."""
    layout = rng.random(S) < 0.75
    out = []
    for _ in range(count):
        keys = np.where(layout, 1000 + np.arange(S), 0).astype(np.int32)
        kind = rng.integers(0, 3, S)            # pre / live / dead
        versions = np.where(layout & (kind > 0), rng.integers(1, 9, S), 0)
        lengths = np.where(kind == 1, rng.integers(0, V + 1, S), -1)
        lengths = np.where(layout, lengths, 0)
        values = np.where((layout & (kind == 1))[:, None],
                          rng.normal(size=(S, V)), 0.0)
        out.append(R.store_new(S, V, N)._replace(
            keys=jnp.asarray(keys), values=jnp.asarray(values, jnp.float32),
            lengths=jnp.asarray(lengths, jnp.int32),
            versions=jnp.asarray(versions, jnp.int32),
            vv=jnp.asarray(rng.integers(0, 50, N), jnp.int32)))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_merge_stores_aligned_matches_reference(seed):
    """Aligned merge == the reference's aligned merge, leaf for leaf, and
    == the O(S²) fallback as replicas."""
    a, b = _aligned(np.random.default_rng(seed), 2)
    got = P.merge_stores_aligned(ref_to_port(a), ref_to_port(b))
    assert_same_store(R.merge_stores_aligned(a, b), got)
    assert P.stores_equal(got, P.merge_stores(ref_to_port(a),
                                              ref_to_port(b)))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_merge_snapshots_fused_matches_reference(k, aligned):
    """K-way fused merge == the reference's fused merge (which pads K to a
    bucket with repeats of the last snapshot; the port runs K as is)."""
    arenas = _aligned(np.random.default_rng(10 + k), k + 1)
    want = R.merge_snapshots_fused(arenas[0], tuple(arenas[1:]),
                                   aligned=aligned)
    acc = ref_to_port(arenas[0])
    n0 = enoki_merge_rows.launches
    got = P.merge_snapshots_fused(acc, [ref_to_port(s) for s in arenas[1:]],
                                  aligned=aligned)
    assert got is acc                   # written into the accumulator
    assert enoki_merge_rows.launches == n0      # CPU: the plain version
    assert_same_store(want, got)
    padded = P.merge_snapshots_fused(
        ref_to_port(arenas[0]),
        [ref_to_port(s) for s in arenas[1:] + [arenas[-1]] * 3],
        aligned=aligned)
    assert_same_port_stores(got, padded)


def test_store_assign_slots_contract():
    """Stamping: applied in place, idempotent on a matching arena, refused
    (arena untouched) on a conflicting one — as the reference decides."""
    layout = {1000: 0, 1001: 1}
    ref, _ = R.store_assign_slots(R.store_new(S, V, N), layout)
    arena = P.store_new(S, V, N, device="cpu")
    stamped, ok = P.store_assign_slots(arena, layout)
    assert ok and stamped is arena
    assert_same_store(ref, stamped)
    again, ok2 = P.store_assign_slots(stamped, layout)
    assert ok2 and P.stores_equal(again, stamped)
    before = carry.store_to_numpy(stamped)
    for bad in ({1000: 1}, {2000: 0}):      # hash lives elsewhere / taken
        _, ok_ref = R.store_assign_slots(ref, bad)
        _, ok_port = P.store_assign_slots(stamped, bad)
        assert ok_ref is ok_port is False
        for x, y in zip(before, carry.store_to_numpy(stamped)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_carry_round_trip(dtype):
    """A reference arena, pulled to numpy, seeds a port arena that holds
    the same leaves; a port arena round-trips through numpy unchanged."""
    rng = np.random.default_rng(3)
    ref = _aligned(rng, 1)[0]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = ref._replace(values=ref.values.astype(jdt))
    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    port = ref_to_port(ref, dtype=tdt)
    assert port.values.dtype == (tdt or torch.float32)
    assert_same_store(ref, port)
    back = carry.store_from_numpy(*carry.store_to_numpy(port), device="cpu",
                                  dtype=tdt)
    assert_same_port_stores(port, back)
    assert_same_store(port_to_ref(port, jdt), back)
    spec = carry.keygroup_spec_from_reference("kg", "replicated", S, V, dtype,
                                              device="cpu")
    assert spec.policy.value == "replicated" and spec.dtype == (
        tdt or torch.float32)


def test_store_select_matches_reference():
    a, b = _aligned(np.random.default_rng(4), 2)
    for pred in (True, False):
        assert_same_store(R.store_select(pred, a, b),
                          P.store_select(pred, ref_to_port(a),
                                         ref_to_port(b)))


def test_crdt_merges_match_reference():
    """LWW registers, G/PN-counters and version vectors, same inputs."""
    from repro.core import crdt as rc
    from repro_torch.core import crdt as pc
    rng = np.random.default_rng(5)
    val = rng.normal(size=(2, 6, V)).astype(np.float32)
    ver = rng.integers(0, 4, (2, 6)).astype(np.int32)
    cnt = rng.integers(0, 9, (4, N)).astype(np.int32)
    t, j = torch.from_numpy, jnp.asarray
    got = pc.lww_merge(pc.LWWRegister(t(val[0]), t(ver[0])),
                       pc.LWWRegister(t(val[1]), t(ver[1])))
    want = rc.lww_merge(rc.LWWRegister(j(val[0]), j(ver[0])),
                        rc.LWWRegister(j(val[1]), j(ver[1])))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(to_np(x), to_np(y))
    g = pc.gcounter_increment(pc.gcounter_new(N), 2, 3)
    rg = rc.gcounter_increment(rc.gcounter_new(N), 2, 3)
    assert int(pc.gcounter_value(pc.gcounter_merge(g, pc.GCounter(t(cnt[0]))))) \
        == int(rc.gcounter_value(rc.gcounter_merge(rg, rc.GCounter(j(cnt[0])))))
    p = pc.pncounter_add(pc.PNCounter(t(cnt[1]), t(cnt[2])), 1, -5)
    r = rc.pncounter_add(rc.PNCounter(j(cnt[1]), j(cnt[2])), 1, -5)
    q = pc.pncounter_merge(p, pc.PNCounter(t(cnt[3]), t(cnt[0])))
    s = rc.pncounter_merge(r, rc.PNCounter(j(cnt[3]), j(cnt[0])))
    assert int(pc.pncounter_value(q)) == int(rc.pncounter_value(s))
    assert bool(pc.vv_dominates(t(cnt[0]), t(cnt[1]))) == bool(
        rc.vv_dominates(j(cnt[0]), j(cnt[1])))


@pytest.mark.parametrize("rule", ["lww", "mean", "max"])
def test_tensor_keygroup_merges_match_reference(rule):
    from repro.core.keygroup import TensorKeygroup as RefTK
    from repro_torch.core.keygroup import TensorKeygroup
    rng = np.random.default_rng(9)
    trees = [{"w": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=4).astype(np.float32)} for _ in range(2)]
    ref = [RefTK.create({k: jnp.asarray(v) for k, v in tr.items()}, rule)
           for tr in trees]
    port = [TensorKeygroup.create({k: torch.from_numpy(v)
                                   for k, v in tr.items()}, rule)
            for tr in trees]
    ref[1], port[1] = ref[1].write(ref[1].tree), port[1].write(port[1].tree)
    want, got = ref[0].merged_with(ref[1]), port[0].merged_with(port[1])
    assert int(want.version) == int(got.version)
    for k in trees[0]:
        np.testing.assert_array_equal(to_np(got.tree[k]), to_np(want.tree[k]))
