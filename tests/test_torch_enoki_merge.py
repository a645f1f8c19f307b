"""The port's ``enoki_merge_rows`` against the reference Pallas kernel.

On the CPU the port's wrapper takes its plain version; the reference kernel
runs in Pallas interpret mode, as ``tests/test_kernels.py`` runs it.  Every
comparison is bit-exact (the merge only selects).  The CUDA kernel against
this plain version is ``tests/test_torch_cuda.py`` (it needs the card, and
imports no jax so that it runs where the card is).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.enoki_merge import ops as ref_ops
from repro.kernels.enoki_merge.kernel import enoki_merge_rows as ref_rows
from repro.kernels.enoki_merge.ref import enoki_merge_ref
from repro_torch.kernels.enoki_merge import ops
from repro_torch.kernels.enoki_merge.kernel import enoki_merge_rows
from torch_parity import port_lockdep, to_np  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
        "int32": jnp.int32, "uint8": jnp.uint8}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32, "uint8": torch.uint8}


def _payload(rng, shape, dtype):
    """numpy payload for ``dtype`` (bf16 is made in float32 and cast in
    each framework)."""
    if dtype in ("int32", "uint8"):
        return rng.integers(0, 100, shape).astype(dtype)
    return rng.normal(size=shape).astype(np.float32)


def _both(a, dtype):
    return jnp.asarray(a).astype(_JNP[dtype]), torch.from_numpy(a).to(_TORCH[dtype])


@pytest.mark.parametrize("R,V,tile", [(256, 128, 64), (512, 256, 256),
                                      (64, 128, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "uint8"])
def test_plain_matches_pallas_interpret(R, V, tile, dtype):
    rng = np.random.default_rng(6)
    a, b = _payload(rng, (R, V), dtype), _payload(rng, (R, V), dtype)
    aver = rng.integers(0, 50, R).astype(np.int32)
    bver = rng.integers(0, 50, R).astype(np.int32)
    (ja, ta), (jb, tb) = _both(a, dtype), _both(b, dtype)
    rv, rver = ref_rows(ja, jnp.asarray(aver), jb, jnp.asarray(bver),
                        rows_tile=tile, interpret=True)
    pv, pver = ops.enoki_merge(ta, torch.from_numpy(aver.copy()), tb,
                               torch.from_numpy(bver))
    np.testing.assert_array_equal(to_np(pv), to_np(rv))
    np.testing.assert_array_equal(to_np(pver), to_np(rver))


def _snapshot(rng, R, V, N, keys):
    """One aligned arena's fields with tie-heavy versions (0..3)."""
    return (torch.from_numpy(keys.copy()),
            torch.from_numpy(rng.normal(size=(R, V)).astype(np.float32)),
            torch.from_numpy(rng.integers(-1, V, R).astype(np.int32)),
            torch.from_numpy(rng.integers(0, 4, R).astype(np.int32)),
            torch.from_numpy(rng.integers(0, 50, N).astype(np.int32)))


def _clone(rows):
    return tuple(t.clone() for t in rows)


@pytest.mark.parametrize("k", [1, 2, 5, 32, 33])
def test_kway_equals_sequential_fold(k):
    """One K-way fold == K two-way folds in order == the reference's
    sequential strict-``>`` fold (values and versions through its oracle,
    which the sweep above holds the kernel to; keys/lengths following the
    winning row, vv max)."""
    R, V, N = 16, 8, 4
    rng = np.random.default_rng(100 + k)
    keys = (1000 + np.arange(R)).astype(np.int32)
    acc = _snapshot(rng, R, V, N, keys)
    snaps = [_snapshot(rng, R, V, N, keys) for _ in range(k)]

    fused = enoki_merge_rows(_clone(acc), snaps)
    seq = _clone(acc)
    for s in snaps:
        enoki_merge_rows(seq, [s])
    for x, y in zip(fused, seq):
        np.testing.assert_array_equal(x.numpy(), y.numpy())

    rk, rv, rl, rver, rvv = (jnp.asarray(t.numpy()) for t in acc)
    for s in snaps:
        sk, sv, sl, sver, svv = (jnp.asarray(t.numpy()) for t in s)
        take = sver > rver
        rk, rl = jnp.where(take, sk, rk), jnp.where(take, sl, rl)
        rv, rver = enoki_merge_ref(rv, rver, sv, sver)
        rvv = jnp.maximum(rvv, svv)
    for x, y in zip(fused, (rk, rv, rl, rver, rvv)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_crdt_laws():
    """Commutative on distinct versions, idempotent, like
    ``tests/test_kernels.py::test_enoki_merge_commutative_idempotent``."""
    R, V = 128, 64
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.normal(size=(R, V)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(R, V)).astype(np.float32))
    aver = torch.from_numpy(rng.permutation(R).astype(np.int32))
    bver = torch.from_numpy(rng.permutation(R).astype(np.int32) + R)
    ab = ops.enoki_merge(a.clone(), aver.clone(), b, bver)
    ba = ops.enoki_merge(b.clone(), bver.clone(), a, aver)
    assert torch.equal(ab[0], ba[0]) and torch.equal(ab[1], ba[1])
    aa = ops.enoki_merge(ab[0].clone(), ab[1].clone(), ab[0], ab[1])
    assert torch.equal(aa[0], ab[0]) and torch.equal(aa[1], ab[1])


@pytest.mark.parametrize("n,row_width", [(10, 4), (8, 4), (3, 4), (7, 7)])
def test_merge_flat_keygroup_ragged_tail(n, row_width):
    """ceil(N/row_width) versions, the last owning the ragged tail, merged
    like a full row — equal to the reference's ``merge_flat_keygroup`` —
    and the old tail-dropping call shape raises."""
    rows = n // row_width
    nver = rows + (1 if rows * row_width < n else 0)
    rng = np.random.default_rng(11)
    a = rng.normal(size=n).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    aver = ((np.arange(nver) * 3 + 1) % 7).astype(np.int32)
    bver = ((np.arange(nver) * 5 + 2) % 7).astype(np.int32)
    rout, rver = ref_ops.merge_flat_keygroup(
        jnp.asarray(a), jnp.asarray(aver), jnp.asarray(b), jnp.asarray(bver),
        row_width=row_width, interpret=True)
    pout, pver = ops.merge_flat_keygroup(
        torch.from_numpy(a.copy()), torch.from_numpy(aver.copy()),
        torch.from_numpy(b), torch.from_numpy(bver), row_width=row_width)
    np.testing.assert_array_equal(pout.numpy(), np.asarray(rout))
    np.testing.assert_array_equal(pver.numpy(), np.asarray(rver))
    if rows * row_width < n:
        with pytest.raises(ValueError):
            ops.merge_flat_keygroup(torch.from_numpy(a),
                                    torch.from_numpy(aver[:rows]),
                                    torch.from_numpy(b),
                                    torch.from_numpy(bver[:rows]),
                                    row_width=row_width)


def test_wrapper_rejects_mismatched_operands():
    acc = (None, torch.zeros(4, 8), None, torch.zeros(4, dtype=torch.int32),
           None)
    with pytest.raises(ValueError):
        enoki_merge_rows(acc, [(None, torch.zeros(4, 6), None,
                                torch.zeros(4, dtype=torch.int32), None)])
    with pytest.raises(ValueError):
        enoki_merge_rows(acc, [(None, torch.zeros(4, 8), None,
                                torch.zeros(4, dtype=torch.int64), None)])
