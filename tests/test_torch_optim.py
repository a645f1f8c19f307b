"""The port's optimisers, schedule, compression and DiLoCo
(``repro_torch.optim``) against the reference's (``repro.optim``) on the
same seeded numpy trees, and twins of ``tests/test_substrate.py``'s
optimiser and compression cases.

Tolerances: float32 results within 1e-6 of the leaf's max-abs (the same
f32 operations, one or two roundings apart: torch's and XLA's reductions
sum in other orders, and ``pow``/``cos`` may differ by an ulp); counts,
rounds, int8 ``q``, top-k values and indices exactly.  bfloat16 params are
the f32 master (AdamW) or the f32 update (Adafactor) rounded once, so they
are held to one bf16 ulp of the leaf's max-abs (2^-8).

The port's updates write into the tensors handed in; every call here gets
fresh tensors from numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_comp
from repro.optim import schedule as ref_schedule
from repro_torch import optim
from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.optim import adamw, compression, schedule
from torch_parity import port_lockdep, to_np  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")

F32_TOL = 1e-6
BF16_TOL = 2.0 ** -8
SHAPES = {"w": (6, 10), "b": (10,), "s": (3, 5, 4), "e": {"k": (8, 3)}}


def _tree(seed, scale=1.0, shapes=SHAPES):
    rng = np.random.default_rng(seed)

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return (scale * rng.standard_normal(s)).astype(np.float32)
    return make(shapes)


def _jnp(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _torch(tree, dtype=torch.float32):
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dtype), tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _close(got, want, tol=F32_TOL, what=""):
    got_l, want_l = _leaves(got), _leaves(want)
    assert len(got_l) == len(want_l), what
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        g, w = to_np(g).astype(np.float32), np.asarray(
            jnp.asarray(w, jnp.float32))
        assert g.shape == w.shape, (what, i)
        err = np.abs(g - w).max() / (np.abs(w).max() + 1e-30)
        assert err <= tol, f"{what} leaf {i}: {err:.3e} > {tol}"


def _grads(steps):
    return [_tree(100 + i, scale=0.5 + i) for i in range(steps)]


# ---------------------------------------------------------------------------
# AdamW, Adafactor and clipping against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["f32", "f32_master", "bf16_master"])
def test_adamw_update_matches_reference(case):
    bf16 = case == "bf16_master"
    keep = case != "f32"
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    p0 = _tree(1)
    rp, tp = _jnp(p0, jdt), _torch(p0, tdt)
    rs, ts = ref_optim.adamw_init(rp, keep_master=keep), \
        optim.adamw_init(tp, keep_master=keep)
    assert sorted(ts) == sorted(rs)
    for i, g in enumerate(_grads(3)):
        lr = 1e-2 * (i + 1)
        rp, rs, rm = ref_optim.adamw_update(_jnp(g, jdt), rs, rp, lr)
        tp_in = tp
        tp, ts, tm = optim.adamw_update(_torch(g, tdt), ts, tp,
                                        torch.tensor(lr))
        assert tp is not None and _leaves(tp)[0] is _leaves(tp_in)[0]
        assert int(ts["count"]) == int(rs["count"]) == i + 1
        _close(tm["grad_norm"], rm["grad_norm"], what="grad_norm")
        for k in ("m", "v") + (("master",) if keep else ()):
            _close(ts[k], rs[k], what=k)
        _close(tp, rp, BF16_TOL if bf16 else F32_TOL, "params")
        if bf16:
            for p, m in zip(_leaves(tp), _leaves(ts["master"])):
                assert torch.equal(p, m.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adafactor_update_matches_reference(dtype):
    bf16 = dtype == "bfloat16"
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    p0 = _tree(2)
    rp, tp = _jnp(p0, jdt), _torch(p0, tdt)
    rs, ts = ref_optim.adafactor_init(rp), optim.adafactor_init(tp)
    assert set(ts["v"]["w"]) == {"row", "col"} and set(ts["v"]["b"]) == {
        "full"}
    assert ts["v"]["s"]["row"].shape == (3, 5) and \
        ts["v"]["s"]["col"].shape == (3, 4)
    for i, g in enumerate(_grads(3)):
        lr = 1e-2
        rp, rs, rm = ref_optim.adafactor_update(_jnp(g, jdt), rs, rp, lr,
                                                weight_decay=0.1)
        tp, ts, tm = optim.adafactor_update(_torch(g, tdt), ts, tp, lr,
                                            weight_decay=0.1)
        assert int(ts["count"]) == int(rs["count"]) == i + 1
        _close(tm["grad_norm"], rm["grad_norm"], what="grad_norm")
        _close(ts["v"], rs["v"], what="v")
        _close(tp, rp, BF16_TOL if bf16 else F32_TOL, "params")
        assert all(p.dtype == tdt for p in _leaves(tp))


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(3, scale=2.0)
    rc, rn = ref_adamw.clip_by_global_norm(_jnp(g), max_norm)
    tc, tn = adamw.clip_by_global_norm(_torch(g), max_norm)
    _close(tn, rn, what="norm")
    _close(tc, rc, what="clipped")
    _close(adamw.global_norm(_torch(g, torch.bfloat16)),
           ref_adamw.global_norm(_jnp(g, jnp.bfloat16)), what="bf16 norm")


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 20), (5, 5)])
def test_warmup_cosine_matches_reference(warmup, total):
    for s in range(total + 6):
        want = ref_schedule.warmup_cosine(jnp.asarray(s, jnp.int32), 3e-4,
                                          warmup, total)
        for step in (torch.tensor(s, dtype=torch.int32), s):
            got = schedule.warmup_cosine(step, 3e-4, warmup, total)
            assert got.dtype == torch.float32 and got.shape == ()
            _close(got, want, what=f"step {s}")
    assert float(schedule.constant(torch.tensor(3), 0.25)) == 0.25


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def test_int8_compression_matches_reference():
    x = _tree(4, scale=3.0)
    want = ref_comp.tree_int8_compress(_jnp(x))
    got = compression.tree_int8_compress(_torch(x))
    for w, g in zip(jax.tree.leaves(want, is_leaf=lambda t: isinstance(
            t, ref_comp.Int8Payload)), _leaves(got)):
        assert g.q.dtype == torch.int8
        np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
        assert float(g.scale) == float(w.scale)
    _close(compression.tree_int8_decompress(got),
           ref_comp.tree_int8_decompress(want), what="decompressed")
    assert compression.compressed_bytes(got) == \
        ref_comp.compressed_bytes(want)
    assert compression.compressed_bytes(_torch(x)) == \
        ref_comp.compressed_bytes(_jnp(x))
    zero = compression.int8_compress(torch.zeros(5))
    assert not zero.q.any() and float(zero.scale) > 0


@pytest.mark.parametrize("k", [1, 7, 200])
def test_topk_compression_matches_reference(k):
    rng = np.random.default_rng(5)
    # distinct magnitudes: lax.top_k and torch.topk may order ties apart
    mags = rng.permutation(np.arange(1, 61)).astype(np.float32) / 8
    x = (mags * rng.choice([-1.0, 1.0], 60)).reshape(5, 12).astype(
        np.float32)
    wp, wr = ref_comp.topk_compress(jnp.asarray(x), k)
    gp, gr = compression.topk_compress(torch.from_numpy(x), k)
    np.testing.assert_array_equal(gp.values.numpy(), np.asarray(wp.values))
    np.testing.assert_array_equal(gp.indices.numpy(), np.asarray(wp.indices))
    assert gp.indices.dtype == torch.int32 and gp.shape == wp.shape
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    np.testing.assert_array_equal(
        compression.topk_decompress(gp).numpy(),
        np.asarray(ref_comp.topk_decompress(wp)))


TIE_DRAWS = {"sign_pair": (np.array([1.0, -1.0, 1.0, 0.0], np.float32), 1),
             "tie_heavy": (None, 12)}


@pytest.mark.parametrize("case", sorted(TIE_DRAWS))
def test_topk_compression_breaks_ties_as_the_reference(case):
    """Equal magnitudes: the entries ``lax.top_k`` keeps, in its order
    (lowest index first among equals), the same residual.  x = [1, -1, 1,
    0] with k = 1 keeps index 0; the tie-heavy draw holds 60 entries of
    four magnitudes and their signs, cut by k = 12 inside a tied run."""
    x, k = TIE_DRAWS[case]
    if x is None:
        rng = np.random.default_rng(17)
        x = (rng.integers(0, 4, 60) * rng.choice([-1.0, 1.0], 60)).reshape(
            5, 12).astype(np.float32)
        mags = np.sort(np.abs(x).reshape(-1))[::-1]
        assert mags[k - 1] == mags[k]
    wp, wr = ref_comp.topk_compress(jnp.asarray(x), k)
    gp, gr = compression.topk_compress(torch.from_numpy(x), k)
    np.testing.assert_array_equal(gp.indices.numpy(), np.asarray(wp.indices))
    np.testing.assert_array_equal(gp.values.numpy(), np.asarray(wp.values))
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    if case == "sign_pair":
        assert gp.indices.tolist() == [0]


# ---------------------------------------------------------------------------
# DiLoCo
# ---------------------------------------------------------------------------

def test_diloco_matches_reference():
    outer0 = _tree(6)
    rs, ts = ref_optim.diloco_init(_jnp(outer0, jnp.bfloat16)), \
        optim.diloco_init(_torch(outer0, torch.bfloat16))
    _close(ts["outer_params"], rs["outer_params"], 0.0, "init")
    for r in range(3):
        locals_ = [_tree(10 * r + p) for p in range(2)]
        rd = [ref_optim.diloco_local_delta(rs["outer_params"], _jnp(l))
              for l in locals_]
        td = [optim.diloco_local_delta(ts["outer_params"], _torch(l))
              for l in locals_]
        for w, g in zip(rd, td):
            _close(g, w, what="delta")
        rmean = jax.tree.map(lambda a, b: (a + b) / 2, *rd)
        tmean = tree_map(lambda a, b: (a + b) / 2, *td)
        rnew, rs = ref_optim.diloco_outer_update(rs, rmean, 0.7, 0.9)
        tnew, ts = optim.diloco_outer_update(ts, tmean, 0.7, 0.9)
        assert int(ts["round"]) == int(rs["round"]) == r + 1
        _close(tnew, rnew, what="outer params")
        _close(ts["momentum"], rs["momentum"], what="momentum")


def test_optim_exports_match_reference():
    assert optim.__all__ == ref_optim.__all__


# ---------------------------------------------------------------------------
# twins of tests/test_substrate.py's optimiser and compression cases
# ---------------------------------------------------------------------------

def _quadratic_progress(update_fn, init_fn, steps=60, lr=0.1):
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros((3,))}
    state = init_fn(params)

    def loss(p):
        return torch.sum((p["w"] - target) ** 2)

    l0 = float(loss(params))
    for _ in range(steps):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(loss({"w": w}), [w])
        params, state, _ = update_fn({"w": g}, state, params, lr)
    return l0, float(loss(params))


def test_adamw_decreases_loss():
    l0, l1 = _quadratic_progress(
        lambda g, s, p, lr: optim.adamw_update(g, s, p, lr,
                                               weight_decay=0.0),
        optim.adamw_init)
    assert l1 < 0.05 * l0


def test_adafactor_decreases_loss():
    l0, l1 = _quadratic_progress(
        lambda g, s, p, lr: optim.adafactor_update(g, s, p, lr),
        optim.adafactor_init)
    assert l1 < 0.2 * l0


def test_adafactor_memory_is_factored():
    st = optim.adafactor_init({"w": torch.zeros((128, 64))})
    n_state = sum(x.numel() for x in tree_flatten(st["v"])[0])
    assert n_state == 128 + 64, "second moment must be O(R+C), not O(R*C)"


def test_grad_clip():
    clipped, norm = adamw.clip_by_global_norm(
        {"w": torch.full((4,), 100.0)}, 1.0)
    assert float(norm) == pytest.approx(200.0)
    assert float(torch.linalg.norm(clipped["w"])) == pytest.approx(1.0,
                                                                   rel=1e-4)


def test_warmup_cosine_shape():
    lrs = [float(optim.warmup_cosine(torch.tensor(s), 1e-3, 10, 100))
           for s in range(100)]
    assert lrs[0] < lrs[9] <= 1e-3 + 1e-9
    assert lrs[50] < lrs[10]
    assert lrs[99] >= 1e-4 - 1e-9  # final_frac floor


def test_diloco_outer_pulls_towards_consensus():
    state = optim.diloco_init({"w": torch.zeros((4,))})
    # two pods moved in the same direction: outer must follow
    da = optim.diloco_local_delta(state["outer_params"],
                                  {"w": torch.full((4,), 1.0)})
    db = optim.diloco_local_delta(state["outer_params"],
                                  {"w": torch.full((4,), 3.0)})
    deltas = {"w": (da["w"] + db["w"]) / 2}
    new_outer, state = optim.diloco_outer_update(state, deltas,
                                                 outer_lr=0.5,
                                                 outer_momentum=0.0)
    # mean delta = -2 -> outer moves +1 with lr 0.5
    np.testing.assert_allclose(new_outer["w"].numpy(), 1.0)


def test_int8_compression_bounded_error():
    x = torch.randn(256, generator=torch.Generator().manual_seed(0)) * 5
    p = optim.int8_compress(x)
    err = (optim.int8_decompress(p) - x).abs().max()
    assert float(err) <= float(p.scale) * 0.5 + 1e-6
    assert p.q.dtype == torch.int8


def test_topk_compression_with_error_feedback():
    x = torch.randn(64, generator=torch.Generator().manual_seed(1))
    payload, residual = optim.topk_compress(x, 8)
    np.testing.assert_allclose(
        (optim.topk_decompress(payload) + residual).numpy(), x.numpy(),
        rtol=1e-6)
    assert payload.values.shape == (8,)
