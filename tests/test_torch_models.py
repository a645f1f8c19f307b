"""The port's model modules against the reference's, module by module.

Inputs are made by numpy from a seed and handed to both packages.  The
building blocks are compared in float32: rmsnorm, RoPE and the MLPs at
1e-6 (the same f32 arithmetic up to summation order), the attention paths
at 1e-5 (online softmax: exp and running sums in another order).  The
configs and the analytic counts are compared exactly.
"""
import dataclasses
import enum

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rc
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import model_zoo as ref_zoo
from repro_torch import configs as tc
from repro_torch.core.carry import params_from_numpy
from repro_torch.core.tree import tree_flatten
from repro_torch.models import attention, layers, model_zoo, transformer
from torch_parity import port_lockdep, to_np  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")

ARCH = "internlm2-1.8b"


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _plain(obj):
    """A config as plain values (enums by value), for cross-package ==."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    return obj.value if isinstance(obj, enum.Enum) else obj


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_arch_ids_and_shapes_match():
    assert tc.ARCH_IDS == rc.ARCH_IDS
    assert [_plain(s) for s in tc.SHAPES] == [_plain(s) for s in rc.SHAPES]
    for name in rc.SHAPES_BY_NAME:
        assert _plain(tc.get_shape(name)) == _plain(rc.get_shape(name))
        assert (_plain(tc.reduced_shape(tc.get_shape(name)))
                == _plain(rc.reduced_shape(rc.get_shape(name))))
    assert _plain(tc.EnokiConfig()) == _plain(rc.EnokiConfig())


@pytest.mark.parametrize("arch_id", rc.ARCH_IDS)
def test_configs_match(arch_id):
    full_t, full_r = tc.get_arch(arch_id), rc.get_arch(arch_id)
    assert _plain(full_t) == _plain(full_r)
    assert _plain(tc.reduced(full_t)) == _plain(rc.reduced(full_r))
    assert full_t.q_dim == full_r.q_dim and full_t.kv_dim == full_r.kv_dim
    for shape in rc.SHAPES:
        assert (tc.shape_applicable(full_t, tc.get_shape(shape.name))
                == rc.shape_applicable(full_r, shape))


@pytest.mark.parametrize("arch_id", rc.ARCH_IDS)
def test_analytic_counts_match(arch_id):
    arch_t, arch_r = tc.get_arch(arch_id), rc.get_arch(arch_id)
    assert arch_t.param_count() == arch_r.param_count()
    assert arch_t.active_param_count() == arch_r.active_param_count()
    for shape in rc.SHAPES:
        assert (model_zoo.model_flops(arch_t, tc.get_shape(shape.name))
                == ref_zoo.model_flops(arch_r, shape))


@pytest.mark.parametrize("arch_id", rc.ARCH_IDS)
@pytest.mark.parametrize("size", ["full", "reduced"])
def test_plan_matches_reference(arch_id, size):
    """Every registry id's plan, full and reduced: zamba2-7b is 13 groups
    of 6 Mamba-2 layers and the shared block, then a tail of 3; xlstm-350m
    is 3 groups of 7 mLSTM layers and 1 sLSTM layer; phi-3-vision plans as
    dense, grok-1 and kimi-k2 as moe, whisper-tiny as 4 encoder and 4
    decoder layers."""
    from repro.models import transformer as ref_transformer
    arch_t, arch_r = tc.get_arch(arch_id), rc.get_arch(arch_id)
    if size == "reduced":
        arch_t, arch_r = tc.reduced(arch_t), rc.reduced(arch_r)
    assert transformer.plan(arch_t) == ref_transformer.plan(arch_r)
    if arch_id == "zamba2-7b" and size == "full":
        assert transformer.plan(arch_t) == {"kind": "zamba", "groups": 13,
                                            "mamba_per": 6, "tail": 3}
    if arch_id == "xlstm-350m":
        assert transformer.plan(arch_t) == {
            "kind": "xlstm", "groups": 3 if size == "full" else 1,
            "mlstm_per": 7}
    if size == "full":
        want = {"phi-3-vision-4.2b": {"kind": "dense", "layers": 32},
                "grok-1-314b": {"kind": "moe", "layers": 64},
                "whisper-tiny": {"kind": "whisper", "enc": 4, "dec": 4}}
        if arch_id in want:
            assert transformer.plan(arch_t) == want[arch_id]


@pytest.mark.parametrize("arch_id", rc.ARCH_IDS)
def test_param_tree_matches_reference(arch_id):
    """Same keys, layer-stacked shapes and dtypes as the reference's tree
    (qkv biases for qwen, tied embeddings and GeGLU for gemma; zamba2's
    (G, per, ...) Mamba-2 stacks, tail and one shared block, with A_log, D
    and dt_bias f32 in a bf16 tree; xlstm's (G, 7, ...) mLSTM and (G, ...)
    sLSTM stacks, with w_if, b_i, b_f and the sLSTM bias f32; the moe
    router f32 in a bf16 tree and kimi-k2's shared expert; phi-3-vision's
    ``patch_proj``; whisper's encoder and decoder stacks, ``enc_norm`` and
    ``frame_proj``)."""
    arch_r, arch_t = rc.reduced(rc.get_arch(arch_id)), tc.reduced(
        tc.get_arch(arch_id))
    ref = jax.eval_shape(lambda: ref_zoo.init_params(
        arch_r, jax.random.PRNGKey(0)))
    port = model_zoo.init_params(arch_t, seed=0, device="cpu")
    ref_shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), ref)
    port_shapes = transformer._map(lambda t: tuple(t.shape), port)
    assert port_shapes == ref_shapes
    ref16 = jax.eval_shape(lambda: ref_zoo.init_params(
        arch_r, jax.random.PRNGKey(0), dtype=jnp.bfloat16))
    port16 = model_zoo.init_params(arch_t, seed=0, dtype=torch.bfloat16,
                                   device="cpu")
    assert transformer._map(lambda t: str(t.dtype).removeprefix("torch."),
                            port16) == jax.tree_util.tree_map(
        lambda a: a.dtype.name, ref16)
    carried = params_from_numpy(arch_t, jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), ref), device="cpu")
    assert transformer._map(lambda t: tuple(t.shape), carried) == ref_shapes


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_layernorm_matches():
    rng = np.random.default_rng(8)
    jx, tx = _both(rng.standard_normal((2, 8, 128)).astype(np.float32) * 3)
    js, ts = _both(1.0 + rng.standard_normal(128).astype(np.float32) * 0.1)
    jb, tb = _both(rng.standard_normal(128).astype(np.float32) * 0.1)
    for dtype in (torch.float32, torch.bfloat16):
        got = layers.layernorm(tx.to(dtype), ts, tb)
        assert got.dtype == dtype
        want = ref_layers.layernorm(jx.astype(jnp.dtype(str(dtype)[6:])),
                                    js, jb)
        tol = 1e-6 if dtype == torch.float32 else 1e-2
        np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("max_len,dim", [(1500, 384), (448, 384), (8, 128),
                                         (5, 2)])
def test_sinusoidal_positions_match(max_len, dim):
    """Whisper's position table (encoder frames, decoder context, reduced
    width, and a width whose half is 1).  Each package's f32 ``exp`` of the
    frequencies may differ by an ulp, which the angle pos x freq carries
    times pos: the tolerance is a few ulp of the largest angle."""
    got = layers.sinusoidal_positions(max_len, dim, device="cpu")
    want = ref_layers.sinusoidal_positions(max_len, dim)
    assert got.shape == (max_len, dim) and got.dtype == torch.float32
    tol = max(1e-6, max_len * 2.0 ** -22)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=0, atol=tol)


def test_rmsnorm_matches():
    rng = np.random.default_rng(0)
    jx, tx = _both(rng.standard_normal((2, 8, 128)).astype(np.float32) * 3)
    js, ts = _both(rng.standard_normal(128).astype(np.float32) * 0.1)
    np.testing.assert_allclose(to_np(layers.rmsnorm(tx, ts)),
                               to_np(ref_layers.rmsnorm(jx, js)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0, 0.0])
def test_apply_rope_matches(theta):
    rng = np.random.default_rng(1)
    jx, tx = _both(rng.standard_normal((2, 16, 4, 32)).astype(np.float32))
    pos = rng.integers(0, 4096, (2, 16)).astype(np.int32)
    jp, tp = _both(pos)
    np.testing.assert_allclose(to_np(layers.apply_rope(tx, tp, theta)),
                               to_np(ref_layers.apply_rope(jx, jp, theta)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", list(rc.Activation))
def test_mlp_apply_matches(kind):
    rng = np.random.default_rng(2)
    d, f = 64, 128
    names = (("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d))) \
        if kind in (rc.Activation.SWIGLU, rc.Activation.GEGLU) else \
        (("w_up", (d, f)), ("b_up", (f,)), ("w_down", (f, d)),
         ("b_down", (d,)))
    arrs = {n: (rng.standard_normal(s) * d ** -0.5).astype(np.float32)
            for n, s in names}
    jx, tx = _both(rng.standard_normal((2, 8, d)).astype(np.float32))
    got = layers.mlp_apply({n: torch.from_numpy(a) for n, a in arrs.items()},
                           tx, tc.Activation(kind.value))
    want = ref_layers.mlp_apply({n: jnp.asarray(a) for n, a in arrs.items()},
                                jx, kind)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _qkv(seed, B=2, S=64, H=4, KV=2, D=32):
    rng = np.random.default_rng(seed)
    return [_both(rng.standard_normal(shape).astype(np.float32))
            for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))]


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 16)])
@pytest.mark.parametrize("block", [16, 64])
def test_blockwise_and_qscan_match(causal, window, block):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(3)
    B, S = 2, 64
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    jp, tp = _both(pos)
    got = attention.blockwise_attention(tq, tk, tv, tp, tp, causal=causal,
                                        window=window, kv_block=block)
    want = ref_attn.blockwise_attention(jq, jk, jv, jp, jp, causal=causal,
                                        window=window, kv_block=block)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-5, atol=1e-5)
    got = attention.qscan_attention(tq, tk, tv, tp, tp, causal=causal,
                                    window=window, q_block=block)
    want = ref_attn.qscan_attention(jq, jk, jv, jp, jp, causal=causal,
                                    window=window, q_block=block)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-5, atol=1e-5)
    got = attention.reference_attention(tq, tk, tv, tp, tp, causal=causal,
                                        window=window)
    want = ref_attn.reference_attention(jq, jk, jv, jp, jp, causal=causal,
                                        window=window)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("length,window", [(0, 0), (37, 0), (63, 0),
                                           (40, 8)])
def test_decode_self_attention_matches(length, window):
    arch_r = rc.reduced(rc.get_arch(ARCH))
    arch_t = tc.reduced(tc.get_arch(ARCH))
    params = jax.device_get(ref_attn.attn_init(jax.random.PRNGKey(4),
                                               arch_r))
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    rng = np.random.default_rng(5)
    B, Smax, KV, D = 2, 64, arch_r.num_kv_heads, arch_r.resolved_head_dim
    jx, tx = _both(rng.standard_normal((B, 1, arch_r.d_model))
                   .astype(np.float32))
    ck = rng.standard_normal((B, Smax, KV, D)).astype(np.float32)
    cv = rng.standard_normal((B, Smax, KV, D)).astype(np.float32)
    want, wk, wv = ref_attn.decode_self_attention(
        params, jx, jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(length, jnp.int32), arch_r, window=window)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, gk, gv = attention.decode_self_attention(
        tparams, tx, tk, tv, torch.tensor(length, dtype=torch.int32), arch_t,
        window=window)
    assert gk is tk and gv is tv, "the cache is written in place"
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(gk), to_np(wk), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to_np(gv), to_np(wv), rtol=1e-6, atol=1e-6)


def test_self_attention_impls_match_reference():
    """self_attention under REFERENCE, QSCAN and FLASH against the
    reference's REFERENCE path on the same weights (f32)."""
    arch_r = rc.reduced(rc.get_arch(ARCH))
    arch_t = tc.reduced(tc.get_arch(ARCH))
    params = jax.device_get(ref_attn.attn_init(jax.random.PRNGKey(6),
                                               arch_r))
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    rng = np.random.default_rng(7)
    B, S = 2, 64
    jx, tx = _both(rng.standard_normal((B, S, arch_r.d_model))
                   .astype(np.float32))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    jp, tp = _both(pos)
    want = ref_attn.self_attention(params, jx, jp, arch_r)
    for impl in tc.AttnImpl:
        got = attention.self_attention(tparams, tx, tp, arch_t, impl=impl)
        np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-5,
                                   atol=1e-5, err_msg=impl.value)


@pytest.mark.parametrize("Sq,Skv", [(1, 8), (16, 8), (5, 100)])
def test_cross_attention_and_project_cross_kv_match(Sq, Skv):
    """Whisper's cross-attention against the encoder output's K/V (every
    query sees every frame; 100 frames: the reference's kv blocks of 4)."""
    arch_r = rc.reduced(rc.get_arch("whisper-tiny"))
    arch_t = tc.reduced(tc.get_arch("whisper-tiny"))
    params = jax.device_get(ref_attn.attn_init(jax.random.PRNGKey(9),
                                               arch_r))
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    rng = np.random.default_rng(10)
    jenc, tenc = _both(rng.standard_normal((2, Skv, arch_r.d_model))
                       .astype(np.float32))
    jx, tx = _both(rng.standard_normal((2, Sq, arch_r.d_model))
                   .astype(np.float32))
    wk, wv = ref_attn.project_cross_kv(params, jenc, arch_r)
    gk, gv = attention.project_cross_kv(tparams, tenc, arch_t)
    np.testing.assert_allclose(to_np(gk), to_np(wk), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to_np(gv), to_np(wv), rtol=1e-6, atol=1e-6)
    want = ref_attn.cross_attention(params, jx, wk, wv, arch_r)
    got = attention.cross_attention(tparams, tx, gk, gv, arch_t)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# caches, input specs and example batches
# ---------------------------------------------------------------------------

NEW_FAMILIES = ["grok-1-314b", "kimi-k2-1t-a32b", "phi-3-vision-4.2b",
                "whisper-tiny"]


@pytest.mark.parametrize("arch_id", NEW_FAMILIES)
@pytest.mark.parametrize("size", ["full", "reduced"])
def test_cache_specs_match_reference(arch_id, size):
    """``init_cache``'s tree on the meta device (``cache_specs``) against
    the reference's ``eval_shape``: the moe k/v, whisper's self K/V of the
    decode context and cross K/V of the encoder's frames; no storage."""
    arch_r, arch_t = rc.get_arch(arch_id), tc.get_arch(arch_id)
    if size == "reduced":
        arch_r, arch_t = rc.reduced(arch_r), tc.reduced(arch_t)
    shape_r = rc.get_shape("decode_32k")
    shape_t = tc.get_shape("decode_32k")
    want = ref_zoo.cache_specs(arch_r, shape_r)
    got = model_zoo.cache_specs(arch_t, shape_t)
    assert all(t.is_meta for t in tree_flatten(got)[0])
    assert transformer._map(lambda t: (tuple(t.shape), str(t.dtype)),
                            got) == jax.tree.map(
        lambda a: (tuple(a.shape), "torch." + a.dtype.name), want)


@pytest.mark.parametrize("arch_id", NEW_FAMILIES + ["internlm2-1.8b"])
@pytest.mark.parametrize("step", ["train", "prefill", "decode"])
def test_input_specs_and_example_batch(arch_id, step):
    """``input_specs`` as the reference's (names, shapes, dtypes), and
    ``example_batch`` materialises them on the generator's device: tokens
    in [0, min(vocab, 1000)), stubs of scale 0.02, the vlm's loss mask 0
    on its patch positions."""
    arch_r, arch_t = rc.reduced(rc.get_arch(arch_id)), tc.reduced(
        tc.get_arch(arch_id))
    shape_r = rc.reduced_shape(next(s for s in rc.SHAPES
                                    if s.step.value == step))
    shape_t = tc.reduced_shape(tc.get_shape(shape_r.name))
    want = ref_zoo.input_specs(arch_r, shape_r)
    specs = model_zoo.input_specs(arch_t, shape_t)
    assert {k: (tuple(d), str(t)) for k, (d, t) in specs.items()} == {
        k: (tuple(v.shape), "torch." + v.dtype.name) for k, v in want.items()}
    batch = model_zoo.example_batch(arch_t, shape_t,
                                    torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == {
        k: (tuple(d), t) for k, (d, t) in specs.items()}
    for name, x in batch.items():
        if x.dtype == torch.int32:
            assert int(x.min()) >= 0 and int(x.max()) < min(
                arch_t.vocab_size, 1000)
        elif name.endswith("_embeds"):
            assert 0.01 < float(x.std()) < 0.04
    if "loss_mask" in batch:
        n = arch_t.num_patches if arch_t.frontend_stub == "clip_patches" \
            else 0
        assert float(batch["loss_mask"][:, :n].sum()) == 0.0
        assert bool((batch["loss_mask"][:, n:] == 1).all())


def test_params_shape_tree_is_meta():
    """``serve.params_shape_tree``: the serving tree (bf16, the router
    f32) on the meta device, shaped as the reference's."""
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve
    for arch_id in ("grok-1-314b", "whisper-tiny"):
        arch_r, arch_t = rc.get_arch(arch_id), tc.get_arch(arch_id)
        want = ref_serve.params_shape_tree(arch_r)
        got = serve.params_shape_tree(arch_t)
        assert transformer._map(
            lambda t: (tuple(t.shape), str(t.dtype), t.is_meta), got) == \
            jax.tree.map(lambda a: (tuple(a.shape), "torch." + a.dtype.name,
                                    True), want)
