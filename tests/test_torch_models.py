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


@pytest.mark.parametrize("arch_id", [
    a for a in rc.ARCH_IDS
    if rc.get_arch(a).family not in ("dense", "hybrid", "ssm")])
def test_unported_families_raise(arch_id):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        transformer.plan(tc.get_arch(arch_id))


@pytest.mark.parametrize("arch_id", ["internlm2-1.8b", "zamba2-7b",
                                     "xlstm-350m"])
@pytest.mark.parametrize("size", ["full", "reduced"])
def test_plan_matches_reference(arch_id, size):
    """The ported plans, full and reduced: zamba2-7b is 13 groups of 6
    Mamba-2 layers and the shared block, then a tail of 3; xlstm-350m is 3
    groups of 7 mLSTM layers and 1 sLSTM layer."""
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


@pytest.mark.parametrize("arch_id", ["internlm2-1.8b", "gemma-7b",
                                     "qwen1.5-32b", "zamba2-7b",
                                     "xlstm-350m"])
def test_param_tree_matches_reference(arch_id):
    """Same keys, layer-stacked shapes and dtypes as the reference's tree
    (qkv biases for qwen, tied embeddings and GeGLU for gemma; zamba2's
    (G, per, ...) Mamba-2 stacks, tail and one shared block, with A_log, D
    and dt_bias f32 in a bf16 tree; xlstm's (G, 7, ...) mLSTM and (G, ...)
    sLSTM stacks, with w_if, b_i, b_f and the sLSTM bias f32)."""
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
