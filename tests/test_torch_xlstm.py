"""The port's xLSTM blocks (``models/xlstm.py``) against the reference's.

xlstm-350m reduced (d 128, 8 layers as 1 group of 7 mLSTM + 1 sLSTM; mLSTM
d_inner 256, 2 heads of 128, chunk 16; sLSTM 2 heads of 64, FFN 170).  The
reference's block parameters are made with ``jax.random`` and carried
across as numpy; the groupnorm scales, which the reference initialises to
zero (so a block's output would be 0), are drawn by numpy around 1 for both
packages.  Inputs come from numpy.  Tolerances:

* float32: 1e-6 for the groupnorm, 1e-5 for one recurrent step, 1e-4 for
  the chunkwise cell, the blocks and several decode steps (exponentials of
  cumulative sums, matrix products in another summation order, then a norm
  and two projections); elementwise ``allclose``;
* bfloat16 compute: 5e-2 relative to the tensor's largest magnitude, the
  reference's own prefill/decode bound (``tests/test_arch_smoke.py``):
  activations are rounded to bf16 at the same points, in products whose
  summation order differs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rc
from repro.models import layers as ref_layers
from repro.models import xlstm as ref_xlstm
from repro_torch import configs as tc
from repro_torch.models import layers, xlstm
from repro_torch.models.transformer import _map
from torch_parity import port_lockdep, to_np  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")

ARCH = "xlstm-350m"
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _unit_norms(params_np, seed):
    rng = np.random.default_rng(seed)
    out = dict(params_np)
    out["norm"] = (1.0 + 0.1 * rng.standard_normal(params_np["norm"].shape)
                   ).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def blocks():
    arch_r = rc.reduced(rc.get_arch(ARCH))
    arch_t = tc.reduced(tc.get_arch(ARCH))
    m_np = _unit_norms(jax.device_get(ref_xlstm.mlstm_init(
        jax.random.PRNGKey(0), arch_r)), 1)
    s_np = _unit_norms(jax.device_get(ref_xlstm.slstm_init(
        jax.random.PRNGKey(2), arch_r)), 3)
    return arch_r, arch_t, m_np, s_np


def _port(params_np, dtype=torch.float32):
    """The carried tree, ``dtype`` on the leaves the reference casts (f32
    leaves of ndim > 1)."""
    return {k: torch.from_numpy(np.array(v)).to(
        dtype if v.ndim > 1 else torch.float32) for k, v in params_np.items()}


def _ref(params_np, dtype):
    return {k: jnp.asarray(v).astype(dtype if v.ndim > 1 else jnp.float32)
            for k, v in params_np.items()}


def _rel(got, want) -> float:
    got, want = to_np(got).astype(np.float32), to_np(want).astype(np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


def _close(got, want, tol, what=""):
    """f32 tolerances elementwise, bf16 relative to the largest magnitude."""
    if tol >= 5e-2:
        assert _rel(got, want) < tol, what
        return
    np.testing.assert_allclose(to_np(got).astype(np.float32),
                               to_np(want).astype(np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_init_trees_match_reference(blocks):
    """Same keys, shapes and dtypes for both cells and their caches;
    ``w_if``, ``b_i``, ``b_f`` and the sLSTM bias stay f32 in a bf16 tree."""
    arch_r, arch_t, _, _ = blocks
    gen = torch.Generator().manual_seed(0)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        for ref_init, port_init in ((ref_xlstm.mlstm_init, xlstm.mlstm_init),
                                    (ref_xlstm.slstm_init, xlstm.slstm_init)):
            ref = jax.eval_shape(lambda: ref_init(jax.random.PRNGKey(0),
                                                  arch_r, dtype=jdt))
            port = port_init(gen, arch_t, dtype=tdt)
            assert set(port) == set(ref)
            for k, a in ref.items():
                assert tuple(port[k].shape) == a.shape, k
                assert str(port[k].dtype).removeprefix("torch.") == \
                    a.dtype.name, k
        for ref_cache, port_cache in (
                (ref_xlstm.mlstm_cache_init, xlstm.mlstm_cache_init),
                (ref_xlstm.slstm_cache_init, xlstm.slstm_cache_init)):
            want = ref_cache(arch_r, 2, jdt)
            got = port_cache(arch_t, 2, tdt, device="cpu")
            assert _map(lambda t: (tuple(t.shape), str(t.dtype)), got) == {
                k: (a.shape, "torch." + a.dtype.name)
                for k, a in want.items()}
    assert xlstm.mlstm_dims(arch_t) == ref_xlstm.mlstm_dims(arch_r) \
        == (256, 2, 128)
    full_t, full_r = tc.get_arch(ARCH), rc.get_arch(ARCH)
    assert xlstm.mlstm_dims(full_t) == ref_xlstm.mlstm_dims(full_r) \
        == (2048, 4, 512)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_groupnorm_heads_matches(dtype):
    """The population variance (``torch.var`` is unbiased by default, which
    would differ by (Dh-1)/Dh inside the rsqrt); f32 at 1e-6, bf16 within one
    bf16 rounding of the same f32 value (2**-7 relative)."""
    jdt, tdt, _ = DTYPES[dtype]
    x = _x(0, (2, 8, 4, 32)) * 3 + 1
    scale = 1.0 + 0.1 * _x(1, (4, 32))
    got = layers.groupnorm_heads(torch.from_numpy(x).to(tdt),
                                 torch.from_numpy(scale).to(tdt))
    want = ref_layers.groupnorm_heads(jnp.asarray(x).astype(jdt),
                                      jnp.asarray(scale).astype(jdt))
    assert got.dtype == tdt
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol, atol=tol)


def test_mlstm_cell_seq_and_the_divisor_rule():
    """The plain chunkwise cell from a non-zero carry (S=96 in chunks of 32)
    and at S=100, where chunk 16 becomes the largest divisor, 10."""
    rng = np.random.default_rng(4)
    for S, chunk in ((96, 32), (100, 16)):
        B, H, d = 2, 2, 32
        qkv = [rng.standard_normal((B, S, H, d)).astype(np.float32)
               for _ in range(3)]
        li = -np.logaddexp(0, -(rng.standard_normal((B, S, H)) - 2))
        lf = -np.logaddexp(0, -(rng.standard_normal((B, S, H)) + 2))
        carry = (rng.standard_normal((B, H, d, d)).astype(np.float32),
                 rng.standard_normal((B, H, d)).astype(np.float32),
                 rng.standard_normal((B, H)).astype(np.float32))
        args = qkv + [li.astype(np.float32), lf.astype(np.float32)]
        h, c = xlstm.mlstm_cell_seq(*(torch.from_numpy(a) for a in args),
                                    chunk, carry=tuple(
                                        torch.from_numpy(a) for a in carry))
        wh, wc = ref_xlstm.mlstm_cell_seq(*(jnp.asarray(a) for a in args),
                                          chunk, carry=tuple(
                                              jnp.asarray(a) for a in carry))
        _close(h, wh, 1e-4, f"h S={S}")
        for g, w, name in zip(c, wc, "Cnm"):
            _close(g, w, 1e-4, f"{name} S={S}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_mlstm_seq_matches(blocks, impl, dtype):
    """The mLSTM block over a sequence and its decode cache (conv window,
    f32 C, n, m), REFERENCE (the plain cell) and FLASH (the kernel's plain
    version on the CPU) against the reference's cell."""
    arch_r, arch_t, m_np, _ = blocks
    jdt, tdt, tol = DTYPES[dtype]
    x = _x(5, (2, 64, arch_r.d_model))
    want, wc = ref_xlstm.mlstm_seq(_ref(m_np, jdt),
                                   jnp.asarray(x).astype(jdt), arch_r,
                                   return_state=True)
    got, gc = xlstm.mlstm_seq(_port(m_np, tdt), torch.from_numpy(x).to(tdt),
                              arch_t, return_state=True,
                              impl=tc.AttnImpl(impl))
    assert got.dtype == tdt and gc["C"].dtype == torch.float32
    assert gc["conv"].dtype == tdt
    _close(got, want, tol)
    for key in wc:
        assert gc[key].shape == wc[key].shape, key
        _close(gc[key], wc[key], tol, key)
    assert torch.equal(xlstm.mlstm_seq(_port(m_np, tdt),
                                       torch.from_numpy(x).to(tdt), arch_t,
                                       impl=tc.AttnImpl(impl)), got)


def test_mlstm_decode_matches(blocks):
    """Eight decode steps from a prefill cache: outputs and caches against
    the reference's, every leaf written in place."""
    arch_r, arch_t, m_np, _ = blocks
    x = _x(6, (2, 48, arch_r.d_model))
    params_r = _ref(m_np, jnp.float32)
    _, wc = ref_xlstm.mlstm_seq(params_r, jnp.asarray(x), arch_r,
                                return_state=True)
    tparams = _port(m_np)
    gc = {k: torch.from_numpy(np.array(v)) for k, v in wc.items()}
    bufs = dict(gc)
    for t in range(8):
        x1 = _x(100 + t, (2, 1, arch_r.d_model))
        wy, wc = ref_xlstm.mlstm_decode(params_r, jnp.asarray(x1), wc, arch_r)
        gy, gc = xlstm.mlstm_decode(tparams, torch.from_numpy(x1), gc, arch_t)
        _close(gy, wy, 1e-4, f"step {t}")
    for key in wc:
        assert gc[key] is bufs[key], f"{key} written in place"
        _close(gc[key], wc[key], 1e-4, key)


def test_slstm_cell_step_matches(blocks):
    """One sLSTM timestep from a non-zero carry; the carry handed in is left
    as it was (the step returns new tensors)."""
    arch_r, arch_t, _, s_np = blocks
    B, d, h = 2, arch_r.d_model, arch_r.xlstm.num_heads
    dh = d // h
    rng = np.random.default_rng(7)
    wx = rng.standard_normal((B, 4 * d)).astype(np.float32)
    carry = (rng.standard_normal((B, h, dh)).astype(np.float32),
             np.abs(rng.standard_normal((B, h, dh))).astype(np.float32) + .5,
             rng.standard_normal((B, h)).astype(np.float32),
             rng.standard_normal((B, h, dh)).astype(np.float32))
    tcarry = tuple(torch.from_numpy(a.copy()) for a in carry)
    got, ghid = xlstm.slstm_cell_step(torch.from_numpy(wx),
                                      torch.from_numpy(np.array(s_np["r"])),
                                      torch.from_numpy(np.array(s_np["b"])),
                                      tcarry, h)
    want, whid = ref_xlstm.slstm_cell_step(
        jnp.asarray(wx), jnp.asarray(s_np["r"]), jnp.asarray(s_np["b"]),
        tuple(jnp.asarray(a) for a in carry), h)
    for g, w, name in zip(got, want, "cnmh"):
        _close(g, w, 1e-5, name)
    _close(ghid, whid, 1e-5, "hid")
    for t, a in zip(tcarry, carry):
        np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_seq_matches(blocks, dtype):
    """The sLSTM block (the sequential cell as a Python loop, groupnorm,
    GeGLU FFN with the tanh GELU) and its final state."""
    arch_r, arch_t, _, s_np = blocks
    jdt, tdt, tol = DTYPES[dtype]
    x = _x(8, (2, 64, arch_r.d_model))
    want, wc = ref_xlstm.slstm_seq(_ref(s_np, jdt),
                                   jnp.asarray(x).astype(jdt), arch_r,
                                   return_state=True)
    got, gc = xlstm.slstm_seq(_port(s_np, tdt), torch.from_numpy(x).to(tdt),
                              arch_t, return_state=True)
    assert got.dtype == tdt and gc["h"].dtype == tdt
    assert gc["c"].dtype == gc["n"].dtype == gc["m"].dtype == torch.float32
    _close(got, want, tol)
    for key in wc:
        assert gc[key].shape == wc[key].shape, key
        _close(gc[key], wc[key], tol, key)


def test_slstm_decode_matches(blocks):
    """Eight decode steps from a prefill state: outputs and caches against
    the reference's, every leaf written in place."""
    arch_r, arch_t, _, s_np = blocks
    x = _x(9, (2, 32, arch_r.d_model))
    params_r = _ref(s_np, jnp.float32)
    _, wc = ref_xlstm.slstm_seq(params_r, jnp.asarray(x), arch_r,
                                return_state=True)
    tparams = _port(s_np)
    gc = {k: torch.from_numpy(np.array(v)) for k, v in wc.items()}
    bufs = dict(gc)
    for t in range(8):
        x1 = _x(200 + t, (2, 1, arch_r.d_model))
        wy, wc = ref_xlstm.slstm_decode(params_r, jnp.asarray(x1), wc, arch_r)
        gy, gc = xlstm.slstm_decode(tparams, torch.from_numpy(x1), gc, arch_t)
        _close(gy, wy, 1e-4, f"step {t}")
    for key in wc:
        assert gc[key] is bufs[key], f"{key} written in place"
        _close(gc[key], wc[key], 1e-4, key)
