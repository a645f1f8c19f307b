"""The port's Mamba-2 block (``models/ssm.py``) against the reference's.

zamba2-7b reduced (d 128, d_inner 256, 8 heads of 32, state 16, conv 4,
chunk 32).  The reference's block parameters are made with ``jax.random``
and carried across as numpy; inputs come from numpy.  Tolerances:

* float32: 1e-5 for the conv and one decode step (the same f32 arithmetic
  in another summation order), 1e-4 for the chunked scan and the block
  (exponentials of cumulative sums over 4 chunks, then a norm and two
  projections);
* bfloat16 compute: 5e-2, the reference's own prefill/decode bound
  (``tests/test_arch_smoke.py``): activations are rounded to bf16 at the
  same points, in products whose summation order differs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rc
from repro.models import ssm as ref_ssm
from repro_torch import configs as tc
from repro_torch.models import ssm
from repro_torch.models.transformer import _map
from torch_parity import port_lockdep, to_np  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")

ARCH = "zamba2-7b"
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


@pytest.fixture(scope="module")
def block():
    arch_r = rc.reduced(rc.get_arch(ARCH))
    arch_t = tc.reduced(tc.get_arch(ARCH))
    params_r = ref_ssm.mamba2_init(jax.random.PRNGKey(0), arch_r)
    params_np = jax.device_get(params_r)
    return arch_r, arch_t, params_r, params_np


def _port(params_np, dtype=torch.float32):
    """The carried tree, ``dtype`` on the leaves the reference casts (f32
    leaves of ndim > 1)."""
    return {k: torch.from_numpy(np.array(v)).to(
        dtype if v.ndim > 1 else torch.float32) for k, v in params_np.items()}


def _ref(params_r, dtype):
    return jax.tree.map(lambda a: a.astype(dtype) if a.ndim > 1 else a,
                        params_r)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(to_np(got).astype(np.float32),
                               to_np(want).astype(np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def test_init_tree_matches_reference(block):
    """Same keys, shapes and dtypes; A_log, D and dt_bias stay f32 in a
    bf16 tree."""
    arch_r, arch_t, _, _ = block
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        ref = jax.eval_shape(lambda: ref_ssm.mamba2_init(
            jax.random.PRNGKey(0), arch_r, dtype=jdt))
        port = ssm.mamba2_init(torch.Generator().manual_seed(0), arch_t,
                               dtype=tdt)
        assert set(port) == set(ref)
        for k, a in ref.items():
            assert tuple(port[k].shape) == a.shape, k
            assert str(port[k].dtype).removeprefix("torch.") == a.dtype.name
    assert ssm.ssm_dims(arch_t) == ref_ssm.ssm_dims(arch_r) == (256, 8, 16)
    cache = ssm.mamba2_cache_init(arch_t, 2, torch.bfloat16, device="cpu")
    want = ref_ssm.mamba2_cache_init(arch_r, 2, jnp.bfloat16)
    assert _map(lambda t: (tuple(t.shape), str(t.dtype)), cache) == {
        k: (a.shape, "torch." + a.dtype.name) for k, a in want.items()}


def test_causal_conv_and_conv_step_match(block):
    """The shifted-add conv over a sequence, and the one-token conv that
    shifts its window IN PLACE, against the reference."""
    _, _, _, params_np = block
    rng = np.random.default_rng(1)
    w = np.array(params_np["conv_x"])
    x = rng.standard_normal((2, 40, w.shape[1])).astype(np.float32)
    _close(ssm.causal_conv(torch.from_numpy(x), torch.from_numpy(w)),
           ref_ssm.causal_conv(jnp.asarray(x), jnp.asarray(w)), 1e-5)
    state = rng.standard_normal((2, w.shape[0] - 1, w.shape[1])).astype(
        np.float32)
    tstate = torch.from_numpy(state.copy())
    y, s = ssm.conv_step(torch.from_numpy(x[:, 0]), tstate,
                         torch.from_numpy(w))
    wy, ws = ref_ssm.conv_step(jnp.asarray(x[:, 0]), jnp.asarray(state),
                               jnp.asarray(w))
    assert s is tstate, "the window is shifted in place"
    _close(y, wy, 1e-5)
    _close(s, ws, 1e-6)


def test_ssd_scan_and_step_match(block):
    """The plain chunked scan (with an initial state) and one recurrent
    step, against the reference's."""
    rng = np.random.default_rng(2)
    B, S, H, P, N = 2, 96, 4, 32, 16
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)) - 2, 0).astype(
        np.float32)
    a = (-dt).astype(np.float32)
    b, c = ((rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
            for _ in range(2))
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    args = (x, a, b, c, dt)
    y, st = ssm.ssd_scan(*(torch.from_numpy(v) for v in args), 32,
                         init_state=torch.from_numpy(s0))
    wy, ws = ref_ssm.ssd_scan(*(jnp.asarray(v) for v in args), 32,
                              init_state=jnp.asarray(s0))
    _close(y, wy, 1e-4)
    _close(st, ws, 1e-4)
    tstate = torch.from_numpy(s0.copy())
    y1, st1 = ssm.ssd_step(*(torch.from_numpy(v[:, 0]) for v in args),
                           tstate)
    wy1, ws1 = ref_ssm.ssd_step(*(jnp.asarray(v[:, 0]) for v in args),
                                jnp.asarray(s0))
    assert st1 is tstate, "the state is updated in place"
    _close(y1, wy1, 1e-5)
    _close(st1, ws1, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_mamba2_seq_matches(block, impl, dtype):
    """The block over a sequence and its decode cache (conv windows, f32
    state), REFERENCE (the plain scan) and FLASH (the SSD kernel's plain
    version on the CPU) against the reference's scan.  S=100 is not a
    multiple of the chunk: the scan takes chunks of 25, the kernel of 32
    with a ragged last one."""
    arch_r, arch_t, params_r, params_np = block
    jdt, tdt, tol = DTYPES[dtype]
    x = np.random.default_rng(3).standard_normal(
        (2, 100, arch_r.d_model)).astype(np.float32)
    want, wc = ref_ssm.mamba2_seq(_ref(params_r, jdt),
                                  jnp.asarray(x).astype(jdt), arch_r,
                                  return_state=True)
    got, gc = ssm.mamba2_seq(_port(params_np, tdt),
                             torch.from_numpy(x).to(tdt), arch_t,
                             return_state=True, impl=tc.AttnImpl(impl))
    assert got.dtype == tdt and gc["state"].dtype == torch.float32
    _close(got, want, tol)
    for key in wc:
        assert gc[key].shape == wc[key].shape, key
        _close(gc[key], wc[key], tol, key)
    assert torch.equal(ssm.mamba2_seq(_port(params_np, tdt),
                                      torch.from_numpy(x).to(tdt), arch_t,
                                      impl=tc.AttnImpl(impl)), got)


def test_mamba2_decode_matches(block):
    """Eight decode steps from a prefill cache: outputs and caches against
    the reference's, the cache written in place."""
    arch_r, arch_t, params_r, params_np = block
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 64, arch_r.d_model)).astype(np.float32)
    _, wc = ref_ssm.mamba2_seq(params_r, jnp.asarray(x), arch_r,
                               return_state=True)
    tparams = _port(params_np)
    gc = {k: torch.from_numpy(np.array(v)) for k, v in wc.items()}
    bufs = dict(gc)
    for t in range(8):
        x1 = rng.standard_normal((2, 1, arch_r.d_model)).astype(np.float32)
        wy, wc = ref_ssm.mamba2_decode(params_r, jnp.asarray(x1), wc, arch_r)
        gy, gc = ssm.mamba2_decode(tparams, torch.from_numpy(x1), gc, arch_t)
        _close(gy, wy, 1e-4, f"step {t}")
    for key in wc:
        assert gc[key] is bufs[key], f"{key} written in place"
        _close(gc[key], wc[key], 1e-4, key)
