"""The port's mLSTM chunk kernel against the reference Pallas kernel.

On the CPU the port's wrapper takes its plain version (the TPU kernel's
per-chunk algebra over the same chunks); the reference kernel runs in Pallas
interpret mode, as ``tests/test_kernels.py`` runs it.  Inputs are made by
numpy from a seed (``test_kernels.py``'s distributions: normal q/k/v,
log-sigmoid gates shifted by -2 and +2) and cast in each framework.
Tolerances are the reference's own (``tests/test_kernels.py``): 1e-4 in
float32 (exponentials of cumulative sums and matrix products in another
summation order) and 5e-2 in bfloat16 (both round the output to bf16, after
f32 products in another order).  The final carry, which the TPU kernel
drops, is held to the reference's ``mlstm_cell_seq`` carry at 1e-4.  The
CUDA kernel against this plain version is ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_chunk.kernel import mlstm_chunk_bhsd as ref_kernel
from repro.kernels.mlstm_chunk.ops import mlstm_chunk as ref_ops
from repro.kernels.mlstm_chunk.ref import mlstm_chunk_ref as ref_oracle
from repro.models import xlstm as ref_xlstm
from repro_torch.kernels.mlstm_chunk import kernel as mk
from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk
from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_ref
from torch_parity import port_lockdep, to_np  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")

_DT = {"float32": (jnp.float32, torch.float32, 1e-4),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
# tests/test_kernels.py's sweep, then reduced xlstm-350m's head dim 128:
# (B, H, S, d, chunk)
SHAPES = [(1, 2, 128, 32, 32), (2, 2, 64, 64, 16), (1, 4, 256, 16, 64),
          (2, 2, 64, 128, 16)]


def _inputs(seed, B, H, S, d, dtype="float32", gate_shift=2.0):
    """Kernel-layout q/k/v (B,H,S,d) and f32 gates (B,H,S) as numpy, then
    in each framework (q/k/v in ``dtype``)."""
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal((B, H, S, d)).astype(np.float32)
           for _ in range(3)]
    log_sig = lambda x: -np.logaddexp(0.0, -x)
    gates = [log_sig(rng.standard_normal((B, H, S)) - gate_shift)
             .astype(np.float32),
             log_sig(rng.standard_normal((B, H, S)) + gate_shift)
             .astype(np.float32)]
    jdt, tdt, tol = _DT[dtype]
    jin = [jnp.asarray(a).astype(jdt) for a in qkv] + \
        [jnp.asarray(g) for g in gates]
    tin = [torch.from_numpy(a).to(tdt) for a in qkv] + \
        [torch.from_numpy(g) for g in gates]
    return jin, tin, tol


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(to_np(got).astype(np.float32),
                               to_np(want).astype(np.float32), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("B,H,S,d,chunk", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_matches_pallas_interpret(B, H, S, d, chunk, dtype):
    jin, tin, tol = _inputs(0, B, H, S, d, dtype)
    n0 = mk.mlstm_chunk_bhsd.launches
    h, (C, n, m) = mk.mlstm_chunk_bhsd(*tin, chunk=chunk)
    assert mk.mlstm_chunk_bhsd.launches == n0, "a CPU call launched"
    assert h.shape == tin[0].shape and h.dtype == tin[0].dtype
    assert C.shape == (B, H, d, d) and n.shape == (B, H, d) \
        and m.shape == (B, H)
    assert C.dtype == n.dtype == m.dtype == torch.float32
    _close(h, ref_kernel(*jin, chunk=chunk, interpret=True), tol)


@pytest.mark.parametrize("B,H,S,d,chunk", SHAPES)
def test_final_carry_matches_mlstm_cell_seq(B, H, S, d, chunk):
    """The carry the TPU kernel drops, against the reference cell's final
    (C, n, m) on the same inputs; the port's oracle (``ref.py``, the plain
    ``mlstm_cell_seq``) gives the same h and carry."""
    jin, tin, tol = _inputs(1, B, H, S, d)
    h, carry = mk.mlstm_chunk_bhsd(*tin, chunk=chunk)
    t = lambda x: x.transpose(0, 2, 1, 3)
    g = lambda x: x.transpose(0, 2, 1)
    wh, wcarry = ref_xlstm.mlstm_cell_seq(t(jin[0]), t(jin[1]), t(jin[2]),
                                          g(jin[3]), g(jin[4]), chunk)
    for got, want, name in zip(carry, wcarry, "Cnm"):
        _close(got, want, tol, name)
    oh, ocarry = mlstm_chunk_ref(*tin, chunk=chunk)
    _close(oh, t(wh), tol, "oracle h")
    _close(oh, ref_oracle(*jin, chunk=chunk), tol, "reference oracle")
    for got, want, name in zip(ocarry, wcarry, "Cnm"):
        _close(got, want, tol, f"oracle {name}")


def test_mlstm_matches_stepwise():
    """The chunkwise form == the step-by-step recurrence (ground truth, the
    reference's ``mlstm_cell_step``), outputs and final carry; the port's
    step (which updates its carry in place) agrees too."""
    B, H, S, d = 1, 2, 32, 16
    jin, tin, tol = _inputs(2, B, H, S, d, gate_shift=1.0)
    h, carry = mk.mlstm_chunk_bhsd(*tin, chunk=8)
    from repro_torch.models.xlstm import mlstm_cell_step
    jcarry = (jnp.zeros((B, H, d, d)), jnp.zeros((B, H, d)),
              jnp.zeros((B, H)))
    tcarry = (torch.zeros((B, H, d, d)), torch.zeros((B, H, d)),
              torch.zeros((B, H)))
    bufs = tcarry
    ys, ts = [], []
    for t in range(S):
        y, jcarry = ref_xlstm.mlstm_cell_step(
            *(a[:, :, t] for a in jin), jcarry)
        ys.append(y)
        yt, tcarry = mlstm_cell_step(*(a[:, :, t] for a in tin), tcarry)
        ts.append(yt)
    assert all(a is b for a, b in zip(tcarry, bufs)), "carry in place"
    _close(h, jnp.stack(ys, axis=2), tol)
    _close(torch.stack(ts, dim=2), jnp.stack(ys, axis=2), 1e-5)
    for got, want, name in zip(carry, jcarry, "Cnm"):
        _close(got, want, tol, name)
        _close(tcarry["Cnm".index(name)], want, 1e-5, f"step {name}")


@pytest.mark.parametrize("S,chunk", [(96, 32), (64, 64)])
def test_ops_in_the_model_layout(S, chunk):
    """``ops.mlstm_chunk`` in the model layout (q/k/v (B,S,H,d), gates
    (B,S,H)) against the reference wrapper in interpret mode; the kernel
    reads it through strided views and writes h through one."""
    B, H, d = 2, 3, 32
    jin, tin, tol = _inputs(3, B, H, S, d)
    t4 = lambda x: x.transpose(1, 2).contiguous()
    tj4 = lambda x: x.transpose(0, 2, 1, 3)
    tj3 = lambda x: x.transpose(0, 2, 1)
    h, carry = mlstm_chunk(*(t4(x) for x in tin), chunk=chunk)
    assert h.shape == (B, S, H, d) and h.is_contiguous()
    want = ref_ops(*(tj4(x) for x in jin[:3]), *(tj3(x) for x in jin[3:]),
                   chunk=chunk, interpret=True)
    _close(h, want, tol)
    _, direct = mk.mlstm_chunk_bhsd(*tin, chunk=chunk)
    for got, same in zip(carry, direct):
        assert torch.equal(got, same)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    _, (q, k, v, li, lf), _ = _inputs(4, 1, 2, 64, 32)
    with pytest.raises(ValueError, match="chunk"):
        mk.mlstm_chunk_bhsd(q, k, v, li, lf, chunk=0)
    with pytest.raises(ValueError, match="does not divide"):
        mk.mlstm_chunk_bhsd(q, k, v, li, lf, chunk=48)
    with pytest.raises(ValueError, match="head dim"):
        z = torch.zeros(1, 2, 64, 40)
        mk.mlstm_chunk_bhsd(z, z, z, li, lf)
    with pytest.raises(ValueError, match="head dim"):
        z = torch.zeros(1, 2, 64, 528)
        mk.mlstm_chunk_bhsd(z, z, z, li, lf)
    with pytest.raises(ValueError, match="dqk == dv"):
        mk.mlstm_chunk_bhsd(q, k, torch.zeros(1, 2, 64, 16), li, lf)
    with pytest.raises(ValueError, match="dtype"):
        mk.mlstm_chunk_bhsd(q, k.bfloat16(), v, li, lf)
    with pytest.raises(ValueError, match="float32"):
        mk.mlstm_chunk_bhsd(q, k, v, li.bfloat16(), lf)
    with pytest.raises(ValueError, match="do not match"):
        mk.mlstm_chunk_bhsd(q, k, v, li[:, :1], lf)
    with pytest.raises(ValueError, match="contiguous"):
        z = torch.zeros(1, 2, 32, 64).transpose(2, 3)
        mk.mlstm_chunk_bhsd(z, z, z, li, lf)
    with pytest.raises(ValueError, match="device"):
        mk.mlstm_chunk_bhsd(*(t.to("meta") for t in (q, k, v, li, lf)))


@pytest.mark.parametrize("d,tiles", [(16, 1), (32, 1), (48, 1), (64, 1),
                                     (80, 2), (128, 2), (192, 3), (512, 8)])
def test_column_tiles(d, tiles):
    """One CTA of the chunk kernel per 64 columns of C: 8 at xlstm-350m's
    d = 512, 2 at reduced xlstm's 128, 1 at d <= 64."""
    assert mk.column_tiles(d) == tiles


def test_column_tiles_refuse_what_the_kernel_does_not_take():
    for d in (0, 528):
        with pytest.raises(ValueError, match="head dim"):
            mk.column_tiles(d)
