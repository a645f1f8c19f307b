"""The port's SSD chunk kernel against the reference Pallas kernel.

On the CPU the port's wrapper takes its plain version (the same per-chunk
algebra over the same chunks); the reference kernel runs in Pallas interpret
mode, as ``tests/test_kernels.py`` runs it.  Inputs are made by numpy from a
seed and cast in each framework.  Tolerances are the reference's own
(``tests/test_kernels.py``): 1e-4 in float32 (summation order and the
exponentials of a cumulative sum taken in another order) and 5e-2 in
bfloat16 (both round the output to bf16, after products taken in f32 in
another order).  The CUDA kernel against this plain version is
``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_chunk.kernel import ssd_chunk_bhcp as ref_kernel
from repro.kernels.ssd_chunk.ops import ssd_chunk as ref_ops
from repro.models import ssm as ref_ssm
from repro_torch.kernels.ssd_chunk import kernel as sk
from repro_torch.kernels.ssd_chunk.ops import ssd_chunk
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref
from repro_torch.models import ssm
from torch_parity import port_lockdep, to_np  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")

_DT = {"float32": (jnp.float32, torch.float32, 1e-4),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
# tests/test_kernels.py's sweep: (B, H, S, P, N, chunk)
SHAPES = [(1, 2, 128, 32, 16, 32), (2, 4, 256, 64, 64, 64),
          (1, 1, 64, 16, 8, 16)]


def _inputs(seed, B, H, S, P, N, dtype="float32"):
    """Kernel-layout x (B,H,S,P), a_dt (B,H,S), b/c (B,1,S,N) as numpy, then
    in each framework's dtype."""
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((B, H, S, P)).astype(np.float32),
            (-np.logaddexp(rng.standard_normal((B, H, S)), 0) * 0.5)
            .astype(np.float32),
            (rng.standard_normal((B, 1, S, N)) * 0.3).astype(np.float32),
            (rng.standard_normal((B, 1, S, N)) * 0.3).astype(np.float32))
    jdt, tdt, tol = _DT[dtype]
    return (arrs, [jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs], tol)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(to_np(got).astype(np.float32),
                               to_np(want).astype(np.float32), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("B,H,S,P,N,chunk", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_matches_pallas_interpret(B, H, S, P, N, chunk, dtype):
    _, jin, tin, tol = _inputs(0, B, H, S, P, N, dtype)
    n0 = sk.ssd_chunk_bhcp.launches
    y, state = sk.ssd_chunk_bhcp(*tin, chunk=chunk)
    assert sk.ssd_chunk_bhcp.launches == n0, "a CPU call launched"
    assert y.shape == tin[0].shape and y.dtype == tin[0].dtype
    assert state.shape == (B, H, P, N) and state.dtype == torch.float32
    _close(y, ref_kernel(*jin, chunk=chunk, interpret=True), tol)


@pytest.mark.parametrize("B,H,S,P,N,chunk", SHAPES)
def test_final_state_matches_ssd_scan(B, H, S, P, N, chunk):
    """The state the TPU kernel drops, against the reference scan's final
    state on the same inputs (dt = 1 feeds the dt-weighted x through)."""
    arrs, (jx, ja, jb, jc), tin, tol = _inputs(1, B, H, S, P, N)
    _, state = sk.ssd_chunk_bhcp(*tin, chunk=chunk)
    xs, a = jx.transpose(0, 2, 1, 3), ja.transpose(0, 2, 1)
    _, want = ref_ssm.ssd_scan(xs, a, jb[:, 0], jc[:, 0], jnp.ones_like(a),
                               chunk)
    _close(state, want, tol)
    y_ref, state_ref = ssd_chunk_ref(*tin, chunk=chunk)
    _close(state_ref, want, tol)


def test_ragged_s_and_the_divisor_rule():
    """The port's kernel takes a ragged last chunk (S=200 in chunks of 128
    and 72; S=100 in 32, 32, 32, 4); the reference scan takes the largest
    divisor of S <= chunk (100 and 25).  The chunked algebra is exact, so
    both agree to f32 rounding; and the port's plain scan keeps the divisor
    rule bit for bit (chunk 32 at S=100 is chunk 25)."""
    for S, chunk, divisor in ((200, 128, 100), (100, 32, 25)):
        arrs, (jx, ja, jb, jc), tin, tol = _inputs(2, 2, 3, S, 32, 16)
        y, state = sk.ssd_chunk_bhcp(*tin, chunk=chunk)
        xs, a = jx.transpose(0, 2, 1, 3), ja.transpose(0, 2, 1)
        wy, ws = ref_ssm.ssd_scan(xs, a, jb[:, 0], jc[:, 0],
                                  jnp.ones_like(a), chunk)
        _close(y, wy.transpose(0, 2, 1, 3), tol, f"y S={S}")
        _close(state, ws, tol, f"state S={S}")
        tx, ta = tin[0].transpose(1, 2), tin[1].transpose(1, 2)
        ones = torch.ones_like(ta)
        got = ssm.ssd_scan(tx, ta, tin[2][:, 0], tin[3][:, 0], ones, chunk)
        same = ssm.ssd_scan(tx, ta, tin[2][:, 0], tin[3][:, 0], ones,
                            divisor)
        for g, s in zip(got, same):
            assert torch.equal(g, s)
        _close(got[0], wy, tol)


def test_ssd_matches_stepwise():
    """The chunked scan == the step-by-step recurrence (ground truth, the
    reference's ``ssd_step``)."""
    B, H, S, P, N = 1, 2, 64, 16, 8
    arrs, (jx, ja, jb, jc), tin, tol = _inputs(3, B, H, S, P, N)
    y, state = sk.ssd_chunk_bhcp(*tin, chunk=16)
    st = jnp.zeros((B, H, P, N))
    ones = jnp.ones((B, H))
    ys = []
    for t in range(S):
        yt, st = ref_ssm.ssd_step(jx[:, :, t], ja[:, :, t], jb[:, 0, t],
                                  jc[:, 0, t], ones, st)
        ys.append(yt)
    _close(y, jnp.stack(ys, axis=2), tol)
    _close(state, st, tol)


@pytest.mark.parametrize("chunk", [32, 48])
def test_ops_weights_x_by_dt_in_the_model_layout(chunk):
    """``ops.ssd_chunk`` in the model layout (x (B,S,H,P), a_dt/dt (B,S,H),
    b/c (B,S,N)) against the reference wrapper in interpret mode, and its
    state against the reference scan (which takes dt apart)."""
    rng = np.random.default_rng(4)
    B, S, H, P, N = 2, 96, 3, 32, 16
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)) - 2, 0).astype(np.float32)
    a_dt = (-dt * 0.7).astype(np.float32)
    b = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    j = [jnp.asarray(v) for v in (x, a_dt, b, c, dt)]
    y, state = ssd_chunk(*(torch.from_numpy(v) for v in (x, a_dt, b, c, dt)),
                         chunk=chunk)
    assert y.shape == (B, S, H, P)
    if S % chunk == 0:      # the reference wrapper asserts divisibility
        _close(y, ref_ops(*j, chunk=chunk, interpret=True), 1e-4)
    wy, ws = ref_ssm.ssd_scan(j[0], j[1], j[2], j[3], j[4], chunk)
    _close(y, wy, 1e-4)
    _close(state, ws, 1e-4)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    _, _, (x, a, b, c), _ = _inputs(5, 1, 2, 64, 32, 16)
    with pytest.raises(ValueError, match="chunk"):
        sk.ssd_chunk_bhcp(x, a, b, c, chunk=0)
    with pytest.raises(ValueError, match="P <= 64"):
        sk.ssd_chunk_bhcp(torch.zeros(1, 2, 64, 80), a, b, c)
    with pytest.raises(ValueError, match="N <= 64"):
        sk.ssd_chunk_bhcp(x, a, torch.zeros(1, 1, 64, 96),
                          torch.zeros(1, 1, 64, 96))
    with pytest.raises(ValueError, match="dtype"):
        sk.ssd_chunk_bhcp(x, a.double(), b, c)
    with pytest.raises(ValueError, match="do not match"):
        sk.ssd_chunk_bhcp(x, a[:, :1], b, c)
    with pytest.raises(ValueError, match="contiguous"):
        sk.ssd_chunk_bhcp(torch.zeros(1, 2, 32, 64).transpose(2, 3), a, b, c)
    with pytest.raises(ValueError, match="device"):
        sk.ssd_chunk_bhcp(*(t.to("meta") for t in (x, a, b, c)))


@pytest.mark.parametrize("chunk", [1, 2])
def test_every_device_takes_65536_batches(chunk):
    """B = 65,536 (past a grid's z limit, which the card once refused while
    the CPU took it) against the reference scan; the kernels walk batches
    and chunks on the grid's x dimension, and ``test_torch_cuda.py`` pins
    the card here and at 65,536 chunks (chunk 1, S = 65,536)."""
    B, H, S, P, N = 65536, 1, 2, 16, 16
    _, (jx, ja, jb, jc), tin, tol = _inputs(7, B, H, S, P, N)
    y, state = sk.ssd_chunk_bhcp(*tin, chunk=chunk)
    xs, a = jx.transpose(0, 2, 1, 3), ja.transpose(0, 2, 1)
    wy, ws = ref_ssm.ssd_scan(xs, a, jb[:, 0], jc[:, 0], jnp.ones_like(a),
                              chunk)
    _close(y, wy.transpose(0, 2, 1, 3), tol, "y")
    _close(state, ws, tol, "state")


# ---------------------------------------------------------------------------
# the CUDA kernels' three passes, in plain PyTorch
# ---------------------------------------------------------------------------

_PASSES_TOL = {"float32": 1e-5, "bfloat16": 5e-2}


@pytest.mark.parametrize("B,H,S,P,N,chunk", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_passes_match_plain_and_pallas(B, H, S, P, N, chunk, dtype):
    """``ssd_chunk_bhcp_passes_plain`` (chunk states, state passing, outputs,
    through the kernels' scratch) against the one-pass plain version, y and
    the final state, and its y against the Pallas kernel in interpret
    mode."""
    _, jin, tin, _ = _inputs(6, B, H, S, P, N, dtype)
    tol = _PASSES_TOL[dtype]
    y, state = sk.ssd_chunk_bhcp_passes_plain(*tin, chunk=chunk)
    assert y.dtype == tin[0].dtype and state.dtype == torch.float32
    want_y, want_s = sk.ssd_chunk_bhcp_plain(*tin, chunk=chunk)
    _close(y, want_y, tol, "y against plain")
    _close(state, want_s, tol, "state against plain")
    _close(y, ref_kernel(*jin, chunk=chunk, interpret=True), tol,
           "y against the Pallas kernel")


@pytest.mark.parametrize("S,chunk,last", [(200, 128, 72), (100, 32, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_passes_take_a_ragged_last_chunk(S, chunk, last, dtype):
    """A ragged last chunk (72 and 4 rows), which the kernels pad with
    zeros: y and the final state against the one-pass plain version, and
    in f32 against the reference scan (which takes the largest divisor of
    S, and computes in the inputs' dtype); the Pallas kernel takes no
    ragged S."""
    assert S % chunk == last
    _, (jx, ja, jb, jc), tin, _ = _inputs(7, 2, 3, S, 32, 16, dtype)
    tol = _PASSES_TOL[dtype]
    y, state = sk.ssd_chunk_bhcp_passes_plain(*tin, chunk=chunk)
    want_y, want_s = sk.ssd_chunk_bhcp_plain(*tin, chunk=chunk)
    _close(y, want_y, tol, f"y S={S}")
    _close(state, want_s, tol, f"state S={S}")
    if dtype == "float32":
        xs, a = jx.transpose(0, 2, 1, 3), ja.transpose(0, 2, 1)
        wy, ws = ref_ssm.ssd_scan(xs, a, jb[:, 0], jc[:, 0],
                                  jnp.ones_like(a), chunk)
        # the reference's own f32 tolerance: another chunking of S
        _close(y, wy.transpose(0, 2, 1, 3), 1e-4, f"y vs scan S={S}")
        _close(state, ws, 1e-4, f"state vs scan S={S}")
