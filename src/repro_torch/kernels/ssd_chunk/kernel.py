"""Mamba-2 SSD chunked scan: the Hopper kernel and its plain version.

Port of the Pallas TPU kernel ``repro.kernels.ssd_chunk.kernel.
ssd_chunk_bhcp``: for each (b, h), a sequential pass over chunks of
``chunk`` rows with an f32 (P, N) state,

    y     = ((C Bᵀ) ⊙ L) x + (C stateᵀ) ⊙ exp(a_cum)
    state = state·exp(a_cum[-1]) + xᵀ (B ⊙ exp(a_cum[-1] - a_cum))

with ``L[i,j] = exp(a_cum[i] - a_cum[j])`` for j <= i and ``a_cum`` the
cumulative sum of ``a_dt`` within the chunk.  x (B,H,S,P) is dt-weighted,
a_dt (B,H,S), b/c (B,1,S,N) are shared across heads (n_groups = 1); y is in
x's dtype, every product in f32.

Two deliberate differences from the reference: the kernel and its plain
version also return the final state, f32 (B,H,P,N), which the TPU kernel
keeps in scratch and drops (a prefill needs it for the decode cache); and
every S is taken, a ragged last chunk being masked, where the reference
asserts that the chunk divides S.

``ssd_chunk_bhcp`` takes the plain version for CPU tensors only; for CUDA
tensors it runs ``csrc/ssd_chunk.cu`` once (or raises): one call is three
kernels, the chunk states, the state passing and the outputs, through a
scratch of every chunk's state (B, H, n_chunks, P, N) f32 that the wrapper
allocates (``ssd_chunk_bhcp_passes_plain`` is the same three passes in
plain PyTorch, for the tests).  The kernels read their operands through
strides (the P and N dims contiguous), so a transposed view of the model
layout is taken as it is.  ``ssd_chunk_bhcp.launches`` counts calls that
ran the kernels, one per call.

chunk <= 128, P <= 64 and N <= 64, float32 or bfloat16 (all four operands
alike); anything else raises ``ValueError`` on every device, so the CPU
refuses what the card would.  B and the chunk count take any size: the
kernels walk (head tile, chunk, b) on the grid's x dimension.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.kernels import build, refuse_grad

MAX_CHUNK, MAX_P, MAX_N = 128, 64, 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_count_lock = threading.Lock()
_bind_lock = threading.Lock()
_fn = None


def ssd_chunk_bhcp_plain(x: torch.Tensor, a_dt: torch.Tensor,
                         b: torch.Tensor, c: torch.Tensor, *,
                         chunk: int = 128
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same per-chunk algebra in plain PyTorch, over the same chunks
    (``min(chunk, S)`` rows; a ragged last chunk is sliced short).
    Returns (y (B,H,S,P) in x's dtype, final state (B,H,P,N) f32)."""
    B, H, S, P = x.shape
    N = b.shape[-1]
    chunk = min(chunk, S)
    y = torch.empty_like(x)
    state = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, chunk):
        s1 = min(s0 + chunk, S)
        xc = x[:, :, s0:s1].float()                       # (B,H,l,P)
        bc = b[:, 0, s0:s1].float()                       # (B,l,N)
        cc = c[:, 0, s0:s1].float()
        a_cum = torch.cumsum(a_dt[:, :, s0:s1].float(), dim=-1)   # (B,H,l)
        l = s1 - s0
        tril = torch.ones((l, l), dtype=torch.bool,
                          device=x.device).tril()
        L = torch.where(tril, torch.exp(a_cum[..., :, None]
                                        - a_cum[..., None, :]), 0.0)
        scores = torch.einsum("bln,bsn->bls", cc, bc)
        y_diag = torch.einsum("bhls,bhsp->bhlp", scores[:, None] * L, xc)
        y_off = torch.einsum("bln,bhpn->bhlp", cc, state)
        y[:, :, s0:s1] = (y_diag + y_off * torch.exp(a_cum)[..., None]
                          ).to(x.dtype)
        decay_to_end = torch.exp(a_cum[..., -1:] - a_cum)          # (B,H,l)
        bw = bc[:, None] * decay_to_end[..., None]                 # (B,H,l,N)
        new = torch.einsum("bhlp,bhln->bhpn", xc, bw)
        state = state * torch.exp(a_cum[..., -1])[..., None, None] + new
    return y, state


def ssd_chunk_bhcp_passes_plain(x: torch.Tensor, a_dt: torch.Tensor,
                                b: torch.Tensor, c: torch.Tensor, *,
                                chunk: int = 128
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernels' three passes in plain PyTorch, with the same
    scratch layout and entering-state convention: (a) every chunk's a_cum,
    its last value and its contribution ``(x ⊙ w)ᵀ B`` with ``w =
    exp(a_cum[-1] - a_cum)`` into a scratch (B, H, n_chunks, P, N); (b) the
    state passing ``s_in[k] = s; s = s·exp(a_last[k]) + contrib[k]``, each
    entering state written over its contribution; (c) every chunk's
    ``y = ((C Bᵀ) ⊙ L) x + (C s_inᵀ) ⊙ exp(a_cum)``.  Returns (y (B,H,S,P)
    in x's dtype, final state (B,H,P,N) f32).  Nothing on the main path
    calls it."""
    B, H, S, P = x.shape
    N = b.shape[-1]
    chunk = min(chunk, S)
    nc = -(-S // chunk)
    pad = nc * chunk - S
    # a ragged last chunk padded with zeros, as the kernels stage it
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, pad))
    af = torch.nn.functional.pad(a_dt.float(), (0, pad))
    bf = torch.nn.functional.pad(b[:, 0].float(), (0, 0, 0, pad))
    cf = torch.nn.functional.pad(c[:, 0].float(), (0, 0, 0, pad))
    xc = xf.reshape(B, H, nc, chunk, P)
    bc = bf.reshape(B, nc, chunk, N)
    cc = cf.reshape(B, nc, chunk, N)
    a_cum = torch.cumsum(af.reshape(B, H, nc, chunk), dim=-1)
    a_last = a_cum[..., -1]                                  # (B,H,nc)
    # (a) chunk states
    w = torch.exp(a_last[..., None] - a_cum)                 # (B,H,nc,l)
    scratch = torch.einsum("bhklp,bkln->bhkpn", xc * w[..., None], bc)
    # (b) state passing, in place
    s = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    for k in range(nc):
        contrib = scratch[:, :, k].clone()
        scratch[:, :, k] = s
        s = s * torch.exp(a_last[:, :, k])[..., None, None] + contrib
    # (c) outputs
    tril = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()
    L = torch.where(tril, torch.exp(a_cum[..., :, None]
                                    - a_cum[..., None, :]), 0.0)
    cb = torch.einsum("bkin,bkjn->bkij", cc, bc)
    y_diag = torch.einsum("bhkij,bhkjp->bhkip", cb[:, None] * L, xc)
    y_off = torch.einsum("bkin,bhkpn->bhkip", cc, scratch)
    y = y_diag + y_off * torch.exp(a_cum)[..., None]
    y = y.reshape(B, H, nc * chunk, P)[:, :, :S]
    return y.to(x.dtype), s


def _check(x, a_dt, b, c, chunk: int, y) -> int:
    """Raises on what the kernel does not take; returns the chunk,
    ``min(chunk, S)`` as the reference takes it."""
    if x.ndim != 4 or a_dt.ndim != 3 or b.ndim != 4 or c.ndim != 4:
        raise ValueError("x must be (B,H,S,P), a_dt (B,H,S), b and c "
                         "(B,1,S,N)")
    B, H, S, P = x.shape
    N = b.shape[-1]
    if a_dt.shape != (B, H, S) or b.shape != (B, 1, S, N) \
            or c.shape != b.shape:
        raise ValueError(f"a_dt {tuple(a_dt.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)} do not match x {tuple(x.shape)}")
    if min(B, H, S) == 0:
        raise ValueError("ssd_chunk_bhcp needs non-empty operands")
    chunk = min(chunk, S)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} is not in 1..{MAX_CHUNK}")
    if not (1 <= P <= MAX_P and 1 <= N <= MAX_N):
        raise ValueError(f"P={P}, N={N}: the kernel takes P <= {MAX_P} and "
                         f"N <= {MAX_N}")
    tensors = (x, a_dt, b, c) if y is None else (x, a_dt, b, c, y)
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in tensors):
        raise ValueError("x, a_dt, b, c (and y) must share one dtype of "
                         "float32/bfloat16, got "
                         f"{[t.dtype for t in tensors]}")
    if y is not None and y.shape != x.shape:
        raise ValueError(f"y {tuple(y.shape)} does not match x "
                         f"{tuple(x.shape)}")
    for t in tensors:
        if t.device != x.device:
            raise ValueError("x, a_dt, b, c and y must be on one device")
    for t in (x, b, c) if y is None else (x, b, c, y):
        if t.stride(3) != 1:
            raise ValueError("the P and N dims must be contiguous (stride 1)")
    return chunk


def _bind():
    global _fn
    with _bind_lock:
        if _fn is None:
            fn = build.load("ssd_chunk").ssd_chunk_bhcp_launch
            p, i = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [i, i, p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                           p, p]
            fn.restype = ctypes.c_int
            _fn = fn
        return _fn


def _launch(x, a_dt, b, c, y, state, chunk: int) -> None:
    fn = _bind()
    B, H, S, P = x.shape
    N = b.shape[-1]
    strides = np.array([*x.stride()[:3], *a_dt.stride(), b.stride(0),
                        b.stride(2), c.stride(0), c.stride(2),
                        *y.stride()[:3]], np.int64)
    dev = x.device
    nc = -(-S // chunk)
    # every chunk's contribution, then its entering state; every chunk's
    # a_cum[-1]
    scratch = torch.empty((B, H, nc, P, N), dtype=torch.float32, device=dev)
    alast = torch.empty((B, H, nc), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(dev.index if dev.index is not None else torch.cuda.current_device(),
             _DTYPES[x.dtype], x.data_ptr(), a_dt.data_ptr(), b.data_ptr(),
             c.data_ptr(), y.data_ptr(), state.data_ptr(), scratch.data_ptr(),
             alast.data_ptr(), B, H, S, P, N, chunk, strides.ctypes.data,
             stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk_bhcp: CUDA error {err} at launch")
    with _count_lock:
        ssd_chunk_bhcp.launches += 1


def ssd_chunk_bhcp(x: torch.Tensor, a_dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, *, chunk: int = 128,
                   y: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,H,S,P) dt-weighted; a_dt (B,H,S); b, c (B,1,S,N) -> (y
    (B,H,S,P) in x's dtype, written into ``y`` when given (any view of the
    right shape, e.g. a transposed model-layout buffer), final state
    (B,H,P,N) f32).  CPU tensors take ``ssd_chunk_bhcp_plain``; CUDA
    tensors run the three kernels once (or raise).
    Under autograd it raises on every device (``kernels.refuse_grad``).
    Under a cost walker (``kernels.charged``) the call is charged its
    work; on fake tensors it returns empty outputs and launches nothing."""
    refuse_grad("ssd_chunk_bhcp", x, a_dt, b, c)
    chunk = _check(x, a_dt, b, c, chunk, y)
    return kernels.charged(
        "ssd_chunk_bhcp", lambda: _run(x, a_dt, b, c, chunk, y),
        lambda: (torch.empty_like(x) if y is None else y,
                 x.new_empty(x.shape[:2] + (x.shape[-1], b.shape[-1]),
                             dtype=torch.float32)),
        x, b, chunk=chunk)


def _run(x, a_dt, b, c, chunk: int, y: Optional[torch.Tensor]
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        res, state = ssd_chunk_bhcp_plain(x, a_dt, b, c, chunk=chunk)
        return (res if y is None else y.copy_(res)), state
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_bhcp: unsupported device {x.device}")
    if y is None:
        y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    B, H, _, P = x.shape
    state = torch.empty((B, H, P, b.shape[-1]), dtype=torch.float32,
                        device=x.device)
    _launch(x, a_dt, b, c, y, state, chunk)
    return y, state


ssd_chunk_bhcp.launches = 0
