"""xLSTM chunkwise mLSTM: the Hopper kernel and its plain version.

Port of the Pallas TPU kernel ``repro.kernels.mlstm_chunk.kernel.
mlstm_chunk_bhsd``: for each (b, h), a sequential pass over chunks of
``chunk`` rows with an f32 carry C (d, d), n (d) and the stabiliser m, all
zero at the start,

    b     = cumsum(log_f)
    D     = b_i - b_j + log_i_j  (j <= i; -1e30 above the diagonal)
    m_tot = max(rowmax D, b + m)
    W     = (q kᵀ · scale) ⊙ exp(D - m_tot)
    h     = [W v + (q·scale) C exp(b + m - m_tot)]
            / max(|rowsum W + (q·scale) n exp(b + m - m_tot)|, exp(-m_tot))

and the carry moved to the chunk's end with ``m_next``.  q/k/v (B,H,S,d)
share a dtype, the gates (B,H,S) are f32, h is in q's dtype, every product
in f32.

One deliberate difference from the reference: the kernel and its plain
version also return the final carry, f32 C (B,H,d,d), n (B,H,d) and m (B,H),
which the TPU kernel keeps in scratch and drops (a prefill needs it for the
decode cache, so ``mlstm_seq(impl=FLASH)`` never scans twice).

``mlstm_chunk_bhsd`` takes the plain version for CPU tensors only; for CUDA
tensors it runs ``csrc/mlstm_chunk.cu`` once (or raises): one call is two
kernels, q kᵀ of every chunk at once into a scratch the wrapper allocates
(it needs no carry), then the chunk loop, ``column_tiles(d)`` CTAs per
(b, h), each keeping 64 columns of C on chip for the whole scan; every
product runs on the tensor cores as 3xTF32.  The kernels read their
operands through strides (the d dim contiguous), so a transposed view of
the model layout is taken as it is.  ``mlstm_chunk_bhsd.launches`` counts
calls that ran the kernels, one per call.

d a multiple of 16 up to 512, chunk <= 64 dividing S (as the reference
asserts), q/k/v of one shape and one dtype of float32/bfloat16, f32 gates;
anything else raises ``ValueError`` on every device, so the CPU refuses what
the card would.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.kernels import build, refuse_grad

MAX_CHUNK, MAX_D = 64, 512
#: columns of C a CTA of the chunk kernel keeps
COLUMN_TILE = 64
NEG_INF = -1e30                 # the TPU kernel's mask value
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_count_lock = threading.Lock()
_bind_lock = threading.Lock()
_fn = None


def mlstm_chunk_bhsd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           log_i: torch.Tensor, log_f: torch.Tensor, *,
                           chunk: int = 64
                           ) -> Tuple[torch.Tensor, Carry]:
    """The TPU kernel's per-chunk algebra in plain PyTorch, batched over
    (B, H), over chunks of ``min(chunk, S)`` rows.  Returns (h (B,H,S,d) in
    q's dtype, (C, n, m) f32)."""
    B, H, S, d = q.shape
    chunk = min(chunk, S)
    scale = d ** -0.5
    dev = q.device
    h = torch.empty_like(q)
    C = torch.zeros((B, H, d, d), dtype=torch.float32, device=dev)
    n = torch.zeros((B, H, d), dtype=torch.float32, device=dev)
    m = torch.zeros((B, H), dtype=torch.float32, device=dev)
    tril = torch.ones((chunk, chunk), dtype=torch.bool, device=dev).tril()
    for s0 in range(0, S, chunk):
        s1 = s0 + chunk
        qc, kc, vc = (t[:, :, s0:s1].float() for t in (q, k, v))
        li, lf = log_i[:, :, s0:s1].float(), log_f[:, :, s0:s1].float()
        b = torch.cumsum(lf, dim=-1)                              # (B,H,l)
        D = b[..., :, None] - b[..., None, :] + li[..., None, :]
        D = torch.where(tril, D, NEG_INF)
        m_inter = b + m[..., None]
        m_tot = torch.maximum(D.amax(dim=-1), m_inter)
        W = (qc @ kc.transpose(-1, -2)) * scale * torch.exp(
            D - m_tot[..., None])
        dec_in = torch.exp(m_inter - m_tot)
        qs = qc * scale
        h_inter = (qs @ C) * dec_in[..., None]
        norm = W.sum(dim=-1) + (qs @ n[..., None])[..., 0] * dec_in
        denom = torch.maximum(norm.abs(), torch.exp(-m_tot))
        h[:, :, s0:s1] = ((W @ vc + h_inter) / denom[..., None]).to(q.dtype)
        last = b[..., -1]
        tail = last[..., None] - b + li                           # (B,H,l)
        m_next = torch.maximum(last + m, tail.amax(dim=-1))
        dec_c = torch.exp(last + m - m_next)
        kw = kc * torch.exp(tail - m_next[..., None])[..., None]
        C = C * dec_c[..., None, None] + kw.transpose(-1, -2) @ vc
        n = n * dec_c[..., None] + kw.sum(dim=-2)
        m = m_next
    return h, (C, n, m)


def _check(q, k, v, log_i, log_f, chunk: int, h) -> int:
    """Raises on what the kernel does not take; returns the chunk,
    ``min(chunk, S)`` as the reference takes it."""
    if q.ndim != 4 or log_i.ndim != 3:
        raise ValueError("q, k, v must be (B,H,S,d) and the gates (B,H,S)")
    B, H, S, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)} (the kernel takes "
                         "dqk == dv)")
    if log_i.shape != (B, H, S) or log_f.shape != (B, H, S):
        raise ValueError(f"log_i {tuple(log_i.shape)} and log_f "
                         f"{tuple(log_f.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if min(B, H, S) == 0:
        raise ValueError("mlstm_chunk_bhsd needs non-empty operands")
    if not (16 <= d <= MAX_D and d % 16 == 0):
        raise ValueError(f"head dim {d}: the kernel takes multiples of 16 up "
                         f"to {MAX_D}")
    chunk = min(chunk, S)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} is not in 1..{MAX_CHUNK}")
    if S % chunk:
        raise ValueError(f"chunk {chunk} does not divide S={S}")
    operands = (q, k, v) if h is None else (q, k, v, h)
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in operands):
        raise ValueError("q, k, v (and h) must share one dtype of "
                         "float32/bfloat16, got "
                         f"{[t.dtype for t in operands]}")
    if log_i.dtype != torch.float32 or log_f.dtype != torch.float32:
        raise ValueError(f"the gates must be float32, got {log_i.dtype} and "
                         f"{log_f.dtype}")
    if h is not None and h.shape != q.shape:
        raise ValueError(f"h {tuple(h.shape)} does not match q "
                         f"{tuple(q.shape)}")
    for t in operands + (log_i, log_f):
        if t.device != q.device:
            raise ValueError("q, k, v, the gates and h must be on one device")
    for t in operands:
        if t.stride(3) != 1:
            raise ValueError("the d dims must be contiguous (stride 1)")
    return chunk


def column_tiles(d: int) -> int:
    """CTAs of the chunk kernel per (b, h) at head dim ``d``, each keeping 64
    columns of C: ``ceil(d / 64)``, 1 at d <= 64, 8 at d = 512."""
    if not 1 <= d <= MAX_D:
        raise ValueError(f"head dim {d} is not in 1..{MAX_D}")
    return -(-d // COLUMN_TILE)


def _bind():
    global _fn
    with _bind_lock:
        if _fn is None:
            fn = build.load("mlstm_chunk").mlstm_chunk_bhsd_launch
            p, i = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [i, i, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i,
                           p, p]
            fn.restype = ctypes.c_int
            _fn = fn
        return _fn


def _launch(q, k, v, log_i, log_f, h, C, n, m, chunk: int) -> None:
    fn = _bind()
    B, H, S, d = q.shape
    strides = np.array([*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                        *log_i.stride(), *log_f.stride(), *h.stride()[:3]],
                       np.int64)
    dev = q.device
    # q kᵀ of every chunk: its rows i < chunk, 64 keys a row
    qk = torch.empty(B * H * S * COLUMN_TILE, dtype=torch.float32,
                     device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(dev.index if dev.index is not None else torch.cuda.current_device(),
             _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             log_i.data_ptr(), log_f.data_ptr(), h.data_ptr(), C.data_ptr(),
             n.data_ptr(), m.data_ptr(), qk.data_ptr(), B, H, S, d, chunk,
             strides.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(f"mlstm_chunk_bhsd: CUDA error {err} at launch")
    with _count_lock:
        mlstm_chunk_bhsd.launches += 1


def mlstm_chunk_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_i: torch.Tensor, log_f: torch.Tensor, *,
                     chunk: int = 64, h: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Carry]:
    """q/k/v (B,H,S,d); log_i/log_f (B,H,S) f32 -> (h (B,H,S,d) in q's
    dtype, written into ``h`` when given (any view of the right shape, e.g.
    a transposed model-layout buffer), (C (B,H,d,d), n (B,H,d), m (B,H))
    f32, the carry after the last chunk).  CPU tensors take
    ``mlstm_chunk_bhsd_plain``; CUDA tensors run the two kernels once (or
    raise).
    Under autograd it raises on every device (``kernels.refuse_grad``).
    Under a cost walker (``kernels.charged``) the call is charged its
    work; on fake tensors it returns empty outputs and launches nothing."""
    refuse_grad("mlstm_chunk_bhsd", q, k, v, log_i, log_f)
    chunk = _check(q, k, v, log_i, log_f, chunk, h)
    return kernels.charged(
        "mlstm_chunk_bhsd", lambda: _run(q, k, v, log_i, log_f, chunk, h),
        lambda: _fake_out(q, h), q, chunk=chunk)


def _fake_out(q: torch.Tensor, h: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, Carry]:
    B, H, _, d = q.shape
    f32 = dict(dtype=torch.float32)
    return (torch.empty_like(q) if h is None else h,
            (q.new_empty((B, H, d, d), **f32), q.new_empty((B, H, d), **f32),
             q.new_empty((B, H), **f32)))


def _run(q, k, v, log_i, log_f, chunk: int, h: Optional[torch.Tensor]
         ) -> Tuple[torch.Tensor, Carry]:
    if q.device.type == "cpu":
        res, carry = mlstm_chunk_bhsd_plain(q, k, v, log_i, log_f,
                                            chunk=chunk)
        return (res if h is None else h.copy_(res)), carry
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_chunk_bhsd: unsupported device {q.device}")
    if h is None:
        h = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    B, H, _, d = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    C = torch.empty((B, H, d, d), **f32)
    n = torch.empty((B, H, d), **f32)
    m = torch.empty((B, H), **f32)
    _launch(q, k, v, log_i, log_f, h, C, n, m, chunk)
    return h, (C, n, m)


mlstm_chunk_bhsd.launches = 0
