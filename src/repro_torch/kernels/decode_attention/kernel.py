"""Ring decode attention: the Hopper kernel and its plain version.

One decode token of every session against the shared attention block's
ring cache (``models.transformer._ring_decode_attn``): for each session b
and KV head, its G query heads,

    s = q kᵀ over the W slots, f32 sums of exact products; -1e30 where a
        slot's position is not in [0, length]
    p = softmax(s) in f32, normalised, then rounded to v's dtype
    o = p v in f32, rounded once to q's dtype

q (B,1,KV,G,Dh) is already scaled; k, v (B,W,KV,Dh) and pos (B,W) int32
are the ring as the cache holds it; ``length`` is a 0-d int32 tensor.  The
result is (B,1,KV·G·Dh) in q's dtype.

``decode_attention`` takes the plain version (``ref.decode_attention_ref``,
the einsums the model ran before) for CPU tensors only; for CUDA tensors it
runs ``csrc/decode_attention.cu`` once (or raises): one block a (session, KV
head), K and V each read once from the ring in place, through their strides,
the tiles of slots that no position attends skipped.  It reads ``length``
and the positions on the device and never synchronises, so a captured
decode graph holds it.  ``decode_attention.launches`` counts calls that ran
the kernel, one per call (at a graph's capture, not at its replays).

q float32 or bfloat16; k and v one dtype of float32/bfloat16, Dh
contiguous; Dh a multiple of 8 up to 256; G <= 32; W <= 65,536.  Anything
else raises ``ValueError`` on every device, so the CPU refuses what the
card would.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.kernels import build, refuse_grad
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

MAX_DH, MAX_G, MAX_W = 256, 32, 65536
#: bytes of K or V a tile of slots holds, at most
TILE_BYTES = 32768
#: scores (W·G f32) a block keeps in shared memory; more go to a scratch
SMEM_SCORES = 16384
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_count_lock = threading.Lock()
_bind_lock = threading.Lock()
_fn = None


def tile_slots(dh: int, itemsize: int) -> int:
    """Slots a tile of the kernel's shared-memory ring holds: at most
    ``TILE_BYTES`` of K or V, a multiple of 8 in 8..128."""
    return max(8, min(128, TILE_BYTES // (dh * itemsize) // 8 * 8))


def _check(q, k, v, pos, length) -> None:
    if q.ndim != 5 or k.ndim != 4 or pos.ndim != 2:
        raise ValueError("q must be (B,1,KV,G,Dh), k and v (B,W,KV,Dh), pos "
                         "(B,W)")
    B, one, KV, G, dh = q.shape
    W = k.shape[1]
    if one != 1 or k.shape != (B, W, KV, dh) or v.shape != k.shape \
            or pos.shape != (B, W):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, pos {tuple(pos.shape)} do not "
                         "match")
    if length.numel() != 1 or length.ndim != 0:
        raise ValueError("length must be a 0-d tensor")
    if min(B, KV, G, W) == 0:
        raise ValueError("decode_attention needs non-empty operands")
    if dh % 8 or dh > MAX_DH or G > MAX_G or W > MAX_W:
        raise ValueError(f"Dh={dh}, G={G}, W={W}: the kernel takes Dh a "
                         f"multiple of 8 up to {MAX_DH}, G <= {MAX_G}, W <= "
                         f"{MAX_W}")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES \
            or v.dtype != k.dtype:
        raise ValueError("q, and k and v alike, must be float32 or bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if pos.dtype != torch.int32 or length.dtype != torch.int32:
        raise ValueError(f"pos and length must be int32, got {pos.dtype}, "
                         f"{length.dtype}")
    if any(t.device != q.device for t in (k, v, pos, length)):
        raise ValueError("q, k, v, pos and length must be on one device")
    if k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the Dh dim of k and v must be contiguous")


def _bind():
    global _fn
    with _bind_lock:
        if _fn is None:
            fn = build.load("decode_attention").decode_attention_launch
            p, i = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [i, i, i, p, p, p, p, p, p, p, i, i, i, i, i, i,
                           p, p]
            fn.restype = ctypes.c_int
            _fn = fn
        return _fn


def _launch(q, k, v, pos, length, out) -> None:
    B, _, KV, G, dh = q.shape
    W = k.shape[1]
    for t in (k, v):
        if t.data_ptr() % 16 or any(s * t.element_size() % 16
                                    for s in t.stride()[:3]):
            raise ValueError("decode_attention: k and v must start on 16 "
                             "bytes and step in multiples of 16 bytes")
    fn = _bind()
    strides = np.array([*k.stride()[:3], *v.stride()[:3], *pos.stride()],
                       np.int64)
    dev = q.device
    scores = None
    if G * W > SMEM_SCORES:
        scores = torch.empty((B * KV * G * W,), dtype=torch.float32,
                             device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(dev.index if dev.index is not None else torch.cuda.current_device(),
             _DTYPES[q.dtype], _DTYPES[k.dtype], q.data_ptr(), k.data_ptr(),
             v.data_ptr(), pos.data_ptr(), length.data_ptr(), out.data_ptr(),
             None if scores is None else scores.data_ptr(), B, KV, G, dh, W,
             tile_slots(dh, k.element_size()), strides.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention: CUDA error {err} at launch")
    with _count_lock:
        decode_attention.launches += 1


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """q (B,1,KV,G,Dh) scaled; k, v (B,W,KV,Dh); pos (B,W) int32; length
    0-d int32 -> (B,1,KV·G·Dh) in q's dtype.  CPU tensors take
    ``decode_attention_ref``; CUDA tensors run the kernel once (or raise).
    Under autograd it raises on every device (``kernels.refuse_grad``).
    Under a cost walker (``kernels.charged``) the call is charged its
    work; on fake tensors it returns an empty output and launches
    nothing."""
    refuse_grad("decode_attention", q, k, v)
    _check(q, k, v, pos, length)
    B, _, KV, G, dh = q.shape
    return kernels.charged(
        "decode_attention", lambda: _run(q, k, v, pos, length),
        lambda: q.new_empty((B, 1, KV * G * dh)), q, k)


def _run(q, k, v, pos, length) -> torch.Tensor:
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, pos, length)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, _, KV, G, dh = q.shape
    out = torch.empty((B, 1, KV * G * dh), dtype=q.dtype, device=q.device)
    _launch(q.contiguous(), k, v, pos, length, out)
    return out


decode_attention.launches = 0
