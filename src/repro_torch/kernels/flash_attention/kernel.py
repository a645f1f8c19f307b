"""Flash attention forward: the Hopper kernel and its plain version.

Port of the Pallas TPU kernel ``repro.kernels.flash_attention.kernel.
flash_attention_bhsd``: online-softmax attention in the kernel layout
q (B,H,Sq,D), k/v (B,KV,Skv,D) -> (B,H,Sq,D), with GQA (query head h reads
kv head h // (H/KV)), causal and sliding-window masks on row/column
positions counted from 0, masked scores at -1e30, m/l/acc in f32, p rounded
to v's dtype before the PV product, and l clamped at 1e-30.

``flash_attention_bhsd`` takes the plain version for CPU tensors only; for
CUDA tensors it launches ``csrc/flash_attention.cu`` once (or raises):
bfloat16 runs the wgmma kernel fed by TMA at every head dim (at D=256 its
consumers hold their 64 x 256 f32 O in 240 registers a thread, and K/V
tiles are 64 keys in a ring of two), float32 the FMA kernel; the dtype
alone decides.  Both read their operands through strides, so any view
whose head dim is contiguous and whose rows start on 16 bytes is taken as
it is: the wgmma kernel's tensor maps are built over the view's own byte
strides (``_tma_geometry``).
``flash_attention_bhsd.launches`` counts kernel launches (the chip smoke
reads it to show that prefill went through the kernel).

The bf16 kernel's mbarrier waits give up after 2^26 polls rather than
hold the card.  At D <= 128 a give-up traps; at D=256, where a reachable
trap would cost the consumers their 240 registers, it adds one to a device
word the wrapper owns (one int32 a device, ``give_up_word``), and the
block runs on to a wrong output.  A launch never reads that word back (a
prefill step does not synchronise, and must not start to): the caller
calls ``check_give_ups()`` where it synchronises already, and it raises
``RuntimeError`` for any give-up since the last check.

Head dims 32, 64, 96 (phi-3-vision), 112 (zamba2's shared block), 128 and
256 (gemma-7b), float32 and bfloat16; anything else raises
``ValueError`` on every device, so the CPU refuses what the card would.
The card takes every view the CPU takes: an operand whose base or strides
break the kernels' 16-byte rows is copied into a fresh buffer first (and
``out`` copied back), and B and H may take any size (the grid walks them
on its x dimension).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 96, 112, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: rows of a TMA box: the bf16 kernel's query tile
Q_TILE_ROWS = 128
_MAX_TMA_STRIDE = 1 << 40      # byte strides must stay below it
_MAX_TMA_DIM = 1 << 32
_MAP_ERROR = 100_000           # the C side's code for a refused tensor map

_count_lock = threading.Lock()
_bind_lock = threading.Lock()
_fn = None
#: device index -> the (1,) int32 word its launches' waits count give-ups in
_give_up_words: Dict[int, torch.Tensor] = {}


def flash_attention_bhsd_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = True,
                               window: int = 0) -> torch.Tensor:
    """The same online softmax in plain PyTorch, over the reference's
    default blocks (``min(256, Sq)`` query rows, ``min(512, Skv)`` keys; a
    ragged last block is sliced short).  Causal blocks strictly above the
    diagonal are skipped, as ``pl.when(run)`` skips them."""
    B, H, Sq, d = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    bq, bk = min(256, Sq), min(512, Skv)
    scale = d ** -0.5
    out = torch.empty_like(q)
    for qi in range(0, Sq, bq):
        nq = min(bq, Sq - qi)
        qg = (q[:, :, qi:qi + nq].float() * scale).reshape(B, KV, G, nq, d)
        m = torch.full((B, KV, G, nq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, KV, G, nq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KV, G, nq, d), dtype=torch.float32,
                          device=q.device)
        q_pos = torch.arange(qi, qi + nq, device=q.device)[:, None]
        for kj in range(0, Skv, bk):
            if causal and kj > qi + nq - 1:
                break
            nk = min(bk, Skv - kj)
            s = torch.einsum("bkgqd,bksd->bkgqs", qg,
                             k[:, :, kj:kj + nk].float())
            k_pos = torch.arange(kj, kj + nk, device=q.device)[None, :]
            mask = torch.ones((nq, nk), dtype=torch.bool, device=q.device)
            if causal:
                mask &= q_pos >= k_pos
            if window > 0:
                mask &= (q_pos - k_pos) < window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bksd->bkgqd", p.to(v.dtype).float(),
                              v[:, :, kj:kj + nk].float())
            acc = acc * corr[..., None] + pv
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, :, qi:qi + nq] = o.reshape(B, H, nq, d).to(q.dtype)
    return out


def _check(q, k, v, out) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be (B, H, S, D) tensors")
    B, H, Sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    KV, Skv = k.shape[1], k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} kv heads")
    if min(B, H, Sq, Skv) == 0:
        raise ValueError("flash_attention_bhsd needs non-empty operands")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of float32/bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    tensors = (q, k, v) if out is None else (q, k, v, out)
    if out is not None and (out.shape != q.shape or out.dtype != q.dtype):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} does not match "
                         f"q {tuple(q.shape)} {q.dtype}")
    for t in tensors:
        if t.device != q.device:
            raise ValueError("q, k, v and out must be on one device")
        if t.stride(3) != 1:
            raise ValueError("the head dim must be contiguous (stride 1)")


def rows_aligned(t: torch.Tensor) -> bool:
    """Whether every (b, h, s) row of ``t`` starts on 16 bytes, as the
    kernels read them (the base and the three outer strides)."""
    per = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        s % per == 0 for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or a copy into a fresh (allocator-aligned) buffer
    when a row would break 16 bytes."""
    return t if rows_aligned(t) else _fresh(t).copy_(t)


def _fresh(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device=t.device)


class TmaGeometry(NamedTuple):
    """What the C side encodes into one tensor map of a (B,H,S,D) view:
    ``dims`` innermost first (the head dim is dim 0, the rest ordered by
    stride), the byte ``strides`` of dims 1-3, the ``box`` of one tile (a
    swizzled slab of the head dim by the tile's rows), the ``swizzle`` in
    bytes (the slab's row bytes), and ``order``: which map dimension is the
    sequence, head and batch index."""
    dims: Tuple[int, int, int, int]
    strides: Tuple[int, int, int]
    box: Tuple[int, int, int, int]
    swizzle: int
    order: Tuple[int, int, int]

    def packed(self) -> Tuple[int, ...]:
        """The 15 values ``encode_map`` in the CUDA source reads."""
        return (*self.dims, *self.strides, *self.box, self.swizzle,
                *self.order)


def kv_tile_rows(d: int) -> int:
    """Keys of the wgmma kernel's K/V tile at head dim ``d`` (``Geo::TK`` in
    the CUDA source): 96 at D=96, 112 and 128; 64 below, and at D=256,
    whose Q tile and two K/V stages fill shared memory."""
    return 96 if 96 <= d <= 128 else 64


def _tma_geometry(view: torch.Tensor, rows: int) -> TmaGeometry:
    """The tensor map of a (B,H,S,D) bf16 view read in tiles of ``rows``
    sequence positions, or ``ValueError`` for what
    TMA refuses.  A row of the head dim lands 128-byte swizzled, a slab of
    64 bf16 columns (D=96, 112 and 128 load as two slabs, TMA filling the
    columns past D with zeros; D=256 as four); D=32's 64-byte rows take the
    64-byte swizzle.  Dims of size 1 take a harmless stride (the view's
    extent), as torch may give them any."""
    if view.ndim != 4:
        raise ValueError("a tensor map is built over a (B, H, S, D) view")
    es = view.element_size()
    B, H, S, D = view.shape
    if view.stride(3) != 1:
        raise ValueError("the head dim must be contiguous (stride 1)")
    if (D * es) % 16:
        raise ValueError(f"TMA needs 16-byte rows: D={D} is {D * es} bytes")
    swizzle = 64 if D * es <= 64 else 128
    sizes = {"s": S, "h": H, "b": B}
    raw = {"s": view.stride(2) * es, "h": view.stride(1) * es,
           "b": view.stride(0) * es}
    extent = max([D * es] + [raw[r] * sizes[r] for r in raw if sizes[r] > 1])
    strides = {r: raw[r] if sizes[r] > 1 else extent for r in raw}
    for r, st in strides.items():
        if st <= 0 or st % 16 or st >= _MAX_TMA_STRIDE:
            raise ValueError(f"TMA refuses a byte stride of {st} (dim {r}): "
                             "positive multiples of 16 below 2**40 only")
    if max(B, H, S, D) >= _MAX_TMA_DIM:
        raise ValueError(f"TMA refuses dims of 2**32 or more: {view.shape}")
    roles = sorted("shb", key=lambda r: (strides[r], "shb".index(r)))
    box_of = {"s": rows, "h": 1, "b": 1}
    return TmaGeometry(
        dims=(D, *(sizes[r] for r in roles)),
        strides=tuple(strides[r] for r in roles),
        box=(swizzle // es, *(box_of[r] for r in roles)),
        swizzle=swizzle,
        order=tuple(1 + roles.index(r) for r in "shb"))


def bind_launch(lib: ctypes.CDLL):
    """``flash_attention_bhsd_launch`` of a built library, typed."""
    fn = lib.flash_attention_bhsd_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, i, p, p, p, p, i, i, i, i, i, i, p, p, i, i,
                   ctypes.c_float, p, p]
    fn.restype = ctypes.c_int
    return fn


def _bind():
    global _fn
    with _bind_lock:
        if _fn is None:
            _fn = bind_launch(build.load("flash_attention"))
        return _fn


def give_up_word(device) -> torch.Tensor:
    """The (1,) int32 word on CUDA ``device`` that the kernel's waits count
    their give-ups in, made (zeroed) at the device's first launch."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    with _bind_lock:
        word = _give_up_words.get(index)
        if word is None:
            word = torch.zeros((1,), dtype=torch.int32,
                               device=torch.device("cuda", index))
            _give_up_words[index] = word
        return word


def check_give_ups() -> int:
    """Read the give-up word of every device launched on, synchronising
    with it; raise ``RuntimeError`` if a wait gave up since the last
    check, zeroing the word first.  Returns 0."""
    with _bind_lock:
        words = dict(_give_up_words)
    failed = {}
    for index, word in sorted(words.items()):
        n = int(word.item())
        if n:
            word.zero_()
            failed[index] = n
    if failed:
        raise RuntimeError(
            "flash_attention_bhsd: mbarrier waits gave up (a lost arrival or "
            "copy) and their blocks' outputs are wrong: " + ", ".join(
                f"{n} on cuda:{i}" for i, n in failed.items()))
    return 0


def _launch(q, k, v, out, causal: bool, window: int) -> None:
    fn = _bind()
    B, H, Sq, d = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    strides = np.array([s for t in (q, k, v, out) for s in t.stride()[:3]],
                       np.int64)
    tma = None
    if q.dtype == torch.bfloat16:
        kv_rows = kv_tile_rows(d)
        tma = np.array([x for t, rows in ((q, Q_TILE_ROWS), (k, kv_rows),
                                          (v, kv_rows))
                        for x in _tma_geometry(t, rows).packed()], np.int64)
    dev = q.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(dev.index if dev.index is not None else torch.cuda.current_device(),
             _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), B, H, KV, Sq, Skv, d, strides.ctypes.data,
             None if tma is None else tma.ctypes.data, int(causal),
             int(window), float(d ** -0.5), give_up_word(dev).data_ptr(),
             stream)
    if err >= _MAP_ERROR:
        raise RuntimeError(f"flash_attention_bhsd: the driver refused a "
                           f"tensor map (CUresult {err - _MAP_ERROR})")
    if err == _MAP_ERROR - 1:
        raise RuntimeError("flash_attention_bhsd: no driver entry point for "
                           "cuTensorMapEncodeTiled")
    if err != 0:
        raise RuntimeError(f"flash_attention_bhsd: CUDA error {err} at launch")
    with _count_lock:
        flash_attention_bhsd.launches += 1


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,H,Sq,D); k,v (B,KV,Skv,D) -> (B,H,Sq,D), written into ``out``
    when given (any view of the right shape, e.g. a transposed model-layout
    buffer).  CPU tensors take ``flash_attention_bhsd_plain``; CUDA tensors
    launch the kernel once (or raise)."""
    _check(q, k, v, out)
    if q.device.type == "cpu":
        res = flash_attention_bhsd_plain(q, k, v, causal=causal,
                                         window=window)
        return res if out is None else out.copy_(res)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bhsd: unsupported device {q.device}")
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dst = out if rows_aligned(out) else _fresh(out)
    _launch(_aligned(q), _aligned(k), _aligned(v), dst, causal, window)
    return out if dst is out else out.copy_(dst)


flash_attention_bhsd.launches = 0
