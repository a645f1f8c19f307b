"""Versioned last-writer-wins row merge: the Hopper kernel and its plain version.

Port of the Pallas TPU kernel ``repro.kernels.enoki_merge.kernel.
enoki_merge_rows``.  Where the reference merges two replicas into fresh
arrays, the port folds K snapshots into an accumulator IN PLACE, in order,
with one launch (``csrc/enoki_merge.cu`` says how):

    per row: the first snapshot holding the maximum version among those
             strictly greater than the accumulator's wins the row (ties
             keep the accumulator) — the sequential strict-``>`` fold;
    vv:      elementwise max over the accumulator and every snapshot.

Operands are ``(keys, values, lengths, versions, vv)`` tuples — a
``core.store.Store`` as it is, or bare rows with ``None`` for keys, lengths
and vv.  ``values`` is ``(R, ...)`` of any dtype (bytes are copied raw);
versions, keys and lengths are ``(R,)`` int32, vv is ``(N,)`` int32.

``enoki_merge_rows`` takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.  ``enoki_merge_rows.launches``
counts kernel launches (the chip smoke reads it to show that the serving
path went through the kernel).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build

Rows = Tuple[Optional[torch.Tensor], torch.Tensor, Optional[torch.Tensor],
             torch.Tensor, Optional[torch.Tensor]]

#: payload bytes one block copies of a row (a row wider than this is split
#: across blocks so a 64-row arena still fills the card)
CHUNK_BYTES = 8192
_MAX_GRID_Y = 65535

_count_lock = threading.Lock()
_bind_lock = threading.Lock()
_fn = None


def enoki_merge_rows_plain(acc: Rows, snaps: Sequence[Rows]) -> Rows:
    """The plain PyTorch fold: ``kernels/enoki_merge/ref.py``'s
    ``torch.where`` applied snapshot by snapshot, written into ``acc``."""
    keys, values, lengths, versions, vv = acc
    for s_keys, s_values, s_lengths, s_versions, s_vv in snaps:
        take = s_versions > versions
        mask = take.reshape(take.shape + (1,) * (values.ndim - 1))
        values.copy_(torch.where(mask, s_values, values))
        if keys is not None:
            keys.copy_(torch.where(take, s_keys, keys))
            lengths.copy_(torch.where(take, s_lengths, lengths))
        versions.copy_(torch.maximum(versions, s_versions))
        if vv is not None:
            vv.copy_(torch.maximum(vv, s_vv))
    return acc


def _check(acc: Rows, snaps: Sequence[Rows]) -> None:
    keys, values, lengths, versions, vv = acc
    if values.ndim < 1 or versions.shape != values.shape[:1]:
        raise ValueError(f"versions {tuple(versions.shape)} do not guard the "
                         f"rows of values {tuple(values.shape)}")
    if (keys is None) != (lengths is None):
        raise ValueError("keys and lengths come together")
    for t in acc:
        if t is not None and (t.device != values.device
                              or not t.is_contiguous()):
            raise ValueError("every operand must be contiguous on the "
                             "accumulator's device")
    for t in (keys, lengths, versions, vv):
        if t is not None and t.dtype != torch.int32:
            raise ValueError(f"metadata must be int32, got {t.dtype}")
    for s in snaps:
        if len(s) != 5:
            raise ValueError("a snapshot is a (keys, values, lengths, "
                             "versions, vv) tuple")
        for a, b in zip(acc, s):
            if (a is None) != (b is None):
                raise ValueError("snapshots must carry the same fields as "
                                 "the accumulator")
            if b is not None and (b.shape != a.shape or b.dtype != a.dtype
                                  or b.device != a.device
                                  or not b.is_contiguous()):
                raise ValueError(
                    f"snapshot operand {tuple(b.shape)} {b.dtype} on "
                    f"{b.device} does not match the accumulator's "
                    f"{tuple(a.shape)} {a.dtype} on {a.device}")


def _bind():
    global _fn
    with _bind_lock:
        if _fn is None:
            fn = build.load("enoki_merge").enoki_merge_rows_launch
            p, ll = ctypes.c_void_p, ctypes.c_longlong
            fn.argtypes = [ctypes.c_int, p, p, p, p, p, p, p, ll,
                           ctypes.c_int, ll, ll, ll, ctypes.c_int,
                           ctypes.c_int, p]
            fn.restype = ctypes.c_int
            _fn = fn
        return _fn


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def launch_geometry(values: torch.Tensor) -> Tuple[int, int, int]:
    """``(row_bytes, chunk_bytes, chunks)`` of a launch over ``values``."""
    rows = values.shape[0]
    row_bytes = (values.numel() // rows) * values.element_size()
    chunk = CHUNK_BYTES
    if -(-row_bytes // chunk) > _MAX_GRID_Y:
        chunk = -(-row_bytes // _MAX_GRID_Y)
        chunk += -chunk % 16
    return row_bytes, chunk, -(-row_bytes // chunk)


def _launch(acc: Rows, snaps: Sequence[Rows]) -> None:
    fn = _bind()
    keys, values, lengths, versions, vv = acc
    rows, k = values.shape[0], len(snaps)
    if rows == 0:
        raise ValueError("enoki_merge_rows needs at least one row")
    row_bytes, chunk, chunks = launch_geometry(values)
    bases = [values.data_ptr()] + [s[1].data_ptr() for s in snaps]
    if row_bytes % 16 == 0 and all(b % 16 == 0 for b in bases):
        vec = 16
    elif row_bytes % 4 == 0 and all(b % 4 == 0 for b in bases):
        vec = 4
    else:
        vec = 1
    # K pointer records, then one zeroed uint32 ticket per row when a row
    # spans several chunk blocks (see the .cu file)
    table = np.zeros(5 * k + ((rows + 1) // 2 if chunks > 1 else 0),
                     np.int64)
    for j, (s_keys, s_values, s_lengths, s_versions, s_vv) in enumerate(snaps):
        table[5 * j:5 * j + 5] = (_ptr(s_values), _ptr(s_versions),
                                  _ptr(s_keys), _ptr(s_lengths), _ptr(s_vv))
    dev = values.device
    dev_table = torch.empty(table.nbytes, dtype=torch.uint8, device=dev)
    # the engine's pool threads merge too: read the stream per call
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(dev.index if dev.index is not None else torch.cuda.current_device(),
             values.data_ptr(), versions.data_ptr(), _ptr(keys),
             _ptr(lengths), _ptr(vv), table.ctypes.data, dev_table.data_ptr(),
             table.nbytes, k, rows, row_bytes, chunk,
             0 if vv is None else vv.numel(), vec, stream)
    if err != 0:
        raise RuntimeError(f"enoki_merge_rows: CUDA error {err} at launch")
    with _count_lock:
        enoki_merge_rows.launches += 1


def enoki_merge_rows(acc: Rows, snaps: Sequence[Rows]) -> Rows:
    """Fold ``snaps`` into ``acc`` in place, in order; returns ``acc``.
    CPU operands take ``enoki_merge_rows_plain``; CUDA operands launch the
    kernel once (or raise)."""
    snaps = tuple(snaps)
    _check(acc, snaps)
    if not snaps:
        return acc
    device = acc[1].device
    if device.type == "cpu":
        return enoki_merge_rows_plain(acc, snaps)
    if device.type != "cuda":
        raise ValueError(f"enoki_merge_rows: unsupported device {device}")
    _launch(acc, snaps)
    return acc


enoki_merge_rows.launches = 0
