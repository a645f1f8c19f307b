"""Versioned last-writer-wins row merge: the Hopper kernel and its plain version.

Port of the Pallas TPU kernel ``repro.kernels.enoki_merge.kernel.
enoki_merge_rows``.  Where the reference merges two replicas into fresh
arrays, the port folds K snapshots into an accumulator IN PLACE, in order,
with one launch for up to ``MAX_K`` snapshots (``csrc/enoki_merge.cu`` says
how; more fold in consecutive launches of ``MAX_K``, ``snapshot_groups``):

    per row: the first snapshot holding the maximum version among those
             strictly greater than the accumulator's wins the row (ties
             keep the accumulator) — the sequential strict-``>`` fold;
    vv:      elementwise max over the accumulator and every snapshot.

Operands are ``(keys, values, lengths, versions, vv)`` tuples — a
``core.store.Store`` as it is, or bare rows with ``None`` for keys, lengths
and vv.  ``values`` is ``(R, ...)`` of any dtype (bytes are copied raw);
versions, keys and lengths are ``(R,)`` int32, vv is ``(N,)`` int32.

``enoki_merge_rows`` takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.  The snapshots' pointers go to
the kernel by value, as a launch parameter (no device table, no copy), and
a row wider than ``CHUNK_BYTES`` is split over up to ``MAX_CHUNKS`` blocks
that form one thread-block cluster (``launch_geometry``).
``enoki_merge_rows.launches`` counts kernel launches (the chip smoke reads
it to show that the serving path went through the kernel).
"""
from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build

Rows = Tuple[Optional[torch.Tensor], torch.Tensor, Optional[torch.Tensor],
             torch.Tensor, Optional[torch.Tensor]]

#: payload bytes a row takes before it is split over a second block
CHUNK_BYTES = 8192
#: blocks one row may span: one thread-block cluster, at most the portable 8
MAX_CHUNKS = 8
#: snapshot records one launch takes by value (``KMAX`` in the CUDA source)
MAX_K = 64

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
            p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            fn.argtypes = [i, p, p, p, p, p, p, i, ll, ll, ll, i, i, i, p]
            fn.restype = ctypes.c_int
            _fn = fn
        return _fn


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def launch_geometry(values: torch.Tensor) -> Tuple[int, int, int]:
    """``(row_bytes, chunk_bytes, chunks)`` of a launch over ``values``: a
    row of up to CHUNK_BYTES is one block; a wider one spans up to
    MAX_CHUNKS blocks (one cluster), its chunk growing with the row, in
    multiples of 16 bytes."""
    rows = values.shape[0]
    row_bytes = (values.numel() // rows) * values.element_size() if rows else 0
    chunks = max(1, min(MAX_CHUNKS, -(-row_bytes // CHUNK_BYTES)))
    chunk = -(-row_bytes // chunks)
    chunk = max(16, chunk + -chunk % 16)
    return row_bytes, chunk, max(1, -(-row_bytes // chunk))


def snapshot_groups(k: int) -> List[Tuple[int, int]]:
    """The ``[start, stop)`` snapshot ranges of the launches that fold ``k``
    snapshots: MAX_K at a time, in order (an ordered fold splits into
    ordered groups)."""
    return [(i, min(k, i + MAX_K)) for i in range(0, k, MAX_K)]


def _vec(row_bytes: int, bases: Sequence[int]) -> int:
    """The widest access (16, 4 or 1 bytes) every row of every base allows."""
    for vec in (16, 4):
        if row_bytes % vec == 0 and all(b % vec == 0 for b in bases):
            return vec
    return 1


def _launch(acc: Rows, snaps: Sequence[Rows]) -> None:
    fn = _bind()
    keys, values, lengths, versions, vv = acc
    rows = values.shape[0]
    row_bytes, chunk, chunks = launch_geometry(values)
    vec = _vec(row_bytes, [values.data_ptr()]
               + [s[1].data_ptr() for s in snaps])
    dev = values.device
    dev_index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    # the engine's pool threads merge too: read the stream per call
    stream = torch.cuda.current_stream(dev).cuda_stream
    acc_ptrs = (values.data_ptr(), versions.data_ptr(), _ptr(keys),
                _ptr(lengths), _ptr(vv))
    nvv = 0 if vv is None else vv.numel()
    for lo, hi in snapshot_groups(len(snaps)):
        group = snaps[lo:hi]
        records = (ctypes.c_ulonglong * (5 * len(group)))(*[
            _ptr(t) for s_keys, s_values, s_lengths, s_versions, s_vv in group
            for t in (s_values, s_versions, s_keys, s_lengths, s_vv)])
        err = fn(dev_index, *acc_ptrs, records, len(group), rows, row_bytes,
                 chunk, chunks, nvv, vec, stream)
        if err != 0:
            raise RuntimeError(f"enoki_merge_rows: CUDA error {err} at launch")
        with _count_lock:
            enoki_merge_rows.launches += 1


def enoki_merge_rows(acc: Rows, snaps: Sequence[Rows]) -> Rows:
    """Fold ``snaps`` into ``acc`` in place, in order; returns ``acc``.
    CPU operands take ``enoki_merge_rows_plain``; CUDA operands launch the
    kernel once for every ``MAX_K`` snapshots (or raise)."""
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
