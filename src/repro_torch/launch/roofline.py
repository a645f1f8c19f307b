"""Roofline terms of an eager step: the counterpart of
``repro.launch.roofline``.

The reference walks post-optimisation HLO text, multiplying while bodies by
their trip counts.  The port's program is eager PyTorch, so its walker is a
``TorchDispatchMode`` (``CostMode``) that sees every aten op as it runs:
each loop iteration is seen, no trip count is guessed, and
``unknown_trip_counts`` is always 0.  Its rules mirror the reference's:

  flops   the matmul family only (``mm``, ``addmm``, ``bmm``, ``baddbmm``;
          ``einsum`` and ``matmul`` reach the dispatcher as these), by
          ``torch.utils.flop_counter``'s formulas: 2·prod(out)·contracted.
          Elementwise work is bandwidth-bound and goes to the bytes term.
  bytes   operand plus result bytes of every op that touches memory; views
          and metadata (``view``, ``transpose``, ``expand``, ``slice``,
          ``select``, ``empty``, ...) are free, as the reference's
          ``SKIP_OPS``; an in-place write counts the written region (a
          ``copy_`` into a slice: the slice and its source; ``index_put_``
          and the scatters: twice the update), as the reference counts a
          dynamic-update-slice.  Eager ops do touch device memory, so here
          the bytes term is the traffic itself, not a bound on it.
  colls   the c10d ops (``allreduce_``, ``allgather_``, ``send``, ...):
          operand bytes, and ring-adjusted wire bytes (2(n-1)/n for an
          all-reduce, (n-1)/n for a gather or scatter, 1 for a send), by
          kind; the group's ranks are read from the op, so a collective
          whose group spans pods counts in ``pod_crossing_bytes``.
  kernels the four hand-written kernels launch through ``ctypes``, which no
          dispatch mode sees: while a walker is active each wrapper charges
          it one op of the analytic work below (``flash_work``,
          ``ssd_work``, ``mlstm_work``, ``merge_work``), whether the kernel
          or the plain version runs, and the aten ops of the plain version
          are not counted.  The CPU and the card count a step alike.
  peak    the walker's own tally of live storage bytes (the step's
          arguments, then every new storage until it dies): the counterpart
          of ``memory_analysis()``.

All numbers are per rank: rank 0's program stands for every rank's, as the
reference's SPMD module does (``launch.dryrun``).  The terms divide by the
card's data-sheet peaks (NVIDIA H100 SXM5 80GB; not measured rates):

  compute_s    = flops / 989 TFLOP/s        (dense bf16 tensor cores)
  memory_s     = bytes / 3.35 TB/s          (HBM3)
  collective_s = in-node bytes / 450 GB/s   (NVLink 4, a direction)
               + inter-node bytes / 50 GB/s (400 Gb/s NDR a GPU)

A group of ranks inside one node of ``RANKS_PER_NODE`` consecutive ranks (an
HGX H100 board) rides NVLink; one that leaves its node, and every
collective of the pod axis (``inter_pod``), rides the inter-node links.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.graphs import eager_steps

# NVIDIA H100 SXM5 80GB data-sheet figures (peaks, not measured rates)
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor cores
TF32_FLOPS_PER_S = 495e12      # dense TF32 tensor cores
F32_FLOPS_PER_S = 66.9e12      # f32 FMAs, no tensor cores
HBM_BYTES_PER_S = 3.35e12      # HBM3
NVLINK_BYTES_PER_S = 450e9     # NVLink 4, one direction, inside a node
INTER_NODE_BYTES_PER_S = 400e9 / 8  # 400 Gb/s NDR InfiniBand a GPU
RANKS_PER_NODE = 8             # an HGX H100 board
# the SSD and mLSTM kernels run every product as three TF32 products
SSD_PRODUCT_FLOPS_PER_S = TF32_FLOPS_PER_S / 3

aten = torch.ops.aten
MATMULS = (aten.mm, aten.addmm, aten.bmm, aten.baddbmm)
#: ops that move no bytes: views, metadata, allocation without a write
FREE_OPS = frozenset({
    aten.view, aten._unsafe_view, aten.reshape, aten.t, aten.transpose,
    aten.permute, aten.expand, aten.as_strided, aten.slice, aten.select,
    aten.unsqueeze, aten.squeeze, aten.detach, aten.alias, aten.unbind,
    aten.split, aten.split_with_sizes, aten.chunk, aten.narrow,
    aten.diagonal, aten.view_as_real, aten.view_as_complex, aten.unfold,
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
    aten.new_empty_strided, aten.lift_fresh,
    aten._local_scalar_dense, aten.set_, aten.resize_, aten.sym_size,
    aten.sym_stride, aten.sym_numel, aten.sym_storage_offset, aten.is_same_size,
})
#: an op that reads a few rows of its first operand: the result, twice
GATHERS = frozenset({aten.index, aten.index_select, aten.gather,
                     aten.embedding, aten.take_along_dim})
#: an op that writes a few rows of its first operand: the update, twice
SCATTERS = frozenset({aten.index_put, aten.index_put_, aten._index_put_impl_,
                      aten.scatter, aten.scatter_, aten.scatter_add,
                      aten.scatter_add_, aten.index_add, aten.index_add_,
                      aten.index_copy, aten.index_copy_,
                      aten.masked_scatter, aten.masked_scatter_})
#: c10d op name -> its kind, named as the reference's HLO opcodes are
COLLECTIVES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast", "send": "collective-permute",
}


# ---------------------------------------------------------------------------
# The kernels' work: one function a kernel (the chip smoke's table reads
# these too)
# ---------------------------------------------------------------------------

def attention_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """Query-key pairs the flash kernel's mask keeps: row i and column j
    counted from 0, j <= i when causal, i - j < window when ``window`` >
    0."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(sq,
                                                                 np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_work(B: int, H: int, KV: int, Sq: int, Skv: int, D: int,
               itemsize: int, causal: bool = True, window: int = 0
               ) -> Tuple[float, float]:
    """(FLOPs, bytes) ``flash_attention_bhsd`` needs: 2·D FLOPs for q·k
    and 2·D for p·v for every kept query-key pair of every head; q, k, v
    read once and the output written once."""
    flops = 4.0 * B * H * D * attention_pairs(Sq, Skv, causal, window)
    nbytes = itemsize * (2 * B * H * Sq * D + 2 * B * KV * Skv * D)
    return flops, float(nbytes)


def ssd_work(B, H, S, P, N, chunk, itemsize):
    """(FLOPs, bytes) the chunked scan needs on these shapes.  Per chunk of
    l rows: C Bᵀ over the l(l+1)/2 pairs on or below the diagonal at 2N
    FLOPs, once per (b, chunk) since B and C are shared across heads; per
    (b, h, chunk) the (S ⊙ L) x product over the same pairs at 2P, and
    2·l·N·P each for C stateᵀ and the state update.  The elementwise terms
    (mask, decays, exps) are left out, so the bound stays a lower bound.
    Bytes: x, a_dt, b, c read once, y and the f32 state written once."""
    flops = 0.0
    for s0 in range(0, S, chunk):
        l = min(chunk, S - s0)
        pairs = l * (l + 1) / 2
        flops += B * pairs * 2 * N + B * H * (pairs * 2 * P + 4 * l * N * P)
    nbytes = itemsize * (2 * B * H * S * P + B * H * S + 2 * B * S * N) \
        + 4 * B * H * P * N
    return flops, nbytes


def mlstm_work(B, H, S, d, chunk, itemsize):
    """(FLOPs, bytes) the chunkwise mLSTM needs on these shapes.  Per chunk
    of l rows and per (b, h): q kᵀ and W v over the l(l+1)/2 query-key
    pairs on or below the diagonal at 2d FLOPs each, 2·l·d² each for q C
    and the carry update (k w)ᵀ v.  The elementwise terms (gates, decays,
    normaliser) are left out, so the bound stays a lower bound.  Bytes:
    q, k, v and the f32 gates read once, h and the f32 final carry written
    once."""
    flops = 0.0
    for _ in range(0, S, chunk):
        pairs = chunk * (chunk + 1) / 2
        flops += B * H * (2 * pairs * 2 * d + 2 * 2 * chunk * d * d)
    nbytes = itemsize * 4 * B * H * S * d + 4 * 2 * B * H * S \
        + 4 * B * H * (d * d + d + 1)
    return flops, nbytes


def merge_work(k: int, rows: int, row_bytes: int, nvv: int,
               winners: Optional[int] = None) -> Tuple[float, float]:
    """(FLOPs, bytes) of folding ``k`` snapshots into an arena of ``rows``
    rows: every version read once (the accumulator's and each snapshot's),
    and for each of ``winners`` rows a snapshot wins, the winner's row read
    and the accumulator's written with their key, length and version (20
    bytes); the version vectors read and the accumulator's written.  With
    ``winners`` None every row may win (what a walker charges: it reads no
    data); the chip smoke counts its data's winners."""
    winners = rows if winners is None else winners
    nbytes = (k + 1) * rows * 4 + winners * (2 * row_bytes + 20) \
        + (k + 2) * nvv * 4
    return 0.0, float(nbytes)


def decode_attention_work(B: int, KV: int, G: int, W: int, Dh: int,
                          q_itemsize: int, kv_itemsize: int,
                          attended: Optional[int] = None
                          ) -> Tuple[float, float]:
    """(FLOPs, bytes) ring decode attention needs: 2·Dh FLOPs for q·k and
    2·Dh for p·v for each of ``attended`` slots a session (the ring's W
    where None: what a walker charges, it reads no positions) and query
    head; K and V of those slots and every slot's position read once, q
    read and the output written once."""
    n = W if attended is None else attended
    flops = 4.0 * B * KV * G * n * Dh
    nbytes = 2 * B * n * KV * Dh * kv_itemsize + 4 * B * W \
        + 2 * B * KV * G * Dh * q_itemsize
    return flops, float(nbytes)


def _flash_charge(q, k, *, causal, window):
    B, H, Sq, D = q.shape
    return 1, flash_work(B, H, k.shape[1], Sq, k.shape[2], D,
                         q.element_size(), causal, window)


def _ssd_charge(x, b, *, chunk):
    B, H, S, P = x.shape
    return 1, ssd_work(B, H, S, P, b.shape[-1], chunk, x.element_size())


def _mlstm_charge(q, *, chunk):
    B, H, S, d = q.shape
    return 1, mlstm_work(B, H, S, d, chunk, q.element_size())


def _decode_attention_charge(q, k):
    B, _, KV, G, Dh = q.shape
    return 1, decode_attention_work(B, KV, G, k.shape[1], Dh,
                                    q.element_size(), k.element_size())


def _merge_charge(acc, snaps):
    from repro_torch.kernels.enoki_merge.kernel import snapshot_groups
    values, vv = acc[1], acc[4]
    rows = values.shape[0]
    row_bytes = (values.numel() // rows) * values.element_size() if rows \
        else 0
    return len(snapshot_groups(len(snaps))), merge_work(
        len(snaps), rows, row_bytes, 0 if vv is None else vv.numel())


#: wrapper name -> its charge: ``(launches, (flops, bytes))`` of one call
KERNEL_CHARGES: Dict[str, Callable] = {
    "flash_attention_bhsd": _flash_charge,
    "ssd_chunk_bhcp": _ssd_charge,
    "mlstm_chunk_bhsd": _mlstm_charge,
    "enoki_merge_rows": _merge_charge,
    "decode_attention": _decode_attention_charge,
}


# ---------------------------------------------------------------------------
# The walker
# ---------------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of an op's arguments or results, in order (tuples,
    lists and dicts nest them; a walked step's ops give nothing else)."""
    out: List[torch.Tensor] = []
    _collect(tree, out)
    return out


def _collect(x, out: List[torch.Tensor]) -> None:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (tuple, list)):
        for y in x:
            _collect(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _collect(y, out)


def _ring_factor(kind: str, n: int) -> float:
    """Wire bytes a rank sends relative to its operand, for ring
    algorithms (the reference's ``_ring_factor``)."""
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n
    if kind == "collective-permute":
        return 1.0
    return (n - 1) / n


def _group_ranks(pg) -> List[int]:
    import torch.distributed as dist
    if isinstance(pg, torch.ScriptObject):
        pg = dist.ProcessGroup.unbox(pg)
    return dist.get_process_group_ranks(pg)


class CostMode(TorchDispatchMode):
    """Counts the cost of what runs under it (the module docstring).

    ``pod_size`` (ranks a pod) turns on ``pod_crossing_bytes``: operand
    bytes of collectives whose group holds ranks of more than one pod
    (rank // pod_size).  The collective bytes split into in-node and
    inter-node parts by nodes of ``RANKS_PER_NODE`` ranks.  Use it as a
    context manager, or through ``analyze_step``.  It walks the thread
    that enters it: there the kernel wrappers charge it
    (``kernels.walking``) and ``StepCache`` steps run their eager bodies
    (``graphs.eager_steps``); other threads run as they would."""

    def __init__(self, pod_size: Optional[int] = None) -> None:
        super().__init__()
        self.pod_size = pod_size
        self.flops = 0.0
        self.bytes = 0.0
        self.coll_bytes = 0.0
        self.coll_wire_bytes = 0.0
        self.coll_ops: Dict[str, float] = {}
        self.coll_count = 0
        self.coll_in_node = 0.0
        self.coll_inter_node = 0.0
        self.pod_crossing = 0.0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        self._live_lock = threading.Lock()   # a storage may die elsewhere
        self._quiet = 0
        self._eager = None
        #: the thread that entered the walker (``kernels.walking``)
        self.thread: Optional[int] = None

    # ----------------------------------------------------------- lifetime
    def __enter__(self):
        from repro_torch import kernels
        if kernels.WALKER is not None:
            raise RuntimeError("a cost walker is active already")
        self.thread = threading.get_ident()
        kernels.WALKER = self
        self._eager = eager_steps()
        self._eager.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch import kernels
        self._eager.__exit__(*exc)
        kernels.WALKER = None
        return super().__exit__(*exc)

    def track(self, tree) -> None:
        """Count the storages of ``tree``'s tensors as live (a step's
        arguments)."""
        for t in _tensors(tree):
            self._admit(t)

    def _admit(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = s._cdata
        if key in self._live:           # most outputs: a live storage's view
            return
        with self._live_lock:
            if key in self._live:
                return
            n = s.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(s, self._release, key)

    def _release(self, key: int) -> None:
        with self._live_lock:
            self.live_bytes -= self._live.pop(key, 0)

    # ------------------------------------------------------------ kernels
    @contextlib.contextmanager
    def kernel(self, name: str, *args, **kwargs):
        """Charge one call of kernel ``name`` its work and launches, and
        count none of the aten ops run inside the block (the plain
        version's); ``kernels.charged`` enters it on the walked thread
        only."""
        launches, (flops, nbytes) = KERNEL_CHARGES[name](*args, **kwargs)
        row = self.kernels.setdefault(
            name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        row["launches"] += launches
        row["flops"] += flops
        row["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    # ----------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        # only the walked step's ops reach here: the mode is thread-local,
        # and autograd carries it to the thread that runs a CUDA backward
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not self._quiet:
            self._charge(func, args, kwargs, out, outs)
        for t in outs:
            self._admit(t)
        return out

    def _charge(self, func, args, kwargs, out, outs) -> None:
        packet = func.overloadpacket
        if func.namespace == "c10d":
            self._collective(func, args)
            return
        if func.namespace != "aten" or packet in FREE_OPS or func.is_view:
            return
        if packet in MATMULS:
            from torch.utils.flop_counter import flop_registry
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if packet in GATHERS:
            index = [t for t in _tensors((args[1:], kwargs))
                     if not t.is_floating_point()]
            self.bytes += 2 * sum(map(_nbytes, outs)) \
                + sum(map(_nbytes, index))
            return
        if packet in SCATTERS:
            rest = _tensors((args[1:], kwargs))
            updates = [t for t in rest if t.dtype == args[0].dtype]
            index = [t for t in rest if t.dtype != args[0].dtype]
            self.bytes += 2 * sum(map(_nbytes, updates)) \
                + sum(map(_nbytes, index))
            return
        ins = _tensors((args, kwargs))
        seen = {id(t) for t in ins}
        self.bytes += sum(map(_nbytes, ins)) + sum(
            _nbytes(t) for t in outs if id(t) not in seen)

    def _collective(self, func, args) -> None:
        name = func.name().split("::")[-1]
        kind = COLLECTIVES.get(name)
        if kind is None:            # recv_, barrier, ...: the sender counts
            return
        pg = next(a for a in args if isinstance(a, torch.ScriptObject)
                  and "ProcessGroup" in str(a))
        ranks = _group_ranks(pg)
        if kind in ("all-gather", "reduce-scatter", "all-to-all"):
            # (outputs, inputs, group, ...)
            operand, result = _tensors(args[1]), _tensors(args[0])
        else:                       # in place: allreduce_, broadcast_, send
            operand = result = _tensors(args[0])
        ob = float(sum(map(_nbytes, operand)))
        self.bytes += ob + sum(map(_nbytes, result))
        self.coll_bytes += ob
        self.coll_wire_bytes += ob * _ring_factor(kind, len(ranks))
        self.coll_ops[kind] = self.coll_ops.get(kind, 0.0) + ob
        self.coll_count += 1
        if name == "send":              # this rank and the one it sends to
            ranks = [self._rank(), ranks[args[2]]]
        nodes = {r // RANKS_PER_NODE for r in ranks}
        if len(nodes) > 1:
            self.coll_inter_node += ob
        else:
            self.coll_in_node += ob
        if self.pod_size and len({r // self.pod_size for r in ranks}) > 1:
            self.pod_crossing += ob

    @staticmethod
    def _rank() -> int:
        import torch.distributed as dist
        return dist.get_rank() if dist.is_initialized() else 0

    # ------------------------------------------------------------- result
    def result(self) -> Dict[str, Any]:
        """The reference's ``analyze_hlo_text`` keys, per rank, and the
        port's own: ``collective_bytes_in_node``/``_inter_node``,
        ``kernel_launches``, ``kernel_work`` and ``peak_bytes``."""
        out = {
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes,
            "collective_bytes_per_device": self.coll_bytes,
            "collective_wire_bytes_per_device": self.coll_wire_bytes,
            "collective_ops": dict(self.coll_ops),
            "collective_count": self.coll_count,
            # every iteration runs under the walker: no trip count to guess
            "unknown_trip_counts": 0,
            "collective_bytes_in_node": self.coll_in_node,
            "collective_bytes_inter_node": self.coll_inter_node,
            "kernel_launches": {k: int(v["launches"])
                                for k, v in sorted(self.kernels.items())},
            "kernel_work": {k: dict(v) for k, v in sorted(
                self.kernels.items())},
            "peak_bytes": self.peak_bytes,
        }
        if self.pod_size:
            out["pod_crossing_bytes_per_device"] = self.pod_crossing
        return out


def analyze_step(fn: Callable, *args, pod_size: Optional[int] = None,
                 **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once under a ``CostMode`` and return its
    counts (``CostMode.result``), with ``fn``'s arguments counted live from
    the start: the counterpart of ``analyze_jit``.  The step runs for real
    (on fake tensors it allocates nothing); a step that writes its state in
    place has written it."""
    mode = CostMode(pod_size)
    mode.track((args, kwargs))
    with mode:
        fn(*args, **kwargs)
    return mode.result()


def roofline_terms(analysis: Dict[str, Any], model_flops_global: float,
                   chips: int, inter_pod: bool = False) -> Dict[str, Any]:
    """The reference's roofline keys at the card's data-sheet peaks, with
    ``collective_s`` the sum of its in-node (NVLink) and inter-node parts;
    ``inter_pod`` puts every collective byte on the inter-node links (the
    reference's DCN rate for the pod axis)."""
    compute_s = analysis["flops_per_device"] / BF16_FLOPS_PER_S
    memory_s = analysis["bytes_per_device"] / HBM_BYTES_PER_S
    total = analysis["collective_bytes_per_device"]
    inter = total if inter_pod else analysis.get(
        "collective_bytes_inter_node", total)
    in_node = total - inter
    coll_in_s = in_node / NVLINK_BYTES_PER_S
    coll_inter_s = inter / INTER_NODE_BYTES_PER_S
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_in_s + coll_inter_s}
    dominant = max(terms, key=terms.get)
    step_s = max(terms.values())
    model_flops_per_device = model_flops_global / chips
    achievable = model_flops_per_device / max(step_s, 1e-30)
    return {
        **terms,
        "collective_in_node_s": coll_in_s,
        "collective_inter_node_s": coll_inter_s,
        "dominant": dominant,
        "bound_step_s": step_s,
        "model_flops_global": model_flops_global,
        "hlo_flops_global": analysis["flops_per_device"] * chips,
        "useful_flops_ratio": model_flops_per_device
        / max(analysis["flops_per_device"], 1e-30),
        "roofline_fraction": achievable / BF16_FLOPS_PER_S,
        "achievable_flops_per_chip": achievable,
    }


# ---------------------------------------------------------------------------
# The serving path (the counterpart of benchmarks/roofline_table.py's
# serving_costs, which the port does not port as a folder)
# ---------------------------------------------------------------------------

def serving_costs(buckets: Sequence[int] = (1, 8, 64),
                  merge_ks: Sequence[int] = (1, 4, 8),
                  device=None) -> List[Dict[str, Any]]:
    """Cost one dispatch of the served path from its deployed entry points:
    the batched fold (``faas.compile_batched_handler``'s body, eager) per
    batch bucket, and the K-way delivery merge per snapshot count, aligned
    (``store.merge_snapshots_fused``: one merge kernel) and the fallback
    (``store.merge_stores`` folded K times).  The handler is the
    reference's ``roofline_acc`` at codec width 8 on a 64 x 8 f32 arena.
    Each step runs on clones, so the cluster's arena is untouched.
    ``device`` None means the card."""
    from repro_torch.core import Cluster, enoki_function
    from repro_torch.core.faas import get_function, registry
    from repro_torch.core.store import (arena_clone, merge_snapshots_fused)

    if "roofline_acc" not in registry():
        @enoki_function(name="roofline_acc", keygroups=["rooflinekg"],
                        codec_width=8)
        def roofline_acc(kv, x):
            cur, _ = kv.get("acc")
            kv.set("acc", cur + x)
            return cur + x

    c = Cluster({"edge": "edge"}, measure_compute=False, device=device)
    c.deploy(get_function("roofline_acc"), ["edge"],
             example_input=np.ones((8,), np.float32))
    nd = c.nodes["edge"]
    bh = nd.batched_handlers["roofline_acc"]
    store, clock = nd.stores["rooflinekg"], nd.clock
    dev = c.device

    def row(program, size, a):
        return {"program": program, "size": size,
                "flops": a["flops_per_device"],
                "bytes": a["bytes_per_device"],
                "unknown_trips": a["unknown_trip_counts"],
                "kernel_launches": sum(a["kernel_launches"].values())}

    rows = []
    for b in buckets:
        xs = torch.ones((b, 8), dtype=torch.float32, device=dev)
        valid = torch.ones((b,), dtype=torch.bool, device=dev)
        arena = arena_clone(store)
        rows.append(row("fold", f"bucket={b}", analyze_step(
            bh.eager, arena, clock.clone(), xs, valid)))
    for aligned in (True, False):
        name = "merge/aligned" if aligned else "merge/fallback"
        for k in merge_ks:
            acc = arena_clone(store)
            snaps = tuple(arena_clone(store) for _ in range(k))
            rows.append(row(name, f"K={k}", analyze_step(
                lambda: merge_snapshots_fused(acc, snaps, aligned=aligned))))
    return rows
