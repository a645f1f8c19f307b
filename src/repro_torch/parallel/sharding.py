"""Sharding rules: parameter, optimiser and cache trees -> partition specs;
the counterpart of ``repro.parallel.sharding``.

Rules are leaf-name based (megatron-style tensor parallelism over the
``model`` axis, FSDP/ZeRO over ``data``), with divisibility guards: an
assignment that does not divide evenly falls back to replication (e.g.
whisper's vocab 51865 % 16 != 0 -> a replicated embedding).  Stacked
leading layer dims are never sharded.

  column-parallel (output dim over model):  wq wk wv w_gate w_up w_z w_x
                                            w_q w_k w_v lm_head ...
  row-parallel (input dim over model):      wo w_down w_out w_ff_down
  expert-parallel (experts over model):     moe w_gate/w_up/w_down when
                                            E % model_shards == 0, else the
                                            experts fall back to column/row TP
  vocab-parallel:                           embed (dim 0)

The ``pod`` axis is NEVER assigned to parameters here: parameter replicas
per pod are Enoki keygroups, reconciled by replication off the hot path.

The rules are pure functions of leaf paths, shapes and a mesh's axis sizes
(``launch.mesh.axis_sizes``: a ``DeviceMesh``, or a shape-only stand-in).
A spec is a ``PartitionSpec``: a tuple with one entry a dim, an axis name,
a tuple of axis names, or None.  ``named`` maps specs to DTensor
placements, one per mesh dim; ``place`` makes the DTensors from a full
tree that every rank holds alike (no collective), and ``gather`` makes
the full tensor back (the counterpart of ``full_tensor()``, through
``parallel.collectives``' transport).

The steps of the port's tensor-parallel and FSDP paths hold plain tensors,
not DTensors: ``local`` cuts a full tree to a rank's shards (what ``place``
then ``to_local()`` gives) and names each leaf's sharded axes, which the
gradient norm, the int8 scale and the ZeRO-1 update read; ``unlocal``
gathers the full tensors back, and ``relayout`` moves a rank's shard from
one spec to another (ZeRO-1's update regions, PEER_FETCH's pod shards).
A ``Grouped`` entry cuts a dim into fewer parts than its axis has ranks,
each part held alike by a group of consecutive ranks (a cache's KV heads
where ``model`` exceeds them); ``unlocal`` takes each group's leader.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.configs.base import (ArchConfig, ParallelConfig,
                                      ShapeConfig, StepKind)
from repro_torch.launch.mesh import axis_sizes

COL_PARALLEL = {"wq", "wk", "wv", "w_gate", "w_up", "w_ff_gate", "w_ff_up",
                "w_z", "w_x", "w_q", "w_k", "w_v", "lm_head", "patch_proj",
                "frame_proj"}
ROW_PARALLEL = {"wo", "w_down", "w_out", "w_ff_down"}
VOCAB_PARALLEL = {"embed"}


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: ``P("data", None)``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


class Grouped(str):
    """A spec entry: the dim cut into ``parts`` parts over ``axis``, whose
    ``n`` ranks (a multiple of ``parts``) hold part ``index * parts // n``:
    each part held alike by ``n / parts`` consecutive ranks (where
    ``model`` exceeds the KV heads, a cache's KV dim: the rank's group's
    head).  Equal to the axis name, so the axes a spec names read it as
    its axis."""

    def __new__(cls, axis: str, parts: int):
        out = super().__new__(cls, axis)
        out.parts = parts
        return out

    def __getnewargs__(self):
        return str(self), self.parts

    def __repr__(self) -> str:
        return f"Grouped({str(self)!r}, {self.parts})"


def tree_map_with_path(fn: Callable, tree: Any, path: Tuple = ()) -> Any:
    """``fn(path, leaf)`` over nested dicts (keys) and tuples/lists
    (indices); a spec is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        out = [tree_map_with_path(fn, v, path + (i,))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    return fn(path, tree)


def _leaf_name(path) -> str:
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def _in_moe(path) -> bool:
    return "moe" in path


def _spec_for(path, leaf, arch: ArchConfig, mesh, parallel: ParallelConfig
              ) -> P:
    name = _leaf_name(path)
    shape = tuple(leaf.shape)
    nd = len(shape)
    sizes = axis_sizes(mesh)
    model = sizes.get("model", 1)
    data = sizes.get("data", 1)
    assign: list = [None] * nd

    def try_assign(dim: int, axis: str, size: int) -> bool:
        if size > 1 and shape[dim] % size == 0 and assign[dim] is None:
            assign[dim] = axis
            return True
        return False

    if nd >= 2:
        moe_expert_weight = (_in_moe(path)
                             and name in ("w_gate", "w_up", "w_down")
                             and nd >= 3)
        if moe_expert_weight and shape[-3] % model == 0:
            try_assign(nd - 3, "model", model)            # expert-parallel
        elif name in COL_PARALLEL:
            try_assign(nd - 1, "model", model)
        elif name in ROW_PARALLEL:
            try_assign(nd - 2, "model", model)
        elif name in VOCAB_PARALLEL:
            try_assign(0, "model", model)
        # FSDP: shard the largest remaining dim over data
        if parallel.fsdp:
            free = [d for d in range(nd) if assign[d] is None]
            for d in sorted(free, key=lambda d: -shape[d]):
                if try_assign(d, "data", data):
                    break
    return P(*assign)


def param_partition_specs(params: Any, arch: ArchConfig, mesh,
                          parallel: ParallelConfig) -> Any:
    return tree_map_with_path(
        lambda path, leaf: _spec_for(path, leaf, arch, mesh, parallel), params)


def opt_state_specs(params: Any, arch: ArchConfig, mesh,
                    parallel: ParallelConfig) -> Any:
    """Specs for one params-shaped moment tree.  ZeRO-1: moments additionally
    sharded over ``data`` even when parameters are not (fsdp=False)."""
    if parallel.fsdp or not parallel.zero1:
        return param_partition_specs(params, arch, mesh, parallel)
    zp = dataclasses.replace(parallel, fsdp=True)   # data-shard the moments
    return param_partition_specs(params, arch, mesh, zp)


# ---------------------------------------------------------------------------
# Activations / batches / caches
# ---------------------------------------------------------------------------

def batch_specs(arch: ArchConfig, shape: ShapeConfig, mesh,
                parallel: ParallelConfig) -> Any:
    """Specs for the input batch dict (``model_zoo.input_specs``' keys)."""
    data = axis_sizes(mesh).get("data", 1)
    bdim = "data" if shape.global_batch % max(data, 1) == 0 and data > 1 \
        else None
    seq = None
    if parallel.seq_shard and shape.step is StepKind.PREFILL:
        seq = "model"
    if shape.step in (StepKind.TRAIN, StepKind.PREFILL):
        specs = {"tokens": P(bdim, seq)}
        if shape.step is StepKind.TRAIN:
            specs["labels"] = P(bdim, seq)
            specs["loss_mask"] = P(bdim, seq)
        if arch.frontend_stub == "clip_patches":
            specs["patch_embeds"] = P(bdim, None, None)
        if arch.frontend_stub == "audio_frames":
            specs["frame_embeds"] = P(bdim, None, None)
        return specs
    return {"token": P(bdim, None)}


def cache_partition_specs(cache: Any, arch: ArchConfig, mesh, batch: int,
                          prefer_seq: bool = False) -> Any:
    """KV/state cache specs: batch over ``data``; one trailing dim over
    ``model``.  ``prefer_seq=True`` shards the SEQUENCE dim (the one right
    after batch), which the flash-decode path needs.  Cache trees are
    stacked (L, B, ...) or nested-stacked (G, n, B, ...); the batch dim is
    located by size match."""
    sizes = axis_sizes(mesh)
    model = sizes.get("model", 1)
    data = sizes.get("data", 1)

    def spec(path, leaf) -> P:
        name = _leaf_name(path)
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd == 0 or name == "length":
            return P()
        assign = [None] * nd
        # find the batch dim: first dim equal to `batch` after the stack dims
        bdim = None
        for d, s in enumerate(shape):
            if s == batch:
                bdim = d
                break
        if bdim is not None and data > 1 and batch % data == 0:
            assign[bdim] = "data"
        if model > 1 and nd >= 2:
            placed = False
            if prefer_seq and bdim is not None and bdim + 1 < nd \
                    and shape[bdim + 1] % model == 0 \
                    and shape[bdim + 1] >= model:
                assign[bdim + 1] = "model"      # the sequence dim
                placed = True
            if not placed:
                for d in sorted(range(nd - 1, max(nd - 3, -1), -1),
                                key=lambda d: -shape[d]):
                    if d != bdim and assign[d] is None \
                            and shape[d] % model == 0 and shape[d] >= model:
                        assign[d] = "model"
                        break
        return P(*assign)

    return tree_map_with_path(spec, cache)


def strip_axes(spec: P, names) -> P:
    """``spec`` with the axes that ``names`` lacks replaced by None (a tuple
    entry keeps the axes it still has)."""
    def fix(entry):
        if entry is None:
            return None
        if isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in names)
            return kept if len(kept) > 1 else (kept[0] if kept else None)
        return entry if entry in names else None
    return P(*(fix(e) for e in spec))


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------

def placements(mesh, spec: P) -> list:
    """One placement per mesh dim: ``Shard(d)`` where the spec puts the
    dim's axis on tensor dim d, else ``Replicate()``.  An entry that names
    several axes splits its dim major to minor, as DTensor applies the
    placements in mesh-dim order."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def _is_spec(x) -> bool:
    return isinstance(x, P)


def _zip_specs(fn: Callable, tree: Any, specs: Any) -> Any:
    if _is_spec(specs):
        return fn(tree, specs)
    if isinstance(specs, dict):
        return {k: _zip_specs(fn, tree[k], specs[k]) for k in specs}
    out = [_zip_specs(fn, t, s) for t, s in zip(tree, specs)]
    return type(specs)(*out) if hasattr(specs, "_fields") else \
        type(specs)(out)


def named(mesh, tree_of_specs: Any) -> Any:
    """Spec tree -> tree of placement lists (the reference's
    ``NamedSharding`` tree)."""
    return _zip_specs(lambda _, s: placements(mesh, s), tree_of_specs,
                      tree_of_specs)


def place(tree: Any, mesh, specs: Any) -> Any:
    """DTensors on ``mesh`` from a full tree that every rank of the mesh
    holds alike: each rank keeps its own shards (``src_data_rank=None``:
    no collective, no copy from another rank)."""
    from torch.distributed.tensor import distribute_tensor
    return _zip_specs(
        lambda x, s: distribute_tensor(x, mesh, placements(mesh, s),
                                       src_data_rank=None), tree, specs)


def gather(x) -> torch.Tensor:
    """The full tensor of a DTensor on every rank of its mesh: its local
    shard all-gathered over each sharded mesh dim, minor to major (a
    ``full_tensor()`` whose collectives take the port's transport)."""
    from torch.distributed.tensor import Shard
    from repro_torch.parallel.collectives import all_gather
    mesh, local = x.device_mesh, x.to_local()
    for i in reversed(range(mesh.ndim)):
        p = x.placements[i]
        if isinstance(p, Shard):
            parts = all_gather(local.contiguous(), mesh,
                               mesh.mesh_dim_names[i])
            local = torch.cat(parts.unbind(0), p.dim)
    return local


# ---------------------------------------------------------------------------
# Plain-tensor shards (the tensor-parallel steps)
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: P) -> tuple:
    """The mesh axes ``spec`` shards on, in dim order."""
    return tuple(a for e in spec for a in _entry_axes(e))


def spec_leaves(specs: Any) -> list:
    """The specs of a spec tree in ``core.tree.tree_flatten``'s leaf order
    (dict keys sorted), a spec being a leaf."""
    if _is_spec(specs):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    return [s for x in specs for s in spec_leaves(x)]


def _cut(x: torch.Tensor, mesh, spec: P) -> torch.Tensor:
    """This rank's shard of the full ``x`` (a view): each dim cut evenly
    over its axes, the first named major (DTensor's order)."""
    from repro_torch.parallel.collectives import axis_index, axis_size
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        n, i = 1, 0
        for a in axes:
            n, i = n * axis_size(mesh, a), i * axis_size(mesh, a) + \
                axis_index(mesh, a)
        if isinstance(entry, Grouped):
            if n % entry.parts or x.shape[d] % entry.parts:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not "
                                 f"split into {entry.parts} parts over "
                                 f"{n} ranks")
            x = x.chunk(entry.parts, d)[i * entry.parts // n]
            continue
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"over {axes}")
        x = x.chunk(n, d)[i]
    return x


def local(tree: Any, mesh, specs: Any) -> Tuple[Any, Any]:
    """``(shards, axes)``: this rank's shard of every leaf of the full
    ``tree`` (a copy), and every leaf's sharded axes (a tuple of axis
    names; ``()`` for a replicated leaf).  No collective: every rank holds
    the full tree alike."""
    shards = _zip_specs(lambda x, s: _cut(x, mesh, s).clone(), tree, specs)
    axes = _zip_specs(lambda _, s: spec_axes(s), specs, specs)
    return shards, axes


def unlocal(x: torch.Tensor, mesh, spec: P) -> torch.Tensor:
    """The full tensor from this rank's shard ``x`` of ``spec``: gathered
    over each sharded axis (every rank of the mesh takes part); a
    ``Grouped`` dim from its groups' leaders."""
    from repro_torch.parallel.collectives import (_all_gather, _cat_gather,
                                                  axis_size)
    for d, entry in enumerate(spec):
        if isinstance(entry, Grouped):
            parts = _all_gather(x.contiguous(), mesh, str(entry))
            x = torch.cat(parts[::axis_size(mesh, str(entry)) //
                                entry.parts].unbind(0), d)
            continue
        for a in reversed(_entry_axes(entry)):    # minor first
            x = _cat_gather(x, mesh, a, d)
    return x


def relayout(x: torch.Tensor, mesh, src: P, dst: P) -> torch.Tensor:
    """This rank's shard ``x`` of spec ``src`` as its shard of spec ``dst``:
    dims whose axes differ are gathered over ``src``'s and cut over
    ``dst``'s; the rest stay as they are (no collective when the specs
    agree, and then ``x`` itself is returned)."""
    from repro_torch.parallel.collectives import _cat_gather
    nd = x.ndim
    src = tuple(src) + (None,) * (nd - len(src))
    dst = tuple(dst) + (None,) * (nd - len(dst))
    if src == dst:
        return x
    cut = [None] * nd
    for d in range(nd):
        if src[d] == dst[d]:
            continue
        for a in reversed(_entry_axes(src[d])):
            x = _cat_gather(x, mesh, a, d)
        cut[d] = dst[d]
    return _cut(x, mesh, P(*cut))
