"""Collectives over one axis of a mesh: the port's counterpart of the
reference's ``shard_map`` bodies (``repro.parallel.sharding.
shard_map_compat`` has no transform to port).

A body runs on every rank with its own shards; where the reference's body
calls ``jax.lax.axis_index``, ``psum``, ``pmax``, ``all_gather`` or
``ppermute`` over a named axis, the port calls the function of the same
name here with the mesh and the axis.  Each returns a new tensor (nothing
is reduced in place) and leaves dtypes as they are, so an int key or
version crosses bit for bit.

**Transport.**  It is picked from the group's backend and the tensor's
device, never by catching an error: NCCL takes CUDA tensors and gloo host
tensors; a CUDA tensor on a gloo group (the ranks that share one card) is
copied to a host buffer, the collective runs there, and the result is
copied back.  gloo's own CUDA paths cover some collectives and dtypes and
not others (none for send and receive), and they too go through host
memory, so the port stages every CUDA tensor itself.

**Gradients** are JAX's for a body whose loss every rank computes alike:
``psum`` returns a value that is the same on every rank of the axis, so
its cotangent is that too and passes through unchanged (the transpose of
``psum`` over an invariant cotangent).  A value that is the same on every
rank of an axis but feeds a per-rank computation goes through ``vary``
(identity forward; its cotangents summed over the axis, the transpose of
JAX's ``pvary``).  Two gathers differ in their transpose, and the choice is the cotangent's:

* ``all_gather`` slices the cotangent to the rank's own part (``g[index]``).
  It is right where every rank of the axis holds the SAME cotangent, as in
  ``moe_apply_ep``, whose gathered tokens feed a computation every rank
  repeats alike.
* ``gather_param`` (FSDP's gather of a parameter sharded over ``data`` or
  ``pod``) reduce-scatters it (``psum_scatter``): each rank's cotangent
  comes from its own batch shard, so the shard's gradient is the sum of
  every rank's slice, JAX's transpose of ``all_gather`` for a value that
  varies over the axis.

``all_gather_dim`` concatenates ``all_gather``'s parts along a dim (the
vlm's patch columns, a shared expert cut on its layer dim), with the same
sliced cotangent.  ``chunk_index`` and ``gather_chunks`` name a rank's
chunk of a batch cut over several axes and gather a small table (the moe
layer's per-expert counts) in that chunk order, with no gradient.

``shard`` (a rank's slice of a value the same on every rank) gathers its
cotangent back.  ``take_part`` cuts a part that several ranks take alike
(a KV head cut from a whole leaf, where ``model`` exceeds the KV heads):
its cotangent, placed at the part, is summed over the axis, so each part's
gradient sums every rank that took it.  The KV groups' gather of a
column-sharded ``wk``/``wv`` is ``gather_param`` over the group axis of
``launch.mesh.kv_groups``' mesh, whose groups are process subgroups of
``model`` (the transport and the walker read them as any group).  ``torch.distributed.nn``'s ``all_reduce`` sums cotangents
instead, which would multiply an expert-parallel layer's gradients by the
axis size.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    return mesh.get_local_rank(axis)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _backend(group, device_type: str) -> str:
    """The backend a group runs ``device_type`` tensors on: ``gloo`` or
    ``nccl`` (``get_backend_config`` reads "cpu:gloo,cuda:gloo" or one
    name for every device)."""
    cfg = dist.get_backend_config(group)
    if ":" not in cfg:
        return cfg
    table = dict(part.split(":") for part in cfg.split(","))
    return table[device_type]


def staged(group, tensor: torch.Tensor) -> bool:
    """True when ``tensor`` crosses ``group`` through a host buffer."""
    return tensor.is_cuda and _backend(group, "cuda") == "gloo"


def _host(group, tensor: torch.Tensor) -> torch.Tensor:
    x = tensor.detach()
    return x.cpu() if staged(group, x) else x.contiguous()


def _all_reduce(x: torch.Tensor, mesh, axis: str, op) -> torch.Tensor:
    if axis_size(mesh, axis) == 1:           # nothing crosses
        return x.detach().clone()
    group = mesh.get_group(axis)
    buf = _host(group, x).clone()
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.device)


def _all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    if axis_size(mesh, axis) == 1:
        return x.detach()[None].clone()
    group = mesh.get_group(axis)
    src = _host(group, x)
    bufs = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(bufs, src, group=group)
    return torch.stack(bufs).to(x.device)


def _chunk(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's part of ``x`` cut evenly along ``dim`` in axis order."""
    n = axis_size(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks of {axis!r}")
    return x.chunk(n, dim)[axis_index(mesh, axis)]


def _cat_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in axis order."""
    if axis_size(mesh, axis) == 1:
        return x.detach().clone()
    return torch.cat(_all_gather(x.contiguous(), mesh, axis).unbind(0), dim)


def _reduce_scatter(x: torch.Tensor, mesh, axis: str,
                    dim: int) -> torch.Tensor:
    """The sum over ``axis``, cut along ``dim``: this rank's part.  gloo's
    reduce-scatter is not in every torch build, so it is an all-reduce and
    a slice (the same numbers, twice the bytes)."""
    return _chunk(_all_reduce(x, mesh, axis, dist.ReduceOp.SUM), mesh, axis,
                  dim).clone()


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Vary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axis, dist.ReduceOp.SUM), None, \
            None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.index = axis_index(mesh, axis)
        return _all_gather(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index], None, None


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _reduce_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _cat_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _cat_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, None, \
            None


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _chunk(x, mesh, axis, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return _cat_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _TakePart(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, part, parts):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.shape, ctx.at = x.shape, part * (x.shape[dim] // parts)
        return x.narrow(dim, ctx.at, x.shape[dim] // parts).clone()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full.narrow(ctx.dim, ctx.at, g.shape[ctx.dim]).copy_(g)
        return _all_reduce(full, ctx.mesh, ctx.axis, dist.ReduceOp.SUM), \
            None, None, None, None, None


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum over the ranks of ``axis`` (``jax.lax.psum``)."""
    return _PSum.apply(x, mesh, axis)


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Elementwise max over the ranks of ``axis`` (``jax.lax.pmax``); no
    gradient."""
    return _all_reduce(x, mesh, axis, dist.ReduceOp.MAX)


def pmin(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Elementwise min over the ranks of ``axis`` (``jax.lax.pmin``); no
    gradient."""
    return _all_reduce(x, mesh, axis, dist.ReduceOp.MIN)


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new leading dim in axis order
    (``jax.lax.all_gather(x, axis, axis=0)``).  Its cotangent is sliced to
    the rank's part: use it where every rank's cotangent is the same (the
    module docstring); a parameter gathered for ranks that each take their
    own batch goes through ``gather_param``."""
    return _Gather.apply(x, mesh, axis)


def all_gather_dim(x: torch.Tensor, mesh, axis: str, dim: int
                   ) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in axis order; its
    cotangent sliced to the rank's part, as ``all_gather``'s (a value
    every rank then uses alike: the vlm's projected patches, a shared
    expert sharded on its layer dim)."""
    return torch.cat(all_gather(x, mesh, axis).unbind(0), dim)


def psum_scatter(x: torch.Tensor, mesh, axis: str, dim: int = 0
                 ) -> torch.Tensor:
    """The sum over ``axis``, cut evenly along ``dim``: this rank's part
    (``jax.lax.psum_scatter(..., tiled=True)``).  Its cotangent is
    gathered back along ``dim``."""
    return _PSumScatter.apply(x, mesh, axis, dim)


def gather_param(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's shard of a parameter concatenated along ``dim`` in
    axis order (FSDP's gather at use).  Its cotangent is reduce-scattered:
    the shard's gradient sums every rank's contribution (the module
    docstring)."""
    return _GatherParam.apply(x, mesh, axis, dim)


def vary(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` as it is; under autograd its cotangents summed over ``axis``."""
    return _Vary.apply(x, mesh, axis)


def shard(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """This rank's part of ``x`` (the same on every rank of ``axis``), cut
    evenly along ``dim`` in axis order: a body's in_spec."""
    return _Shard.apply(x, mesh, axis, dim)


def take_part(x: torch.Tensor, mesh, axis: str, dim: int, part: int,
              parts: int) -> torch.Tensor:
    """Part ``part`` of ``parts`` equal parts of ``x`` (the same on every
    rank of ``axis``) along ``dim``, which several ranks may take alike:
    its cotangent, zero but at the part, is summed over ``axis`` (the
    module docstring)."""
    if x.shape[dim] % parts:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {parts} parts")
    return _TakePart.apply(x, mesh, axis, dim, part, parts)


def chunk_index(mesh, axes: Sequence[str]) -> Tuple[int, int]:
    """``(i, n)``: this rank's chunk of a value cut evenly over ``axes``
    (a batch spec's entry, the first named major) and the number of
    chunks; axes the mesh lacks count as 1."""
    i, n = 0, 1
    for a in axes:
        if a in mesh.mesh_dim_names:
            i, n = i * axis_size(mesh, a) + axis_index(mesh, a), \
                n * axis_size(mesh, a)
    return i, n


def gather_chunks(x: torch.Tensor, mesh, axes: Sequence[str]
                  ) -> torch.Tensor:
    """Every rank's ``x`` over ``axes`` stacked on a new leading dim in
    chunk order (``chunk_index``): an ``all_gather`` an axis, the minor
    first.  No gradient: for small tables such as per-expert counts."""
    x = x.detach()[None]
    for a in reversed([a for a in axes if a in mesh.mesh_dim_names]):
        x = _all_gather(x.contiguous(), mesh, a).flatten(0, 1)
    return x


def ppermute(x: torch.Tensor, mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``jax.lax.ppermute``: for each ``(src, dst)`` pair of axis indices
    the ``src`` rank's ``x`` lands on ``dst``; a rank that no pair names as
    ``dst`` gets zeros.  No gradient."""
    group = mesh.get_group(axis)
    me = axis_index(mesh, axis)
    src = _host(group, x)
    out = torch.zeros_like(src)
    ops = []
    for s, d in perm:
        if s == me and d == me:
            out.copy_(src)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, src,
                                  dist.get_global_rank(group, d), group))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, s), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out.to(x.device)
