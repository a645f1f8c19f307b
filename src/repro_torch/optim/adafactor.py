"""Adafactor (Shazeer & Stern, 2018): factored second moments; the
counterpart of ``repro.optim.adafactor``.

For a (..., R, C) weight the second moment is stored as row/col exponential
averages over the last two dims (O(R + C) instead of O(R x C)); 1-D leaves
keep full moments.  No momentum (beta1 = 0), the time-dependent decay
``1 - t^-0.8``, update clipping at an RMS of 1.0, and the learning rate
driven from the shared schedule.  bf16 params are updated in f32 and cast
back.  As ``adamw_update`` does, ``adafactor_update`` writes the moments
and params into the tensors handed in and returns them.

On a mesh (``mesh=``, ``specs=``) each parameter and gradient is the
rank's shard, and the factors keep the reference's layout (``specs`` of
``launch.train.state_specs``: replicated, or over ``pod`` under
PEER_FETCH).  Every mean is the whole leaf's, as GSPMD computes it:
``row`` and ``col`` are the shard's sums over the reduced dim, ``psum``-ed
over the axes that shard that dim and divided by its full size, then
gathered over the axes that shard the other dims (a factor whose batch dim
is an expert dim sharded over ``model`` is so assembled whole on every
rank) and cut to the factor's own layout; ``row_mean`` is taken over the
whole ``row``, and the update clip's RMS is the ``psum`` of the shards'
sums of squares over the leaf's axes divided by the leaf's size.  The
gradient clip's norm counts each element once (``global_norm``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.optim.adamw import _clip_scale, global_norm


def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor_init(params: Any) -> Dict[str, Any]:
    def per_leaf(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if _factored(p.shape):
            return {"row": torch.zeros(p.shape[:-1], **f32),       # (..., R)
                    "col": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"full": torch.zeros(p.shape, **f32)}

    leaves = tree_flatten(params)[0]
    device = leaves[0].device if leaves else None
    return {"v": tree_map(per_leaf, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def adafactor_update(grads: Any, state: Dict[str, Any], params: Any,
                     lr, weight_decay: float = 0.0, decay: float = 0.8,
                     eps: float = 1e-30, clip_threshold: float = 1.0,
                     grad_clip: float = 1.0, mesh=None, specs=None,
                     factor_specs=None
                     ) -> Tuple[Any, Dict[str, Any], dict]:
    """One Adafactor step, in place: ``(params, state, {"grad_norm"})``
    with the tensors handed in, updated.  On a ``mesh`` (the module
    docstring): ``specs`` are the params' (and gradients') partition specs
    in ``tree_flatten``'s order, ``factor_specs`` a dict a leaf of its
    factors' specs (``{"row", "col"}`` or ``{"full"}``; None: replicated)."""
    from repro_torch.parallel.sharding import P, spec_axes
    axes = None if mesh is None else [spec_axes(sp) for sp in specs]
    norm = global_norm(grads, mesh, axes)
    scale = _clip_scale(norm, grad_clip)
    count = state["count"]
    count.add_(1)
    # time-dependent decay as in the paper: 1 - t^{-0.8}
    beta2 = 1.0 - count.float() ** (-decay)
    flat_p, treedef = tree_flatten(params)
    flat_g = tree_flatten(grads)[0]
    # a leaf's moments are a dict ({"row", "col"} or {"full"}): flatten the
    # params' structure only, so each leaf's dict comes out whole
    flat_v = _flatten_up_to(state["v"], params)
    if mesh is None:
        specs = [None] * len(flat_p)
    if factor_specs is None:
        factor_specs = [None] * len(flat_p)
    with torch.no_grad():
        for g, v, p, sp, fs in zip(flat_g, flat_v, flat_p, specs,
                                   factor_specs):
            g = g.float() * scale
            g2 = (g * g).add_(eps)
            if _factored(g.shape):
                if mesh is None:
                    r_new, c_new = g2.mean(dim=-1), g2.mean(dim=-2)
                else:
                    r_new, c_new = _factor_means(g2, mesh, sp)
                row, col = v["row"], v["col"]
                fs = fs or {"row": P(), "col": P()}
                row.mul_(beta2).add_((1 - beta2) * _cut_to(r_new, mesh,
                                                           fs["row"]))
                col.mul_(beta2).add_((1 - beta2) * _cut_to(c_new, mesh,
                                                           fs["col"]))
                del r_new, c_new
                row_w, col_w = _whole(row, mesh, fs["row"]), \
                    _whole(col, mesh, fs["col"])
                row_mean = row_w.mean(dim=-1, keepdim=True)
                vhat = _cut_to(row_w / torch.clamp(row_mean, min=eps), mesh,
                               _drop(sp, -1))[..., None] \
                    * _cut_to(col_w, mesh, _drop(sp, -2))[..., None, :]
            elif mesh is None:              # 1-D: the moment is vhat
                v["full"].mul_(beta2).add_((1 - beta2) * g2)
                vhat = v["full"].clone()
            else:                    # the moment in its layout, used in sp's
                fsp = (fs or {}).get("full")
                vhat = beta2 * _cut_to(_whole(v["full"], mesh, fsp), mesh,
                                       sp) + (1 - beta2) * g2
                v["full"].copy_(_cut_to(_whole(vhat, mesh, sp), mesh, fsp))
            del g2
            # u = g / sqrt(max(vhat, eps)), written into g and vhat's own
            # buffers (a leaf's f32 temporaries are few: an expert leaf's
            # shard is GBs)
            u = g.div_(vhat.clamp_(min=eps).sqrt_())
            del g, vhat
            # update clipping: RMS(u) <= d, over the whole leaf
            if mesh is None:
                ms = torch.mean(u * u)
            else:
                from repro_torch.parallel.collectives import psum
                ms = torch.sum(u * u)
                for a in spec_axes(sp):
                    ms = psum(ms, mesh, a)
                ms = ms / _full_numel(u, mesh, sp)
            rms = torch.sqrt(ms)
            u.div_(torch.clamp(rms / clip_threshold, min=1.0))
            p32 = p if p.dtype == torch.float32 else p.float()
            # new = p32 - lr * u - lr * weight_decay * p32, in u's and
            # p32's buffers (p32 is p itself for f32 params, which the
            # copy overwrites last)
            new = torch.sub(p32, u.mul_(lr), out=u)
            new.sub_(p32.mul_(lr * weight_decay))
            p.copy_(new)
    return (tree_unflatten(treedef, flat_p), {"v": state["v"], "count": count},
            {"grad_norm": norm})


def _drop(spec, dim: int):
    """``spec`` of a leaf without its dim ``dim`` (-1 or -2): the spec of
    a factor reduced over that dim (None stays None)."""
    if spec is None:
        return None
    from repro_torch.parallel.sharding import P
    entries = list(spec)
    del entries[dim]
    return P(*entries)


def _factor_means(g2: torch.Tensor, mesh, spec):
    """The shard ``g2``'s contributions to ``row`` (mean over the last dim)
    and ``col`` (mean over the second last), each WHOLE: the shard's sums
    ``psum``-ed over the axes of the reduced dim and divided by its full
    size, then gathered over the axes of the other dims."""
    from repro_torch.parallel.collectives import axis_size, psum
    from repro_torch.parallel.sharding import P, _entry_axes, unlocal
    spec = P(*(tuple(spec) + (None,) * (g2.ndim - len(spec))))
    out = []
    for dim in (-1, -2):
        s = g2.sum(dim=dim)
        size = g2.shape[dim]
        for a in _entry_axes(spec[dim]):
            s = psum(s, mesh, a)
            size *= axis_size(mesh, a)
        out.append(unlocal(s / size, mesh, _drop(spec, dim)))
    return out[0], out[1]


def _whole(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The whole tensor of the shard ``x`` of ``spec`` (``x`` itself off a
    mesh or with no spec)."""
    if mesh is None or spec is None:
        return x
    from repro_torch.parallel.sharding import unlocal
    return unlocal(x, mesh, spec)


def _cut_to(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's shard of spec ``spec`` of the whole ``x``."""
    if mesh is None or spec is None:
        return x
    from repro_torch.parallel.sharding import _cut
    return _cut(x, mesh, spec)


def _full_numel(x: torch.Tensor, mesh, spec) -> int:
    """The element count of the whole leaf whose shard ``x`` is."""
    from repro_torch.parallel.collectives import axis_size
    from repro_torch.parallel.sharding import spec_axes
    n = x.numel()
    for a in spec_axes(spec):
        n *= axis_size(mesh, a)
    return n


def _flatten_up_to(tree: Any, like: Any) -> list:
    """The subtrees of ``tree`` at the leaves of ``like`` (jax's
    ``treedef.flatten_up_to``), in ``tree_flatten``'s order."""
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in _flatten_up_to(tree[k],
                                                                like[k])]
    if isinstance(like, (list, tuple)):
        return [x for t, l in zip(tree, like) for x in _flatten_up_to(t, l)]
    return [tree]
