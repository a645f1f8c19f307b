"""AdamW with decoupled weight decay and global-norm gradient clipping: the
counterpart of ``repro.optim.adamw``.

Mixed precision as in the reference: params may be bf16, and the optimiser
then carries an f32 master copy in its state (``master``); the moments are
f32, and updates are computed in f32 and cast back to the params' dtype.

``adamw_update`` keeps the reference's signature and return values, but
writes the new moments, master and params INTO the tensors handed in (and
returns those same tensors): the counterpart of the reference step's
``donate_argnums=(0,)``, without which a train step would hold two copies
of the state.  It works leaf by leaf, so its temporaries are one leaf's.
The step count stays on the device, and nothing is read back to the host.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten


def global_norm(tree: Any, mesh=None, axes=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (0-d).

    On a ``mesh`` each leaf is this rank's shard, and ``axes`` (one tuple
    a leaf, in ``tree_flatten``'s order) names the axes it is sharded on:
    the leaves' sums of squares are summed by their axes, and each sum
    ``psum``-ed over those axes and no others, so every element counts
    once (a leaf the same on every rank of an axis is not summed over
    it).  The norm is then the same on every rank."""
    leaves = tree_flatten(tree)[0]
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in leaves))
    from repro_torch.parallel.collectives import psum
    parts: dict = {}
    for x, ax in zip(leaves, axes):
        sq = torch.sum(torch.square(x.float()))
        parts[ax] = parts[ax] + sq if ax in parts else sq
    total = 0
    for ax, part in parts.items():       # the same order on every rank
        for a in ax:
            part = psum(part, mesh, a)
        total = total + part
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """(grads in f32 scaled to a global norm of at most ``max_norm``, the
    norm before clipping)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


def adamw_init(params: Any, keep_master: bool = True) -> Dict[str, Any]:
    """Zeroed f32 moments ``m`` and ``v``, an int32 ``count`` and, with
    ``keep_master``, an f32 copy of the params, on the params' device."""
    leaves = tree_flatten(params)[0]
    device = leaves[0].device if leaves else None
    zeros = lambda t: tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        t)
    state = {"m": zeros(params), "v": zeros(params),
             "count": torch.zeros((), dtype=torch.int32, device=device)}
    if keep_master:
        state["master"] = tree_map(
            lambda p: p.to(torch.float32, copy=True), params)
    return state


def adamw_update(grads: Any, state: Dict[str, Any], params: Any,
                 lr, weight_decay: float = 0.1, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 grad_clip: float = 1.0, mesh=None,
                 axes=None) -> Tuple[Any, Dict[str, Any], dict]:
    """One AdamW step, in place (module docstring): ``(params, state,
    {"grad_norm"})`` with the tensors handed in, updated.  ``lr`` is a
    float or a 0-d f32 tensor.  On a ``mesh`` the trees are a rank's
    shards and ``axes`` their sharded axes (``global_norm``); the update
    is elementwise, so only the norm crosses ranks."""
    norm = global_norm(grads, mesh, axes)
    scale = _clip_scale(norm, grad_clip)
    count = state["count"]
    count.add_(1)
    c = count.float()
    bc1 = 1.0 - torch.pow(torch.full_like(c, b1), c)
    bc2 = 1.0 - torch.pow(torch.full_like(c, b2), c)
    flat_p, treedef = tree_flatten(params)
    flat_g = tree_flatten(grads)[0]
    flat_m, flat_v = tree_flatten(state["m"])[0], tree_flatten(state["v"])[0]
    flat_master = (tree_flatten(state["master"])[0] if "master" in state
                   else [None] * len(flat_p))
    with torch.no_grad():
        for g, m, v, p, master in zip(flat_g, flat_m, flat_v, flat_p,
                                      flat_master):
            g = g.float() * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            del g
            p32 = master if master is not None else (
                p if p.dtype == torch.float32 else p.float())
            upd = (m / bc1).div_(torch.sqrt(v / bc2).add_(eps))
            upd.add_(weight_decay * p32)
            p32.sub_(upd.mul_(lr))
            if p32 is not p:
                p.copy_(p32)
    new_state = {"m": state["m"], "v": state["v"], "count": count}
    if "master" in state:
        new_state["master"] = state["master"]
    return tree_unflatten(treedef, flat_p), new_state, {"grad_norm": norm}
