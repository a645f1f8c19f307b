"""Adafactor (Shazeer & Stern, 2018): factored second moments; the
counterpart of ``repro.optim.adafactor``.

For a (..., R, C) weight the second moment is stored as row/col exponential
averages over the last two dims (O(R + C) instead of O(R x C)); 1-D leaves
keep full moments.  No momentum (beta1 = 0), the time-dependent decay
``1 - t^-0.8``, update clipping at an RMS of 1.0, and the learning rate
driven from the shared schedule.  bf16 params are updated in f32 and cast
back.  As ``adamw_update`` does, ``adafactor_update`` writes the moments
and params into the tensors handed in and returns them.
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
                     grad_clip: float = 1.0
                     ) -> Tuple[Any, Dict[str, Any], dict]:
    """One Adafactor step, in place: ``(params, state, {"grad_norm"})``
    with the tensors handed in, updated."""
    norm = global_norm(grads)
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
    with torch.no_grad():
        for g, v, p in zip(flat_g, flat_v, flat_p):
            g = g.float() * scale
            g2 = g * g + eps
            if _factored(g.shape):
                row, col = v["row"], v["col"]
                row.mul_(beta2).add_((1 - beta2) * g2.mean(dim=-1))
                col.mul_(beta2).add_((1 - beta2) * g2.mean(dim=-2))
                row_mean = row.mean(dim=-1, keepdim=True)
                vhat = (row / torch.clamp(row_mean, min=eps))[..., None] \
                    * col[..., None, :]
            else:
                vhat = v["full"]
                vhat.mul_(beta2).add_((1 - beta2) * g2)
            del g2
            u = g / torch.sqrt(torch.clamp(vhat, min=eps))
            del g, vhat
            # update clipping: RMS(u) <= d
            rms = torch.sqrt(torch.mean(u * u))
            u.div_(torch.clamp(rms / clip_threshold, min=1.0))
            p32 = p if p.dtype == torch.float32 else p.float()
            new = p32 - lr * u - lr * weight_decay * p32
            p.copy_(new)
    return (tree_unflatten(treedef, flat_p), {"v": state["v"], "count": count},
            {"grad_norm": norm})


def _flatten_up_to(tree: Any, like: Any) -> list:
    """The subtrees of ``tree`` at the leaves of ``like`` (jax's
    ``treedef.flatten_up_to``), in ``tree_flatten``'s order."""
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in _flatten_up_to(tree[k],
                                                                like[k])]
    if isinstance(like, (list, tuple)):
        return [x for t, l in zip(tree, like) for x in _flatten_up_to(t, l)]
    return [tree]
