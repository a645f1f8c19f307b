"""DiLoCo-style outer optimisation: the Enoki REPLICATED policy for the
training keygroup; the counterpart of ``repro.optim.diloco``.

Each pod is an Enoki "edge node": it trains on pod-local data against
pod-local parameters.  Every R inner steps the anti-entropy round runs
``diloco_outer_update``: pods exchange deltas (outer_params - local_params),
average them, and apply an outer Nesterov step to the shared outer params,
which are then adopted locally.  Staleness = R inner steps.

``diloco_outer_update`` writes the momentum, the outer params and the round
into the state handed in, as the port's inner optimisers do, and returns
them.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core.tree import tree_flatten, tree_map


def diloco_init(params: Any) -> Dict[str, Any]:
    leaves = tree_flatten(params)[0]
    device = leaves[0].device if leaves else None
    return {
        # the replicated keygroup's contents
        "outer_params": tree_map(lambda p: p.to(torch.float32, copy=True),
                                 params),
        "momentum": tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params),
        "round": torch.zeros((), dtype=torch.int32, device=device),
    }


def diloco_local_delta(outer_params: Any, local_params: Any) -> Any:
    """The anti-entropy payload: what this pod learned since the last
    round."""
    return tree_map(lambda o, l: o - l.float(), outer_params, local_params)


def diloco_outer_update(state: Dict[str, Any], mean_delta: Any,
                        outer_lr: float = 0.7, outer_momentum: float = 0.9
                        ) -> Tuple[Any, Dict[str, Any]]:
    """Nesterov outer step on the averaged delta, in place.  Returns (the
    new outer params in f32, the state); callers cast to the model
    dtype."""
    with torch.no_grad():
        for m, p, d in zip(tree_flatten(state["momentum"])[0],
                           tree_flatten(state["outer_params"])[0],
                           tree_flatten(mean_delta)[0]):
            m.mul_(outer_momentum).add_(d)
            p.sub_(outer_lr * (outer_momentum * m + d))
        state["round"].add_(1)
    return state["outer_params"], state
