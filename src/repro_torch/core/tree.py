"""Nested tuple/list/dict containers of leaves — the handler-input and
-output structures the engine stacks and unstacks (JAX's pytrees, for the
container types handlers use)."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

_LEAF = None


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; ``treedef`` rebuilds the structure."""
    if isinstance(tree, (tuple, list)):
        leaves, defs = [], []
        for x in tree:
            ls, d = tree_flatten(x)
            leaves.extend(ls)
            defs.append((d, len(ls)))
        return leaves, (type(tree), defs)
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, defs = tree_flatten([tree[k] for k in keys])
        return leaves, (dict, (keys, defs))
    return [tree], _LEAF


def tree_unflatten(treedef: Any, leaves: List[Any]) -> Any:
    if treedef is _LEAF:
        return leaves[0]
    kind, defs = treedef
    if kind is dict:
        keys, inner = defs
        return dict(zip(keys, tree_unflatten(inner, leaves)))
    out, i = [], 0
    for d, n in defs:
        out.append(tree_unflatten(d, leaves[i:i + n]))
        i += n
    if kind is list:
        return out
    return kind(*out) if hasattr(kind, "_fields") else kind(out)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
