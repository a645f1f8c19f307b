"""Anti-entropy payload compression: the counterpart of
``repro.optim.compression``.

Replication rounds across pods move parameter deltas over the slow inter-pod
link, the paper's constrained edge-cloud link (section 4.2).  Two standard
compressors:

* int8 symmetric quantisation (per-tensor scale): 4x over f32, with
  deterministic round-half-to-even (``torch.round``, as ``jnp.round``);
* top-k sparsification (magnitude): keeps the k largest entries; the
  residual is returned for the caller to feed back (error feedback).
  The entries are ``lax.top_k``'s, in its order: by descending magnitude,
  the lowest index first among equal magnitudes.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.core.tree import tree_flatten, tree_map


class Int8Payload(NamedTuple):
    q: torch.Tensor        # int8, same shape
    scale: torch.Tensor    # () f32


def int8_compress(x: torch.Tensor, mesh=None, axes=()) -> Int8Payload:
    """Symmetric int8 with one scale for the whole tensor.  With ``mesh``,
    ``x`` is this rank's shard of a leaf sharded on ``axes``: the scale is
    the whole leaf's (the ``pmax`` of the shards' max over ``axes``), as
    the reference computes it from the whole leaf, and the shard is
    quantised with it."""
    peak = torch.max(torch.abs(x))
    if mesh is not None:
        from repro_torch.parallel.collectives import pmax
        for a in axes:
            peak = pmax(peak, mesh, a)
    scale = torch.clamp(peak, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return Int8Payload(q=q, scale=scale.to(torch.float32))


def int8_decompress(p: Int8Payload) -> torch.Tensor:
    return p.q.to(torch.float32) * p.scale


def tree_int8_compress(tree: Any) -> Any:
    return tree_map(int8_compress, tree)


def tree_int8_decompress(tree: Any) -> Any:
    if isinstance(tree, Int8Payload):
        return int8_decompress(tree)
    if isinstance(tree, dict):
        return {k: tree_int8_decompress(v) for k, v in tree.items()}
    return type(tree)(tree_int8_decompress(v) for v in tree)


class TopKPayload(NamedTuple):
    values: torch.Tensor   # (k,) f32
    indices: torch.Tensor  # (k,) int32 into the flattened tensor
    shape: tuple           # static


def topk_compress(x: torch.Tensor, k: int
                  ) -> Tuple[TopKPayload, torch.Tensor]:
    """Returns (payload, residual): the residual is the error-feedback
    term."""
    flat = x.reshape(-1).to(torch.float32)
    k = min(k, flat.shape[0])
    # a stable descending sort keeps lax.top_k's tie order (torch.topk
    # breaks ties in no set order)
    idx = torch.sort(torch.abs(flat), descending=True,
                     stable=True).indices[:k]
    vals = flat[idx]
    residual = flat.index_fill(0, idx, 0.0).reshape(x.shape)
    return TopKPayload(values=vals, indices=idx.to(torch.int32),
                       shape=tuple(x.shape)), residual


def topk_decompress(p: TopKPayload) -> torch.Tensor:
    size = math.prod(p.shape)
    flat = torch.zeros((size,), dtype=torch.float32, device=p.values.device)
    flat[p.indices.long()] = p.values
    return flat.reshape(p.shape)


def compressed_bytes(tree: Any) -> int:
    """Wire size of a (compressed) payload tree (replication accounting)."""
    return sum(leaf.numel() * leaf.element_size()
               for leaf in tree_flatten(tree)[0])
