"""Keygroups — Enoki/FReD's unit of replication.

* ``KeygroupSpec`` + ``arena_new`` — a string-keyed KV arena
  (``store.Store``) with a replication policy, placed on a device; what the
  paper's functions see via ``kv.*``.
* ``TensorKeygroup`` — a dict of tensors (parameters, a session cache, a
  cursor) with a scalar step-version and a merge rule.  Torch has no pytree
  registry, so it is a plain class over a dict.

Merge rules for tensor keygroups:
  lww     — replica with the higher version wins wholesale (sessions/cursors)
  mean    — elementwise average (parameter averaging / local SGD)
  max     — elementwise max (CRDT counters, metrics high-water marks)
  diloco  — needs the replication engine (a later slice)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ReplicationPolicy
from repro_torch.core import crdt
from repro_torch.core.store import Store, store_new
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class KeygroupSpec:
    name: str
    policy: ReplicationPolicy = ReplicationPolicy.REPLICATED
    # arena keygroups
    slots: int = 64
    value_width: int = 64
    dtype: Any = torch.float32
    # tensor keygroups
    merge: str = "lww"            # lww | mean | max | diloco
    # owner node for PEER_FETCH / CLOUD_CENTRAL placements
    owner: Optional[str] = None
    # where the arena lives; None means the CUDA card (raises without one)
    device: Any = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))


def arena_new(spec: KeygroupSpec, num_nodes: int) -> Store:
    return store_new(spec.slots, spec.value_width, num_nodes, spec.dtype,
                     device=spec.device)


class TensorKeygroup:
    """A replicated dict of tensors with a version and a merge rule."""

    def __init__(self, tree: Dict[str, torch.Tensor], version: torch.Tensor,
                 merge: str = "lww"):
        self.tree = tree
        self.version = version
        self.merge = merge

    @classmethod
    def create(cls, tree: Dict[str, torch.Tensor],
               merge: str = "lww") -> "TensorKeygroup":
        device = next(iter(tree.values())).device if tree else None
        return cls(tree, torch.zeros((), dtype=torch.int32, device=device),
                   merge)

    def write(self, new_tree: Dict[str, torch.Tensor]) -> "TensorKeygroup":
        return TensorKeygroup(new_tree, self.version + 1, self.merge)

    def merged_with(self, other: "TensorKeygroup") -> "TensorKeygroup":
        return merge_tensor_keygroups(self, other)


def merge_tensor_keygroups(a: TensorKeygroup, b: TensorKeygroup
                           ) -> TensorKeygroup:
    if a.merge != b.merge:
        raise ValueError(f"merge-rule mismatch: {a.merge} vs {b.merge}")
    if a.tree.keys() != b.tree.keys():
        raise ValueError("tensor keygroups hold different keys")
    if a.merge == "lww":
        take_b = b.version > a.version
        tree = {k: torch.where(take_b, b.tree[k], a.tree[k]) for k in a.tree}
    elif a.merge == "mean":
        tree = {k: (a.tree[k] + b.tree[k]) / 2 for k in a.tree}
    elif a.merge == "max":
        tree = {k: crdt.max_merge(a.tree[k], b.tree[k]) for k in a.tree}
    else:
        raise ValueError(
            f"merge rule {a.merge!r} needs the replication engine "
            "(diloco merges are stateful)")
    return TensorKeygroup(tree, torch.maximum(a.version, b.version), a.merge)
