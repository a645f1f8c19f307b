"""Convergent replicated data types (CRDTs) as pure torch merge functions.

Every merge here is **commutative, associative and idempotent**, which is
what makes Enoki's asynchronous anti-entropy safe: replicas converge no
matter the order or repetition of merge rounds.  Counters are int32 with
one slot per node.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


# ---------------------------------------------------------------------------
# LWW register: (value, packed_version) — merge keeps the higher version.
# ---------------------------------------------------------------------------

class LWWRegister(NamedTuple):
    value: torch.Tensor      # (..., payload)
    version: torch.Tensor    # (...,) packed lamport version


def lww_merge(a: LWWRegister, b: LWWRegister) -> LWWRegister:
    """Elementwise last-writer-wins.  version ties are identical writes."""
    take_b = b.version > a.version
    # broadcast the selection mask over trailing payload dims
    mask = take_b.reshape(take_b.shape + (1,) * (a.value.ndim - take_b.ndim))
    return LWWRegister(value=torch.where(mask, b.value, a.value),
                       version=torch.maximum(a.version, b.version))


# ---------------------------------------------------------------------------
# G-counter: per-node grow-only counters; merge = elementwise max.
# ---------------------------------------------------------------------------

class GCounter(NamedTuple):
    counts: torch.Tensor     # (num_nodes,) int32 — one slot per node


def gcounter_new(num_nodes: int, device=None) -> GCounter:
    return GCounter(torch.zeros((num_nodes,), dtype=torch.int32,
                                device=device))


def gcounter_increment(c: GCounter, node_id, amount=1) -> GCounter:
    counts = c.counts.clone()
    counts[node_id] += amount
    return GCounter(counts)


def gcounter_merge(a: GCounter, b: GCounter) -> GCounter:
    return GCounter(torch.maximum(a.counts, b.counts))


def gcounter_value(c: GCounter) -> torch.Tensor:
    return c.counts.sum()


# ---------------------------------------------------------------------------
# PN-counter: increments and decrements as two G-counters.
# ---------------------------------------------------------------------------

class PNCounter(NamedTuple):
    pos: torch.Tensor
    neg: torch.Tensor


def pncounter_new(num_nodes: int, device=None) -> PNCounter:
    z = torch.zeros((num_nodes,), dtype=torch.int32, device=device)
    return PNCounter(z, z.clone())


def pncounter_add(c: PNCounter, node_id, amount) -> PNCounter:
    amount = int(amount)
    pos, neg = c.pos.clone(), c.neg.clone()
    pos[node_id] += max(amount, 0)
    neg[node_id] += max(-amount, 0)
    return PNCounter(pos, neg)


def pncounter_merge(a: PNCounter, b: PNCounter) -> PNCounter:
    return PNCounter(torch.maximum(a.pos, b.pos), torch.maximum(a.neg, b.neg))


def pncounter_value(c: PNCounter) -> torch.Tensor:
    return c.pos.sum() - c.neg.sum()


# ---------------------------------------------------------------------------
# Max/min registers (grow-only extremes) — trivially CRDT.
# ---------------------------------------------------------------------------

def max_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.maximum(a, b)


def min_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.minimum(a, b)


# ---------------------------------------------------------------------------
# Version vectors: (num_nodes,) per-node high-water marks; merge = max.
# ---------------------------------------------------------------------------

def vv_new(num_nodes: int, device=None) -> torch.Tensor:
    return torch.zeros((num_nodes,), dtype=torch.int32, device=device)


def vv_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.maximum(a, b)


def vv_dominates(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """True iff a >= b componentwise (a has seen everything b has)."""
    return torch.all(a >= b)
