"""Lamport-style versioning shared by the store, CRDTs and replication.

A *packed version* totally orders writes across nodes:

    packed = lamport_clock * MAX_NODES + node_id

so comparing packed ints implements last-writer-wins with deterministic
node-id tie-breaking.  On ``torch.int32`` tensors the product wraps in two's
complement exactly as ``jnp.int32`` does (Python-int operands do not promote
an int32 tensor), so packed versions are bit-identical to the reference's.
"""
from __future__ import annotations

import torch

# Upper bound on cluster size for version packing.  64 keeps packed versions
# within int32 for ~33M writes per key.
MAX_NODES = 64

VERSION_DTYPE = torch.int32


def pack_version(clock, node_id):
    return clock * MAX_NODES + node_id


def unpack_clock(packed):
    return packed // MAX_NODES


def unpack_node(packed):
    return packed % MAX_NODES


def fnv1a(key: str) -> int:
    """Stable 31-bit FNV-1a hash for string keys (0 is reserved for 'empty')."""
    h = 0x811C9DC5
    for ch in key.encode("utf-8"):
        h ^= ch
        h = (h * 0x01000193) & 0xFFFFFFFF
    h &= 0x7FFFFFFF
    return h if h != 0 else 1
