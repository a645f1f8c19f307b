"""Client-centric consistency (the FReD guarantee Enoki inherits).

A session carries version-vector high-water marks of everything it has read
and written; a replica can serve the session iff its own version vector
dominates the session's requirement.  The checks run host-side in the
router against the replicas' version vectors, read back as numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.crdt import vv_dominates, vv_merge


@dataclasses.dataclass
class Session:
    """Mutable client session token (host-side)."""

    num_nodes: int
    read_vv: np.ndarray = None    # highest clocks this session has observed
    write_vv: np.ndarray = None   # highest clocks this session has written

    def __post_init__(self):
        if self.read_vv is None:
            self.read_vv = np.zeros((self.num_nodes,), np.int32)
        if self.write_vv is None:
            self.write_vv = np.zeros((self.num_nodes,), np.int32)

    # -- requirements -----------------------------------------------------
    def requirement(self) -> np.ndarray:
        """vv a replica must dominate to serve this session:
        read-your-writes needs write_vv; monotonic reads needs read_vv."""
        return np.maximum(self.read_vv, self.write_vv)

    def can_read_from(self, replica_vv) -> bool:
        return bool(np.all(np.asarray(replica_vv) >= self.requirement()))

    # -- observations -----------------------------------------------------
    def observe_read(self, replica_vv) -> None:
        self.read_vv = np.maximum(self.read_vv, np.asarray(replica_vv))

    def observe_write(self, node_id: int, clock: int) -> None:
        self.write_vv[node_id] = max(self.write_vv[node_id], int(clock))


def replica_dominates(replica_vv: torch.Tensor, required_vv: torch.Tensor):
    """Device-side variant of the session check."""
    return vv_dominates(replica_vv, required_vv)


def merge_observed(a_vv: torch.Tensor, b_vv: torch.Tensor) -> torch.Tensor:
    return vv_merge(a_vv, b_vv)
