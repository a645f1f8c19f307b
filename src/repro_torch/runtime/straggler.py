"""Straggler mitigation policies.

Enoki's asynchronous replication IS the training-side straggler story: a pod
that misses an anti-entropy round merges late with bounded staleness instead
of stalling the fleet (contrast synchronous DP, where the slowest pod sets
the step time).  ``StragglerPolicy`` tracks per-pod round participation and
decides merge admission; serving-side hedging lives in core/router.py.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Set


@dataclasses.dataclass
class StragglerPolicy:
    max_staleness_rounds: int = 2     # a pod may lag this many rounds
    quorum_frac: float = 0.5          # proceed when this fraction arrived

    def __post_init__(self):
        self.last_round: Dict[str, int] = {}

    def report(self, pod: str, round_id: int) -> None:
        self.last_round[pod] = max(self.last_round.get(pod, -1), round_id)

    def can_proceed(self, round_id: int, expected: List[str]) -> bool:
        """Anti-entropy may fold in whoever arrived once a quorum is in."""
        arrived = sum(1 for p in expected
                      if self.last_round.get(p, -1) >= round_id)
        return arrived >= max(1, int(len(expected) * self.quorum_frac))

    def too_stale(self, pod: str, round_id: int) -> bool:
        """A pod beyond the staleness bound must restore from peers
        (checkpoint/keygroup) instead of merging its divergent state."""
        return round_id - self.last_round.get(pod, -1) \
            > self.max_staleness_rounds

    def laggards(self, round_id: int, expected: List[str]) -> List[str]:
        return [p for p in expected
                if self.last_round.get(p, -1) < round_id]
