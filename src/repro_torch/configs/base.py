"""Configuration enums the port's serving path reads.

Only ``ReplicationPolicy`` so far: the model-zoo configs of
``repro.configs.base`` come with the model slices.  The values equal the
reference enum's, which is how tests map one onto the other.
"""
from __future__ import annotations

import enum


class ReplicationPolicy(str, enum.Enum):
    """The three data placements evaluated in the paper (§4.3 / Fig 5)."""

    CLOUD_CENTRAL = "cloud_central"  # state on one node; every access remote
    PEER_FETCH = "peer_fetch"        # state on owner node; reads fetch on demand (SyncMesh)
    REPLICATED = "replicated"        # Enoki: local replica everywhere, async anti-entropy
