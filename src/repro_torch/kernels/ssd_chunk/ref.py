"""Plain-torch oracle: the ``models.ssm`` chunked scan; the counterpart of
``repro.kernels.ssd_chunk.ref``."""
from __future__ import annotations

import torch

from repro_torch.models.ssm import ssd_scan


def ssd_chunk_ref(x, a_dt, b, c, *, chunk: int = 128):
    """Same layout as the kernel: x (B,H,S,P) dt-weighted; a_dt (B,H,S);
    b, c (B,1,S,N) -> (y (B,H,S,P), final state (B,H,P,N))."""
    xs = x.transpose(1, 2)                            # (B,S,H,P)
    a = a_dt.transpose(1, 2)                          # (B,S,H)
    # ssd_scan takes x and dt apart; dt = 1 feeds the dt-weighted input
    # through unchanged (identical algebra)
    y, state = ssd_scan(xs, a, b[:, 0], c[:, 0], torch.ones_like(a), chunk)
    return y.transpose(1, 2), state
