"""Model layout in and out: the counterpart of
``repro.kernels.ssd_chunk.ops.ssd_chunk``.

The reference dt-weights x and transposes it, a_dt and the output between
the model layout and the kernel layout.  Here the kernel reads the model
layout through strides instead: the transposes below are views, and y is
allocated in the model layout and written through a transposed view.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.ssd_chunk.kernel import ssd_chunk_bhcp


def ssd_chunk(x: torch.Tensor, a_dt: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor, dt: torch.Tensor, *, chunk: int = 128
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P); a_dt/dt (B,S,H); b, c (B,S,N) -> (y (B,S,H,P) without
    the D skip (the caller adds it), final state (B,H,P,N) f32)."""
    xw = x * dt[..., None]
    y = torch.empty(xw.shape, dtype=xw.dtype, device=xw.device)
    b4 = b[:, None] if b.ndim == 3 else b
    c4 = c[:, None] if c.ndim == 3 else c
    _, state = ssd_chunk_bhcp(xw.transpose(1, 2), a_dt.transpose(1, 2), b4,
                              c4, chunk=chunk, y=y.transpose(1, 2))
    return y, state
