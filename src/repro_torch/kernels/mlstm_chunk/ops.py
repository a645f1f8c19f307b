"""Model layout in and out: the counterpart of
``repro.kernels.mlstm_chunk.ops.mlstm_chunk``.

The reference transposes q/k/v, the gates and the output between the model
layout and the kernel layout.  Here the kernel reads the model layout
through strides instead: the transposes below are views, and h is allocated
in the model layout and written through a transposed view.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.mlstm_chunk.kernel import Carry, mlstm_chunk_bhsd


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_i: torch.Tensor, log_f: torch.Tensor, *, chunk: int = 64
                ) -> Tuple[torch.Tensor, Carry]:
    """q/k/v (B,S,H,d); gates (B,S,H) f32 -> (h (B,S,H,d), the final carry
    (C (B,H,d,d), n (B,H,d), m (B,H)) f32)."""
    h = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    t = lambda x: x.transpose(1, 2)
    _, carry = mlstm_chunk_bhsd(t(q), t(k), t(v), t(log_i), t(log_f),
                                chunk=chunk, h=t(h))
    return h, carry
