"""Model layout (B,S,H,Dh) in and out: the counterpart of
``repro.kernels.flash_attention.ops.flash_attention``.

The reference transposes q/k/v to the kernel layout and the result back.
Here the kernel reads the model layout through strides instead: the
transposes below are views, and the output is allocated in the model layout
and written through a transposed view, so no copy is made on either side.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,S,H,Dh); k,v (B,S,KV,Dh) -> (B,S,H,Dh)."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal, window=window,
                         out=out.transpose(1, 2))
    return out
