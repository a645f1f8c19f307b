"""Plain-torch oracle for the flash attention kernel (O(S²) memory): the
counterpart of ``repro.kernels.flash_attention.ref``."""
from __future__ import annotations

import torch

from repro_torch.models.attention import reference_attention


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B,S,H,Dh); k,v (B,S,KV,Dh) -> (B,S,H,Dh)."""
    B, Sq = q.shape[:2]
    Skv = k.shape[1]
    pos_q = torch.arange(Sq, dtype=torch.int32, device=q.device).expand(B, Sq)
    pos_k = torch.arange(Skv, dtype=torch.int32, device=q.device).expand(B, Skv)
    return reference_attention(q, k, v, pos_q, pos_k, causal=causal,
                               window=window)
