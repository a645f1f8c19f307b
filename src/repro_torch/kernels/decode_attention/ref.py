"""The plain version of ring decode attention: the two f32 einsums and the
masked softmax ``models.transformer._ring_decode_attn`` ran before the
kernel, as they stood.  CPU tensors take it, bit for bit as before."""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos: torch.Tensor, length: torch.Tensor
                         ) -> torch.Tensor:
    """q (B,1,KV,G,Dh) scaled; k, v (B,W,KV,Dh); pos (B,W) the slots'
    positions (-1: empty); ``length`` 0-d.  Slots with positions in [0,
    length] attend.  Returns (B,1,KV·G·Dh) in q's dtype."""
    s = attn._einsum_f32("bqkgd,bskd->bqkgs", q, k)
    valid = (pos >= 0) & (pos <= length)
    s = torch.where(valid[:, None, None, None, :], s, attn.NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = attn._einsum_f32("bqkgs,bskd->bqkgd", p.to(v.dtype), v)
    return out.reshape(q.shape[0], 1, -1).to(q.dtype)
