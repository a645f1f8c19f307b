"""Attention: GQA/MHA/MQA with a blockwise online-softmax reference path;
the counterpart of ``repro.models.attention``.

The sequence path (train/prefill) has three implementations, chosen by
``AttnImpl``: the kv-block online-softmax loop (``blockwise_attention``,
REFERENCE), the q-block loop with a full-row softmax (``qscan_attention``,
QSCAN) and the flash-attention kernel (``kernels/flash_attention``, FLASH),
which on a CUDA tensor is the hand-written Hopper kernel.

Decode is one token's einsum against the whole cache (plain torch, as the
reference leaves it to XLA).  Where the reference asks XLA for an f32
product of bf16 operands (``preferred_element_type=jnp.float32``), the port
upcasts the operands and multiplies in f32: bf16 products are exact in
f32, so both accumulate the same values in f32.

Shapes (conventions used across the model zoo):
    x            (B, S, D)
    q            (B, S, H, Dh)
    k, v         (B, S, KV, Dh)
    cache k/v    (B, Smax, KV, Dh)  + 0-d ``length`` tensor (tokens filled)

Whisper's cross-attention (decoder queries against the encoder output's
K/V, projected once at prefill) is ``blockwise_attention``, plain torch, as
in the reference.  The mesh-sharded flash decode comes with the training
and mesh slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, AttnImpl
from repro_torch.models.layers import apply_rope, dense_init

NEG_INF = -1e30


def _einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` with f32 accumulation and an f32 result."""
    return torch.einsum(eq, a.float(), b.float())


def _scaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    """``q * jnp.asarray(scale, q.dtype)``: the scale rounded to q's dtype."""
    return q * torch.tensor(scale, dtype=q.dtype)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def attn_init(gen: torch.Generator, arch: ArchConfig,
              dtype=torch.float32) -> dict:
    d = arch.d_model
    dh = arch.resolved_head_dim
    p = {
        "wq": dense_init(gen, (d, arch.num_heads * dh), dtype=dtype),
        "wk": dense_init(gen, (d, arch.num_kv_heads * dh), dtype=dtype),
        "wv": dense_init(gen, (d, arch.num_kv_heads * dh), dtype=dtype),
        "wo": dense_init(gen, (arch.num_heads * dh, arch.d_model),
                         dtype=dtype),
    }
    if arch.qkv_bias:
        for name, width in (("bq", arch.num_heads), ("bk", arch.num_kv_heads),
                            ("bv", arch.num_kv_heads)):
            p[name] = torch.zeros((width * dh,), dtype=dtype,
                                  device=gen.device)
    return p


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------

def _project_qkv(params: dict, xq: torch.Tensor, xkv: torch.Tensor,
                 arch: ArchConfig):
    dh = arch.resolved_head_dim
    q = xq @ params["wq"]
    k = xkv @ params["wk"]
    v = xkv @ params["wv"]
    if "bq" in params:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    B, Sq = xq.shape[:2]
    Skv = xkv.shape[1]
    q = q.reshape(B, Sq, arch.num_heads, dh)
    k = k.reshape(B, Skv, arch.num_kv_heads, dh)
    v = v.reshape(B, Skv, arch.num_kv_heads, dh)
    return q, k, v


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
          window: int) -> Optional[torch.Tensor]:
    """(B, Sq, 1, 1, Skv) keep-mask from (B, Sq) and (B, Skv) positions, or
    None when nothing is masked."""
    if not causal and window <= 0:
        return None
    diff = q_pos[:, :, None, None, None] - k_pos[:, None, None, None, :]
    mask = torch.ones_like(diff, dtype=torch.bool)
    if causal:
        mask &= diff >= 0
    if window > 0:
        mask &= diff < window
    return mask


# ---------------------------------------------------------------------------
# Blockwise online-softmax attention (the flash-structured reference)
# ---------------------------------------------------------------------------

def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_positions: torch.Tensor, kv_positions: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        kv_block: int = 512) -> torch.Tensor:
    """Online-softmax attention looped over KV blocks.

    q (B,Sq,H,Dh); k,v (B,Skv,KV,Dh); positions (B,S) int.
    GQA by grouping: H = KV * G, scores per (KV, G) pair so K/V are never
    materialised per query head.  window > 0 keeps the last ``window``
    positions (sliding window).
    """
    B, Sq, H, Dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    blk = min(kv_block, Skv)
    while Skv % blk:
        blk //= 2

    qg = _scaled(q, Dh ** -0.5).reshape(B, Sq, KV, G, Dh)
    m = torch.full((B, Sq, KV, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Sq, KV, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, KV, G, Dh), dtype=torch.float32,
                      device=q.device)
    for lo in range(0, Skv, blk):
        k_blk, v_blk = k[:, lo:lo + blk], v[:, lo:lo + blk]
        s = _einsum_f32("bqkgd,bskd->bqkgs", qg, k_blk)
        mask = _mask(q_positions, kv_positions[:, lo:lo + blk], causal,
                     window)
        if mask is not None:
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + _einsum_f32(
            "bqkgs,bskd->bqkgd", p.to(v_blk.dtype), v_blk)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def qscan_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    q_block: int = 512) -> torch.Tensor:
    """Loop over QUERY blocks with a full-row one-pass softmax: nothing f32
    is carried across blocks; per-block live memory is one
    (B, bq, KV, G, Skv) f32 score block."""
    B, Sq, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    blk = min(q_block, Sq)
    while Sq % blk:
        blk //= 2
    qg = _scaled(q, Dh ** -0.5).reshape(B, Sq, KV, G, Dh)
    outs = []
    for lo in range(0, Sq, blk):
        s = _einsum_f32("bqkgd,bskd->bqkgs", qg[:, lo:lo + blk], k)
        mask = _mask(q_positions[:, lo:lo + blk], kv_positions, causal,
                     window)
        if mask is not None:
            s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out = _einsum_f32("bqkgs,bskd->bqkgd", p.to(v.dtype), v)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1).reshape(B, Sq, H, Dh)


def reference_attention(q, k, v, q_positions, kv_positions, causal=True,
                        window: int = 0) -> torch.Tensor:
    """O(S²)-memory oracle used only by tests at tiny shapes."""
    B, Sq, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, Dh).float()
    s = torch.einsum("bqkgd,bskd->bqkgs", qg, k.float())
    s = s * (Dh ** -0.5)
    mask = _mask(q_positions, kv_positions, causal, window)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Sequence-mode self-attention (train / prefill)
# ---------------------------------------------------------------------------

def self_attention(params: dict, x: torch.Tensor, positions: torch.Tensor,
                   arch: ArchConfig, causal: bool = True, window: int = 0,
                   impl: AttnImpl = AttnImpl.REFERENCE) -> torch.Tensor:
    q, k, v = _project_qkv(params, x, x, arch)
    if arch.rope_theta > 0:
        q = apply_rope(q, positions, arch.rope_theta)
        k = apply_rope(k, positions, arch.rope_theta)
    if impl == AttnImpl.FLASH:
        from repro_torch.kernels.flash_attention.ops import flash_attention
        out = flash_attention(q, k, v, causal=causal, window=window)
    elif impl == AttnImpl.QSCAN:
        out = qscan_attention(q, k, v, positions, positions, causal=causal,
                              window=window)
    else:
        out = blockwise_attention(q, k, v, positions, positions,
                                  causal=causal, window=window)
    B, S = x.shape[:2]
    return out.reshape(B, S, -1) @ params["wo"]


# ---------------------------------------------------------------------------
# Decode mode (one token, KV cache)
# ---------------------------------------------------------------------------

def decode_self_attention(params: dict, x1: torch.Tensor,
                          cache_k: torch.Tensor, cache_v: torch.Tensor,
                          length: torch.Tensor, arch: ArchConfig,
                          window: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step.  x1 (B,1,D); cache (B,Smax,KV,Dh); length a 0-d
    int tensor on the cache's device.

    The new K/V are written into ``cache_k``/``cache_v`` IN PLACE (the
    counterpart of the reference step's donated cache), at ``length``
    clamped to the last slot as ``dynamic_update_slice`` clamps it.
    Returns (attn_out (B,1,D), cache_k, cache_v).
    """
    B = x1.shape[0]
    dh = arch.resolved_head_dim
    pos = length.reshape(1, 1).expand(B, 1).to(torch.int32)
    q, k, v = _project_qkv(params, x1, x1, arch)
    if arch.rope_theta > 0:
        q = apply_rope(q, pos, arch.rope_theta)
        k = apply_rope(k, pos, arch.rope_theta)
    Smax, KV = cache_k.shape[1], cache_k.shape[2]
    slot = torch.clamp(length, max=Smax - 1).reshape(1).long()
    cache_k.index_copy_(1, slot, k.to(cache_k.dtype))
    cache_v.index_copy_(1, slot, v.to(cache_v.dtype))

    G = arch.num_heads // KV
    qg = _scaled(q, dh ** -0.5).reshape(B, 1, KV, G, dh)
    s = _einsum_f32("bqkgd,bskd->bqkgs", qg, cache_k)
    idx = torch.arange(Smax, device=cache_k.device)
    valid = idx <= length
    if window > 0:
        valid &= idx > length - window
    s = torch.where(valid[None, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = _einsum_f32("bqkgs,bskd->bqkgd", p.to(cache_v.dtype), cache_v)
    out = out.reshape(B, 1, -1).to(x1.dtype) @ params["wo"]
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# Cross-attention (whisper)
# ---------------------------------------------------------------------------

def cross_attention(params: dict, x: torch.Tensor, kv_cache_k: torch.Tensor,
                    kv_cache_v: torch.Tensor, arch: ArchConfig) -> torch.Tensor:
    """Decoder->encoder cross-attention against precomputed K/V (whisper):
    every query sees every encoder position."""
    B, Sq = x.shape[:2]
    dh = arch.resolved_head_dim
    q = (x @ params["wq"]).reshape(B, Sq, arch.num_heads, dh)
    if "bq" in params:
        q = q + params["bq"].reshape(arch.num_heads, dh).to(q.dtype)
    Skv = kv_cache_k.shape[1]
    pos_q = torch.zeros((B, Sq), dtype=torch.int32, device=x.device)
    pos_kv = torch.zeros((B, Skv), dtype=torch.int32, device=x.device)
    out = blockwise_attention(q, kv_cache_k, kv_cache_v, pos_q, pos_kv,
                              causal=False)
    return out.reshape(B, Sq, -1) @ params["wo"]


def project_cross_kv(params: dict, enc_out: torch.Tensor, arch: ArchConfig):
    """K/V of the encoder output, computed once at prefill (whisper)."""
    B, S = enc_out.shape[:2]
    dh = arch.resolved_head_dim
    k = (enc_out @ params["wk"]).reshape(B, S, arch.num_kv_heads, dh)
    v = (enc_out @ params["wv"]).reshape(B, S, arch.num_kv_heads, dh)
    if "bk" in params:
        k = k + params["bk"].reshape(arch.num_kv_heads, dh).to(k.dtype)
        v = v + params["bv"].reshape(arch.num_kv_heads, dh).to(v.dtype)
    return k, v
