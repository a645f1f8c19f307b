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
in the reference.

Tensor parallelism (``mesh`` given to ``self_attention``,
``decode_self_attention``, ``cross_attention`` and ``project_cross_kv``):
``wq``/``wk``/``wv`` hold the rank's columns,
so its heads are read from the weights' widths (``_project_qkv``), never
from ``arch``: ``H / model`` query and ``max(KV / model, 1)`` key/value
heads, the grouping ``h // (H / KV)`` holding on each rank.  Where
``model`` exceeds the KV heads, ``wk``/``wv`` (and ``bk``/``bv``) come in
as the one head of the rank's group, whole (``transformer.kv_view``), and
all ``H / model`` query heads of the rank read it.  The input enters
through ``vary`` and ``wo`` (the rank's rows) leaves through one ``psum``
over ``model``; a decode cache holds the rank's KV heads.

Flash decode (``flash_decode_attention``, ``decode_self_attention_sharded``)
runs on every rank of a mesh whose ``model`` axis shards the cache on the
SEQUENCE: each rank holds S/n positions, computes a partial softmax over
them, and the ranks combine with ``pmax`` of the max and ``psum`` of the
normaliser and of the weighted values (``parallel.collectives``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, AttnImpl
from repro_torch.models.layers import apply_rope, dense_init, tp_in, tp_out

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
    """q (B, Sq, H, Dh), k and v (B, Skv, KV, Dh), the head counts read
    from the weights' widths (a rank's under tensor parallelism)."""
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
    q = q.reshape(B, Sq, -1, dh)
    k = k.reshape(B, Skv, -1, dh)
    v = v.reshape(B, Skv, -1, dh)
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
                   impl: AttnImpl = AttnImpl.REFERENCE,
                   mesh=None, return_kv: bool = False):
    """With ``mesh``: the rank's heads (the module docstring).  With
    ``return_kv``: ``(out, (k, v))``, k after RoPE, for a prefill cache."""
    x = tp_in(x, mesh)
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
    out = tp_out(out.reshape(B, S, -1) @ params["wo"], mesh)
    return (out, (k, v)) if return_kv else out


# ---------------------------------------------------------------------------
# Decode mode (one token, KV cache)
# ---------------------------------------------------------------------------

def decode_self_attention(params: dict, x1: torch.Tensor,
                          cache_k: torch.Tensor, cache_v: torch.Tensor,
                          length: torch.Tensor, arch: ArchConfig,
                          window: int = 0, mesh=None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step.  x1 (B,1,D); cache (B,Smax,KV,Dh); length a 0-d
    int tensor on the cache's device.  With ``mesh``: the rank's heads and
    its KV heads' cache (the module docstring).

    The new K/V are written into ``cache_k``/``cache_v`` IN PLACE (the
    counterpart of the reference step's donated cache), at ``length``
    clamped to the last slot as ``dynamic_update_slice`` clamps it.
    Returns (attn_out (B,1,D), cache_k, cache_v).
    """
    B = x1.shape[0]
    dh = arch.resolved_head_dim
    pos = length.reshape(1, 1).expand(B, 1).to(torch.int32)
    x1 = tp_in(x1, mesh)
    q, k, v = _project_qkv(params, x1, x1, arch)
    if arch.rope_theta > 0:
        q = apply_rope(q, pos, arch.rope_theta)
        k = apply_rope(k, pos, arch.rope_theta)
    Smax, KV = cache_k.shape[1], cache_k.shape[2]
    slot = torch.clamp(length, max=Smax - 1).reshape(1).long()
    cache_k.index_copy_(1, slot, k.to(cache_k.dtype))
    cache_v.index_copy_(1, slot, v.to(cache_v.dtype))

    G = q.shape[2] // KV
    qg = _scaled(q, dh ** -0.5).reshape(B, 1, KV, G, dh)
    s = _einsum_f32("bqkgd,bskd->bqkgs", qg, cache_k)
    idx = torch.arange(Smax, device=cache_k.device)
    valid = idx <= length
    if window > 0:
        valid &= idx > length - window
    s = torch.where(valid[None, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = _einsum_f32("bqkgs,bskd->bqkgd", p.to(cache_v.dtype), cache_v)
    out = tp_out(out.reshape(B, 1, -1).to(x1.dtype) @ params["wo"], mesh)
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# Flash decode: partial softmax over the sequence-sharded cache
# ---------------------------------------------------------------------------

def flash_decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, length: torch.Tensor, mesh,
                           axis: str = "model") -> torch.Tensor:
    """Decode attention with the cache sharded on the SEQUENCE dim over
    ``axis``: this rank's ``cache_k``/``cache_v`` (B, S/n, KV, Dh) hold
    positions ``base .. base + S/n - 1``, ``base`` = the rank's index on
    ``axis`` x S/n.  q (B, 1, KV, G, Dh), scaled, the same on every rank.
    Returns (B, 1, KV, G, Dh) f32, the same on every rank of ``axis``.

    A rank whose positions all lie past ``length`` has every score at
    NEG_INF: its partial normaliser and values are those of a uniform
    softmax, and they vanish in the combine through exp(m - m_g) = 0."""
    from repro_torch.parallel.collectives import axis_index, pmax, psum
    s_local = cache_k.shape[1]
    base = axis_index(mesh, axis) * s_local
    s = _einsum_f32("bqkgd,bskd->bqkgs", q, cache_k)
    idx = base + torch.arange(s_local, device=cache_k.device)
    s = torch.where((idx <= length)[None, None, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)                                       # (B,1,KV,G)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = _einsum_f32("bqkgs,bskd->bqkgd", p.to(cache_v.dtype), cache_v)
    m_g = pmax(m, mesh, axis)
    corr = torch.exp(m - m_g)
    l_g = psum(l * corr, mesh, axis)
    o_g = psum(o * corr[..., None], mesh, axis)
    return o_g / torch.clamp(l_g, min=1e-30)[..., None]


def decode_self_attention_sharded(params: dict, x1: torch.Tensor,
                                  cache_k: torch.Tensor,
                                  cache_v: torch.Tensor, length: torch.Tensor,
                                  arch: ArchConfig, mesh, axis: str = "model"
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """``decode_self_attention`` with the flash-decode read path, on this
    rank's sequence shard of the cache.  The new K/V row goes IN PLACE to
    global position ``length`` (clamped to the last, as the unsharded step
    clamps it) on the one rank whose shard holds it; the others rewrite a
    row with itself.  Returns (attn_out (B,1,D), cache_k, cache_v)."""
    from repro_torch.parallel.collectives import axis_index, axis_size
    B = x1.shape[0]
    dh = arch.resolved_head_dim
    pos = length.reshape(1, 1).expand(B, 1).to(torch.int32)
    q, k, v = _project_qkv(params, x1, x1, arch)
    if arch.rope_theta > 0:
        q = apply_rope(q, pos, arch.rope_theta)
        k = apply_rope(k, pos, arch.rope_theta)
    s_local, KV = cache_k.shape[1], cache_k.shape[2]
    base = axis_index(mesh, axis) * s_local
    at = torch.clamp(length, max=s_local * axis_size(mesh, axis) - 1) - base
    owner = (at >= 0) & (at < s_local)
    slot = torch.clamp(at, 0, s_local - 1).reshape(1).long()
    for cache, new in ((cache_k, k), (cache_v, v)):
        row = torch.where(owner, new.to(cache.dtype),
                          cache.index_select(1, slot))
        cache.index_copy_(1, slot, row)
    G = arch.num_heads // KV
    qg = _scaled(q, dh ** -0.5).reshape(B, 1, KV, G, dh)
    out = flash_decode_attention(qg, cache_k, cache_v, length, mesh, axis)
    out = out.reshape(B, 1, -1).to(x1.dtype) @ params["wo"]
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# Cross-attention (whisper)
# ---------------------------------------------------------------------------

def cross_attention(params: dict, x: torch.Tensor, kv_cache_k: torch.Tensor,
                    kv_cache_v: torch.Tensor, arch: ArchConfig,
                    mesh=None) -> torch.Tensor:
    """Decoder->encoder cross-attention against precomputed K/V (whisper):
    every query sees every encoder position.  With ``mesh``: the rank's
    query heads against its KV heads' K/V, ``wo`` row-parallel (one
    ``tp_out``)."""
    B, Sq = x.shape[:2]
    dh = arch.resolved_head_dim
    q = (tp_in(x, mesh) @ params["wq"]).reshape(B, Sq, -1, dh)
    if "bq" in params:
        q = q + params["bq"].reshape(-1, dh).to(q.dtype)
    Skv = kv_cache_k.shape[1]
    pos_q = torch.zeros((B, Sq), dtype=torch.int32, device=x.device)
    pos_kv = torch.zeros((B, Skv), dtype=torch.int32, device=x.device)
    out = blockwise_attention(q, kv_cache_k, kv_cache_v, pos_q, pos_kv,
                              causal=False)
    return tp_out(out.reshape(B, Sq, -1) @ params["wo"], mesh)


def project_cross_kv(params: dict, enc_out: torch.Tensor, arch: ArchConfig,
                     mesh=None):
    """K/V of the encoder output, computed once at prefill (whisper); with
    ``mesh`` the rank's KV heads."""
    B, S = enc_out.shape[:2]
    dh = arch.resolved_head_dim
    enc_out = tp_in(enc_out, mesh)
    k = (enc_out @ params["wk"]).reshape(B, S, -1, dh)
    v = (enc_out @ params["wv"]).reshape(B, S, -1, dh)
    if "bk" in params:
        k = k + params["bk"].reshape(-1, dh).to(k.dtype)
        v = v + params["bv"].reshape(-1, dh).to(v.dtype)
    return k, v
