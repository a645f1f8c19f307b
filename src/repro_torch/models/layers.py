"""Shared neural-net building blocks (plain torch, dict params): the
counterpart of ``repro.models.layers``.

The f32 upcasts sit where the reference has them: the norms and RoPE
compute in float32 and cast back to the input's dtype.  The reference's
``cross_entropy_loss`` comes with the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import Activation


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim with the population variance
    (``jnp.var``); no model of the zoo calls it, as in the reference."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(dtype)


def groupnorm_heads(x: torch.Tensor, scale: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """Per-head groupnorm over the feature dim.  x: (..., H, Dh).  The
    population variance (``jnp.var``), where ``torch.var`` defaults to the
    unbiased one; the scale multiplies (no ``1 +`` as in rmsnorm)."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # filled on the device (no copy from the host: decode is captured)
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) int.  Split-halves layout."""
    if theta <= 0:
        return x
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)          # (Dh/2,)
    angles = positions[..., None].float() * freqs           # (B, S, Dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(max_len: int, dim: int, device=None) -> torch.Tensor:
    """Whisper-style absolute sinusoidal embeddings (max_len, dim), f32,
    made on ``device`` (nothing is copied from the host, so a captured
    decode step may make them)."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    idx = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    log10k = torch.log(torch.full((), 10000.0, dtype=torch.float32,
                                  device=device))
    inv = torch.exp(-log10k * idx / max(dim // 2 - 1, 1))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _act(x: torch.Tensor, kind: Activation) -> torch.Tensor:
    if kind == Activation.SWIGLU or kind == Activation.GEGLU:
        raise ValueError("gated activations handled in gated_mlp")
    if kind == Activation.GELU:
        return _gelu(x)
    return F.relu(x)


def gated_mlp(params: dict, x: torch.Tensor, kind: Activation) -> torch.Tensor:
    """SwiGLU / GeGLU: down( act(x@gate) * (x@up) )."""
    gate = x @ params["w_gate"]
    up = x @ params["w_up"]
    if kind == Activation.GEGLU:
        h = _gelu(gate) * up
    else:
        h = F.silu(gate) * up
    return h @ params["w_down"]


def plain_mlp(params: dict, x: torch.Tensor, kind: Activation) -> torch.Tensor:
    h = x @ params["w_up"]
    if "b_up" in params:
        h = h + params["b_up"].to(h.dtype)
    h = _act(h, kind)
    out = h @ params["w_down"]
    if "b_down" in params:
        out = out + params["b_down"].to(out.dtype)
    return out


def mlp_apply(params: dict, x: torch.Tensor, kind: Activation) -> torch.Tensor:
    if kind in (Activation.SWIGLU, Activation.GEGLU):
        return gated_mlp(params, x, kind)
    return plain_mlp(params, x, kind)


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
               dtype=torch.float32) -> torch.Tensor:
    """Normal(0, 1) * scale (default fan_in**-0.5), drawn in f32 from
    ``gen`` on the generator's device (on the meta device, which has no
    generator, ``gen`` only names the device: shapes, no numbers)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    s = scale if scale is not None else fan_in ** -0.5
    meta = gen.device.type == "meta"
    w = torch.randn(tuple(shape), generator=None if meta else gen,
                    dtype=torch.float32, device=gen.device)
    return (w * s).to(dtype)


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, kind: Activation,
             dtype=torch.float32, bias: bool = False) -> dict:
    if kind in (Activation.SWIGLU, Activation.GEGLU):
        return {
            "w_gate": dense_init(gen, (d_model, d_ff), dtype=dtype),
            "w_up": dense_init(gen, (d_model, d_ff), dtype=dtype),
            "w_down": dense_init(gen, (d_ff, d_model), dtype=dtype),
        }
    p = {
        "w_up": dense_init(gen, (d_model, d_ff), dtype=dtype),
        "w_down": dense_init(gen, (d_ff, d_model), dtype=dtype),
    }
    if bias:
        p["b_up"] = torch.zeros((d_ff,), dtype=dtype, device=gen.device)
        p["b_down"] = torch.zeros((d_model,), dtype=dtype, device=gen.device)
    return p

