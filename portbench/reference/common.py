"""Plain float32 building blocks of the references (torch only).

Every function works on one sequence at a time, in float32, with TF32
off (``highest``), and no kernel, cache or batching of the program under
test.  ``low=True`` computes the same mathematics with every product's
operands rounded to fp8 (e4m3, a scale per row of an activation and per
output column of a weight): the control, the precision a step below the
bfloat16 the configurations serve in.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0                 # the largest finite float8_e4m3fn


def highest() -> None:
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def q8(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``x`` rounded to e4m3 with one scale per slice along ``dim`` (the
    slice's largest magnitude maps to 448), returned in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def mm(x: torch.Tensor, w: torch.Tensor, low: bool = False) -> torch.Tensor:
    """``x @ w`` in float32; ``low``: both operands through ``q8`` (x by
    rows, w by output columns)."""
    x, w = x.float(), w.float()
    if low:
        x, w = q8(x, -1), q8(w, 0)
    return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with a ``1 + scale`` gain."""
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return x * (1.0 + scale.float())


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding of x (S, H, D) in the split-halves layout: the
    first D/2 features rotate against the last D/2 at frequencies
    theta^(-2i/D)."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                  device=x.device) / d)
    ang = (positions.double()[:, None] * inv).float()        # (S, D/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int = 0, low: bool = False, block: int = 1024
              ) -> torch.Tensor:
    """Causal softmax attention of one sequence, q (S, H, D), k and v
    (S, KV, D), query head h reading KV head h // (H / KV); ``window`` > 0
    keeps keys fewer than ``window`` positions back.  Queries go in
    blocks of ``block`` rows, each against the keys it can see."""
    S, H, D = q.shape
    KV = k.shape[1]
    G = H // KV
    q, k, v = q.float() * D ** -0.5, k.float(), v.float()
    if low:
        q, k, v = q8(q), q8(k), q8(v)
    out = torch.empty((S, H, D), dtype=torch.float32, device=q.device)
    for q0 in range(0, S, block):
        q1 = min(S, q0 + block)
        k0 = max(0, q0 - window + 1) if window > 0 else 0
        qb = q[q0:q1].reshape(q1 - q0, KV, G, D)
        s = torch.einsum("qkgd,skd->kgqs", qb, k[k0:q1])     # (KV,G,q,s)
        qi = torch.arange(q0, q1, device=q.device)[:, None]
        ki = torch.arange(k0, q1, device=q.device)[None, :]
        keep = ki <= qi
        if window > 0:
            keep &= qi - ki < window
        s = torch.where(keep, s, float("-inf"))
        p = torch.softmax(s, dim=-1)
        if low:
            p = q8(p)
        o = torch.einsum("kgqs,skd->qkgd", p, v[k0:q1])
        out[q0:q1] = o.reshape(q1 - q0, H, D)
    return out


def swiglu(x: torch.Tensor, w_gate, w_up, w_down, low: bool = False
           ) -> torch.Tensor:
    """down(silu(x gate) * (x up))."""
    return mm(F.silu(mm(x, w_gate, low)) * mm(x, w_up, low), w_down, low)


def head(x: torch.Tensor, final_norm, lm_head, eps: float,
         low: bool = False) -> torch.Tensor:
    """Logits of the rows of x (n, d)."""
    return mm(rmsnorm(x, final_norm, eps), lm_head, low)


def embed(table: torch.Tensor, tokens: torch.Tensor, d: int
          ) -> torch.Tensor:
    """The rows of ``tokens`` times sqrt(d), in float32."""
    return table[tokens.long()].float() * math.sqrt(d)


def layer(tree, index) -> dict:
    """Layer ``index`` (an int or a tuple of ints) of a layer-stacked
    parameter tree, every leaf as it is stored (views)."""
    if isinstance(tree, dict):
        return {k: layer(v, index) for k, v in tree.items()}
    return tree[index]


def gap_of(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """For rows of reference logits (n, V) and the tokens served at them
    (n,): how far each served token's logit lies below the row's best."""
    best = logits.max(dim=-1).values
    got = logits.gather(-1, tokens.long()[:, None])[:, 0]
    return best - got


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want| (0 when both are 0)."""
    got, want = got.float(), want.float()
    den = float(want.abs().max()) if want.numel() else 0.0
    num = float((got - want).abs().max()) if want.numel() else 0.0
    return num / den if den > 0 else num


def shape_of(sizes: dict, *keys: str) -> tuple:
    return tuple(int(sizes[k]) for k in keys)
