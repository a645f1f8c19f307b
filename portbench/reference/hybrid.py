"""Plain float32 forward of a Mamba-2 / shared-attention hybrid (zamba2):
the benchmark's reference for the hybrid configurations.  Imports torch
and nothing of the program under test.

The model as Zamba2 (arXiv:2411.15242) describes it: a backbone of Mamba-2
layers (SSD, arXiv:2405.21060) with a weight-shared attention + MLP block
applied after every ``every`` of them, a final RMSNorm and an untied
output head.

Departures from Zyphra's Zamba2-7B, all shared with the program under
test, whose weights' layout this follows (the configuration file lists
them under ``assumed``):
  * ONE shared block (Zyphra alternates two), with no per-application
    LoRA adapters, taking the residual stream alone (d_model wide, head
    dim d_model / heads) where Zyphra concatenates the original
    embeddings (2 d_model wide);
  * the shared block's MLP is SwiGLU (Zyphra: GELU);
  * the shared block is applied after each full group of ``every`` Mamba
    layers, 81 = 13 x 6 + 3: the remaining 3 form a tail;
  * Mamba-2 with one group of B and C (Zyphra: 2), no bias in the
    projections;
  * the embedding is multiplied by sqrt(d_model) and every RMSNorm gain
    is ``1 + scale`` (the gated norm inside Mamba-2 too).

The SSD recurrence, per head h, with a = -exp(A_log), dt = softplus(x
w_dt + dt_bias):  state_t = exp(a dt_t) state_{t-1} + dt_t x_t B_t^T and
y_t = state_t C_t + D x_t; it is computed here in chunks of ``CHUNK``
positions (exact: within a chunk the quadratic form, across chunks the
carried state).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench.reference import common as c
from portbench.reference.dense import attn_block

CHUNK = 256

MAMBA_INIT = {
    "ln": ("normal", "gain"),
    "mamba/w_z": ("normal", "fan_in"), "mamba/w_x": ("normal", "fan_in"),
    "mamba/w_B": ("normal", "fan_in"), "mamba/w_C": ("normal", "fan_in"),
    "mamba/w_dt": ("normal", "fan_in"),
    "mamba/conv_x": ("normal", "conv"), "mamba/conv_B": ("normal", "conv"),
    "mamba/conv_C": ("normal", "conv"),
    "mamba/A_log": ("A_log", None), "mamba/D": ("D", None),
    "mamba/dt_bias": ("dt_bias", None),
    "mamba/norm": ("normal", "gain"), "mamba/w_out": ("normal", "fan_in"),
}

#: leaf -> how ``portbench.weights`` draws it
INIT = {
    "embed": ("normal", "embed"), "lm_head": ("normal", "fan_in"),
    "final_norm": ("normal", "gain"),
    **{f"blocks/{k}": v for k, v in MAMBA_INIT.items()},
    **{f"tail/{k}": v for k, v in MAMBA_INIT.items()},
    "shared/ln1": ("normal", "gain"), "shared/ln2": ("normal", "gain"),
    "shared/attn/wq": ("normal", "fan_in"),
    "shared/attn/wk": ("normal", "fan_in"),
    "shared/attn/wv": ("normal", "fan_in"),
    "shared/attn/wo": ("normal", "fan_in"),
    "shared/mlp/w_gate": ("normal", "fan_in"),
    "shared/mlp/w_up": ("normal", "fan_in"),
    "shared/mlp/w_down": ("normal", "fan_in"),
}


def dims(s: dict):
    """(groups, every, tail, d_inner, ssm heads)."""
    every, layers = int(s["every"]), int(s["mamba_layers"])
    di = int(s["expand"]) * int(s["d_model"])
    return layers // every, every, layers % every, di, \
        di // int(s["ssm_head_dim"])


def param_shapes(s: dict) -> Dict[str, tuple]:
    """leaf path -> (shape, dtype) of the served weights."""
    G, per, T, di, Hs = dims(s)
    d, H, KV, Dh, F_, V, N, W = c.shape_of(
        s, "d_model", "heads", "kv_heads", "head_dim", "d_ff", "vocab",
        "state", "conv_width")
    bf, f32 = torch.bfloat16, torch.float32

    def mamba(*lead):
        return {"ln": (lead + (d,), bf),
                "mamba/w_z": (lead + (d, di), bf),
                "mamba/w_x": (lead + (d, di), bf),
                "mamba/w_B": (lead + (d, N), bf),
                "mamba/w_C": (lead + (d, N), bf),
                "mamba/w_dt": (lead + (d, Hs), bf),
                "mamba/conv_x": (lead + (W, di), bf),
                "mamba/conv_B": (lead + (W, N), bf),
                "mamba/conv_C": (lead + (W, N), bf),
                "mamba/A_log": (lead + (Hs,), f32),
                "mamba/D": (lead + (Hs,), f32),
                "mamba/dt_bias": (lead + (Hs,), f32),
                "mamba/norm": (lead + (di,), bf),
                "mamba/w_out": (lead + (di, d), bf)}
    out = {"embed": ((V, d), bf), "lm_head": ((d, V), bf),
           "final_norm": ((d,), bf),
           **{f"blocks/{k}": v for k, v in mamba(G, per).items()},
           "shared/ln1": ((d,), bf), "shared/ln2": ((d,), bf),
           "shared/attn/wq": ((d, H * Dh), bf),
           "shared/attn/wk": ((d, KV * Dh), bf),
           "shared/attn/wv": ((d, KV * Dh), bf),
           "shared/attn/wo": ((H * Dh, d), bf),
           "shared/mlp/w_gate": ((d, F_), bf),
           "shared/mlp/w_up": ((d, F_), bf),
           "shared/mlp/w_down": ((F_, d), bf)}
    if T:
        out.update({f"tail/{k}": v for k, v in mamba(T).items()})
    return out


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of x (S, C) with w (W, C), zeros before the
    sequence: y_t = sum_i w_i x_{t-W+1+i}."""
    Wd = w.shape[0]
    pad = F.pad(x, (0, 0, Wd - 1, 0))
    return sum(pad[i:i + x.shape[0]] * w[i].float() for i in range(Wd))


def ssd(x: torch.Tensor, a_dt: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, dt: torch.Tensor, low: bool = False):
    """The SSD recurrence over one sequence: x (S, H, P), a_dt and dt
    (S, H), B and C (S, N) -> (y (S, H, P), final state (H, P, N))."""
    S, H, P = x.shape
    N = B.shape[-1]
    xdt = x * dt[..., None]
    if low:
        xdt, B, C = c.q8(xdt), c.q8(B), c.q8(C)
    state = torch.zeros((H, P, N), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    for s0 in range(0, S, CHUNK):
        s1 = min(S, s0 + CHUNK)
        acum = torch.cumsum(a_dt[s0:s1], dim=0)                  # (l, H)
        seg = acum[:, None, :] - acum[None, :, :]                # (l, l, H)
        l = s1 - s0
        tril = torch.ones((l, l), dtype=torch.bool,
                          device=x.device).tril()[..., None]
        decay = torch.exp(torch.where(tril, seg, float("-inf")))
        cb = C[s0:s1] @ B[s0:s1].T                               # (l, l)
        y_in = torch.einsum("ijh,jhp->ihp", cb[..., None] * decay,
                            xdt[s0:s1])
        y_st = torch.einsum("in,hpn->ihp", C[s0:s1], state) \
            * torch.exp(acum)[..., None]
        y[s0:s1] = y_in + y_st
        to_end = torch.exp(acum[-1] - acum)                      # (l, H)
        state = state * torch.exp(acum[-1])[:, None, None] + torch.einsum(
            "jn,jh,jhp->hpn", B[s0:s1], to_end, xdt[s0:s1])
    return y, state


def mamba_layer(mp: dict, x: torch.Tensor, s: dict, low: bool):
    """One Mamba-2 mixer on the normed input x (S, d) -> (out, cache):
    the last conv_width - 1 pre-conv projections and the final state."""
    S = x.shape[0]
    P = int(s["ssm_head_dim"])
    eps = float(s["norm_eps"])
    z = c.mm(x, mp["w_z"], low)
    xp = c.mm(x, mp["w_x"], low)
    bp = c.mm(x, mp["w_B"], low)
    cp = c.mm(x, mp["w_C"], low)
    xi = F.silu(causal_conv(xp, mp["conv_x"]))
    Bm = F.silu(causal_conv(bp, mp["conv_B"]))
    Cm = F.silu(causal_conv(cp, mp["conv_C"]))
    dt = F.softplus(c.mm(x, mp["w_dt"], low) + mp["dt_bias"].float())
    a = -torch.exp(mp["A_log"].float())
    xh = xi.reshape(S, -1, P)
    y, state = ssd(xh, a * dt, Bm, Cm, dt, low)
    y = (y + xh * mp["D"].float()[:, None]).reshape(S, -1)
    y = c.rmsnorm(y, mp["norm"], eps) * F.silu(z)
    w = int(s["conv_width"]) - 1
    cache = {"conv_x": xp[-w:], "conv_B": bp[-w:], "conv_C": cp[-w:],
             "state": state}
    return c.mm(y, mp["w_out"], low), cache


def forward(w: dict, s: dict, tokens: torch.Tensor,
            logit_positions: Sequence[int], low: bool = False,
            keep_cache: bool = False):
    """One sequence ``tokens`` (S,) -> (logits (len(logit_positions), V)
    f32, cache or None).  The cache holds ``("mamba/<leaf>", (g, i))``
    for the i-th Mamba layer of group g, ``("tail/<leaf>", (t,))`` for
    the tail's, and ``("shared_k", (g,))``/``("shared_v", (g,))``, the
    shared block's rotated K and its V at its application after group g,
    (S, KV, Dh)."""
    c.highest()
    G, per, T, _, _ = dims(s)
    eps = float(s["norm_eps"])
    window = int(s.get("window") or 0)
    S = tokens.shape[0]
    positions = torch.arange(S, device=tokens.device)
    x = c.embed(w["embed"], tokens, int(s["d_model"]))
    cache: Optional[dict] = {} if keep_cache else None

    def mamba(lp, where, index):
        nonlocal x
        y, mc = mamba_layer(lp["mamba"], c.rmsnorm(x, lp["ln"], eps), s, low)
        x = x + y
        if keep_cache:
            for k, v in mc.items():
                cache[(f"{where}/{k}", index)] = v

    sh = w["shared"]
    for g in range(G):
        for i in range(per):
            mamba(c.layer(w["blocks"], (g, i)), "mamba", (g, i))
        y, k, v = attn_block(sh["attn"], c.rmsnorm(x, sh["ln1"], eps),
                             positions, s, window, low)
        if keep_cache:
            cache[("shared_k", (g,))] = k
            cache[("shared_v", (g,))] = v
        del k, v
        x = x + y
        m = sh["mlp"]
        x = x + c.swiglu(c.rmsnorm(x, sh["ln2"], eps), m["w_gate"],
                         m["w_up"], m["w_down"], low)
    for t in range(T):
        mamba(c.layer(w["tail"], t), "tail", (t,))
    at = torch.as_tensor(list(logit_positions), device=tokens.device)
    return c.head(x[at], w["final_norm"], w["lm_head"], eps, low), cache
