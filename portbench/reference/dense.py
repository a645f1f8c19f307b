"""Plain float32 forward of a dense decoder (internlm2): the benchmark's
reference for the dense configurations.  Imports torch and nothing of the
program under test.

The model, as InternLM2 (arXiv:2403.17297) describes it: token embedding,
L pre-norm layers of grouped-query attention with rotary positions and a
SwiGLU MLP, a final RMSNorm and an untied output head.

Departures from the published description, all shared with the program
under test, which the weights' layout follows:
  * the embedding is multiplied by sqrt(d_model);
  * every RMSNorm gain is ``1 + scale``;
  * wq/wk/wv are separate matrices (InternLM2 packs them as ``wqkv``).

The rotary embedding rotates the first half of a head's features against
the second (the published code's ``rotate_half``).

Weights are stacked by layer, as the program holds them:
``blocks/attn/wq`` is (L, d, H*Dh).  ``forward`` runs one sequence.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from portbench.reference import common as c

#: leaf -> how ``portbench.weights`` draws it: ("normal", scale rule)
INIT = {
    "embed": ("normal", "embed"),
    "lm_head": ("normal", "fan_in"),
    "final_norm": ("normal", "gain"),
    "blocks/ln1": ("normal", "gain"),
    "blocks/ln2": ("normal", "gain"),
    "blocks/attn/wq": ("normal", "fan_in"),
    "blocks/attn/wk": ("normal", "fan_in"),
    "blocks/attn/wv": ("normal", "fan_in"),
    "blocks/attn/wo": ("normal", "fan_in"),
    "blocks/mlp/w_gate": ("normal", "fan_in"),
    "blocks/mlp/w_up": ("normal", "fan_in"),
    "blocks/mlp/w_down": ("normal", "fan_in"),
}


def param_shapes(s: dict) -> Dict[str, tuple]:
    """leaf path -> (shape, dtype) of the served weights."""
    L, d, H, KV, Dh, F, V = c.shape_of(
        s, "layers", "d_model", "heads", "kv_heads", "head_dim", "d_ff",
        "vocab")
    bf = torch.bfloat16
    return {
        "embed": ((V, d), bf), "lm_head": ((d, V), bf),
        "final_norm": ((d,), bf),
        "blocks/ln1": ((L, d), bf), "blocks/ln2": ((L, d), bf),
        "blocks/attn/wq": ((L, d, H * Dh), bf),
        "blocks/attn/wk": ((L, d, KV * Dh), bf),
        "blocks/attn/wv": ((L, d, KV * Dh), bf),
        "blocks/attn/wo": ((L, H * Dh, d), bf),
        "blocks/mlp/w_gate": ((L, d, F), bf),
        "blocks/mlp/w_up": ((L, d, F), bf),
        "blocks/mlp/w_down": ((L, F, d), bf),
    }


def attn_block(ap: dict, x: torch.Tensor, positions: torch.Tensor, s: dict,
               window: int, low: bool):
    """Pre-norm attention's output and its (rotated) K and V."""
    S = x.shape[0]
    Dh = int(s["head_dim"])
    q = c.mm(x, ap["wq"], low).reshape(S, -1, Dh)
    k = c.mm(x, ap["wk"], low).reshape(S, -1, Dh)
    v = c.mm(x, ap["wv"], low).reshape(S, -1, Dh)
    q = c.rope(q, positions, float(s["rope_theta"]))
    k = c.rope(k, positions, float(s["rope_theta"]))
    o = c.attention(q, k, v, window=window, low=low)
    return c.mm(o.reshape(S, -1), ap["wo"], low), k, v


def forward(w: dict, s: dict, tokens: torch.Tensor,
            logit_positions: Sequence[int], low: bool = False,
            keep_cache: bool = False):
    """One sequence ``tokens`` (S,) -> (logits (len(logit_positions), V)
    f32, cache or None).  The cache holds, for every layer i,
    ``("k", (i,))`` and ``("v", (i,))``: (S, KV, Dh) f32, K after its
    rotation."""
    c.highest()
    eps = float(s["norm_eps"])
    S = tokens.shape[0]
    positions = torch.arange(S, device=tokens.device)
    x = c.embed(w["embed"], tokens, int(s["d_model"]))
    cache: Optional[dict] = {} if keep_cache else None
    for i in range(int(s["layers"])):
        lp = c.layer(w["blocks"], i)
        y, k, v = attn_block(lp["attn"], c.rmsnorm(x, lp["ln1"], eps),
                             positions, s, 0, low)
        if keep_cache:
            cache[("k", (i,))] = k
            cache[("v", (i,))] = v
        del k, v
        x = x + y
        m = lp["mlp"]
        x = x + c.swiglu(c.rmsnorm(x, lp["ln2"], eps), m["w_gate"],
                         m["w_up"], m["w_down"], low)
    at = torch.as_tensor(list(logit_positions), device=tokens.device)
    return c.head(x[at], w["final_norm"], w["lm_head"], eps, low), cache
