"""Layer-stack orchestrator: the counterpart of ``repro.models.transformer``
for the dense family.

A dense model is one segment of L identical [attn + mlp] layers whose
parameters are stacked on a leading axis (``blocks.attn.wq`` is
``(L, d, H*Dh)``), so a parameter tree carries across from the reference
key for key.  The reference's ``lax.scan`` over the stack is a Python loop
(``_scan``).  Params and caches are plain nested dicts of tensors.

Both modes of a block:
  seq(params, x, positions)           -> y            (train / prefill)
  decode(params, x1, cache, length)   -> y, cache     (one token; the cache
                                                       is written in place)

The moe, xlstm, zamba2, vlm and whisper plans raise ``NotImplementedError``
naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig, AttnImpl
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import dense_init, mlp_apply, mlp_init, rmsnorm

_NOT_PORTED = {
    "hybrid": "the zamba2 serving path (ROADMAP, open item 1)",
    "ssm": "the xlstm serving path (ROADMAP, open item 2)",
    "moe": "the rest of the model zoo: moe (ROADMAP, open item 8)",
    "vlm": "the rest of the model zoo: vlm (ROADMAP, open item 8)",
    "audio": "the rest of the model zoo: whisper (ROADMAP, open item 8)",
}


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

def plan(arch: ArchConfig) -> Dict[str, Any]:
    """Static structure of the layer stack."""
    if arch.family == "dense":
        return {"kind": "dense", "layers": arch.num_layers}
    if arch.family in _NOT_PORTED:
        raise NotImplementedError(
            f"repro_torch: family {arch.family!r} ({arch.name}) is not ported "
            f"yet; it comes with {_NOT_PORTED[arch.family]}")
    raise ValueError(arch.family)


def _layer(tree, i: int):
    """Layer ``i`` of a layer-stacked tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack(list(z)) for z in zip(*trees))
    return torch.stack(trees)


def _map(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def _dense_layer_init(gen: torch.Generator, arch: ArchConfig, dtype) -> dict:
    zeros = lambda: torch.zeros((arch.d_model,), dtype=dtype,
                                device=gen.device)
    return {
        "ln1": zeros(),
        "attn": attn.attn_init(gen, arch, dtype=dtype),
        "ln2": zeros(),
        "mlp": mlp_init(gen, arch.d_model, arch.d_ff, arch.activation,
                        dtype=dtype),
    }


def _stack_init(layer_init, gen: torch.Generator, n: int, arch: ArchConfig,
                dtype) -> dict:
    return _stack([layer_init(gen, arch, dtype) for _ in range(n)])


def init_params(arch: ArchConfig, seed: int = 0, dtype=torch.float32,
                device=None) -> dict:
    """Random-init parameters with the reference's tree, shapes and scales,
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (``None``: the CUDA card).  The numbers differ from the reference's
    ``jax.random`` ones; carry a reference tree across with
    ``core.carry.params_from_numpy`` to compute on the same weights."""
    p = plan(arch)
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    params: dict = {
        "embed": dense_init(gen, (arch.vocab_size, arch.d_model), scale=1.0,
                            dtype=dtype),
        "final_norm": torch.zeros((arch.d_model,), dtype=dtype,
                                  device=gen.device),
    }
    if not arch.tie_embeddings:
        params["lm_head"] = dense_init(gen, (arch.d_model, arch.vocab_size),
                                       dtype=dtype)
    params["blocks"] = _stack_init(_dense_layer_init, gen, p["layers"], arch,
                                   dtype)
    return params


# ---------------------------------------------------------------------------
# Sequence forward (train / prefill).  Returns (logits, aux_loss, cache|None)
# ---------------------------------------------------------------------------

def _dense_block_seq(lp, x, positions, arch, impl):
    x = x + attn.self_attention(lp["attn"], rmsnorm(x, lp["ln1"]), positions,
                                arch, impl=impl)
    x = x + mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"]), arch.activation)
    return x


def _scan(body, carry, xs, n: int):
    """The reference's ``lax.scan`` over the layer stack ``xs``, as a Python
    loop; the per-layer outputs are stacked (None when the body emits
    None)."""
    ys = []
    for i in range(n):
        carry, y = body(carry, _layer(xs, i))
        ys.append(y)
    return carry, (_stack(ys) if ys and ys[0] is not None else None)


def _cast(tree, compute_dtype):
    """f32 leaves with ndim > 1 in the compute dtype; norm scales left as
    they are (the reference's ``cast``)."""
    return _map(lambda a: a.to(compute_dtype)
                if a.dtype == torch.float32 and a.ndim > 1 else a, tree)


def _embed(arch: ArchConfig, params: dict, tokens: torch.Tensor,
           compute_dtype) -> torch.Tensor:
    x = params["embed"][tokens.long()].to(compute_dtype)
    return x * torch.tensor(arch.d_model ** 0.5, dtype=compute_dtype)


def _head(arch: ArchConfig, params: dict, x: torch.Tensor,
          compute_dtype) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"])
    head = params["embed"].T if arch.tie_embeddings else params["lm_head"]
    return x @ head.to(compute_dtype)


def forward_seq(arch: ArchConfig, params: dict, tokens: torch.Tensor,
                impl: AttnImpl = AttnImpl.REFERENCE,
                return_cache: bool = False,
                compute_dtype=torch.bfloat16):
    """tokens (B, S) int -> (logits (B, S, V), aux 0.0, cache | None); the
    cache holds the layer-stacked (L, B, S, KV, Dh) ``k`` and ``v``.
    Positions are 0..S-1 in every row."""
    p = plan(arch)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    x = _embed(arch, params, tokens, compute_dtype)

    def body(x, lp):
        lp = _cast(lp, compute_dtype)
        y = _dense_block_seq(lp, x, positions, arch, impl)
        return y, (_layer_kv(lp, x, positions, arch) if return_cache
                   else None)

    x, kv = _scan(body, x, params["blocks"], p["layers"])
    cache = None
    if return_cache:
        cache = {"k": kv[0], "v": kv[1]}
    logits = _head(arch, params, x, compute_dtype)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device), cache


def _layer_kv(lp, x_in, positions, arch):
    """Recompute this layer's K/V for the prefill cache (cheap vs attention)."""
    xn = rmsnorm(x_in, lp["ln1"])
    dh = arch.resolved_head_dim
    B, S = xn.shape[:2]
    k = (xn @ lp["attn"]["wk"]).reshape(B, S, arch.num_kv_heads, dh)
    v = (xn @ lp["attn"]["wv"]).reshape(B, S, arch.num_kv_heads, dh)
    if "bk" in lp["attn"]:
        k = k + lp["attn"]["bk"].reshape(arch.num_kv_heads, dh).to(k.dtype)
        v = v + lp["attn"]["bv"].reshape(arch.num_kv_heads, dh).to(v.dtype)
    if arch.rope_theta > 0:
        k = attn.apply_rope(k, positions, arch.rope_theta)
    return k, v


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def init_cache(arch: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Zeroed layer-stacked (L, B, max_len, KV, Dh) ``k``/``v`` and a 0-d
    int32 ``length``, on ``device`` (``None``: the CUDA card)."""
    p = plan(arch)
    dev = resolve_device(device)
    shape = (p["layers"], batch, max_len, arch.num_kv_heads,
             arch.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "length": torch.zeros((), dtype=torch.int32, device=dev)}


# ---------------------------------------------------------------------------
# Decode (one token)
# ---------------------------------------------------------------------------

def decode_step(arch: ArchConfig, params: dict, cache: dict,
                token: torch.Tensor, compute_dtype=torch.bfloat16):
    """token (B, 1) int -> (logits (B, 1, V), cache').

    Each layer's new K/V are written into ``cache["k"]``/``cache["v"]`` IN
    PLACE (the counterpart of the reference step's donated cache); the
    returned dict shares those tensors and carries ``length + 1``.  Decode
    attention is the einsum path (the reference's ``impl`` argument does
    not reach it either)."""
    p = plan(arch)
    length = cache["length"]
    x = _embed(arch, params, token, compute_dtype)
    for i in range(p["layers"]):
        lp = _cast(_layer(params["blocks"], i), compute_dtype)
        xn = rmsnorm(x, lp["ln1"])
        y, _, _ = attn.decode_self_attention(lp["attn"], xn, cache["k"][i],
                                             cache["v"][i], length, arch)
        x = x + y
        x = x + mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"]), arch.activation)
    logits = _head(arch, params, x, compute_dtype)
    new_cache = dict(cache)
    new_cache["length"] = length + 1
    return logits, new_cache
