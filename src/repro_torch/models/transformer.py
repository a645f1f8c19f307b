"""Layer-stack orchestrator: the counterpart of ``repro.models.transformer``
for every family of the registry.

Segment plans (family -> structure):
  dense / vlm        L x [attn + mlp]          (vlm: patch embeddings first)
  moe                L x [attn + moe]
  ssm (xlstm)        G x [7 x mlstm; slstm]                       (G = L/8)
  hybrid (zamba2)    G x [6 x mamba2; SHARED attn+mlp] (+ tail of mamba2)
  audio (whisper)    4 x [enc attn + mlp]; 4 x [self + cross + mlp]

Parameters of a homogeneous run of layers are stacked on a leading axis
(``blocks.attn.wq`` is ``(L, d, H*Dh)``; zamba2's ``blocks.mamba.w_x`` is
``(G, 6, d, d_inner)``; xlstm's ``blocks.mlstm.cell.w_q`` is ``(G, 7, di,
di)`` and ``blocks.slstm.cell.r`` ``(G, 4, H, dh, dh)``), so a parameter tree
carries across from the reference key for key.  The reference's
``lax.scan`` over the stack is a Python loop (``_scan``).  Params and
caches are plain nested dicts of tensors.

Both modes of a block:
  seq(params, x, positions)           -> y            (train / prefill)
  decode(params, x1, cache, length)   -> y, cache     (one token; the cache
                                                       is written in place)

The vlm and audio front ends are stubs, as in the reference: ``extra``
carries ``patch_embeds`` (vlm: ``num_patches`` positions put in front of the
text, the prompt's length kept) or ``frame_embeds`` (whisper: the
encoder's input frames), and ``model_zoo.example_batch`` makes both.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, AttnImpl
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (apply_rope, dense_init, mlp_apply,
                                       mlp_init, rmsnorm,
                                       sinusoidal_positions)


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

def plan(arch: ArchConfig) -> Dict[str, Any]:
    """Static structure of the layer stack."""
    if arch.family in ("dense", "vlm"):
        return {"kind": "dense", "layers": arch.num_layers}
    if arch.family == "moe":
        return {"kind": "moe", "layers": arch.num_layers}
    if arch.family == "ssm":        # xlstm
        per = arch.xlstm.slstm_every
        groups = max(1, arch.num_layers // per)
        return {"kind": "xlstm", "groups": groups, "mlstm_per": per - 1}
    if arch.family == "hybrid":     # zamba2
        per = arch.shared_attn_every
        groups = arch.num_layers // per
        tail = arch.num_layers - groups * per
        return {"kind": "zamba", "groups": groups, "mamba_per": per,
                "tail": tail}
    if arch.family == "audio":
        return {"kind": "whisper", "enc": arch.encoder_layers,
                "dec": arch.num_layers}
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


def _put(dst, src, i: int) -> None:
    """Layer ``i`` of the stacked tree ``dst`` := the tree ``src``."""
    if isinstance(dst, dict):
        for k in dst:
            _put(dst[k], src[k], i)
    else:
        dst[i].copy_(src)


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


def _moe_layer_init(gen: torch.Generator, arch: ArchConfig, dtype) -> dict:
    zeros = lambda: torch.zeros((arch.d_model,), dtype=dtype,
                                device=gen.device)
    return {
        "ln1": zeros(),
        "attn": attn.attn_init(gen, arch, dtype=dtype),
        "ln2": zeros(),
        "moe": moe_mod.moe_init(gen, arch, dtype=dtype),
    }


def _whisper_dec_layer_init(gen: torch.Generator, arch: ArchConfig,
                            dtype) -> dict:
    zeros = lambda: torch.zeros((arch.d_model,), dtype=dtype,
                                device=gen.device)
    return {
        "ln1": zeros(),
        "self_attn": attn.attn_init(gen, arch, dtype=dtype),
        "ln_x": zeros(),
        "cross_attn": attn.attn_init(gen, arch, dtype=dtype),
        "ln2": zeros(),
        "mlp": mlp_init(gen, arch.d_model, arch.d_ff, arch.activation,
                        dtype=dtype, bias=False),
    }


def _mamba_layer_init(gen: torch.Generator, arch: ArchConfig, dtype) -> dict:
    return {
        "ln": torch.zeros((arch.d_model,), dtype=dtype, device=gen.device),
        "mamba": ssm_mod.mamba2_init(gen, arch, dtype=dtype),
    }


def _mlstm_layer_init(gen: torch.Generator, arch: ArchConfig, dtype) -> dict:
    return {
        "ln": torch.zeros((arch.d_model,), dtype=dtype, device=gen.device),
        "cell": xlstm_mod.mlstm_init(gen, arch, dtype=dtype),
    }


def _xlstm_group_init(gen: torch.Generator, arch: ArchConfig, dtype) -> dict:
    per = plan(arch)["mlstm_per"]
    return {
        "mlstm": _stack_init(_mlstm_layer_init, gen, per, arch, dtype),
        "slstm": {"ln": torch.zeros((arch.d_model,), dtype=dtype,
                                    device=gen.device),
                  "cell": xlstm_mod.slstm_init(gen, arch, dtype=dtype)},
    }


def _stack_init(layer_init, gen: torch.Generator, n: int, arch: ArchConfig,
                dtype) -> dict:
    """``n`` layers stacked on a leading axis, drawn one after the other
    and copied into the stack as each is made: the stack and one layer are
    live at once, never the ``n`` layers twice (grok-1's experts are 9.7 GB
    a layer in bf16)."""
    first = layer_init(gen, arch, dtype)
    out = _map(lambda a: a.new_empty((n,) + tuple(a.shape)), first)
    _put(out, first, 0)
    del first
    for i in range(1, n):
        _put(out, layer_init(gen, arch, dtype), i)
    return out


def init_params(arch: ArchConfig, seed: int = 0, dtype=torch.float32,
                device=None) -> dict:
    """Random-init parameters with the reference's tree, shapes and scales,
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (``None``: the CUDA card).  The numbers differ from the reference's
    ``jax.random`` ones; carry a reference tree across with
    ``core.carry.params_from_numpy`` to compute on the same weights.  On the
    ``meta`` device the tree holds shapes and dtypes only."""
    p = plan(arch)
    dev = resolve_device(device)
    # the meta device has no generator: a stand-in that names the device
    gen = SimpleNamespace(device=dev) if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    params: dict = {
        "embed": dense_init(gen, (arch.vocab_size, arch.d_model), scale=1.0,
                            dtype=dtype),
        "final_norm": torch.zeros((arch.d_model,), dtype=dtype,
                                  device=gen.device),
    }
    if not arch.tie_embeddings:
        params["lm_head"] = dense_init(gen, (arch.d_model, arch.vocab_size),
                                       dtype=dtype)
    if p["kind"] == "dense":
        params["blocks"] = _stack_init(_dense_layer_init, gen, p["layers"],
                                       arch, dtype)
    elif p["kind"] == "moe":       # the router f32 in every tree
        params["blocks"] = _stack_init(_moe_layer_init, gen, p["layers"],
                                       arch, dtype)
    elif p["kind"] == "xlstm":     # (G, 7, ...) mLSTM and (G, ...) sLSTM
        params["blocks"] = _stack_init(_xlstm_group_init, gen, p["groups"],
                                       arch, dtype)
    elif p["kind"] == "zamba":     # (G, per, ...) mamba stacks, a tail, ONE
        params["blocks"] = _stack([  # shared block
            _stack_init(_mamba_layer_init, gen, p["mamba_per"], arch, dtype)
            for _ in range(p["groups"])])
        if p["tail"]:
            params["tail"] = _stack_init(_mamba_layer_init, gen, p["tail"],
                                         arch, dtype)
        params["shared"] = _dense_layer_init(gen, arch, dtype)
    else:                          # whisper: encoder and decoder stacks
        # an encoder layer is a dense one (the reference's
        # _whisper_enc_layer_init: the same tree, an MLP with no bias)
        params["enc_blocks"] = _stack_init(_dense_layer_init, gen, p["enc"],
                                           arch, dtype)
        params["dec_blocks"] = _stack_init(_whisper_dec_layer_init, gen,
                                           p["dec"], arch, dtype)
        params["enc_norm"] = torch.zeros((arch.d_model,), dtype=dtype,
                                         device=gen.device)
        # the front-end stub's adapter: frame embeddings -> d_model
        params["frame_proj"] = dense_init(gen, (arch.d_model, arch.d_model),
                                          dtype=dtype)
    if arch.frontend_stub == "clip_patches":
        params["patch_proj"] = dense_init(gen, (arch.d_model, arch.d_model),
                                          dtype=dtype)
    return params


# ---------------------------------------------------------------------------
# Sequence forward (train / prefill).  Returns (logits, aux_loss, cache|None)
# ---------------------------------------------------------------------------

def _dense_block_seq(lp, x, positions, arch, impl, window=0, causal=True):
    x = x + attn.self_attention(lp["attn"], rmsnorm(x, lp["ln1"]), positions,
                                arch, causal=causal, window=window, impl=impl)
    x = x + mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"]), arch.activation)
    return x


def _moe_block_seq(lp, x, positions, arch, impl):
    x = x + attn.self_attention(lp["attn"], rmsnorm(x, lp["ln1"]), positions,
                                arch, impl=impl)
    y, aux = moe_mod.moe_apply(lp["moe"], rmsnorm(x, lp["ln2"]), arch)
    return x + y, aux


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
                extra: Optional[dict] = None,
                impl: AttnImpl = AttnImpl.REFERENCE,
                return_cache: bool = False,
                compute_dtype=torch.bfloat16):
    """tokens (B, S) int -> (logits (B, S, V), aux f32, cache | None).
    Positions are 0..S-1 in every row.  ``impl`` picks the attention path
    and, in the Mamba-2 and mLSTM layers, the scan (FLASH: the kernels).
    ``extra`` holds the front-end stubs' inputs: ``patch_embeds`` (B,
    num_patches, d) f32 for the vlm, which take the first ``num_patches``
    positions in place of as many text tokens, or ``frame_embeds`` (B, F,
    d) f32 for whisper's encoder.  ``aux`` is the moe layers' summed
    load-balancing loss (0 elsewhere).

    The dense and moe caches hold the layer-stacked (L, B, S, KV, Dh)
    ``k`` and ``v``; whisper's the decoder's ``self_k``/``self_v`` (L, B,
    S, KV, Dh) and the encoder output's ``cross_k``/``cross_v`` (L, B, F,
    KV, Dh).  The xlstm cache holds ``mlstm`` (G, 7, ...: the conv window and
    the f32 C, n, m) and ``slstm`` (G, ...: f32 c, n, m and h).  The zamba2
    cache holds ``mamba`` (G, per, ...) and ``tail`` (the conv windows and
    f32 states), and the shared block's
    ``shared_k``/``shared_v`` (G, B, win, KV, Dh) of the last ``win``
    positions with their ``shared_pos`` (G, B, win), ``win`` being the
    sliding window when it is shorter than S, else S."""
    p = plan(arch)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    x = _embed(arch, params, tokens, compute_dtype)
    if arch.frontend_stub == "clip_patches":
        patches = extra["patch_embeds"].to(compute_dtype) @ \
            params["patch_proj"].to(compute_dtype)
        x = torch.cat([patches, x[:, :S - arch.num_patches]], dim=1)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = None

    if p["kind"] == "whisper":
        x, cache = _whisper_seq(arch, params, x, positions, extra, impl,
                                return_cache, compute_dtype)
    elif p["kind"] == "dense":
        def body(x, lp):
            lp = _cast(lp, compute_dtype)
            y = _dense_block_seq(lp, x, positions, arch, impl)
            return y, (_layer_kv(lp, x, positions, arch) if return_cache
                       else None)

        x, kv = _scan(body, x, params["blocks"], p["layers"])
        if return_cache:
            cache = {"k": kv[0], "v": kv[1]}
    elif p["kind"] == "moe":
        auxs, kvs = [], []
        for i in range(p["layers"]):
            lp = _cast(_layer(params["blocks"], i), compute_dtype)
            if return_cache:
                kvs.append(_layer_kv(lp, x, positions, arch))
            x, aux = _moe_block_seq(lp, x, positions, arch, impl)
            auxs.append(aux)
        aux_total = aux_total + torch.stack(auxs).sum()
        if return_cache:
            k, v = _stack(kvs)
            cache = {"k": k, "v": v}
    elif p["kind"] == "xlstm":
        def mbody(x, lp):
            y = xlstm_mod.mlstm_seq(lp["cell"], rmsnorm(x, lp["ln"]), arch,
                                    return_state=return_cache, impl=impl)
            if return_cache:
                y, mc = y
                return x + y, mc
            return x + y, None

        def group(x, gp):
            gp = _cast(gp, compute_dtype)
            x, mcs = _scan(mbody, x, gp["mlstm"], p["mlstm_per"])
            sp = gp["slstm"]
            y = xlstm_mod.slstm_seq(sp["cell"], rmsnorm(x, sp["ln"]), arch,
                                    return_state=return_cache)
            if return_cache:
                y, sc = y
                return x + y, (mcs, sc)
            return x + y, None

        x, gcs = _scan(group, x, params["blocks"], p["groups"])
        if return_cache:
            cache = {"mlstm": gcs[0], "slstm": gcs[1]}
    else:
        shared = _cast(params["shared"], compute_dtype)
        win = arch.sliding_window if 0 < arch.sliding_window < S else S

        def mamba_body(x, lp):
            y = ssm_mod.mamba2_seq(lp["mamba"], rmsnorm(x, lp["ln"]), arch,
                                   return_state=return_cache, impl=impl)
            if return_cache:
                y, mc = y
                return x + y, mc
            return x + y, None

        def group(x, gp):
            gp = _cast(gp, compute_dtype)
            x, mcs = _scan(mamba_body, x, gp, p["mamba_per"])
            x_pre = x
            x = _dense_block_seq(shared, x, positions, arch, impl,
                                 window=arch.sliding_window)
            if not return_cache:
                return x, None
            k, v = _layer_kv(shared, x_pre, positions, arch)
            # ring layout: position p -> slot p % win; the last `win`
            # positions land on slots (S-win+i) % win == i when win | S
            return x, (mcs, k[:, -win:].clone(), v[:, -win:].clone())

        x, gcs = _scan(group, x, params["blocks"], p["groups"])
        if return_cache:
            mcs, k, v = gcs
            pos = torch.arange(S - win, S, dtype=torch.int32,
                               device=x.device)
            cache = {"mamba": mcs, "shared_k": k, "shared_v": v,
                     "shared_pos": pos.expand(p["groups"], B, win).clone()}
        if p["tail"]:
            x, tcs = _scan(lambda x, lp: mamba_body(
                x, _cast(lp, compute_dtype)), x, params["tail"], p["tail"])
            if return_cache:
                cache["tail"] = tcs
    logits = _head(arch, params, x, compute_dtype)
    return logits, aux_total, cache


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


def _whisper_seq(arch, params, x, positions, extra, impl, return_cache,
                 compute_dtype):
    """Encoder over the frame embeddings (non-causal), decoder over the
    tokens (x: their embedding): self-attention, cross-attention against
    the encoder output, MLP.  Returns (x, cache | None)."""
    p = plan(arch)
    dev = x.device
    frames = extra["frame_embeds"].to(compute_dtype) @ \
        params["frame_proj"].to(compute_dtype)
    B, F = frames.shape[:2]
    frames = frames + sinusoidal_positions(F, arch.d_model,
                                           device=dev).to(compute_dtype)
    enc_pos = torch.arange(F, dtype=torch.int32, device=dev).expand(B, F)
    for i in range(p["enc"]):
        lp = _cast(_layer(params["enc_blocks"], i), compute_dtype)
        frames = _dense_block_seq(lp, frames, enc_pos, arch, impl,
                                  causal=False)
    enc = rmsnorm(frames, params["enc_norm"])

    S = x.shape[1]
    x = x + sinusoidal_positions(S, arch.d_model,
                                 device=dev).to(compute_dtype)
    self_kv, cross_kv = [], []
    for i in range(p["dec"]):
        lp = _cast(_layer(params["dec_blocks"], i), compute_dtype)
        h_pre = x
        x = x + attn.self_attention(lp["self_attn"], rmsnorm(x, lp["ln1"]),
                                    positions, arch, causal=True, impl=impl)
        ck, cv = attn.project_cross_kv(lp["cross_attn"], enc, arch)
        x = x + attn.cross_attention(lp["cross_attn"], rmsnorm(x, lp["ln_x"]),
                                     ck, cv, arch)
        x = x + mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"]), arch.activation)
        if return_cache:
            self_kv.append(_layer_kv_whisper(lp, h_pre, arch))
            cross_kv.append((ck, cv))
    if not return_cache:
        return x, None
    (sk, sv), (ck, cv) = _stack(self_kv), _stack(cross_kv)
    return x, {"self_k": sk, "self_v": sv, "cross_k": ck, "cross_v": cv}


def _layer_kv_whisper(lp, x_in, arch):
    """This decoder layer's self-attention K/V for the prefill cache (no
    RoPE: whisper's positions are added to the embeddings)."""
    xn = rmsnorm(x_in, lp["ln1"])
    dh = arch.resolved_head_dim
    B, S = xn.shape[:2]
    k = (xn @ lp["self_attn"]["wk"]).reshape(B, S, arch.num_kv_heads, dh)
    v = (xn @ lp["self_attn"]["wv"]).reshape(B, S, arch.num_kv_heads, dh)
    return k, v


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def init_cache(arch: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """A zeroed decode cache with a 0-d int32 ``length``, on ``device``
    (``None``: the CUDA card).  Dense and moe: layer-stacked (L, B,
    max_len, KV, Dh) ``k``/``v``.  whisper: the decoder's ``self_k``/
    ``self_v`` (L, B, max_len, KV, Dh) and ``cross_k``/``cross_v`` (L, B,
    num_patches, KV, Dh), the encoder output's K/V that prefill fills.
    xlstm: ``mlstm`` (G, 7, ...) conv windows in ``dtype`` and f32 C, n,
    m, ``slstm`` (G, ...) f32 c, n, m and h in ``dtype``; no leaf grows
    with ``max_len``.  zamba2: ``mamba`` (G, per, ...) and ``tail`` states
    (conv windows in ``dtype``, SSM states f32), and the shared block's
    ``shared_k``/``shared_v`` (G, B, W, KV, Dh) with ``shared_pos`` (G, B,
    W) = -1 (empty), W being a ring of ``sliding_window`` slots when that is
    shorter than ``max_len``, else ``max_len``."""
    p = plan(arch)
    dev = resolve_device(device)
    kv = arch.num_kv_heads, arch.resolved_head_dim
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
    length = torch.zeros((), dtype=torch.int32, device=dev)
    if p["kind"] in ("dense", "moe"):
        return {"k": zeros(p["layers"], batch, max_len, *kv),
                "v": zeros(p["layers"], batch, max_len, *kv),
                "length": length}
    if p["kind"] == "whisper":
        n, frames = p["dec"], arch.num_patches
        return {"self_k": zeros(n, batch, max_len, *kv),
                "self_v": zeros(n, batch, max_len, *kv),
                "cross_k": zeros(n, batch, frames, *kv),
                "cross_v": zeros(n, batch, frames, *kv),
                "length": length}
    if p["kind"] == "xlstm":
        g, m = p["groups"], p["mlstm_per"]
        return {
            "mlstm": _stack([_stack([xlstm_mod.mlstm_cache_init(
                arch, batch, dtype, device=dev) for _ in range(m)])
                for _ in range(g)]),
            "slstm": _stack([xlstm_mod.slstm_cache_init(
                arch, batch, dtype, device=dev) for _ in range(g)]),
            "length": length}
    g, m = p["groups"], p["mamba_per"]
    mamba = lambda n: _stack([ssm_mod.mamba2_cache_init(
        arch, batch, dtype, device=dev) for _ in range(n)])
    win = arch.sliding_window
    slots = win if 0 < win < max_len else max_len
    out = {"mamba": _stack([mamba(m) for _ in range(g)]),
           "shared_k": zeros(g, batch, slots, *kv),
           "shared_v": zeros(g, batch, slots, *kv),
           "shared_pos": torch.full((g, batch, slots), -1, dtype=torch.int32,
                                    device=dev),
           "length": length}
    if p["tail"]:
        out["tail"] = mamba(p["tail"])
    return out


# ---------------------------------------------------------------------------
# Decode (one token)
# ---------------------------------------------------------------------------

def decode_step(arch: ArchConfig, params: dict, cache: dict,
                token: torch.Tensor, compute_dtype=torch.bfloat16):
    """token (B, 1) int -> (logits (B, 1, V), cache').

    Every cache leaf is written IN PLACE (the counterpart of the reference
    step's donated cache): each layer's K/V; in xlstm the mLSTM conv
    windows, C, n and m and the sLSTM c, n, m and h; in zamba2 the Mamba-2
    conv windows and states and the shared block's ring (K/V and positions
    at slot ``length % W``); the returned dict shares those tensors and
    carries ``length + 1``.  Decode attention is the einsum path (the
    reference's ``impl`` argument does not reach it either); the moe layers
    route the step's B tokens into buckets of ``cap_multiple=8``, and
    whisper's decoder attends to its own cache and, across, to the
    encoder's K/V (plain, as in the reference), its position embedding
    gathered at ``length`` on the device (clamped to the cache, as the
    reference's gather clamps)."""
    p = plan(arch)
    length = cache["length"]
    x = _embed(arch, params, token, compute_dtype)
    if p["kind"] in ("dense", "moe"):
        for i in range(p["layers"]):
            lp = _cast(_layer(params["blocks"], i), compute_dtype)
            xn = rmsnorm(x, lp["ln1"])
            y, _, _ = attn.decode_self_attention(
                lp["attn"], xn, cache["k"][i], cache["v"][i], length, arch)
            x = x + y
            xn = rmsnorm(x, lp["ln2"])
            if p["kind"] == "moe":
                y, _ = moe_mod.moe_apply(lp["moe"], xn, arch, cap_multiple=8)
            else:
                y = mlp_apply(lp["mlp"], xn, arch.activation)
            x = x + y
    elif p["kind"] == "whisper":
        n = cache["self_k"].shape[2]
        at = torch.clamp(length, max=n - 1).reshape(1).long()
        x = x + sinusoidal_positions(n, arch.d_model, device=x.device).to(
            compute_dtype).index_select(0, at)[None]
        for i in range(p["dec"]):
            lp = _cast(_layer(params["dec_blocks"], i), compute_dtype)
            y, _, _ = attn.decode_self_attention(
                lp["self_attn"], rmsnorm(x, lp["ln1"]), cache["self_k"][i],
                cache["self_v"][i], length, arch)
            x = x + y
            x = x + attn.cross_attention(lp["cross_attn"],
                                         rmsnorm(x, lp["ln_x"]),
                                         cache["cross_k"][i],
                                         cache["cross_v"][i], arch)
            x = x + mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"]),
                              arch.activation)
    elif p["kind"] == "xlstm":
        for g in range(p["groups"]):
            gp = _cast(_layer(params["blocks"], g), compute_dtype)
            mc = _layer(cache["mlstm"], g)
            for i in range(p["mlstm_per"]):
                lp = _layer(gp["mlstm"], i)
                y, _ = xlstm_mod.mlstm_decode(lp["cell"], rmsnorm(x, lp["ln"]),
                                              _layer(mc, i), arch)
                x = x + y
            sp = gp["slstm"]
            y, _ = xlstm_mod.slstm_decode(sp["cell"], rmsnorm(x, sp["ln"]),
                                          _layer(cache["slstm"], g), arch)
            x = x + y
    else:
        shared = _cast(params["shared"], compute_dtype)

        def mamba(x, lp, c):
            y, _ = ssm_mod.mamba2_decode(lp["mamba"], rmsnorm(x, lp["ln"]),
                                         c, arch)
            return x + y

        for g in range(p["groups"]):
            gp = _cast(_layer(params["blocks"], g), compute_dtype)
            gc = _layer(cache["mamba"], g)
            for i in range(p["mamba_per"]):
                x = mamba(x, _layer(gp, i), _layer(gc, i))
            xn = rmsnorm(x, shared["ln1"])
            x = x + _ring_decode_attn(shared["attn"], xn,
                                      cache["shared_k"][g],
                                      cache["shared_v"][g],
                                      cache["shared_pos"][g], length, arch)
            x = x + mlp_apply(shared["mlp"], rmsnorm(x, shared["ln2"]),
                              arch.activation)
        for i in range(p["tail"]):
            x = mamba(x, _cast(_layer(params["tail"], i), compute_dtype),
                      _layer(cache["tail"], i))
    logits = _head(arch, params, x, compute_dtype)
    new_cache = dict(cache)
    new_cache["length"] = length + 1
    return logits, new_cache


def _ring_decode_attn(ap, x1, ck, cv, cpos, length, arch):
    """Sliding-window decode with a ring cache.  ck/cv (B, W, KV, Dh);
    cpos (B, W) holds the absolute position in each slot (-1: empty).  The
    new K/V and position go IN PLACE to slot ``length % W`` (a device
    index: no host sync); slots holding positions in [0, length] attend."""
    B = x1.shape[0]
    dh = arch.resolved_head_dim
    pos = length.reshape(1, 1).expand(B, 1).to(torch.int32)
    q, k, v = attn._project_qkv(ap, x1, x1, arch)
    if arch.rope_theta > 0:
        q = apply_rope(q, pos, arch.rope_theta)
        k = apply_rope(k, pos, arch.rope_theta)
    W, KV = ck.shape[1], ck.shape[2]
    slot = torch.remainder(length, W).reshape(1).long()
    ck.index_copy_(1, slot, k.to(ck.dtype))
    cv.index_copy_(1, slot, v.to(cv.dtype))
    cpos.index_copy_(1, slot, pos)
    G = arch.num_heads // KV
    qg = attn._scaled(q, dh ** -0.5).reshape(B, 1, KV, G, dh)
    s = attn._einsum_f32("bqkgd,bskd->bqkgs", qg, ck)
    valid = (cpos >= 0) & (cpos <= length)
    s = torch.where(valid[:, None, None, None, :], s, attn.NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = attn._einsum_f32("bqkgs,bskd->bqkgd", p.to(cv.dtype), cv)
    return out.reshape(B, 1, -1).to(x1.dtype) @ ap["wo"]
