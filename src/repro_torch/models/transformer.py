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

Tensor parallelism (every family, a ``mesh`` with a ``model`` axis;
``tp_mesh``):
each rank holds its shards of the parameters (``parallel.sharding.local``
of the reference's specs): the column-parallel projections' columns, the
row-parallel ones' rows, and, where ``model`` divides the vocabulary
(``vocab_split``), the embedding's vocabulary rows ``[lo, hi)`` and
``lm_head``'s vocabulary columns; elsewhere (whisper's 51,865) both whole
on every rank, as the specs' divisibility guard leaves them.  The
residual stream is the same on every rank of ``model`` (and the rank's
batch shard over ``data``).  A split ``_embed`` looks up the tokens in
``[lo, hi)``, zeroes the rest and sums over ``model``; every attention and
MLP sums its row-parallel output over ``model`` (``attention``,
``layers``); a split ``_head`` gives the rank's vocabulary shard of the
logits (gemma's tied ``embed.T`` too), which ``lm_loss`` reads through the
vocab-parallel cross-entropy; a whole one gives every rank the whole
logits.  The decode cache holds the rank's KV heads
(``init_cache(mesh=)``).  Where ``model`` exceeds the KV heads (a multiple
of them: ``kv_split``), Megatron's replicated KV heads: rank ``r`` serves
query heads ``[r H / model, (r + 1) H / model)``, which all read KV head
``r // rep`` (``rep = model / KV``); the specs still cut ``wk``/``wv`` by
columns, and the ``rep`` ranks of a head's group gather its columns at use
(``kv_view``), so each holds and caches the head whole.  The vlm's
``patch_proj`` and whisper's ``frame_proj`` give the rank's d / model columns, gathered over ``model``
before the patches join the text or the frames enter the encoder;
whisper's encoder and decoder layers are dense ones on the rank's heads,
and its cross-attention reads the rank's KV heads of the encoder output.
A moe layer holds its rank's experts or expert columns and runs
``moe.moe_apply_tp``, which keeps the global batch's capacity, dispatch
order and aux.  zamba2's Mamba-2 layers
and xlstm's mLSTM layers run their scans on the rank's heads (``ssm``,
``xlstm``; ``tp_view`` cuts the per-head and per-column leaves the specs
leave whole), xlstm's sLSTM recurrence runs whole on every rank, and
zamba2's shared block is a dense layer on the rank's heads, its ring
cache by KV heads.

``forward_seq(seq_shard=True)`` (the prefill's ``ParallelConfig.seq_shard``)
adds Megatron's sequence parallelism over ``model`` (``layers.SeqSharded``):
the tokens are the rank's slice of the sequence, the residual stream
between layers is that slice, each layer takes its normed input gathered
whole and reduce-scatters its row-parallel output (``tp_out``); attention,
the scans and the moe layer run on the rank's heads, experts or columns
over the whole sequence at its global positions, the sLSTM and the
patches whole on every rank, each rank keeping its slice.  whisper's
encoder is not cut.

The vlm and audio front ends are stubs, as in the reference: ``extra``
carries ``patch_embeds`` (vlm: ``num_patches`` positions put in front of the
text, the prompt's length kept) or ``frame_embeds`` (whisper: the
encoder's input frames), and ``model_zoo.example_batch`` makes both.
"""
from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig, AttnImpl
from repro_torch.core import spans
from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attention.kernel import decode_attention
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (SeqSharded, apply_rope,
                                       cross_entropy_loss, dense_init,
                                       mlp_apply, mlp_init, rmsnorm,
                                       seq_gather, seq_part,
                                       sinusoidal_positions, tp_in, tp_out,
                                       unsharded)


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

def _dense_block_seq(lp, x, positions, arch, impl, window=0, causal=True,
                     mesh=None, return_kv=False):
    """One dense layer; with ``mesh``, tensor-parallel over ``model`` (a
    ``SeqSharded`` one: ``x`` the rank's slice of the sequence, each
    sublayer's normed input gathered whole).  With ``return_kv``: ``(x,
    (k, v))``, the attention's K/V for a prefill cache."""
    with spans.span("model.attention"):
        y = attn.self_attention(lp["attn"],
                                seq_gather(rmsnorm(x, lp["ln1"]), mesh),
                                positions, arch, causal=causal, window=window,
                                impl=impl, mesh=mesh, return_kv=return_kv)
        y, kv = y if return_kv else (y, None)
        x = x + y
    with spans.span("model.mlp"):
        x = x + mlp_apply(lp["mlp"], seq_gather(rmsnorm(x, lp["ln2"]), mesh),
                          arch.activation, mesh)
    return (x, kv) if return_kv else x


def _moe_block_seq(lp, x, positions, arch, impl, mesh=None,
                   moe_impl="auto", batch_axes=(), return_kv=False):
    """One moe layer; with ``mesh``, tensor-parallel over ``model``: the
    attention on the rank's heads, then ``moe_apply_tp`` in the form
    ``moe_impl`` and the mesh select (the reference's "ep" where the mesh
    takes it, E % model == 0 and the tokens split over ``data``, else its
    fall-back, the global batch's dispatch); under ``SeqSharded`` on the
    whole sequence, each rank keeping its slice of the output.  Returns
    ``(x, aux)``, or ``(x, aux, (k, v))`` with ``return_kv``."""
    y = attn.self_attention(lp["attn"], seq_gather(rmsnorm(x, lp["ln1"]),
                                                   mesh), positions, arch,
                            impl=impl, mesh=mesh, return_kv=return_kv)
    y, kv = y if return_kv else (y, None)
    x = x + y
    xn = seq_gather(rmsnorm(x, lp["ln2"]), mesh)
    if mesh is not None:
        y, aux = moe_mod.moe_apply_tp(lp["moe"], xn, arch, unsharded(mesh),
                                      batch_axes, moe_impl)
        y = seq_part(y, mesh)
    else:
        y, aux = moe_mod.moe_apply(lp["moe"], xn, arch)
    return (x + y, aux, kv) if return_kv else (x + y, aux)


def _unstack(tree, n: int) -> list:
    """The ``n`` layers of a layer-stacked tree, one ``unbind`` a leaf
    (views): under autograd a stacked leaf's gradient is then one stack of
    its layers' gradients, not a zero-filled full-size tensor a layer."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    assert tree.shape[0] == n, (tuple(tree.shape), n)
    return tree.unbind(0)


def _scan(body, carry, xs, n: int):
    """The reference's ``lax.scan`` over the layer stack ``xs``, as a Python
    loop; the per-layer outputs are stacked (None when the body emits
    None)."""
    ys = []
    for lp in _unstack(xs, n):
        carry, y = body(carry, lp)
        ys.append(y)
    return carry, (_stack(ys) if ys and ys[0] is not None else None)


def _save_mm(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, mode: str):
    """A layer body under activation checkpointing (the reference's
    ``jax.checkpoint``): "none" runs ``fn`` as it is; "full" keeps only the
    body's inputs and recomputes the rest in the backward pass (the
    reference's ``nothing_saveable``); "block" keeps the outputs of
    ``aten.mm`` as well, the products with no batch dims (the projections
    and the MLP), and recomputes the rest, the attention's and the
    experts' batched einsums included (the reference's
    ``dots_with_no_batch_dims_saveable``).  A mode changes memory, not
    results."""
    if mode == "none":
        return fn
    if mode == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if mode == "block":
        return lambda *args: checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_mm))
    raise ValueError(f"remat mode {mode!r}: none | block | full")


def _cast(tree, compute_dtype):
    """Floating leaves with ndim > 1 in the compute dtype; norm scales left
    as they are.  The reference's ``cast`` narrows f32 leaves only and
    lets jnp promote a bf16 weight against f32 activations; widening such a
    weight here computes the same."""
    return _map(lambda a: a.to(compute_dtype)
                if a.is_floating_point() and a.ndim > 1 else a, tree)


#: biases of column-parallel weights: the specs leave them replicated
#: (1-D a layer), and a rank adds its columns' part
_COL_BIASES = frozenset({"bq", "bk", "bv", "b_up"})


def kv_split(arch: ArchConfig, model: int) -> Tuple[int, int]:
    """``(KV heads a rank holds, rep)`` over ``model`` ranks: ``KV /
    model`` heads and rep 1 where ``model`` divides the KV heads; else
    (``model`` a multiple of them, Megatron's replicated KV heads) the one
    head ``rank // rep`` of its group of ``rep = model / KV`` consecutive
    ranks, which all hold it."""
    kv = arch.num_kv_heads
    return (kv // model, 1) if kv % model == 0 else (1, model // kv)


def check_tp_split(arch: ArchConfig, model: int) -> None:
    """``ValueError`` unless ``model`` divides every width the family
    splits: the query heads of every family with attention, and its
    key/value heads or a multiple of them (``kv_split``: then each group
    of ``model / KV`` ranks holds one KV head whole, where the reference
    splits the head and lets GSPMD reshard it; a KV count that neither
    divides ``model`` nor is divided by it raises); the
    dense MLP's hidden width (dense, vlm, whisper and zamba2's shared
    block), the vlm's ``patch_proj`` and whisper's ``frame_proj`` columns
    (d_model), and for the moe family d_expert wherever the specs cut it
    (the experts when E % model != 0, a shared expert when the layer count
    is not a multiple of ``model``: ``moe.expert_layout``); zamba2's SSM
    heads and d_inner; xlstm's mLSTM heads and d_inner and its sLSTM
    feed-forward width.  The vocabulary is not among them: where ``model``
    does not divide it, the embedding and head stay whole
    (``vocab_split``).  The same on every device."""
    widths = {}
    if arch.family != "ssm":
        widths.update({"query heads": arch.num_heads,
                       "key/value heads": arch.num_kv_heads})
    if arch.family == "moe":
        lay = moe_mod.expert_layout(arch, model)
        if lay["experts"] == "tp" or lay["shared"] == "tp":
            widths["d_expert"] = arch.moe.d_expert
    elif arch.family == "ssm":
        di, h, _ = xlstm_mod.mlstm_dims(arch)
        widths.update({"mLSTM heads": h, "mLSTM d_inner": di,
                       "sLSTM d_ff": int(arch.xlstm.proj_factor_slstm *
                                         arch.d_model)})
    else:
        widths["d_ff"] = arch.d_ff
    if arch.family == "hybrid":
        di, h, _ = ssm_mod.ssm_dims(arch)
        widths.update({"SSM heads": h, "SSM d_inner": di})
    if arch.frontend_stub in ("clip_patches", "audio_frames"):
        widths["d_model"] = arch.d_model
    bad = {k: v for k, v in widths.items() if v % model}
    if "key/value heads" in bad and model % arch.num_kv_heads == 0:
        del bad["key/value heads"]
    if bad:
        raise ValueError(f"{arch.name}: {bad} do not split over model = "
                         f"{model}")


#: the families a ``model`` axis runs tensor-parallel
TP_FAMILIES = ("dense", "vlm", "moe", "hybrid", "ssm", "audio")

#: the Mamba-2 and mLSTM leaves the specs leave whole that ``tp_view``
#: cuts to the rank's heads or d_inner columns: the Mamba-2 ones on their
#: last dim; the mLSTM ``conv``, ``b_i`` and ``b_f`` on their last dim,
#: ``norm`` (H, dh) on its heads and ``w_if`` (di, 2H) on its heads in
#: both halves
MAMBA_CUTS = ("conv_x", "norm", "w_dt", "A_log", "D", "dt_bias")
MLSTM_CUTS = ("conv", "b_i", "b_f", "norm", "w_if")


def tp_mesh(arch: ArchConfig, mesh, flash_decode: bool = False):
    """The mesh to run ``arch`` tensor-parallel on, or None: a family of
    ``TP_FAMILIES`` on a mesh with a ``model`` axis (a flash-decode step
    shards the cache on the sequence instead).  Checks the widths against
    ``model``."""
    if mesh is None or flash_decode or arch.family not in TP_FAMILIES \
            or "model" not in mesh.mesh_dim_names:
        return None
    from repro_torch.parallel.collectives import axis_size
    check_tp_split(arch, axis_size(mesh, "model"))
    return mesh


def vocab_split(arch: ArchConfig, mesh) -> bool:
    """True when the tensor-parallel ``mesh`` (``tp_mesh``) cuts the
    vocabulary over ``model``: ``model`` divides it, the divisibility
    guard of the specs' ``embed`` and ``lm_head`` rules."""
    if mesh is None:
        return False
    from repro_torch.launch.mesh import axis_sizes
    sizes = axis_sizes(mesh)
    return "model" in sizes and arch.vocab_size % sizes["model"] == 0


def _positions(B: int, S: int, device) -> torch.Tensor:
    """The global positions 0..S-1 of every row (B, S) int32."""
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


#: the leaves of an attention's params that a KV group shares
KV_WEIGHTS, _KV_BIASES = ("wk", "wv"), ("bk", "bv")


def map_attention(fn: Callable[[dict], dict], tree: dict) -> dict:
    """``tree`` with every attention's params (a dict holding ``wk``)
    replaced by ``fn`` of it, in the tree's order; the rest as it is."""
    if "wk" in tree:
        return fn(tree)
    return {k: map_attention(fn, v) if isinstance(v, dict) else v
            for k, v in tree.items()}


def kv_view(params: dict, mesh, arch: ArchConfig) -> dict:
    """Where ``model`` exceeds the KV heads (``kv_split``'s rep > 1): every
    attention's ``wk``/``wv`` as its rank's KV head whole, the rest as it
    is.  A leaf the specs cut by columns (``Dh / rep`` of the head a rank)
    is gathered over the rank's KV group (``collectives.gather_param`` on
    ``launch.mesh.kv_groups``: its cotangent reduce-scattered over the
    group, so each shard's gradient sums every rank that read the head); a
    leaf the specs leave whole (``model`` does not divide KV x Dh) gives
    the rank its head (``collectives.take_part``: the cotangent summed
    over ``model``); a leaf one head wide is the head already (the serve
    factories gather once, ``launch.serve``).  Elsewhere ``params``
    itself."""
    from repro_torch.launch.mesh import KV_GROUP_AXIS, kv_groups
    from repro_torch.parallel import collectives as col
    model = col.axis_size(mesh, "model")
    _, rep = kv_split(arch, model)
    if rep == 1:
        return params
    dh, kv = arch.resolved_head_dim, arch.num_kv_heads
    g = col.axis_index(mesh, "model") // rep

    def head(w):
        if w.shape[-1] == dh:
            return w
        if w.shape[-1] * model == kv * dh:
            return col.gather_param(w, kv_groups(mesh, rep), KV_GROUP_AXIS,
                                    w.ndim - 1)
        return col.take_part(w, mesh, "model", w.ndim - 1, g, kv)

    return map_attention(lambda ap: {k: head(v) if k in KV_WEIGHTS else v
                                     for k, v in ap.items()}, params)


def tp_view(params: dict, mesh, arch: ArchConfig) -> dict:
    """The rank's view of its parameter shards: each column-parallel
    bias cut to the rank's columns (``collectives.shard``, whose
    cotangent is gathered back), and where ``model`` exceeds the KV heads
    ``wk``/``wv`` as the rank's KV head (``kv_view``) and ``bk``/``bv``
    cut to it (``collectives.take_part``: the cotangent, placed at the
    head, summed over ``model``); a moe shared expert sharded on its layer
    dim (``moe.expert_layout``) gathered over ``model``
    (``all_gather_dim``: every rank then runs it alike, so its cotangent
    is sliced back); the Mamba-2 and mLSTM leaves the specs replicate that
    belong to a head or a d_inner column cut to the rank's (``shard``;
    ``MAMBA_CUTS`` and ``MLSTM_CUTS``: ``w_if`` by heads in both its
    halves, the input gates ``[:H]`` and the forget gates ``[H:]``); the
    rest as they are."""
    from repro_torch.parallel.collectives import (all_gather_dim, axis_index,
                                                  axis_size, shard,
                                                  take_part)
    _, rep = kv_split(arch, axis_size(mesh, "model"))
    g = axis_index(mesh, "model") // rep

    def cut(k, v):
        if rep > 1 and k in _KV_BIASES:
            return take_part(v, mesh, "model", v.ndim - 1, g,
                             arch.num_kv_heads)
        return shard(v, mesh, "model", v.ndim - 1)

    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict) else
                    cut(k, v) if k in _COL_BIASES else v)
                for k, v in tree.items()}
    out = walk(kv_view(params, mesh, arch))
    if arch.family == "moe" and moe_mod.expert_layout(
            arch, axis_size(mesh, "model"))["shared"] == "layer":
        moe = out["blocks"]["moe"]
        moe["shared"] = {k: all_gather_dim(v, mesh, "model", 0)
                         for k, v in moe["shared"].items()}
    last = lambda v: shard(v, mesh, "model", v.ndim - 1)
    if arch.family == "hybrid":
        for stack in ("blocks", "tail"):
            if stack in out:
                m = out[stack]["mamba"]
                m.update({k: last(m[k]) for k in MAMBA_CUTS})
    if arch.family == "ssm":
        c = out["blocks"]["mlstm"]["cell"]
        c.update({k: last(c[k]) for k in MLSTM_CUTS[:3]})  # conv, b_i, b_f
        c["norm"] = shard(c["norm"], mesh, "model", c["norm"].ndim - 2)
        w = c["w_if"]
        c["w_if"] = shard(w.unflatten(-1, (2, -1)), mesh, "model",
                          w.ndim).flatten(-2)
    return out


def _embed(arch: ArchConfig, params: dict, tokens: torch.Tensor,
           compute_dtype, mesh=None) -> torch.Tensor:
    """The scaled embedding.  With a ``mesh`` that cuts the vocabulary
    (``vocab_split``) the rank holds rows ``[lo, lo + V / model)``: it
    looks up the tokens it owns, zeroes the rest and sums over ``model``
    (one rank adds each row: exact), reduce-scattered to the rank's slice
    under ``SeqSharded``; with a whole table every rank looks up every
    token (its slice under ``SeqSharded``)."""
    table = params["embed"]
    if not vocab_split(arch, mesh):
        x = seq_part(table[tokens.long()].to(compute_dtype), mesh)
    else:
        from repro_torch.parallel.collectives import axis_index
        at = tokens.long() - axis_index(mesh, "model") * table.shape[0]
        mine = (at >= 0) & (at < table.shape[0])
        x = table[torch.clamp(at, 0, table.shape[0] - 1)].to(compute_dtype)
        x = tp_out(torch.where(mine[..., None], x, torch.zeros_like(x)),
                   mesh)
    return x * torch.tensor(arch.d_model ** 0.5, dtype=compute_dtype)


def _head(arch: ArchConfig, params: dict, x: torch.Tensor,
          compute_dtype, mesh=None) -> torch.Tensor:
    """Logits; with a ``mesh`` that cuts the vocabulary the rank's shard
    of them (its input through ``tp_in``), else the whole logits on every
    rank (each rank's cotangent of ``x`` is then whole already)."""
    x = rmsnorm(x, params["final_norm"])
    if vocab_split(arch, mesh):
        x = tp_in(x, mesh)
    head = params["embed"].T if arch.tie_embeddings else params["lm_head"]
    return x @ head.to(compute_dtype)


def _last_position(x: torch.Tensor, mesh) -> torch.Tensor:
    """Under ``SeqSharded``: the sequence's last row (B, 1, d), which the
    last rank of ``model`` holds, on every rank (a ``psum`` of it and the
    others' zeros: exact)."""
    from repro_torch.parallel.collectives import axis_index, axis_size, psum
    x1 = x[:, -1:]
    if axis_index(mesh, "model") != axis_size(mesh, "model") - 1:
        x1 = torch.zeros_like(x1)
    return psum(x1, mesh, "model")


def forward_seq(arch: ArchConfig, params: dict, tokens: torch.Tensor,
                extra: Optional[dict] = None,
                impl: AttnImpl = AttnImpl.REFERENCE,
                remat: str = "none",
                return_cache: bool = False,
                mesh=None, moe_impl: str = "auto",
                compute_dtype=torch.bfloat16,
                batch_axes: Tuple[str, ...] = (),
                seq_shard: bool = False):
    """tokens (B, S) int -> (logits (B, S, V), aux f32, cache | None).
    Positions are 0..S-1 in every row.  ``impl`` picks the attention path
    and, in the Mamba-2 and mLSTM layers, the scan (FLASH: the kernels).
    ``extra`` holds the front-end stubs' inputs: ``patch_embeds`` (B,
    num_patches, d) f32 for the vlm, which take the first ``num_patches``
    positions in place of as many text tokens, or ``frame_embeds`` (B, F,
    d) f32 for whisper's encoder.  ``aux`` is the moe layers' summed
    load-balancing loss (0 elsewhere).  ``remat`` ("none", "block",
    "full"; ``_remat``) wraps each layer body the reference wraps: the dense
    and moe layers, xlstm's mLSTM layers, zamba2's Mamba-2 layers and tail,
    and whisper's encoder and decoder layers.  ``mesh`` runs the model
    tensor-parallel on the rank's shards (``tp_mesh``; the module
    docstring): the logits are the rank's vocabulary shard and the cache
    holds its KV heads; ``tokens`` are the rank's chunk of the global batch
    over ``batch_axes``, which the moe layers' capacity, dispatch order and
    aux read (``moe_apply_tp`` in the form ``moe_impl``).  With
    ``seq_shard`` too (the module docstring), ``tokens`` (B, S / model)
    are the rank's slice of the sequence, ``model`` must divide S, and the
    logits are the last position's (B, 1, ·), on every rank; the cache is
    the one without ``seq_shard``.

    The dense and moe caches hold the layer-stacked (L, B, S, KV, Dh)
    ``k`` and ``v``; whisper's the decoder's ``self_k``/``self_v`` (L, B,
    S, KV, Dh) and the encoder output's ``cross_k``/``cross_v`` (L, B, F,
    KV, Dh).  The xlstm cache holds ``mlstm`` (G, 7, ...: the conv window and
    the f32 C, n, m) and ``slstm`` (G, ...: f32 c, n, m and h).  The zamba2
    cache holds ``mamba`` (G, per, ...) and ``tail`` (the conv windows and
    f32 states), and the shared block's
    ``shared_k``/``shared_v`` (G, B, win, KV, Dh) of the last ``win``
    positions with their ``shared_pos`` (G, B, win), ``win`` being the
    sliding window when it is shorter than S, else S.  Under tensor
    parallelism each recurrent leaf holds the rank's columns or heads
    (``ssm``, ``xlstm``; the sLSTM state whole).

    Each dense layer's two sub-layers (whisper's encoder's and zamba2's
    shared block's too), each Mamba-2 layer and the head run in a
    ``core.spans`` span: ``model.attention``, ``model.mlp``,
    ``model.mamba``, ``model.head``."""
    p = plan(arch)
    tp = tp_mesh(arch, mesh)
    if tp is not None:
        params = tp_view(params, tp, arch)
    # sp: the mesh of the layers' collectives, SeqSharded under seq_shard
    sp = SeqSharded(tp) if seq_shard and tp is not None else tp
    ids = _seq_ids(tokens, sp)
    B, S = ids.shape
    positions = _positions(B, S, tokens.device)
    if arch.frontend_stub == "clip_patches":
        # the text follows the patches: position i >= P holds token i - P
        P = arch.num_patches
        x = _embed(arch, params, torch.cat([ids[:, :P], ids[:, :S - P]], 1),
                   compute_dtype, sp)
        patches = tp_in(extra["patch_embeds"].to(compute_dtype), tp) @ \
            params["patch_proj"].to(compute_dtype)
        if tp is not None:          # the rank's d / model columns
            from repro_torch.parallel.collectives import all_gather_dim
            patches = all_gather_dim(patches, tp, "model", -1)
        patches = seq_part(torch.cat([patches, patches.new_zeros(
            (B, S - P, arch.d_model))], 1), sp)
        is_patch = seq_part(positions < P, sp)
        x = torch.where(is_patch[..., None], patches, x)
    else:
        x = _embed(arch, params, ids, compute_dtype, sp)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = None

    if p["kind"] == "whisper":
        x, cache = _whisper_seq(arch, params, x, positions, extra, impl,
                                remat, return_cache, compute_dtype, sp)
    elif p["kind"] == "dense":
        def body(x, lp):
            out = _dense_block_seq(_cast(lp, compute_dtype), x, positions,
                                   arch, impl, mesh=sp,
                                   return_kv=return_cache)
            return out if return_cache else (out, None)

        x, kv = _scan(_remat(body, remat), x, params["blocks"], p["layers"])
        if return_cache:
            cache = {"k": kv[0], "v": kv[1]}
    elif p["kind"] == "moe":
        def body(x, lp):
            out = _moe_block_seq(_cast(lp, compute_dtype), x, positions, arch,
                                 impl, sp, moe_impl, batch_axes,
                                 return_kv=return_cache)
            return out[0], out[1:] if return_cache else out[1]

        x, out = _scan(_remat(body, remat), x, params["blocks"], p["layers"])
        auxs = out[0] if return_cache else out
        aux_total = aux_total + auxs.sum()
        if return_cache:
            cache = {"k": out[1][0], "v": out[1][1]}
    elif p["kind"] == "xlstm":
        def mbody(x, lp):
            y = xlstm_mod.mlstm_seq(lp["cell"],
                                    seq_gather(rmsnorm(x, lp["ln"]), sp),
                                    arch, return_state=return_cache,
                                    impl=impl, mesh=sp)
            if return_cache:
                y, mc = y
                return x + y, mc
            return x + y, None

        def group(x, gp):
            gp = _cast(gp, compute_dtype)
            x, mcs = _scan(_remat(mbody, remat), x, gp["mlstm"],
                           p["mlstm_per"])
            sl = gp["slstm"]
            y = xlstm_mod.slstm_seq(sl["cell"],
                                    seq_gather(rmsnorm(x, sl["ln"]), sp),
                                    arch, return_state=return_cache, mesh=sp)
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
            with spans.span("model.mamba"):
                y = ssm_mod.mamba2_seq(lp["mamba"],
                                       seq_gather(rmsnorm(x, lp["ln"]), sp),
                                       arch, return_state=return_cache,
                                       impl=impl, mesh=sp)
                y, mc = y if return_cache else (y, None)
                return x + y, mc

        def group(x, gp):
            gp = _cast(gp, compute_dtype)
            x, mcs = _scan(_remat(mamba_body, remat), x, gp, p["mamba_per"])
            x = _dense_block_seq(shared, x, positions, arch, impl,
                                 window=arch.sliding_window, mesh=sp,
                                 return_kv=return_cache)
            if not return_cache:
                return x, None
            x, (k, v) = x
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
            x, tcs = _scan(_remat(lambda x, lp: mamba_body(
                x, _cast(lp, compute_dtype)), remat), x, params["tail"],
                p["tail"])
            if return_cache:
                cache["tail"] = tcs
    with spans.span("model.head"):
        if sp is not tp:
            x = _last_position(x, tp)
        logits = _head(arch, params, x, compute_dtype, tp)
    return logits, aux_total, cache


def _seq_ids(tokens: torch.Tensor, mesh) -> torch.Tensor:
    """The token ids (B, S) whole: under ``SeqSharded`` the ranks' slices
    gathered over ``model``."""
    if not isinstance(mesh, SeqSharded):
        return tokens
    from repro_torch.parallel.collectives import _cat_gather
    return _cat_gather(tokens, mesh, "model", 1)


def _whisper_seq(arch, params, x, positions, extra, impl, remat,
                 return_cache, compute_dtype, mesh=None):
    """Encoder over the frame embeddings (non-causal), decoder over the
    tokens (x: their embedding): self-attention, cross-attention against
    the encoder output, MLP.  Returns (x, cache | None).  With ``mesh``:
    the rank's heads and columns (``frame_proj``'s gathered); under
    ``SeqSharded`` the decoder's residual is the rank's slice of the
    tokens, the encoder whole on every rank."""
    p = plan(arch)
    dev = x.device
    tp = unsharded(mesh)
    frames = tp_in(extra["frame_embeds"].to(compute_dtype), tp) @ \
        params["frame_proj"].to(compute_dtype)
    if tp is not None:              # the rank's d / model columns
        from repro_torch.parallel.collectives import all_gather_dim
        frames = all_gather_dim(frames, tp, "model", -1)
    B, F = frames.shape[:2]
    frames = frames + sinusoidal_positions(F, arch.d_model,
                                           device=dev).to(compute_dtype)
    enc_pos = _positions(B, F, dev)

    def enc_body(h, lp):
        lp = _cast(lp, compute_dtype)
        return _dense_block_seq(lp, h, enc_pos, arch, impl, causal=False,
                                mesh=tp), None

    frames, _ = _scan(_remat(enc_body, remat), frames, params["enc_blocks"],
                      p["enc"])
    enc = rmsnorm(frames, params["enc_norm"])

    S = positions.shape[1]
    x = x + seq_part(sinusoidal_positions(S, arch.d_model, device=dev).to(
        compute_dtype)[None], mesh)

    def dec_body(h, lp):
        lp = _cast(lp, compute_dtype)
        y = attn.self_attention(lp["self_attn"],
                                seq_gather(rmsnorm(h, lp["ln1"]), mesh),
                                positions, arch, causal=True, impl=impl,
                                mesh=mesh, return_kv=return_cache)
        y, skv = y if return_cache else (y, None)
        h = h + y
        ck, cv = attn.project_cross_kv(lp["cross_attn"], enc, arch, tp)
        h = h + attn.cross_attention(lp["cross_attn"],
                                     seq_gather(rmsnorm(h, lp["ln_x"]), mesh),
                                     ck, cv, arch, mesh)
        h = h + mlp_apply(lp["mlp"], seq_gather(rmsnorm(h, lp["ln2"]), mesh),
                          arch.activation, mesh)
        return h, ((skv, (ck, cv)) if return_cache else None)

    x, kv = _scan(_remat(dec_body, remat), x, params["dec_blocks"], p["dec"])
    if not return_cache:
        return x, None
    (sk, sv), (ck, cv) = kv
    return x, {"self_k": sk, "self_v": sv, "cross_k": ck, "cross_v": cv}


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def init_cache(arch: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None, mesh=None) -> dict:
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
    shorter than ``max_len``, else ``max_len``.  With a tensor-parallel
    ``mesh`` (``tp_mesh``): the rank's
    shape, ``batch / data`` sessions (the global ``batch`` when ``data``
    does not divide it), ``max(KV / model, 1)`` heads (``kv_split``: where
    ``model`` exceeds the KV heads, the rank's group's one head) and the
    recurrent states' rank parts (``mamba2_cache_init``,
    ``mlstm_cache_init``)."""
    p = plan(arch)
    dev = resolve_device(device)
    kv = arch.num_kv_heads, arch.resolved_head_dim
    model = 1
    if tp_mesh(arch, mesh) is not None:
        from repro_torch.parallel.collectives import axis_size
        model = axis_size(mesh, "model")
        kv = kv_split(arch, model)[0], kv[1]
        if "data" in mesh.mesh_dim_names and \
                batch % axis_size(mesh, "data") == 0:
            batch //= axis_size(mesh, "data")
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
                arch, batch, dtype, device=dev, model=model)
                for _ in range(m)])
                for _ in range(g)]),
            "slstm": _stack([xlstm_mod.slstm_cache_init(
                arch, batch, dtype, device=dev) for _ in range(g)]),
            "length": length}
    g, m = p["groups"], p["mamba_per"]
    mamba = lambda n: _stack([ssm_mod.mamba2_cache_init(
        arch, batch, dtype, device=dev, model=model) for _ in range(n)])
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
                token: torch.Tensor, mesh=None, flash_decode: bool = False,
                compute_dtype=torch.bfloat16,
                batch_axes: Tuple[str, ...] = ()):
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
    reference's gather clamps).  With ``flash_decode`` and a ``mesh``, the
    dense and moe caches are this rank's SEQUENCE shards over ``model``
    and their attention is ``decode_self_attention_sharded``.  Without
    ``flash_decode``, a ``mesh`` runs the model tensor-parallel
    (``tp_mesh``): the rank's
    parameter shards, its KV heads' cache and recurrent states' rank
    parts, and its vocabulary shard of the logits; the moe layers route
    the global batch's tokens (the rank's
    chunk over ``batch_axes``: ``moe_apply_tp``)."""
    p = plan(arch)
    length = cache["length"]
    tp = tp_mesh(arch, mesh, flash_decode)
    if tp is not None:
        params = tp_view(params, tp, arch)
    x = _embed(arch, params, token, compute_dtype, tp)
    if p["kind"] in ("dense", "moe"):
        for i in range(p["layers"]):
            lp = _cast(_layer(params["blocks"], i), compute_dtype)
            xn = rmsnorm(x, lp["ln1"])
            if flash_decode and mesh is not None:
                y, _, _ = attn.decode_self_attention_sharded(
                    lp["attn"], xn, cache["k"][i], cache["v"][i], length,
                    arch, mesh)
            else:
                y, _, _ = attn.decode_self_attention(
                    lp["attn"], xn, cache["k"][i], cache["v"][i], length,
                    arch, mesh=tp)
            x = x + y
            xn = rmsnorm(x, lp["ln2"])
            if p["kind"] == "moe" and tp is not None:
                y, _ = moe_mod.moe_apply_tp(lp["moe"], xn, arch, tp,
                                            batch_axes, cap_multiple=8)
            elif p["kind"] == "moe":
                y, _ = moe_mod.moe_apply(lp["moe"], xn, arch, cap_multiple=8)
            else:
                y = mlp_apply(lp["mlp"], xn, arch.activation, tp)
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
                cache["self_v"][i], length, arch, mesh=tp)
            x = x + y
            x = x + attn.cross_attention(lp["cross_attn"],
                                         rmsnorm(x, lp["ln_x"]),
                                         cache["cross_k"][i],
                                         cache["cross_v"][i], arch, tp)
            x = x + mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"]),
                              arch.activation, tp)
    elif p["kind"] == "xlstm":
        for g in range(p["groups"]):
            gp = _cast(_layer(params["blocks"], g), compute_dtype)
            mc = _layer(cache["mlstm"], g)
            for i in range(p["mlstm_per"]):
                lp = _layer(gp["mlstm"], i)
                y, _ = xlstm_mod.mlstm_decode(lp["cell"], rmsnorm(x, lp["ln"]),
                                              _layer(mc, i), arch, tp)
                x = x + y
            sp = gp["slstm"]
            y, _ = xlstm_mod.slstm_decode(sp["cell"], rmsnorm(x, sp["ln"]),
                                          _layer(cache["slstm"], g), arch,
                                          tp)
            x = x + y
    else:
        shared = _cast(params["shared"], compute_dtype)

        def mamba(x, lp, c):
            y, _ = ssm_mod.mamba2_decode(lp["mamba"], rmsnorm(x, lp["ln"]),
                                         c, arch, tp)
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
                                      cache["shared_pos"][g], length, arch,
                                      tp)
            x = x + mlp_apply(shared["mlp"], rmsnorm(x, shared["ln2"]),
                              arch.activation, tp)
        for i in range(p["tail"]):
            x = mamba(x, _cast(_layer(params["tail"], i), compute_dtype),
                      _layer(cache["tail"], i))
    logits = _head(arch, params, x, compute_dtype, tp)
    new_cache = dict(cache)
    new_cache["length"] = length + 1
    return logits, new_cache


def _ring_decode_attn(ap, x1, ck, cv, cpos, length, arch, mesh=None):
    """Sliding-window decode with a ring cache.  ck/cv (B, W, KV, Dh);
    cpos (B, W) holds the absolute position in each slot (-1: empty).  The
    new K/V and position go IN PLACE to slot ``length % W`` (a device
    index: no host sync); slots holding positions in [0, length] attend.
    With ``mesh``: the rank's heads and its KV heads' ring."""
    B = x1.shape[0]
    dh = arch.resolved_head_dim
    pos = length.reshape(1, 1).expand(B, 1).to(torch.int32)
    x1 = tp_in(x1, mesh)
    q, k, v = attn._project_qkv(ap, x1, x1, arch)
    if arch.rope_theta > 0:
        q = apply_rope(q, pos, arch.rope_theta)
        k = apply_rope(k, pos, arch.rope_theta)
    W, KV = ck.shape[1], ck.shape[2]
    slot = torch.remainder(length, W).reshape(1).long()
    ck.index_copy_(1, slot, k.to(ck.dtype))
    cv.index_copy_(1, slot, v.to(cv.dtype))
    cpos.index_copy_(1, slot, pos)
    G = q.shape[2] // KV
    qg = attn._scaled(q, dh ** -0.5).reshape(B, 1, KV, G, dh)
    out = decode_attention(qg, ck, cv, cpos, length)
    return tp_out(out @ ap["wo"], mesh)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def lm_loss(arch: ArchConfig, params: dict, batch: dict,
            impl: AttnImpl = AttnImpl.REFERENCE, remat: str = "none",
            mesh=None, moe_impl: str = "auto",
            compute_dtype=torch.bfloat16,
            batch_axes: Tuple[str, ...] = ()
            ) -> Tuple[torch.Tensor, dict]:
    """Next-token cross-entropy plus the moe layers' aux loss: ``(loss,
    {"ce", "aux"})``.  ``batch``: ``tokens``, ``labels``, an optional
    ``loss_mask`` and the front ends' ``patch_embeds``/``frame_embeds``.
    Training differentiates it under ``AttnImpl.REFERENCE``: the kernels
    have no backward and refuse to run under autograd (FLASH raises).
    With a ``mesh``: the model tensor-parallel (``tp_mesh``; vocab-parallel
    cross-entropy over ``model`` where it cuts the vocabulary),
    and ``batch`` the rank's shard over ``batch_axes``, the mean taken
    over the global batch and the moe aux the global batch's; the loss is
    then the same on every rank."""
    logits, aux, _ = forward_seq(arch, params, batch["tokens"], extra=batch,
                                 impl=impl, remat=remat, mesh=mesh,
                                 moe_impl=moe_impl,
                                 compute_dtype=compute_dtype,
                                 batch_axes=batch_axes)
    tp = tp_mesh(arch, mesh)
    loss = cross_entropy_loss(logits, batch["labels"], batch.get("loss_mask"),
                              mesh=mesh,
                              vocab_axis="model" if vocab_split(arch, tp)
                              else None,
                              batch_axes=batch_axes if mesh is not None
                              else ())
    return loss + aux, {"ce": loss, "aux": aux}
