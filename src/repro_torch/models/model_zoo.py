"""Model-zoo public API: params, caches, steps, input specs and analytic
counts; the counterpart of ``repro.models.model_zoo``.

The reference's ``ShapeDtypeStruct`` stand-ins are ``(shape, dtype)``
pairs here (``input_specs``) and tensors on the ``meta`` device, which hold
no storage (``cache_specs``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig, StepKind
from repro_torch.models import transformer
from repro_torch.models.ssm import ssm_dims
from repro_torch.models.xlstm import mlstm_dims

init_params = transformer.init_params
forward_seq = transformer.forward_seq
decode_step = transformer.decode_step
init_cache = transformer.init_cache
lm_loss = transformer.lm_loss


def inner_axes(mesh) -> Dict[str, int]:
    """The axes of ``mesh`` other than ``pod`` whose size is > 1 (the
    ``data`` and ``model`` axes a step shards over)."""
    from repro_torch.launch.mesh import axis_sizes
    return {a: n for a, n in axis_sizes(mesh).items()
            if a != "pod" and n > 1}


def check_mesh(arch: ArchConfig, mesh) -> Dict[str, int]:
    """A step of ``arch`` on ``mesh``: the inner axes it shards over, which
    every family runs tensor-parallel (``transformer.TP_FAMILIES``); a
    width that ``model`` does not divide raises ``ValueError``
    (``transformer.check_tp_split``)."""
    inner = inner_axes(mesh)
    if inner:
        transformer.check_tp_split(arch, inner.get("model", 1))
    return inner


# ---------------------------------------------------------------------------
# Analytic parameter counts (roofline MODEL_FLOPS = 6·N·D)
# ---------------------------------------------------------------------------

def analytic_param_count(arch: ArchConfig, active_only: bool = False) -> int:
    d, dh = arch.d_model, arch.resolved_head_dim
    n = 0
    # embeddings (+ untied head)
    n += arch.vocab_size * d
    if not arch.tie_embeddings:
        n += d * arch.vocab_size

    def attn_params() -> int:
        a = d * arch.num_heads * dh + 2 * d * arch.num_kv_heads * dh \
            + arch.num_heads * dh * d
        if arch.qkv_bias:
            a += arch.num_heads * dh + 2 * arch.num_kv_heads * dh
        return a

    def mlp_params(dff: int) -> int:
        gated = arch.activation.value in ("swiglu", "geglu")
        return (3 if gated else 2) * d * dff

    if arch.family in ("dense", "vlm"):
        n += arch.num_layers * (attn_params() + mlp_params(arch.d_ff) + 2 * d)
    elif arch.family == "moe":
        cfg = arch.moe
        e = cfg.top_k if active_only else cfg.num_experts
        per = attn_params() + d * cfg.num_experts  # router always dense
        per += e * 3 * d * cfg.d_expert
        if cfg.shared_expert:
            per += 3 * d * cfg.d_expert
        n += arch.num_layers * (per + 2 * d)
    elif arch.family == "ssm":      # xlstm
        di, h, _ = mlstm_dims(arch)
        mlstm = 2 * d * di + 4 * di + 3 * di * di + di * 2 * h + 2 * h \
            + di + di * d
        dff = int(arch.xlstm.proj_factor_slstm * d)
        hh = arch.xlstm.num_heads
        slstm = d * 4 * d + 4 * hh * (d // hh) ** 2 + 4 * d + d + 3 * d * dff
        per = arch.xlstm.slstm_every
        groups = max(1, arch.num_layers // per)
        n += groups * ((per - 1) * (mlstm + d) + slstm + d)
    elif arch.family == "hybrid":   # zamba2
        di, h, ns = ssm_dims(arch)
        mamba = 2 * d * di + 2 * d * ns + d * h + 4 * (di + 2 * ns) \
            + 3 * h + di + di * d + d
        n += arch.num_layers * mamba
        n += attn_params() + mlp_params(arch.d_ff) + 2 * d  # ONE shared block
    elif arch.family == "audio":
        enc = attn_params() + mlp_params(arch.d_ff) + 2 * d
        dec = 2 * attn_params() + mlp_params(arch.d_ff) + 3 * d
        n += arch.encoder_layers * enc + arch.num_layers * dec + d * d + d
    return n


def model_flops(arch: ArchConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS: 6·N·D for training, 2·N·D per generated/processed token
    for inference (N = active params)."""
    n_active = analytic_param_count(arch, active_only=True)
    if shape.step is StepKind.TRAIN:
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_active * tokens
    if shape.step is StepKind.PREFILL:
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence in the batch
    return 2.0 * n_active * shape.global_batch


# ---------------------------------------------------------------------------
# Input specs and example batches
# ---------------------------------------------------------------------------

def input_specs(arch: ArchConfig, shape: ShapeConfig
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The batch a step takes, as ``name -> (shape, dtype)``: tokens (and
    a train step's labels and loss mask), the vlm's ``patch_embeds`` and
    whisper's ``frame_embeds`` (B, num_patches, d) f32; decode takes one
    token a sequence."""
    B, S = shape.global_batch, shape.seq_len
    if shape.step is StepKind.DECODE:
        return {"token": ((B, 1), torch.int32)}
    specs = {"tokens": ((B, S), torch.int32)}
    if shape.step is StepKind.TRAIN:
        specs["labels"] = ((B, S), torch.int32)
        specs["loss_mask"] = ((B, S), torch.float32)
    stub = {"clip_patches": "patch_embeds", "audio_frames": "frame_embeds"}
    if arch.frontend_stub in stub:
        specs[stub[arch.frontend_stub]] = (
            (B, arch.num_patches, arch.d_model), torch.float32)
    return specs


def cache_specs(arch: ArchConfig, shape: ShapeConfig,
                dtype=torch.bfloat16) -> dict:
    """``init_cache``'s tree on the ``meta`` device: shapes and dtypes,
    no storage."""
    return transformer.init_cache(arch, shape.global_batch, shape.seq_len,
                                  dtype, device="meta")


def example_batch(arch: ArchConfig, shape: ShapeConfig,
                  gen: torch.Generator) -> dict:
    """A materialised batch of ``input_specs`` on ``gen``'s device, drawn
    from ``gen`` in the specs' order: integers uniform in [0, min(vocab,
    1000)), floats normal x 0.02, a train step's loss mask ones (zeros on
    the vlm's patch positions).  The numbers differ from the reference's
    ``jax.random`` ones; use reduced configs on the CPU."""
    out = {}
    for name, (dims, dtype) in input_specs(arch, shape).items():
        if dtype == torch.int32:
            out[name] = torch.randint(0, min(arch.vocab_size, 1000), dims,
                                      generator=gen, dtype=torch.int32,
                                      device=gen.device)
        else:
            out[name] = torch.randn(dims, generator=gen, dtype=dtype,
                                    device=gen.device) * 0.02
    if "loss_mask" in out:
        out["loss_mask"] = torch.ones_like(out["loss_mask"])
        if arch.frontend_stub == "clip_patches":
            # no next-token loss on patch positions
            out["loss_mask"][:, :arch.num_patches] = 0
    return out
