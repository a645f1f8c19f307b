"""Model-zoo public API: params, caches, steps and analytic counts; the
counterpart of ``repro.models.model_zoo``.

``input_specs``/``cache_specs`` (ShapeDtypeStruct stand-ins for dry runs)
have no counterpart: the port allocates what it runs.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeConfig, StepKind
from repro_torch.models import transformer
from repro_torch.models.ssm import ssm_dims
from repro_torch.models.xlstm import mlstm_dims

init_params = transformer.init_params
forward_seq = transformer.forward_seq
decode_step = transformer.decode_step
init_cache = transformer.init_cache


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
