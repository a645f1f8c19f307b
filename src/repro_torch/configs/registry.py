"""Architecture / shape / cell registry.

``get_arch("--arch id")`` resolves an assigned architecture; ``cells()``
enumerates the (arch x shape) grid with applicability filtering (long_500k
only runs for sub-quadratic archs, per DESIGN.md §5).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.configs.base import (
    ArchConfig,
    MoEConfig,
    SHAPES,
    SHAPES_BY_NAME,
    ShapeConfig,
    SSMConfig,
    StepKind,
    XLSTMConfig,
)

# ---------------------------------------------------------------------------
# Registry construction
# ---------------------------------------------------------------------------

_ARCH_MODULES = {
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "phi-3-vision-4.2b": "repro_torch.configs.phi3_vision_4p2b",
    "grok-1-314b": "repro_torch.configs.grok1_314b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "qwen1.5-32b": "repro_torch.configs.qwen1_5_32b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1p8b",
    "qwen1.5-110b": "repro_torch.configs.qwen1_5_110b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
}

ARCH_IDS: Tuple[str, ...] = tuple(_ARCH_MODULES)

_cache: Dict[str, ArchConfig] = {}


def get_arch(arch_id: str) -> ArchConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch_id!r}; choose from {sorted(_ARCH_MODULES)}")
    if arch_id not in _cache:
        import importlib

        mod = importlib.import_module(_ARCH_MODULES[arch_id])
        _cache[arch_id] = mod.CONFIG
    return _cache[arch_id]


def get_shape(shape_id: str) -> ShapeConfig:
    return SHAPES_BY_NAME[shape_id]


# ---------------------------------------------------------------------------
# Applicability (DESIGN.md §5)
# ---------------------------------------------------------------------------

# Sub-quadratic archs run long_500k; pure full-attention archs skip it.
SUBQUADRATIC = {"xlstm-350m", "zamba2-7b"}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Return (runs, reason-if-skipped)."""
    if shape.name == "long_500k" and arch.name not in SUBQUADRATIC:
        return False, ("pure full-attention arch; 500k-token full-cache decode "
                       "excluded per spec (needs sub-quadratic attention)")
    return True, ""


def cells(include_skipped: bool = False) -> Iterator[Tuple[ArchConfig, ShapeConfig, str]]:
    """All 40 (arch x shape) cells; yields (arch, shape, skip_reason)."""
    for arch_id in ARCH_IDS:
        arch = get_arch(arch_id)
        for shape in SHAPES:
            ok, reason = shape_applicable(arch, shape)
            if ok or include_skipped:
                yield arch, shape, reason


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests
# ---------------------------------------------------------------------------

def reduced(arch: ArchConfig) -> ArchConfig:
    """Shrink an arch config to CPU-smoke size, preserving family structure.

    Keeps: block pattern (moe/ssm/xlstm/shared-attn/enc-dec), GQA ratio,
    activation, biases.  Shrinks: layers, widths, experts, vocab.
    """
    updates: dict = dict(
        num_layers=min(arch.num_layers, 4),
        d_model=128,
        vocab_size=512,
        max_seq_len=512,
    )
    # preserve the GQA ratio at reduced head counts
    ratio = max(1, arch.num_heads // max(arch.num_kv_heads, 1))
    heads = 4
    updates["num_heads"] = heads
    updates["num_kv_heads"] = max(1, heads // ratio)
    updates["head_dim"] = 32 if arch.head_dim else None
    updates["d_ff"] = 256 if arch.d_ff else 0
    if arch.moe is not None:
        updates["moe"] = MoEConfig(
            num_experts=min(arch.moe.num_experts, 8),
            top_k=min(arch.moe.top_k, 2),
            d_expert=128,
            shared_expert=arch.moe.shared_expert,
        )
    if arch.ssm is not None:
        updates["ssm"] = SSMConfig(state_dim=16, conv_width=4, expand=2,
                                   head_dim=32, chunk_size=32)
    if arch.xlstm is not None:
        updates["xlstm"] = XLSTMConfig(slstm_every=arch.xlstm.slstm_every,
                                       num_heads=2, chunk_size=16)
        updates["num_layers"] = 8 if arch.xlstm.slstm_every <= 8 else 4
    if arch.shared_attn_every:
        updates["shared_attn_every"] = 2
        updates["num_layers"] = 5
    if arch.is_encoder_decoder:
        updates["encoder_layers"] = 2
        updates["num_layers"] = 2
    if arch.num_patches:
        updates["num_patches"] = 8
    if arch.sliding_window:
        updates["sliding_window"] = 64
    return dataclasses.replace(arch, **updates)


def reduced_shape(shape: ShapeConfig) -> ShapeConfig:
    """Smoke-test shape: tiny batch and sequence, same step kind."""
    return dataclasses.replace(
        shape, seq_len=64 if shape.step is StepKind.TRAIN else 128,
        global_batch=2)
