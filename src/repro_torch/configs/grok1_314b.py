"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072.

MoE with 8 experts, top-2 routing (hf:xai-org/grok-1).  d_ff is the per-expert
hidden dim.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=32768),
    rope_theta=10_000.0,
)
