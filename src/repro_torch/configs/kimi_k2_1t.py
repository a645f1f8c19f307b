"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840.

Trillion-parameter MoE: 384 experts, top-8 routing, per-expert hidden 2048,
plus one shared expert (paper-table, arXiv:2501.kimi2).  Active params ≈32B.
head_dim = 7168/64 = 112 (kept exact per the assigned table).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    moe=MoEConfig(num_experts=384, top_k=8, d_expert=2048, shared_expert=True),
    rope_theta=50_000.0,
)
