"""zamba2-7b [hybrid]: 81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000.

Mamba2 backbone with a single weight-SHARED attention+MLP block applied every
6 layers (arXiv:2411.15242).  ssm_state=64.  The shared block's d_ff=14336 and
32 heads come from the assigned table; Mamba2 blocks use expand=2, head_dim=64.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm=SSMConfig(state_dim=64, conv_width=4, expand=2, head_dim=64, chunk_size=128),
    shared_attn_every=6,
    sliding_window=4096,        # used by the shared attn block in long_500k mode
    max_seq_len=1_048_576,
)
