"""gemma-7b [dense]: 28L d_model=3072 16H (GQA kv=16) d_ff=24576 vocab=256000.

GeGLU activation, head_dim=256 (so q_dim = 16*256 = 4096 != d_model, explicit
o-proj 4096->3072).  arXiv:2403.08295.
"""
from repro_torch.configs.base import Activation, ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    d_ff=24576,
    vocab_size=256000,
    head_dim=256,
    activation=Activation.GEGLU,
    tie_embeddings=True,
    rope_theta=10_000.0,
)
