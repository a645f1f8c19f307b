"""phi-3-vision-4.2b [vlm]: 32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.

phi3-mini backbone + CLIP vision frontend.  Per spec the frontend is a STUB:
``input_specs()`` provides precomputed patch embeddings (num_patches tokens of
width d_model) that are concatenated ahead of the text tokens.
"""
from repro_torch.configs.base import Activation, ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    activation=Activation.SWIGLU,
    frontend_stub="clip_patches",
    num_patches=576,           # 24x24 CLIP-L/14 at 336px
    rope_theta=10_000.0,
    max_seq_len=131_072,
)
