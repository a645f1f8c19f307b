"""whisper-tiny [audio]: 4L d_model=384 6H (GQA kv=6) d_ff=1536 vocab=51865.

Encoder-decoder; the conv frontend is a STUB per spec — ``input_specs()``
provides precomputed frame embeddings for the encoder (arXiv:2212.04356).
"""
from repro_torch.configs.base import Activation, ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,              # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    activation=Activation.GELU,
    is_encoder_decoder=True,
    encoder_layers=4,
    frontend_stub="audio_frames",
    num_patches=1500,          # encoder frame positions (30s at 50Hz)
    rope_theta=0.0,            # whisper uses learned/sinusoidal abs positions
    max_seq_len=32_768,        # assigned stress shapes exceed nominal 448
)
