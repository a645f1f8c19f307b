"""xlstm-350m [ssm]: 24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304.

sLSTM + mLSTM blocks (7:1 mLSTM:sLSTM per arXiv:2405.04517).  d_ff=0 means
there is no separate MLP block — the up/down projections live inside the
xLSTM blocks themselves (post-up-projection structure).
"""
from repro_torch.configs.base import ArchConfig, XLSTMConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    xlstm=XLSTMConfig(slstm_every=8, num_heads=4, proj_factor_mlstm=2.0,
                      proj_factor_slstm=1.333, chunk_size=64),
    tie_embeddings=True,
    max_seq_len=1_048_576,  # O(1) recurrent state: no context limit in principle
)
