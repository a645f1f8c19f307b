"""The yardstick's arithmetic, frozen here: the chip's peaks, each kernel's
analytic work from its shapes, and a configuration's model FLOPs.

``attention_pairs``, ``flash_work``, ``ssd_work``, ``mlstm_work`` and
``merge_work`` are copies of the program's cost walker's
(``launch/roofline.py``); a later change to the program leaves these as
they are.  Model FLOPs come from the configuration's shapes, not from what
the program runs:
  * 2 FLOPs for each weight of a matrix or conv applied to each token
    (norm gains, A, D and biases are left out);
  * zamba2's shared block at each of its applications;
  * the output head only at the positions whose logits the step returns;
  * attention at 4 Dh FLOPs per kept query-key pair per head;
  * the SSD terms of ``ssd_work``.
"""
from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

# NVIDIA H100 SXM5 80GB data sheet, dense, at its 700 W limit
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
HBM_BYTES_PER_S = 3.35e12


def attention_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """Query-key pairs the mask keeps: row i and column j counted from 0,
    j <= i when causal, i - j < window when ``window`` > 0."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(sq,
                                                                 np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_work(B: int, H: int, KV: int, Sq: int, Skv: int, D: int,
               itemsize: int, causal: bool = True, window: int = 0
               ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one flash attention call: 2 D FLOPs for q k and
    2 D for p v for every kept query-key pair of every head; q, k, v read
    once and the output written once."""
    flops = 4.0 * B * H * D * attention_pairs(Sq, Skv, causal, window)
    nbytes = itemsize * (2 * B * H * Sq * D + 2 * B * KV * Skv * D)
    return flops, float(nbytes)


def ssd_work(B, H, S, P, N, chunk, itemsize):
    """(FLOPs, bytes) of the chunked SSD scan: per chunk of l rows, C B^T
    over the l(l+1)/2 pairs at 2N FLOPs once per (b, chunk); per (b, h,
    chunk) the masked product with x over the same pairs at 2P, and
    2 l N P each for C state^T and the state update.  Elementwise terms
    left out.  Bytes: x, a_dt, b, c read once, y and the f32 state
    written once."""
    flops = 0.0
    for s0 in range(0, S, chunk):
        l = min(chunk, S - s0)
        pairs = l * (l + 1) / 2
        flops += B * pairs * 2 * N + B * H * (pairs * 2 * P + 4 * l * N * P)
    nbytes = itemsize * (2 * B * H * S * P + B * H * S + 2 * B * S * N) \
        + 4 * B * H * P * N
    return flops, nbytes


def mlstm_work(B, H, S, d, chunk, itemsize):
    """(FLOPs, bytes) of the chunkwise mLSTM (see the program's walker)."""
    flops = 0.0
    for _ in range(0, S, chunk):
        pairs = chunk * (chunk + 1) / 2
        flops += B * H * (2 * pairs * 2 * d + 2 * 2 * chunk * d * d)
    nbytes = itemsize * 4 * B * H * S * d + 4 * 2 * B * H * S \
        + 4 * B * H * (d * d + d + 1)
    return flops, nbytes


def merge_work(k: int, rows: int, row_bytes: int, nvv: int,
               winners=None) -> Tuple[float, float]:
    """(FLOPs, bytes) of folding ``k`` snapshots into an arena of ``rows``
    rows (see the program's walker)."""
    winners = rows if winners is None else winners
    nbytes = (k + 1) * rows * 4 + winners * (2 * row_bytes + 20) \
        + (k + 2) * nvv * 4
    return 0.0, float(nbytes)


def bound_s(flops: float, nbytes: float, flops_per_s: float) -> float:
    """The least time the chip could take: the larger of the two."""
    return max(flops / flops_per_s, nbytes / HBM_BYTES_PER_S)


# ---------------------------------------------------------------------------
# Model FLOPs
# ---------------------------------------------------------------------------

def _attn_weights(s: dict) -> int:
    d, H, KV, Dh = (int(s[k]) for k in ("d_model", "heads", "kv_heads",
                                         "head_dim"))
    return 2 * d * H * Dh + 2 * d * KV * Dh


def _mlp_weights(s: dict) -> int:
    return 3 * int(s["d_model"]) * int(s["d_ff"])


def _mamba(s: dict):
    d, N, W = int(s["d_model"]), int(s["state"]), int(s["conv_width"])
    di = int(s["expand"]) * d
    hs = di // int(s["ssm_head_dim"])
    weights = 2 * d * di + 2 * d * N + d * hs + di * d + W * (di + 2 * N)
    return weights, hs, int(s["ssm_head_dim"]), N


def _layout(module: str, s: dict):
    """(matrix weights applied to every token, attention layers, their
    window, mamba layers)."""
    if module == "dense":
        L = int(s["layers"])
        return L * (_attn_weights(s) + _mlp_weights(s)), L, 0, 0
    every, m = int(s["every"]), int(s["mamba_layers"])
    apps = m // every
    mw = _mamba(s)[0]
    return (m * mw + apps * (_attn_weights(s) + _mlp_weights(s)), apps,
            int(s.get("window") or 0), m)


def prefill_flops(module: str, s: dict, seq: int, sequences: int) -> float:
    """Model FLOPs of prefilling ``sequences`` prompts of ``seq`` tokens,
    returning the last position's logits of each."""
    weights, attn_layers, window, mamba_layers = _layout(module, s)
    per_seq = 2.0 * weights * seq + 2.0 * int(s["d_model"]) * int(s["vocab"])
    per_seq += attn_layers * 4.0 * int(s["head_dim"]) * int(s["heads"]) * \
        attention_pairs(seq, seq, True, window)
    if mamba_layers:
        _, hs, p, n = _mamba(s)
        per_seq += mamba_layers * ssd_work(1, hs, seq, p, n,
                                           int(s["ssd_chunk"]), 4)[0]
    return per_seq * sequences


def decode_flops(module: str, s: dict, positions: Iterable[Tuple[int, int]]
                 ) -> float:
    """Model FLOPs of decode tokens: ``positions`` holds (p, n) pairs, n
    sessions each writing position p (0-based), attending to positions
    0..p (within the window), with their logits."""
    weights, attn_layers, window, mamba_layers = _layout(module, s)
    per_token = 2.0 * weights + 2.0 * int(s["d_model"]) * int(s["vocab"])
    if mamba_layers:
        _, hs, p, n = _mamba(s)
        per_token += mamba_layers * ssd_work(1, hs, 1, p, n, 1, 4)[0]
    pair = attn_layers * 4.0 * int(s["head_dim"]) * int(s["heads"])
    total = 0.0
    for pos, n in positions:
        kept = pos + 1 if window <= 0 else min(pos + 1, window)
        total += n * (per_token + pair * kept)
    return total
