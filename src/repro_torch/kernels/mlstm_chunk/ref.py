"""Plain-torch oracle: the ``models.xlstm`` chunkwise cell; the counterpart
of ``repro.kernels.mlstm_chunk.ref``."""
from __future__ import annotations

from repro_torch.models.xlstm import mlstm_cell_seq


def mlstm_chunk_ref(q, k, v, log_i, log_f, *, chunk: int = 64):
    """Kernel layout: q/k/v (B,H,S,d), gates (B,H,S) -> (h (B,H,S,d), the
    final carry (C, n, m))."""
    t = lambda x: x.transpose(1, 2)
    h, carry = mlstm_cell_seq(t(q), t(k), t(v), t(log_i), t(log_f), chunk)
    return t(h), carry
