"""Wrappers: the two-way row merge and flat tensor keygroups."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.enoki_merge.kernel import enoki_merge_rows


def enoki_merge(a_val: torch.Tensor, a_ver: torch.Tensor,
                b_val: torch.Tensor, b_ver: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-way merge of ``b`` into ``a`` (written into ``a``): rows whose
    ``b`` version is strictly greater take ``b``'s payload, versions max.
    Returns ``(a_val, a_ver)``."""
    enoki_merge_rows((None, a_val, None, a_ver, None),
                     [(None, b_val, None, b_ver, None)])
    return a_val, a_ver


def merge_flat_keygroup(a_flat: torch.Tensor, a_ver: torch.Tensor,
                        b_flat: torch.Tensor, b_ver: torch.Tensor,
                        row_width: int = 1024
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LWW-merge flat replica ``b`` (N,) into ``a`` (written into ``a``),
    with per-row versions.

    Row-granularity contract: versions guard ``row_width`` payload
    elements each, so a replica of N elements carries
    ``ceil(N / row_width)`` version entries — the LAST one owning the
    ragged tail when ``row_width`` does not divide N; any other count
    raises.  The tail is one more versioned row (the kernel takes any row
    width), merged exactly like the full rows.  Returns
    ``(a_flat, a_ver)``."""
    n = a_flat.shape[0]
    rows = n // row_width
    full = rows * row_width
    nver = rows + (1 if full < n else 0)
    if a_ver.shape[0] != nver or b_ver.shape[0] != nver:
        raise ValueError(f"{n} elements at row width {row_width} need "
                         f"{nver} versions, got {a_ver.shape[0]} and "
                         f"{b_ver.shape[0]}")
    if rows:
        enoki_merge(a_flat[:full].view(rows, row_width), a_ver[:rows],
                    b_flat[:full].view(rows, row_width), b_ver[:rows])
    if full < n:
        enoki_merge(a_flat[full:].view(1, n - full), a_ver[rows:],
                    b_flat[full:].view(1, n - full), b_ver[rows:])
    return a_flat, a_ver
