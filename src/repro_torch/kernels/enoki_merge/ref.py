"""Plain-torch oracle for the versioned LWW merge: the counterpart of
``repro.kernels.enoki_merge.ref``."""
from __future__ import annotations

import torch


def enoki_merge_ref(a_val, a_ver, b_val, b_ver):
    """Rows whose ``b`` version is strictly greater take ``b``'s payload
    (ties keep ``a``); versions max.  Fresh tensors: nothing is written."""
    take_b = b_ver > a_ver
    val = torch.where(take_b[:, None], b_val, a_val)
    ver = torch.maximum(a_ver, b_ver)
    return val, ver
