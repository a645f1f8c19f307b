"""Device resolution: ``None`` means the CUDA card, with no silent fallback."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when no CUDA device is visible.  Any
    explicit value (``"cpu"``, ``"cuda:1"``, a ``torch.device``) is taken
    as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: no CUDA device is available; pass "
                "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU, which runs
    eagerly)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
