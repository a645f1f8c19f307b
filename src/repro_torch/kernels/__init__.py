"""Hand-written Hopper kernels of the port, each beside its plain version."""

import torch


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would record a call of ``kernel``: the kernels
    compute forward only (so do the reference's Pallas kernels, which
    ``jax.grad`` cannot differentiate), and a launch writes into a fresh
    buffer with no gradient history.  Checked on every device, so the CPU
    refuses what the card would."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the kernel has no backward; training runs "
            "AttnImpl.REFERENCE (call it under torch.no_grad() or on "
            "tensors that do not require grad)")
