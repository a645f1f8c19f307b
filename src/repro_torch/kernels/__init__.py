"""Hand-written Hopper kernels of the port, each beside its plain version."""

import threading
from typing import Any, Callable

import torch

#: the cost walker (``launch.roofline.CostMode``) while one is active; None
#: costs the served path one read a wrapper call (``charged``)
WALKER = None


def walking() -> bool:
    """Whether a cost walker is active on this thread, the one that entered
    it: a call from another thread (a server's) is not the walked step's."""
    walker = WALKER
    return walker is not None and walker.thread == threading.get_ident()


def is_fake(*trees) -> bool:
    """Whether any tensor of ``trees`` is a fake tensor (shapes, no
    storage: a dry-run's).  A fake tensor is not a device: a wrapper
    launches nothing for it."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.utils._pytree import tree_flatten
    return any(isinstance(t, FakeTensor) for t in tree_flatten(trees)[0])


def charged(name: str, run: Callable[[], Any], fake: Callable[[], Any],
            *args, **kwargs) -> Any:
    """``run()``: a wrapper's launch, or its plain version on the CPU.
    While a cost walker is active on this thread (``walking``), the call is
    charged kernel ``name``'s work, reckoned from ``args`` and ``kwargs``
    (``launch.roofline.KERNEL_CHARGES``), and none of the aten ops ``run``
    does is counted; when ``args`` hold fake tensors, ``fake()`` (outputs
    of the right shapes) is returned and nothing runs."""
    if WALKER is None or not walking():
        return run()
    with WALKER.kernel(name, *args, **kwargs):
        return fake() if is_fake(args) else run()


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
