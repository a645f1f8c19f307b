"""Arena state carried across from numpy (the port's counterpart of weights).

An arena pulled to the host from either package (``jax.device_get`` on a
reference ``Store``, or ``store_to_numpy`` here) seeds port replicas, so
both packages can compute on the same state.  Everything here takes and
returns numpy arrays and plain values, never framework objects of the
reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ReplicationPolicy
from repro_torch.core.keygroup import KeygroupSpec
from repro_torch.core.store import Store, to_numpy
from repro_torch.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32, "uint8": torch.uint8}


def store_from_numpy(keys, values, lengths, versions, vv, device=None,
                     dtype: Optional[torch.dtype] = None) -> Store:
    """A port arena holding copies of the given arrays.  ``dtype`` casts
    the payload (numpy has no bfloat16: pass float32 values and
    ``dtype=torch.bfloat16``)."""
    dev = resolve_device(device)

    def meta(a):
        return torch.tensor(np.asarray(a, np.int32), device=dev)

    vals = torch.tensor(np.asarray(values), device=dev)
    if dtype is not None:
        vals = vals.to(dtype)
    return Store(keys=meta(keys), values=vals, lengths=meta(lengths),
                 versions=meta(versions), vv=meta(vv))


def store_to_numpy(store: Store) -> Tuple[np.ndarray, ...]:
    """``(keys, values, lengths, versions, vv)`` as host arrays (bfloat16
    payloads widen to float32)."""
    return tuple(to_numpy(t) for t in store)


def keygroup_spec_from_reference(name: str, policy: str, slots: int,
                                 value_width: int, dtype: str,
                                 owner: Optional[str] = None,
                                 device=None) -> KeygroupSpec:
    """A port ``KeygroupSpec`` from a reference keygroup's plain fields:
    the policy's ``.value`` and the payload dtype's name."""
    return KeygroupSpec(name=name, policy=ReplicationPolicy(policy),
                        slots=slots, value_width=value_width,
                        dtype=_DTYPES[dtype], owner=owner, device=device)
