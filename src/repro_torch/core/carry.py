"""State carried across from numpy: arenas, model parameters and decode
caches.

An arena pulled to the host from either package (``jax.device_get`` on a
reference ``Store``, or ``store_to_numpy`` here) seeds port replicas, and a
reference parameter or cache tree pulled to the host (nested dicts of numpy
arrays) becomes the port's, key for key, so both packages can compute on
the same state.  Everything here takes and returns numpy arrays and plain
values, never framework objects of the reference.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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


def _tensor(a, dev: torch.device, dtype: Optional[torch.dtype]):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16 (jax on the host)
        a, dtype = a.astype(np.float32), dtype or torch.bfloat16
    t = torch.from_numpy(np.array(a)).to(dev)    # a writable host copy
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def _tree_from_numpy(tree, dev, dtype):
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, dev, dtype) for k, v in tree.items()}
    return _tensor(tree, dev, dtype)


def params_from_numpy(arch, tree: dict, device=None,
                      dtype: Optional[torch.dtype] = None) -> dict:
    """The port's parameter tree from the reference's (nested dicts of
    numpy arrays, e.g. ``jax.device_get(params)``), key for key and
    shape for shape.  ``dtype`` casts every floating leaf (bfloat16 leaves
    arrive as bfloat16 unless it says otherwise)."""
    from repro_torch.models.transformer import plan
    plan(arch)                          # only ported families carry over
    missing = {"embed", "final_norm", "blocks"} - set(tree)
    if missing or (not arch.tie_embeddings and "lm_head" not in tree):
        raise ValueError(f"not a {arch.name} parameter tree: keys "
                         f"{sorted(tree)}")
    return _tree_from_numpy(tree, resolve_device(device), dtype)


def cache_from_numpy(tree: dict, device=None,
                     dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """A decode cache (``k``, ``v``, int ``length``) from numpy arrays;
    ``dtype`` casts ``k``/``v``, ``length`` stays int32."""
    dev = resolve_device(device)
    out = {k: _tensor(v, dev, dtype) for k, v in tree.items()}
    out["length"] = out["length"].to(torch.int32)
    return out


def cache_to_numpy(cache: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A decode cache as host arrays (bfloat16 widens to float32)."""
    return {k: to_numpy(v) for k, v in cache.items()}
