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

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ReplicationPolicy
from repro_torch.core.keygroup import KeygroupSpec
from repro_torch.core.store import Store, to_numpy
from repro_torch.core.tree import tree_map
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
    shape for shape: dense and moe ``blocks`` (moe: ``blocks.moe.router``,
    f32 in every reference tree, and the stacked experts), xlstm's
    ``blocks`` (``mlstm`` (G, 7, ...) and ``slstm`` (G, ...)), zamba2's
    ``blocks`` (G, per, ...), ``tail`` and the one ``shared`` block, or
    whisper's ``enc_blocks``, ``dec_blocks``, ``enc_norm`` and
    ``frame_proj``; the vlm's ``patch_proj`` beside its ``blocks``.  Each
    leaf keeps the reference's dtype unless ``dtype`` is given, which casts
    every floating leaf (bfloat16 leaves arrive as bfloat16)."""
    from repro_torch.models.transformer import plan
    p = plan(arch)
    need = {"embed", "final_norm"}
    if not arch.tie_embeddings:
        need.add("lm_head")
    if p["kind"] == "whisper":
        need |= {"enc_blocks", "dec_blocks", "enc_norm", "frame_proj"}
    else:
        need.add("blocks")
    if p["kind"] == "zamba":
        need |= {"shared", "tail"} if p["tail"] else {"shared"}
    if arch.frontend_stub == "clip_patches":
        need.add("patch_proj")
    if need - set(tree):
        raise ValueError(f"not a {arch.name} parameter tree: keys "
                         f"{sorted(tree)}")
    return _tree_from_numpy(tree, resolve_device(device), dtype)


#: decode-cache leaves that ``dtype`` casts (K/V, whisper's self and cross
#: K/V, conv windows, the sLSTM hidden state ``h``); the SSM ``state``, the
#: mLSTM ``C``/``n``/``m`` and the sLSTM ``c``/``n``/``m`` stay f32 and
#: ``shared_pos``/``length`` int32, as the reference keeps them
_CACHE_CAST = frozenset({"k", "v", "shared_k", "shared_v", "self_k", "self_v",
                         "cross_k", "cross_v", "conv_x", "conv_B", "conv_C",
                         "conv", "h"})


def cache_from_numpy(tree: dict, device=None,
                     dtype: Optional[torch.dtype] = None) -> dict:
    """A decode cache from (nested dicts of) numpy arrays: dense and moe
    ``k``, ``v``, ``length``, whisper's ``self_k``/``self_v``/``cross_k``/
    ``cross_v``, xlstm's ``mlstm``/``slstm`` states, or zamba2's
    ``mamba``/``tail`` states and the shared block's ring.  ``dtype`` casts
    the K/V, conv-window and sLSTM ``h`` leaves only; ``length`` is int32."""
    dev = resolve_device(device)

    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        return _tensor(t, dev, dtype if key in _CACHE_CAST else None)

    out = walk(tree)
    out["length"] = out["length"].to(torch.int32)
    return out


def cache_to_numpy(cache: dict) -> dict:
    """A decode cache as (nested dicts of) host arrays (bfloat16 widens to
    float32)."""
    return tree_map(to_numpy, cache)
