"""Shared plumbing of the port-vs-reference tests (``tests/test_torch_*.py``).

Arenas cross between the packages as numpy arrays only: a reference
``Store`` goes through ``jax.device_get`` and ``repro_torch.core.carry``;
a port ``Store`` comes back through ``store_to_numpy``.  Comparisons are
bitwise on every leaf (bfloat16 payloads are compared as float32, which is
exact).  ``port_lockdep`` arms the port's runtime lock-order validator the
way ``tests/conftest.py`` arms the reference's.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.store import Store as RefStore
from repro_torch.core.carry import store_from_numpy, store_to_numpy

FIELDS = ("keys", "values", "lengths", "versions", "vv")


def ref_numpy(store) -> tuple:
    """A reference arena's leaves as host arrays (bf16 widened)."""
    return tuple(np.asarray(jnp.asarray(x, jnp.float32)
                            if x.dtype == jnp.bfloat16 else x)
                 for x in jax.device_get(store))


def ref_to_port(store, device="cpu", dtype=None):
    return store_from_numpy(*ref_numpy(store), device=device, dtype=dtype)


def port_to_ref(store, dtype=None) -> RefStore:
    keys, values, lengths, versions, vv = store_to_numpy(store)
    vals = jnp.asarray(values)
    return RefStore(jnp.asarray(keys), vals if dtype is None
                    else vals.astype(dtype), jnp.asarray(lengths),
                    jnp.asarray(versions), jnp.asarray(vv))


def assert_same_store(ref, port, what="") -> None:
    for name, a, b in zip(FIELDS, ref_numpy(ref), store_to_numpy(port)):
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")


def assert_same_port_stores(a, b, what="") -> None:
    for name, x, y in zip(FIELDS, store_to_numpy(a), store_to_numpy(b)):
        np.testing.assert_array_equal(x, y, err_msg=f"{what} {name}")


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().cpu().numpy()
    x = jax.device_get(x)
    return np.asarray(jnp.asarray(x, jnp.float32)
                      if getattr(x, "dtype", None) == jnp.bfloat16 else x)


@pytest.fixture(autouse=True)
def port_lockdep():
    """Every port lock built inside a test is ordered; teardown fails the
    test on any recorded violation or acquisition-graph cycle."""
    from repro_torch.analysis import lockdep
    lockdep.enable()
    problems = None
    try:
        yield
        problems = lockdep.verify()
    finally:
        lockdep.disable()
    assert not problems, "lockdep:\n  " + "\n  ".join(problems)
