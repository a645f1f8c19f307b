"""Shared plumbing of the port-vs-reference tests (``tests/test_torch_*.py``).

Arenas cross between the packages as numpy arrays only: a reference
``Store`` goes through ``jax.device_get`` and ``repro_torch.core.carry``;
a port ``Store`` comes back through ``store_to_numpy``.  Comparisons are
bitwise on every leaf (bfloat16 payloads are compared as float32, which is
exact).  ``port_lockdep`` arms the port's runtime lock-order validator the
way ``tests/conftest.py`` arms the reference's.

The twins of the reference's suites run one scenario through both packages:
``REF`` and ``PORT`` carry each package's entry points (the port's
``Cluster`` on the CPU) and a few array helpers, so a handler or a scenario
is written once over ``pkg.xp``; ``record`` turns what a scenario returns
(results, stats, clusters) into host values that compare bit for bit with
``assert_same_record``.
"""
from __future__ import annotations

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.core.store as ref_store
import repro.launch.faas_server as ref_server
import repro.runtime as ref_runtime
import repro_torch.core as port_core
import repro_torch.core.store as port_store
import repro_torch.launch.faas_server as port_server
import repro_torch.runtime as port_runtime
from repro.configs.base import ReplicationPolicy as RefPolicy
from repro.core.cluster import InvokeResult as RefResult
from repro.core.engine import BatchedInvocationEngine as RefEngine
from repro.core.store import Store as RefStore
from repro_torch.configs.base import ReplicationPolicy as PortPolicy
from repro_torch.core.carry import store_from_numpy, store_to_numpy
from repro_torch.core.cluster import InvokeResult as PortResult
from repro_torch.core.engine import BatchedInvocationEngine as PortEngine

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


# ---------------------------------------------------------------------------
# one scenario, both packages
# ---------------------------------------------------------------------------

def _jnp_vec(vals, like=None):
    return jnp.stack([jnp.asarray(v, jnp.float32) for v in vals])


def _torch_vec(vals, like=None):
    dev = like.device if isinstance(like, torch.Tensor) else "cpu"
    return torch.stack([torch.as_tensor(v, dtype=torch.float32, device=dev)
                        for v in vals])


def _torch_zeros(n, like=None):
    dev = like.device if isinstance(like, torch.Tensor) else "cpu"
    return torch.zeros((n,), device=dev)


def _pkg(name, core, store, server, runtime, policy, engine, xp, cluster):
    return types.SimpleNamespace(
        name=name, core=core, Cluster=cluster, Router=core.Router,
        enoki_function=core.enoki_function, get_function=core.get_function,
        handler_read_only=core.handler_read_only, Policy=policy,
        Engine=engine, EngineStats=core.EngineStats,
        store_contents=store.store_contents, stores_equal=store.stores_equal,
        store=store, server=server, runtime=runtime, xp=xp)


REF = _pkg("ref", ref_core, ref_store, ref_server, ref_runtime, RefPolicy,
           RefEngine,
           types.SimpleNamespace(where=jnp.where, vec=_jnp_vec,
                                 cat=jnp.concatenate,
                                 atleast_1d=jnp.atleast_1d,
                                 zeros=lambda n, like=None: jnp.zeros((n,))),
           ref_core.Cluster)
PORT = _pkg("port", port_core, port_store, port_server, port_runtime,
            PortPolicy, PortEngine,
            types.SimpleNamespace(where=torch.where, vec=_torch_vec,
                                  cat=torch.cat, atleast_1d=torch.atleast_1d,
                                  zeros=_torch_zeros),
            functools.partial(port_core.Cluster, device="cpu"))
PKGS = (REF, PORT)


def stats_of(stats) -> dict:
    """A stats dataclass's counters (its lock left out)."""
    return {f.name: getattr(stats, f.name) for f in dataclasses.fields(stats)
            if not f.name.startswith("_")}


def result_of(r) -> dict:
    """An ``InvokeResult`` of either package as host values."""
    return {"output": to_np(r.output), "response_ms": r.response_ms,
            "t_sent": r.t_sent, "t_received": r.t_received,
            "t_applied": r.t_applied,
            "kv_ops": [tuple(op) for op in r.kv_ops], "node": r.node,
            "chain": list(r.chain)}


def cluster_of(c, kgs=None) -> dict:
    """Every node's arenas (leaves as host arrays), clock and the cluster's
    stats, of either package."""
    out = {"stats": stats_of(c.stats)}
    for name in sorted(c.nodes):
        nd = c.nodes[name]
        out[f"{name}/clock"] = int(nd.clock)
        for kg in sorted(nd.stores):
            if kgs is None or kg in kgs:
                s = nd.stores[kg]
                out[f"{name}/{kg}"] = (
                    ref_numpy(s) if isinstance(s, RefStore)
                    else store_to_numpy(s))
    return out


def record(x):
    """Host values of a scenario's output: results, stats, clusters and
    containers of them (tickets stay as the keys of result maps)."""
    if isinstance(x, (RefResult, PortResult)):
        return result_of(x)
    if isinstance(x, (ref_core.Cluster, port_core.Cluster)):
        return cluster_of(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return stats_of(x)
    if isinstance(x, dict):
        return {k: record(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(record(v) for v in x) if not hasattr(x, "_fields") \
            else tuple(to_np(v) for v in x)
    if isinstance(x, (torch.Tensor, jax.Array, np.ndarray, np.generic)):
        return to_np(x)
    return x


def assert_same_record(want, got, path="") -> None:
    """Bit-for-bit equality of two ``record``s (arrays by value and dtype
    kind, floats exactly)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and want.keys() == got.keys(), \
            f"{path}: keys {sorted(map(str, want))} != {sorted(map(str, got))}"
        for k in want:
            assert_same_record(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(want) == len(got), \
            f"{path}: {want!r} != {got!r}"
        for i, (a, b) in enumerate(zip(want, got)):
            assert_same_record(a, b, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert want.shape == got.shape, f"{path}: {want.shape} != {got.shape}"
        np.testing.assert_array_equal(want, got, err_msg=path)
    else:
        assert want == got, f"{path}: {want!r} != {got!r}"


def twin(scenario, *args, **kwargs):
    """Run ``scenario(pkg, ...)`` through both packages and hold the
    port's record to the reference's, bit for bit; returns both."""
    want = record(scenario(REF, *args, **kwargs))
    got = record(scenario(PORT, *args, **kwargs))
    assert_same_record(want, got, scenario.__name__)
    return want, got
