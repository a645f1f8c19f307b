"""The port's CUDA kernel on the card: ``enoki_merge_rows`` against its
plain version on the same card inputs, and the served merge path launching
it once per fused merge.

Every test here is marked ``cuda`` and skips, with its reason, on a host
without a card (the kernel has no CPU mode).  The file imports no jax, so
it runs where the card is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import Cluster, enoki_function, get_function
from repro_torch.core.store import (arena_clone, merge_snapshots_fused,
                                    stores_equal)
from repro_torch.kernels.enoki_merge.kernel import (enoki_merge_rows,
                                                    enoki_merge_rows_plain)

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32, "uint8": torch.uint8}


@pytest.fixture(autouse=True)
def port_lockdep():
    from repro_torch.analysis import lockdep
    lockdep.enable()
    problems = None
    try:
        yield
        problems = lockdep.verify()
    finally:
        lockdep.disable()
    assert not problems, "lockdep:\n  " + "\n  ".join(problems)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _arena(rng, R, V, dtype, device):
    if dtype in ("int32", "uint8"):
        values = rng.integers(0, 100, (R, V)).astype(dtype)
    else:
        values = rng.normal(size=(R, V)).astype(np.float32)
    return (torch.arange(1, R + 1, dtype=torch.int32, device=device),
            torch.from_numpy(values).to(device=device, dtype=_TORCH[dtype]),
            torch.from_numpy(rng.integers(-1, V, R).astype(np.int32)).to(device),
            torch.from_numpy(rng.integers(0, 4, R).astype(np.int32)).to(device),
            torch.from_numpy(rng.integers(0, 50, 64).astype(np.int32)).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "uint8"])
@pytest.mark.parametrize("R,V,k", [(64, 25600, 1), (64, 100, 5), (7, 3, 33),
                                   (256, 128, 8), (33, 2049, 2)])
def test_kernel_matches_plain_on_cuda(card, R, V, k, dtype):
    """Bit-exact against the plain fold, one launch per call."""
    rng = np.random.default_rng(R + V + k)
    acc = _arena(rng, R, V, dtype, card)
    snaps = [_arena(rng, R, V, dtype, card) for _ in range(k)]
    want = enoki_merge_rows_plain(tuple(t.clone() for t in acc), snaps)
    n0 = enoki_merge_rows.launches
    got = enoki_merge_rows(tuple(t.clone() for t in acc), snaps)
    torch.cuda.synchronize()
    assert enoki_merge_rows.launches == n0 + 1
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@enoki_function(name="tcu_counter", keygroups=["tcu_kg"], codec_width=256)
def tcu_counter(kv, x):
    cur, _ = kv.get("count")
    kv.set("count", cur + x[0])
    return cur[:1] + x[:1]


@pytest.mark.cuda
def test_fused_delivery_merge_launches_once(card):
    """A CUDA cluster: K=5 pending snapshots fold with ONE kernel launch,
    equal to the CPU cluster's plain fold of the same requests."""
    got = {}
    for device in ("cuda", "cpu"):
        c = Cluster({"edge": "edge", "edge2": "edge"}, measure_compute=False,
                    device=device)
        c.deploy(get_function("tcu_counter"), ["edge", "edge2"])
        for i in range(5):
            c.invoke("tcu_counter", "edge", np.full(1, i + 1.0, np.float32),
                     t_send=10.0 * i)
        n0 = enoki_merge_rows.launches
        c.flush_replication(1e12)
        launched = enoki_merge_rows.launches - n0
        assert c.stats.merge_dispatches == c.stats.merge_aligned == 1
        assert launched == (1 if device == "cuda" else 0)
        got[device] = arena_clone(c.store_of("tcu_kg", "edge2")), c
    cuda_store, cpu_store = got["cuda"][0], got["cpu"][0]
    assert stores_equal(cuda_store, cpu_store)
    acc = arena_clone(cuda_store)
    n0 = enoki_merge_rows.launches
    merge_snapshots_fused(acc, [cuda_store] * 3, aligned=True)
    assert enoki_merge_rows.launches == n0 + 1
