"""Rank bodies of ``tests/test_torch_roofline.py`` (jax-free: spawned
children import this module by name)."""
import torch

from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.roofline import analyze_step
from repro_torch.parallel import collectives as col

M, K = 64, 32


def collectives_world(rank: int) -> dict:
    """Each collective of the port over each axis of a (pod 2, model 2)
    mesh, walked once on this rank's (M, K) f32 shard, pods of 2 ranks."""
    mesh = make_test_mesh((2, 2), ("pod", "model"))
    x = torch.full((M, K), float(rank + 1))
    out = {}
    for axis in ("pod", "model"):
        for name, fn in (("psum", col.psum), ("all_gather", col.all_gather),
                         ("psum_scatter", col.psum_scatter)):
            out[f"{name}/{axis}"] = analyze_step(fn, x, mesh, axis,
                                                 pod_size=2)
    return out
