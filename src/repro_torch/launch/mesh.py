"""Mesh construction over a ``torch.distributed`` world: the counterpart of
``repro.launch.mesh``.

FUNCTIONS, not module-level constants: importing this module touches no
process group and no device.  Single-pod: (16, 16) ("data", "model") = 256
ranks.  Multi-pod: (2, 16, 16) ("pod", "data", "model") = 512 ranks; the
``pod`` axis is the Enoki replication domain, the inner axes a pod's own.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names`` over the world that is already up.  ``init_world``
brings one up (the counterpart of the reference's forced host device
count): every rank runs it with the same ``init_method`` (a ``file://``
store, or ``tcp://localhost:<port>``), on gloo, which takes the CPU and one
card that several ranks share (NCCL refuses two ranks on one device).  The
backend is named per device type, ``cpu:gloo,cuda:gloo``, so the mesh's
sub-groups are gloo on a card as well.  A mesh whose size is not the
world's raises ``ValueError``, where ``jax.make_mesh`` raises for too few
devices.

``spawn_world`` starts such a world in child processes (spawned, one a
rank), runs a function on every rank and returns what each returned; every
wait has a time limit, and a rank that raises or never answers fails the
call and stops the others.

``init_fake_world`` joins a world of the ``fake`` backend as its rank 0
alone, so a production mesh of 256 or 512 ranks builds in one process for
the dry-run (``launch.dryrun``); its collectives answer at once and move
nothing.  ``close_world`` leaves whichever world the process joined.
"""
from __future__ import annotations

import datetime
import math
import queue as queue_mod
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs.base import (MULTI_POD_MESH, SINGLE_POD_MESH,
                                      MeshConfig)
from repro_torch.device import resolve_device

BACKEND = "cpu:gloo,cuda:gloo"
COLLECTIVE_TIMEOUT_S = 300.0    # a collective that waits longer raises

_WORLD: dict = {}


def init_world(rank: int, world_size: int, init_method: str, device=None
               ) -> torch.device:
    """Join the default process group as ``rank`` of ``world_size`` (gloo
    for CPU and CUDA tensors alike) and return the rank's device
    (``None``: the card, which raises without one; the tests pass
    ``"cpu"``).  The world's ranks share one card: its current one."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:           # the ranks share the current card
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dist.init_process_group(BACKEND, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(
                                seconds=COLLECTIVE_TIMEOUT_S))
    _WORLD["device"] = dev
    return dev


def init_fake_world(world_size: int, device="cuda") -> torch.device:
    """Join a fake world of ``world_size`` ranks as rank 0 (the counterpart
    of the reference's forced host device count, for ``launch.dryrun``):
    the ``fake`` backend answers every collective at once and moves no
    byte, so a production mesh of 256 or 512 ranks builds in one process.
    ``device`` is the device type the dry-run's fake tensors name; no
    card is touched.  ``close_world`` leaves it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    _WORLD["device"] = torch.device(device)
    return _WORLD["device"]


def close_world() -> None:
    """Leave the world this process joined (real or fake)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _WORLD.pop("device", None)


def world_device() -> torch.device:
    """The device ``init_world`` gave this rank."""
    if not dist.is_initialized() or "device" not in _WORLD:
        raise RuntimeError("no world: call init_world first")
    return _WORLD["device"]


def make_mesh_compat(shape: Sequence[int], axes: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the whole world,
    rank-major as ``jax.make_mesh`` lays its devices."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} against axes {axes}")
    dev = world_device()
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; "
                         f"the world has {dist.get_world_size()}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_compat(shape, axes)


def make_mesh_from_config(cfg: MeshConfig):
    return make_mesh_compat(cfg.shape, cfg.axes)


def mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    return MULTI_POD_MESH if multi_pod else SINGLE_POD_MESH


def make_test_mesh(shape=(2, 2, 2), axes=("pod", "data", "model")):
    """Small mesh for the CPU tests (a world of ``prod(shape)`` ranks from
    ``init_world(..., device="cpu")``)."""
    return make_mesh_compat(shape, axes)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``, or of a shape-only
    stand-in whose ``shape`` is already that mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


# ---------------------------------------------------------------------------
# Worlds in child processes
# ---------------------------------------------------------------------------

def _rank_main(rank: int, fn: Callable, world_size: int, init_method: str,
               device, threads: Optional[int], args: tuple, results) -> None:
    if threads:
        torch.set_num_threads(threads)
    try:
        init_world(rank, world_size, init_method, device)
        out = fn(rank, *args)
        results.put((rank, True, out))
    except BaseException:              # reported; the parent stops the rest
        results.put((rank, False, traceback.format_exc()))
        raise
    dist.destroy_process_group()


def spawn_world(fn: Callable, world_size: int, init_method: str,
                args: tuple = (), device=None, timeout_s: float = 600.0,
                threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(rank, *args)`` on every rank of a new world of
    ``world_size`` spawned processes joined through ``init_method``, and
    return the ranks' results in rank order.  ``fn`` must be importable by
    its module's name (spawned children import it); results cross by
    pickle.  Raises ``RuntimeError`` with the traceback when a rank raises,
    and when not every rank has answered within ``timeout_s``; either way
    every child is stopped before it returns."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = mp.start_processes(
        _rank_main, args=(fn, world_size, init_method, device, threads,
                          args, results),
        nprocs=world_size, join=False, start_method="spawn").processes
    got: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(
                    f"world of {world_size}: ranks "
                    f"{sorted(set(range(world_size)) - set(got))} did not "
                    f"answer within {timeout_s} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in got]
                if dead:
                    raise RuntimeError(f"world of {world_size}: ranks {dead} "
                                       "exited without an answer")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                                   f"{out}")
            got[rank] = out
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return [got[r] for r in range(world_size)]
