"""What the traffic kinds share: a mix's parameters come from
``traffic/<mix>.json``, whose ``kind`` names the generator that drives the
program's sessions path with them, ``kinds/<kind>.py`` (its class
``Traffic``, a ``Mix``).  A new mix of a kind is a data file; a new kind
is a new file of ``kinds/``.

Every kind is a closed loop of rounds dispatched ``AHEAD`` ahead of the
host.  A kind's ``setup`` makes the weights and its traffic from the seed
and warms every shape it uses; ``window`` drives the mix for the run's
seconds and leaves its end-to-end numbers in ``e2e``; ``run_stretch``
drives a fixed stretch under the profiler; ``take`` copies out what the
check needs and drops the program's state; ``judge`` holds it against the
reference (and the control).
"""
from __future__ import annotations

import random
import time
from typing import Dict, Optional

import torch

from portbench import program as prog_mod
from portbench import trace as tr
from portbench import weights

AHEAD = 1                       # rounds dispatched ahead of the host
clock = time.perf_counter       # the host clock (a test substitutes one)


def generator(seed: int, stream: int, device) -> torch.Generator:
    """The seed's generator for one purpose (1: prompts), on
    ``device``."""
    return torch.Generator(device=device).manual_seed(seed * 16 + stream)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Event:
    """A CUDA event, or the moment of recording on the CPU (which runs
    every op before it returns)."""

    def __init__(self, device):
        self.ev = torch.cuda.Event() if device.type == "cuda" else None
        if self.ev is not None:
            self.ev.record()

    def wait(self) -> None:
        if self.ev is not None:
            self.ev.synchronize()


class Mix:
    """State common to every kind: the program, the weights, and what the
    per-layer readers read (``trace``, ``stretch``, ``readings``)."""

    def __init__(self, cell, seed: int, program, device):
        self.cell, self.seed, self.prog = cell, seed, program
        self.dev = torch.device(device)
        self.p = cell.traffic
        self.sizes = cell.sizes
        self.ref = cell.reference
        self.module = cell.config["reference"]["module"]
        self.trace: Optional[tr.Trace] = None
        self.stretch: Dict[str, float] = {}
        self.readings: Dict[str, float] = {}
        self.rng = random.Random(seed)
        self.attempted = 0
        self.failed = 0
        self.detail: Dict[str, dict] = {}   # the worst error by cache leaf
        self.phases: Dict[str, float] = {}  # set-up seconds by phase
        self._t = clock()

    def phase(self, name: str) -> None:
        """Close a set-up phase: the seconds since the last one, the
        device drained."""
        sync(self.dev)
        now = clock()
        self.phases[name] = now - self._t
        self._t = now

    def make_weights(self) -> None:
        self.phase("start")
        self.params = weights.make(self.ref, self.sizes,
                                   seed=self.seed * 16, device=self.dev)
        self.phase("weights")

    def profiled(self, body) -> None:
        """``body()`` under the profiler, then the device drained: the
        trace's stretch."""
        p = tr.Profiled()
        p.start()
        body()
        sync(self.dev)
        self.trace = p.stop()


def worst(r: dict, name: str, value: float) -> None:
    r[name] = max(r.get(name, 0.0), value)


def session(live: dict, pod: int, b: int) -> dict:
    """One session's slices of every leaf of a pod-stacked cache, keyed as
    the reference keys its cache: (path, layer index) -> tensor."""
    out = {}
    for path, x in prog_mod.leaves(live):
        if path == "length" or path.endswith("_pos"):
            continue
        x = x[pod]
        # the layer dims lead, the session dim follows them
        for index in _indices(x.shape[:x.dim() - rank(path)]):
            out[(path, index)] = x[index + (b,)].clone()
    return out


def corner(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The leading corner of ``x`` the size of ``like`` (a cache's first
    positions)."""
    return x[tuple(slice(0, n) for n in like.shape)]


def rank(path: str) -> int:
    """A leaf's dims after its session dim."""
    name = path.split("/")[-1]
    return {"k": 3, "v": 3, "shared_k": 3, "shared_v": 3, "conv_x": 2,
            "conv_B": 2, "conv_C": 2, "state": 3}[name] + 1


def _indices(dims) -> list:
    out = [()]
    for n in dims:
        out = [i + (j,) for i in out for j in range(n)]
    return out
