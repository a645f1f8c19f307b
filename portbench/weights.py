"""Seeded weights, made on the device by the benchmark and handed alike to
the program under test and to the reference.

A configuration's reference module gives the layout (``param_shapes``:
leaf path -> (shape, dtype), stacked by layer as the program holds them)
and how each leaf is drawn (``INIT``).  Each leaf is one draw from one
``torch.Generator`` on the device, in the dtype it is served in, the
leaves taken in sorted path order: a few large calls, the same numbers for
the same seed.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

GAIN_STD = 0.1                  # RMSNorm gains: 1 + N(0, GAIN_STD)
CONV_STD = 0.5                  # depthwise conv taps
DT_RANGE = (1e-3, 1e-1)         # Mamba-2's dt at init, log-uniform
A_RANGE = (1.0, 16.0)           # Mamba-2's -A at init, uniform


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """{"a/b": x} -> {"a": {"b": x}}."""
    out: dict = {}
    for path, x in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = x
    return out


def _draw(gen, shape, dtype, device, rule, scale) -> torch.Tensor:
    if rule == "normal":
        x = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        return x.mul_(scale)
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    if rule == "A_log":
        return torch.log(A_RANGE[0] + (A_RANGE[1] - A_RANGE[0]) * u).to(dtype)
    if rule == "dt_bias":
        lo, hi = math.log(DT_RANGE[0]), math.log(DT_RANGE[1])
        dt = torch.exp(lo + (hi - lo) * u)
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)   # softplus^-1
    if rule == "D":
        return (1.0 + GAIN_STD * (2.0 * u - 1.0)).to(dtype)
    raise ValueError(f"unknown init rule {rule!r}")


def _scale(kind, shape, sizes) -> float:
    if kind == "fan_in":
        return shape[-2] ** -0.5
    if kind == "embed":
        return int(sizes["d_model"]) ** -0.5
    if kind == "gain":
        return GAIN_STD
    if kind == "conv":
        return CONV_STD
    return 1.0


def make(ref, sizes: dict, seed: int, device) -> dict:
    """The served weights of the configuration ``sizes`` whose reference
    module is ``ref``, from ``seed``, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = {}
    for path, (shape, dtype) in sorted(ref.param_shapes(sizes).items()):
        rule, kind = ref.INIT[path]
        flat[path] = _draw(gen, shape, dtype, device, rule,
                           _scale(kind, shape, sizes))
    return nest(flat)
