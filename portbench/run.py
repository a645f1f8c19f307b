"""Run one cell of ``BENCHMARK.json`` once, on the machine it is started on:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Set-up makes the weights and the traffic
from the seed on the card, warms every shape the cell uses and loads the
program's kernels from ``build/`` (compiling them on a checkout's first
run); the window then drives the cell's mix for ``--seconds``; with
``--trace 1`` a fixed stretch after it runs under the profiler.  Once the
window has closed and the peak memory is read, the program's state is
dropped and the plain reference checks what the timed path produced.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit, also printed as the last lines of standard error.  With no card,
or fewer than the cell asks for, or with jax or the JAX package loaded,
it prints no result and exits with a code other than 0.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """This process's start, in ``time.time()``'s seconds (from /proc;
    the module's import time where /proc is not there)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(x.split()[1]) for x in f if x.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _IMPORTED


_IMPORTED = time.time()


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run(cell, seed: int, seconds: float, trace: bool, device="cuda",
        arch=None, control: bool = False, t_start: float = None,
        program=None) -> dict:
    """One run of ``cell``: the result line's object (and, with
    ``control``, the control's numbers under ``control``)."""
    import torch

    from portbench import drive, spec
    from portbench.program import Program
    t_start = _IMPORTED if t_start is None else t_start
    dev = torch.device(device)
    prog = program or Program(cell.config, cell.sizes, dev, arch)
    mix = spec.kind(cell.traffic["kind"])(cell, seed, prog, dev)
    mix.setup(trace)
    drive.sync(dev)
    setup_s = time.time() - t_start
    mix.window(seconds)
    if trace:
        mix.run_stretch()
    drive.sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    give_ups = prog.give_ups()
    mix.count_failed()
    got = mix.take()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.time()
    sides = mix.judge(got, control)
    sides["program"]["give_ups"] = float(give_ups)
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in sorted(sides["program"].items())}
    correct = _within(checks)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"]).read(mix)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(mix.e2e, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu",
            "count": cell.chips, "memory_peak_bytes": peak}
    if trace:
        info.update(busy_s=mix.trace.busy_s if mix.trace else 0.0,
                    window_s=mix.trace.window_s if mix.trace else 0.0)
    out = {"correct": correct, "attempted": mix.attempted,
           "failed": mix.failed, "metrics": metrics, "device": info}
    if trace and mix.trace is not None:
        out["breakdown"] = mix.trace.breakdown()
    out["window"] = dict(mix.e2e, setup_s=setup_s, **mix.readings,
                         phases=mix.phases, detail=mix.detail)
    out["check_s"] = time.time() - t_check
    if control:
        # the control in the program's place, held to the same limits
        low = {k: {"value": v, "limit": cell.limits[k]}
               for k, v in sorted(sides["control"].items())}
        out["control"] = low
        out["control_correct"] = _within(low)
    out["checks"] = checks
    return out


def _within(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / "portbench" / sub))
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from portbench import spec
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    limit = power_limit()
    out = run(cell, args.seed, args.seconds, bool(args.trace),
              t_start=t_start)
    out["device"]["power"] = limit
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad}", file=sys.stderr)
        return 4
    checks = out.pop("checks")
    print(f"window {out.pop('window')} check_s {out.pop('check_s')}",
          file=sys.stderr)
    out["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
