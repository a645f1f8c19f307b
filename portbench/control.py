"""The readings a cell's limits are set from, on the chip:

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \\
        --seconds <s> [--control 0|1]

runs the cell once a seed in this one process (the weights, the traffic
and the window made anew from each seed) and prints one JSON line a seed:
the numbers compared for the program and, with ``--control 1``, for the
control (the reference in fp8 in the program's place, over the same
prompts and tokens), each side's verdict under the cell's limits
(``correct``, ``control_correct``: the control has to come out false),
the worst cache leaf of each, and the window's end-to-end numbers.  The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from portbench.run import ROOT, process_start, run


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from portbench import spec
    cell = spec.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run(cell, seed, args.seconds, False,
                  control=bool(args.control), t_start=t_start)
        t_start = time.time()
        print(json.dumps({
            "seed": seed,
            "program": {k: c["value"] for k, c in out["checks"].items()},
            "control": {k: c["value"] for k, c in
                        out.get("control", {}).items()},
            "correct": out["correct"],
            "control_correct": out.get("control_correct"),
            "window": out["window"],
            "memory_peak_bytes": out["device"]["memory_peak_bytes"]}),
            flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
