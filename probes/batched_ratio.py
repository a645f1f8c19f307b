#!/usr/bin/env python3
"""Batched against sequential invocation through the port, on one device.

    python3 probes/batched_ratio.py [cpu|cuda]      # from the repository root

Runs ``chip_smoke.batched_vs_sequential``: ``tests/test_perf_paths.py``'s
measurement (one ``invoke_batch`` of 64 against 64 sequential ``invoke``s
of an 8-wide accumulator, warmup 1, interleaved repeats 5, medians), and
prints it as one JSON line with the device it ran on.  The reference holds
the ratio to at least 2.5; on the CPU the port's fold runs eagerly.
"""
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch

    import chip_smoke
    device = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    out = chip_smoke.batched_vs_sequential(torch, device)
    name = (torch.cuda.get_device_name(0) if device == "cuda"
            else f"cpu ({torch.get_num_threads()} threads)")
    print(json.dumps({"device": name, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
