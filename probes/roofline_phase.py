#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``roofline`` and ``dryrun`` phases alone on one
CUDA card.

    python3 probes/roofline_phase.py

Builds the kernels, runs the train phase's ``full`` part (the dry-run's
peak is held against its measured peak), then the cost walker on the
three sessions prefills and the served path (``chip_smoke.run_roofline``),
then the dry-run phase: its three cells in child processes
(``chip_smoke.run_dryrun``).  Prints the card's name and
power limit, then one JSON line a phase; any failed check raises, as in
the smoke.  Also runs the ``cuda`` tests of the walker and the dry-run.
"""
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.enoki_merge import kernel
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.mlstm_chunk import kernel as mk
    from repro_torch.kernels.ssd_chunk import kernel as sk
    if not torch.cuda.is_available():
        print("roofline_phase: no CUDA device is available", file=sys.stderr)
        return 2
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    t0 = time.time()
    build.build_all()
    print("build_s", time.time() - t0, flush=True)
    counters = {"enoki_merge_rows": kernel.enoki_merge_rows,
                "flash_attention_bhsd": fk.flash_attention_bhsd,
                "ssd_chunk_bhcp": sk.ssd_chunk_bhcp,
                "mlstm_chunk_bhsd": mk.mlstm_chunk_bhsd}
    t0 = time.time()
    full = cs.train_full(torch, counters)
    print(json.dumps({"phase": "train.full", "nvidia_smi": smi,
                      **{k: v for k, v in full.items()
                         if k != "profile_step"}}), flush=True)
    print("train_full_s", time.time() - t0, flush=True)
    t_phase = time.perf_counter()
    roof = cs.run_roofline(torch, counters)
    print(json.dumps({"phase": "roofline", **roof,
                      "wall_s": time.perf_counter() - t_phase,
                      "nvidia_smi": smi}), flush=True)
    t_dry = time.perf_counter()
    dry = cs.run_dryrun(torch, full)
    print(json.dumps({"phase": "dryrun", **dry,
                      "wall_s": time.perf_counter() - t_dry,
                      "phases_s": time.perf_counter() - t_phase,
                      "nvidia_smi": smi}), flush=True)
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "cuda",
         "tests/test_torch_cuda.py", "-k", "walker or dry_run",
         "-p", "no:cacheprovider"], cwd=ROOT, capture_output=True,
        text=True, env={"PYTHONPATH": str(ROOT / "src"),
                        "PATH": "/usr/bin:/bin:/usr/local/bin"})
    print(tests.stdout[-3000:], tests.stderr[-2000:], flush=True)
    return tests.returncode


if __name__ == "__main__":
    sys.exit(main())
