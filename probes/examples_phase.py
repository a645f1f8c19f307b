#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``examples`` phase alone on one CUDA card, twin
by twin.

    python3 probes/examples_phase.py [quickstart] [batched_invoke] \
        [smart_city] [serve_wallclock] [serve_sessions] \
        [train_local_sgd]                    # from the repository root

With no argument every twin runs, in the smoke's order.  Each prints one
JSON line (its record and its seconds; a twin that fails prints its error
and the rest still run), after the card's name and power limit; the
records also go to ``chiprun_out/examples_phase.json``.  The merge kernel
is built at its first launch.
"""
import json
import pathlib
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.enoki_merge import kernel
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.mlstm_chunk import kernel as mk
    from repro_torch.kernels.ssd_chunk import kernel as sk
    if not torch.cuda.is_available():
        print("examples_phase: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = (kernel.enoki_merge_rows, fk.flash_attention_bhsd,
                sk.ssd_chunk_bhcp, mk.mlstm_chunk_bhsd)
    print(cs.nvidia_smi_line(), flush=True)
    names = cs.FAAS_EXAMPLES + ("serve_sessions", "train_local_sgd")
    out, failed = {}, False
    for name in sys.argv[1:] or names:
        t0 = time.perf_counter()
        try:
            if name == "serve_sessions":
                rec = cs.check_sessions_example(torch, counters)
            elif name == "train_local_sgd":
                rec = cs.check_train_example(torch, counters)
            else:
                rec = cs.check_faas_example(torch, counters, name)
        except Exception as e:      # report it, run the other twins
            traceback.print_exc()
            rec, failed = f"FAILED: {e!r}", True
        out[name] = rec
        print(json.dumps({name: rec, "s": time.perf_counter() - t0}),
              flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "examples_phase.json").write_text(json.dumps(out, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
