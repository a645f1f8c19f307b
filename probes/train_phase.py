#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``train`` phase alone on one CUDA card, part by
part.

    python3 probes/train_phase.py [full] [cpu_twin] [replicated] \
        [xlstm_grads] [flash_refuses]        # from the repository root

With no argument every part runs, in the smoke's order.  Each part prints
one JSON line (its record and its seconds; a part that fails prints its
error and the rest still run), after the card's name and power limit; the
records also go to ``chiprun_out/train_phase.json``.  Kernels are built at
their first launch (``flash_refuses`` launches none).
"""
import json
import pathlib
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

PARTS = ("full", "cpu_twin", "replicated", "xlstm_grads", "flash_refuses")


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.enoki_merge import kernel
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.mlstm_chunk import kernel as mk
    from repro_torch.kernels.ssd_chunk import kernel as sk
    if not torch.cuda.is_available():
        print("train_phase: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {"enoki_merge_rows": kernel.enoki_merge_rows,
                "flash_attention_bhsd": fk.flash_attention_bhsd,
                "ssd_chunk_bhcp": sk.ssd_chunk_bhcp,
                "mlstm_chunk_bhsd": mk.mlstm_chunk_bhsd}
    print(cs.nvidia_smi_line(), flush=True)
    out, failed = {}, False
    for part in sys.argv[1:] or PARTS:
        t0 = time.perf_counter()
        try:
            if part == "replicated":
                rec = [cs.train_replicated(torch, counters, c)
                       for c in (False, True)]
            else:
                rec = getattr(cs, "train_" + part)(torch, counters)
        except Exception as e:      # report it, run the other parts
            traceback.print_exc()
            rec, failed = f"FAILED: {e!r}", True
        out[part] = rec
        print(json.dumps({part: rec, "s": time.perf_counter() - t0}),
              flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "train_phase.json").write_text(json.dumps(out, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
