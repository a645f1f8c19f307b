#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``tensor_parallel`` phase alone on one CUDA card.

    python3 probes/tp_phase.py                      # the first world's parts
    python3 probes/tp_phase.py moe_prefill vlm      # these parts only
    python3 probes/tp_phase.py prefill audio seq_shard   # whisper-tiny and
                                    # seq_shard beside the dense prefill
    python3 probes/tp_phase.py hybrid_prefill ssm_prefill hybrid_train \
        ssm_train                                   # the second world's
    python3 probes/tp_phase.py kv_replicated        # the 16-rank world's

Builds the kernels (flash is the phase's: each rank's prefill runs it on
its heads), spawns the phase's world of 4 ranks sharing the card
(``chip_smoke.run_tp``; 16 ranks for ``kv_replicated``, whose world is
its own) and prints one JSON line a part after the card's name and power
limit.  Any failed check raises, as in the smoke.
"""
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("tp_phase: no CUDA device is available", file=sys.stderr)
        return 2
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    t0 = time.time()
    build.build_all()
    print("build_s", time.time() - t0, flush=True)
    cfg = cs.tp_config()
    if sys.argv[1:]:
        cfg["parts"] = tuple(sys.argv[1:])
    ranks = cs.KV_RANKS if set(cfg["parts"]) <= set(cs.KV_PARTS) \
        else cs.MESH_RANKS
    records, wall = cs.run_tp(torch, cfg, ranks=ranks)
    for part in cfg["parts"]:
        print(json.dumps({"part": part, "nvidia_smi": smi, **records[part]}),
              flush=True)
    print(json.dumps({"wall_s": wall}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
