#!/usr/bin/env python3
"""Time the merge, mLSTM and flash kernels of two checkouts on one CUDA card,
in turn.

    python3 probes/compare_trees.py OTHER_TREE      # from the repository root

OTHER_TREE is another checkout of this repository (for example the parent
commit unpacked with ``git archive`` into ``build/parent``).  Each round runs
one child process per tree, in the order other, this, this, other, so that
neither side always runs first.  Each child builds its own tree's kernels
and times them with that tree's ``chip_smoke.py`` (CUDA events, L2 flushed,
medians; the host's enqueue cost apart): ``enoki_merge_rows`` on 64 slots of
100 KB (K=1 and K=8) and of 1 MB (K=1), ``mlstm_chunk_bhsd`` at one
xlstm-350m mLSTM prefill layer, and ``flash_attention_bhsd`` at one
gemma-7b prefill layer (D=256; ``GEMMA_FLASH``) beside SDPA on the same
inputs.  Prints one JSON line per child, then the card's name and power
limit.
"""
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHILD = r'''
import json, pathlib, sys
root = pathlib.Path(sys.argv[1]).resolve()
sys.path.insert(0, str(root)); sys.path.insert(0, str(root / "src"))
import torch
import chip_smoke as cs
from repro_torch.kernels import build
from repro_torch.kernels.enoki_merge import kernel as ek
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.mlstm_chunk import kernel as mk
torch.backends.cuda.matmul.allow_tf32 = False
build.build_all(["enoki_merge", "mlstm_chunk", "flash_attention"])
flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device="cuda")
out = {"tree": sys.argv[2]}
for width, k in ((cs.ROW_100KB, 1), (cs.ROW_100KB, 8), (cs.ROW_1MB, 1)):
    t = cs.time_geometry(torch, ek, width, k, flush)
    out[f"merge_{4 * width}B_k{k}"] = {"us": t["ms"] * 1e3,
                                       "host_us": t["host_ms"] * 1e3}
t = cs.time_mlstm(torch, mk, flush)
out["mlstm"] = {"ms": t["ms"], "host_ms": t["host_ms"]}
t = cs.time_flash(torch, fk, flush, cs.GEMMA_FLASH)
out["flash_gemma_d256"] = {k: t[k] for k in ("ms", "library_ms", "bound_ms",
                                             "max_abs_err")}
print(json.dumps(out), flush=True)
'''


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = pathlib.Path(sys.argv[1]).resolve()
    for tree, label in ((other, "other"), (ROOT, "this"), (ROOT, "this"),
                        (other, "other")):
        proc = subprocess.run([sys.executable, "-c", CHILD, str(tree), label],
                              timeout=600)
        if proc.returncode:
            return proc.returncode
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    print(chip_smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
