#!/usr/bin/env python3
"""Time variants of the mLSTM chunk kernel on one CUDA card, in one process.

    python3 probes/mlstm_variants.py      # from the repository root

Each variant is the package's CUDA source with a part changed, built with the
package's own nvcc flags into ``build/probes/``, and run at the main-path
geometry of ``chip_smoke.py`` (one xlstm-350m mLSTM prefill layer, f32) with
its timing method (CUDA events, L2 flushed, medians), two rounds in turn:

- ``base``: the package's kernel;
- ``tf32x1``: one TF32 product a step instead of three (wrong below 1e-4:
  the cost of 3xTF32);
- ``no_qk``: the chunk loop alone, without the q kᵀ kernel before it (it
  reads a stale q kᵀ: the q kᵀ kernel's share);
- ``cluster``: ``probes/mlstm_cluster.cu``, one thread-block cluster per
  (b, h) summing partial q kᵀ through distributed shared memory.

Prints how many of the clustered design's clusters the card runs at once
(``cudaOccupancyMaxActiveClusters``) against the serving geometry's 16, one
JSON line per variant and round (ms, max |error| against the plain
version), and the card's name and power limit.
"""
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.mlstm_chunk import kernel as mk  # noqa: E402

OUT = build.BUILD_DIR / "probes"
LO = """    mma_tf32(e, lo, bh0, bh1);
    mma_tf32(e, hi, bl0, bl1);
"""
LO2 = """      mma_tf32(c[m][u], fa[m].lo, bh0, bh1);
      mma_tf32(c[m][u], fa[m].hi, bl0, bl1);
"""
QK = """  mlstm_qk_kernel<T><<<bh * (unsigned)(p.S / p.L), QK_THREADS, QK_SMEM,
                       stream>>>(p);"""


def variants():
    src = build.KERNEL_SOURCES["mlstm_chunk"].read_text()
    out = {"base": src, "tf32x1": src.replace(LO, "").replace(LO2, ""),
           "no_qk": src.replace(QK, ""),
           "cluster": (ROOT / "probes" / "mlstm_cluster.cu").read_text()}
    for name in ("tf32x1", "no_qk"):
        if out[name] == src:
            raise RuntimeError(f"variant {name} changed nothing")
    return out


def build_all(sources):
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        f = OUT / f"mlstm_{name}.cu"
        f.write_text(src)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o",
             str(OUT / f"libmlstm_{name}.so"), str(f)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(OUT / f"libmlstm_{name}.so"))
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("mlstm_variants: no CUDA device", file=sys.stderr)
        return 2
    libs = build_all(variants())
    occupancy = libs["cluster"].mlstm_chunk_max_active_clusters
    print(json.dumps({"cluster_max_active_at_d512": occupancy(0, 512),
                      "clusters_needed": cs.MAIN_MLSTM[0] * cs.MAIN_MLSTM[1]}),
          flush=True)
    B, H, S, d, chunk = cs.MAIN_MLSTM
    gen = torch.Generator(device="cuda").manual_seed(7)
    ins = cs._mlstm_inputs(torch, gen, B, H, S, d, "float32")
    q, k, v, li, lf = ins
    want = mk.mlstm_chunk_bhsd_plain(*ins, chunk=chunk)
    strides = np.array([*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                        *li.stride(), *lf.stride(), *q.stride()[:3]],
                       np.int64)
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device="cuda")
    for rnd in range(2):
        for name, lib in libs.items():
            h = torch.empty_like(q)
            carry = (torch.empty((B, H, d, d), device="cuda"),
                     torch.empty((B, H, d), device="cuda"),
                     torch.empty((B, H), device="cuda"))
            qk = torch.empty(B * H * S * 64, device="cuda")
            ptrs = [q, k, v, li, lf, h, *carry]
            if name != "cluster":
                ptrs.append(qk)
            args = ([0, 0] + [ctypes.c_void_p(t.data_ptr()) for t in ptrs]
                    + [B, H, S, d, chunk, ctypes.c_void_p(strides.ctypes.data),
                       ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)])

            def run(fn=lib.mlstm_chunk_bhsd_launch, args=args):
                err = fn(*args)
                if err:
                    raise RuntimeError(f"CUDA error {err}")
            run()
            torch.cuda.synchronize()
            err = max(float((g - w).abs().max())
                      for g, w in zip((h, *carry), (want[0], *want[1])))
            ms, _ = cs._median_ms(torch, run, lambda: None, flush, 10)
            print(json.dumps({"variant": name, "round": rnd, "ms": ms,
                              "max_abs_err": err}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
