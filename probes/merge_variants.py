#!/usr/bin/env python3
"""Time variants of the merge kernel on one CUDA card, in one process.

    python3 probes/merge_variants.py      # from the repository root

Each variant is the package's CUDA source with a part changed, built with the
package's own nvcc flags into ``build/probes/`` and called through the
package's wrapper, at the main-path geometries of ``chip_smoke.py`` (64
fully populated slots of 100 KB and of 1 MB, K=1) with its timing method
(CUDA events, L2 flushed, medians), three rounds in turn:

- ``base``: the package's kernel;
- ``empty``: the same launch (grid, clusters, parameters) returning at once:
  the floor this timing method reads for any kernel of that launch;
- ``nocluster``: no cluster and no cluster barrier (a row's blocks may then
  write its metadata before another has read it: timing only).

Prints one JSON line per variant, geometry and round (device µs, host
enqueue µs, whether the result matched the plain fold), and the card's name
and power limit.
"""
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.enoki_merge import kernel as ek  # noqa: E402

OUT = build.BUILD_DIR / "probes"
BODY = ("  // grid.x: (chunk, row), the chunk fastest; a row's chunks are one "
        "cluster\n")


def variants():
    src = build.KERNEL_SOURCES["enoki_merge"].read_text()
    out = {"base": src,
           "empty": src.replace(BODY, BODY + "  if (a.k > 0) return;\n"),
           "nocluster": src.replace("if (a.chunks > 1) cluster_arrive();", "")
                           .replace("if (a.chunks > 1) cluster_wait();", "")
                           .replace("cfg.numAttrs = 1;", "cfg.numAttrs = 0;")}
    for name in ("empty", "nocluster"):
        if out[name] == src:
            raise RuntimeError(f"variant {name} changed nothing")
    return out


def build_all(sources):
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        f = OUT / f"merge_{name}.cu"
        f.write_text(src)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o",
             str(OUT / f"libmerge_{name}.so"), str(f)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
        fn = ctypes.CDLL(str(OUT / f"libmerge_{name}.so")) \
            .enoki_merge_rows_launch
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, i, ll, ll, ll, i, i, i, p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("merge_variants: no CUDA device", file=sys.stderr)
        return 2
    fns = build_all(variants())
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device="cuda")
    for rnd in range(3):
        for name, fn in fns.items():
            ek._fn = fn        # the wrapper calls this variant's library
            for width in (cs.ROW_100KB, cs.ROW_1MB):
                gen = torch.Generator(device="cuda").manual_seed(width)
                pristine = cs._arena(torch, gen, cs.SLOTS, width, "float32",
                                     "cuda", 1000)
                snaps = [cs._arena(torch, gen, cs.SLOTS, width, "float32",
                                   "cuda", 1000)]
                for a in [pristine] + snaps:
                    a[2].fill_(width)
                acc = cs._clone(pristine)

                def reset():
                    for dst, src in zip(acc, pristine):
                        dst.copy_(src)
                want = ek.enoki_merge_rows_plain(cs._clone(pristine), snaps)
                got = ek.enoki_merge_rows(cs._clone(pristine), snaps)
                torch.cuda.synchronize()
                ok = cs._max_abs_err(torch, got, want) == 0.0
                ms, host = cs._median_ms(
                    torch, lambda: ek.enoki_merge_rows(acc, snaps), reset,
                    flush, 20)
                print(json.dumps({"variant": name, "round": rnd,
                                  "row_bytes": width * 4, "us": ms * 1e3,
                                  "host_us": host * 1e3, "matches": ok}),
                      flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
