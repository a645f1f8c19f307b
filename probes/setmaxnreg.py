#!/usr/bin/env python3
"""Whether ptxas lets a consumer warpgroup use the registers that
``setmaxnreg.inc`` grants past the launch's 168 a thread.

    python3 probes/setmaxnreg.py      # from the repository root; one CUDA card

Builds ``probes/setmaxnreg.cu`` in several variants (compile-time switches)
into ``build/probes/`` with the package's nvcc flags, and for each prints
one JSON line: ptxas's registers, spills and warnings (``-Xptxas=-v``), the
highest register the SASS names (``cuobjdump -sass``: past R167 only the
consumers after ``setmaxnreg.inc`` may go), the SASS's local-memory
instructions (STL/LDL: spills), and whether one launch of 132 blocks ends
with the exact O it must hold (4 x iterations everywhere).  Then the same
SASS reading of the flash library's ``flash_fwd_bf16_wgmma`` at every head
dim, and the card's name and power limit.

Variants: ``shfl_24_240`` (the role from a shuffle; producer 24, consumers
240: the flash kernel's D=256 layout), ``tid_24_240`` (the role from
threadIdx.x / 128), ``shfl_40_232`` (the D <= 128 kernel's counts),
``shfl_24_240_trap`` (a trap reachable in the consumers' loop, as in the
flash kernel's waits that trap) and ``none`` (no setmaxnreg: every thread
at 168).
"""
import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

OUT = build.BUILD_DIR / "probes"
SRC = ROOT / "probes" / "setmaxnreg.cu"
VARIANTS = {
    "shfl_24_240": {"ROLE_SHFL": 1, "PRODUCER_REGS": 24, "CONSUMER_REGS": 240},
    "tid_24_240": {"ROLE_SHFL": 0, "PRODUCER_REGS": 24, "CONSUMER_REGS": 240},
    "shfl_40_232": {"ROLE_SHFL": 1, "PRODUCER_REGS": 40, "CONSUMER_REGS": 232},
    "shfl_24_240_trap": {"ROLE_SHFL": 1, "PRODUCER_REGS": 24,
                         "CONSUMER_REGS": 240, "TRAP": 1},
    "none": {"SETMAXNREG": 0},
}
ITERS, BLOCKS = 64, 132


def cuobjdump() -> str:
    return str(pathlib.Path(build._nvcc()).with_name("cuobjdump"))


def sass_by_function(lib: pathlib.Path) -> dict:
    """Each kernel's SASS in a library, by mangled name."""
    text = subprocess.run([cuobjdump(), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return {k: "\n".join(v) for k, v in out.items()}


def read_sass(sass: str) -> dict:
    regs = [int(r) for r in re.findall(r"\bR(\d+)\b", sass)]
    return {"max_register": max(regs) if regs else None,
            "registers_past_167": sum(1 for r in set(regs) if r > 167),
            "stl": len(re.findall(r"\bSTL\b", sass)),
            "ldl": len(re.findall(r"\bLDL\b", sass)),
            "setmaxnreg": len(re.findall(r"USETMAXREG|SETMAXREG", sass))}


def build_variants() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, defs in VARIANTS.items():
        lib = OUT / f"libsetmaxnreg_{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS,
               *(f"-D{k}={v}" for k, v in defs.items()), "-o", str(lib),
               str(SRC)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        built[name] = (proc.returncode, log, lib)
    return built


def run(lib: pathlib.Path) -> dict:
    fn = ctypes.CDLL(str(lib)).setmaxnreg_probe_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.full((BLOCKS * 256, 130), float("nan"), device="cuda")
    err = fn(out.data_ptr(), BLOCKS, ITERS,
             torch.cuda.current_stream().cuda_stream)
    if err:
        return {"launch_error": err}
    torch.cuda.synchronize()
    o = out[:, :128]
    return {"o_exact": bool((o == 4.0 * ITERS).all()),
            "o_min": float(o.min()), "o_max": float(o.max()),
            "maxes_exact": bool((out[:, 128:] == 1.0).all())}


def main() -> int:
    if not torch.cuda.is_available():
        print("setmaxnreg: no CUDA device", file=sys.stderr)
        return 2
    for name, (rc, log, lib) in build_variants().items():
        rec = {"variant": name, **VARIANTS[name], "nvcc_rc": rc}
        if rc == 0:
            usage = build.resource_usage(log)
            rec["ptxas"] = next(iter(usage.values()), {})
            rec["ptxas_warnings"] = [line.strip() for line in log.splitlines()
                                     if "arning" in line or "C75" in line]
            rec["sass"] = read_sass(
                next(iter(sass_by_function(lib).values())))
            rec.update(run(lib))
        else:
            rec["log"] = log[-3000:]
        print(json.dumps(rec), flush=True)
    build.build_all(["flash_attention"])
    log = build.build_log("flash_attention")
    usage = build.resource_usage(log)
    for fn, sass in sass_by_function(
            build.library_path("flash_attention")).items():
        if "flash_fwd_bf16_wgmma" not in fn:
            continue
        d = re.search(r"wgmmaILi(\d+)E", fn).group(1)
        print(json.dumps({"kernel": f"flash_fwd_bf16_wgmma<{d}>",
                          "ptxas": usage.get(fn, {}), "sass": read_sass(sass),
                          "ptxas_warnings": [
                              line.strip() for line in log.splitlines()
                              if "C75" in line and fn in line]}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
