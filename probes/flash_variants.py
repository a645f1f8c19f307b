#!/usr/bin/env python3
"""Build variants of the flash kernel at one head dim and read what ptxas
made of each, then check and time them on one CUDA card, in one process.

    python3 probes/flash_variants.py [D [VARIANT ...]]   # D=256, all variants

Each variant is the package's ``flash_attention.cu`` with a part changed
(string replacement; a replacement that changes nothing is an error),
built with the package's nvcc flags into ``build/probes/`` with only head
dim D instantiated, all builds at once.  For each: ptxas's registers and
spills, its C7513 warning (wgmma serialised), and the SASS's highest
register, the count of registers past R167 (only the consumers, after
``setmaxnreg.inc``, may go there) and its local-memory instructions.  The
SASS of the ``base`` variant goes to ``build/probes/flash_sass_D<D>.txt``.
Each variant that builds is then run through the package's wrapper on a
ragged GQA case (against the plain version, ``chip_smoke``'s tolerances;
not the variants that drop work on purpose) and timed at
``chip_smoke.py``'s prefill geometry of that head dim (gemma-7b's at
D=256), two rounds in turn.  Prints one JSON line per
variant and round, then the card's name and power limit.
"""
import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "probes"))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import setmaxnreg as smr  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402

OUT = build.BUILD_DIR / "probes"
GEOMETRY = {256: cs.GEMMA_FLASH, 128: cs.MAIN_FLASH, 112: cs.ZAMBA_FLASH,
            96: cs.PHI_FLASH}
# name -> ([(old, new), ...] applied to the package's source, whether its
# output is held to the plain version; a variant that is not computes a
# wrong output on purpose and is only timed (what a part of the kernel
# costs)
VARIANTS = {
    "base": ([], True),
    # every wait traps when it never ends (the D <= 128 kernels' waits)
    "trap": ([("TRAP = D != 256;", "TRAP = true;")], True),
    # no wait traps, at every head dim
    "trap_free": ([("TRAP = D != 256;", "TRAP = false;")], True),
    # a wait that gives up returns without counting it in the give-up word
    # (the waits before the word existed: what the base's atomicAdd costs)
    "silent_give_up": ([("        atomicAdd(give_ups, 1);\n", "")], True),
    # no output stored (a condition that never holds keeps the work live)
    "no_store": ([("if (qp0 < p.Sq)\n", "if (qp0 < p.Sq - (1 << 30))\n"),
                  ("if (qp1 < p.Sq)\n", "if (qp1 < p.Sq - (1 << 30))\n")],
                 False),
    # O never rescaled when a row max moves
    "no_rescale": ([("__any_sync(0xffffffffu, sm.c0 != 1.f || sm.c1 != 1.f)",
                     "__any_sync(0xffffffffu, sm.c0 != sm.c0)")], False),
}


def only_head_dim(src: str, d: int) -> str:
    out = []
    for line in src.splitlines(keepends=True):
        m = re.match(r"\s+case (\d+): return launch<\d+>", line)
        if m and int(m.group(1)) != d:
            continue
        out.append(line)
    return "".join(out)


def sources(d: int, names) -> dict:
    src = only_head_dim(build.KERNEL_SOURCES["flash_attention"].read_text(), d)
    out = {}
    for name in names:
        edits, _ = VARIANTS[name]
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} found "
                                   f"{text.count(old)} times")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_all(srcs: dict) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        f = OUT / f"flash_{name}.cu"
        f.write_text(text)
        lib = OUT / f"libflash_{name}.so"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(f)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    out = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        out[name] = (proc.returncode, log, lib)
    return out


def bind(lib: pathlib.Path):
    return fk.bind_launch(ctypes.CDLL(str(lib)))


def check(d: int) -> float:
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = 0.0
    q, k, v = cs._qkv(torch, gen, 2, 300, 300, 4, 2, d, "bfloat16")
    for causal, window in cs.FLASH_MASKS:
        want = fk.flash_attention_bhsd_plain(q, k, v, causal=causal,
                                             window=window)
        got = fk.flash_attention_bhsd(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err, _ = cs._flash_close(torch, fk, q, k, v, got, want, causal,
                                 window, f"D={d} causal={causal} "
                                 f"window={window}")
        worst = max(worst, err)
    return worst


def time_kernel(geometry, flush) -> float:
    """The kernel's median ms at a prefill geometry (bf16, causal), with
    ``chip_smoke``'s method."""
    B, S, H, KV, D, window = geometry
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = cs._qkv(torch, gen, B, S, S, H, KV, D, "bfloat16")
    ms, _ = cs._median_ms(
        torch, lambda: fk.flash_attention_bhsd(q, k, v, causal=True,
                                               window=window),
        lambda: None, flush, 10)
    return ms


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 2
    d = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    built = build_all(sources(d, sys.argv[2:] or list(VARIANTS)))
    ok = {}
    for name, (rc, log, lib) in built.items():
        rec = {"variant": name, "D": d, "nvcc_rc": rc}
        if rc:
            rec["log"] = log[-3000:]
            print(json.dumps(rec), flush=True)
            continue
        kernel = f"flash_fwd_bf16_wgmmaILi{d}E"
        usage = {k: v for k, v in build.resource_usage(log).items()
                 if kernel in k}
        sass = {k: v for k, v in smr.sass_by_function(lib).items()
                if kernel in k}
        rec["ptxas"] = next(iter(usage.values()), {})
        rec["c7513"] = any("C7513" in line and kernel in line
                           for line in log.splitlines())
        rec["sass"] = smr.read_sass(next(iter(sass.values()), ""))
        if name == "base":
            (OUT / f"flash_sass_D{d}.txt").write_text(
                next(iter(sass.values()), ""))
        print(json.dumps(rec), flush=True)
        ok[name] = lib
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device="cuda")
    for rnd in range(2):
        for name, lib in ok.items():
            fk._fn = bind(lib)
            rec = {"variant": name, "round": rnd}
            try:
                if VARIANTS[name][1]:
                    rec["max_abs_err"] = check(d)
                rec["ms"] = time_kernel(GEOMETRY[d], flush)
                rec["give_ups"] = fk.check_give_ups()
            except (AssertionError, RuntimeError) as e:
                rec["error"] = str(e)[:400]
            print(json.dumps(rec), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
