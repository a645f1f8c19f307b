"""Build the port's CUDA sources and load them with ``ctypes``.

Each kernel is one ``.cu`` file under ``kernels/<name>/csrc/`` with a plain
C interface.  At first use it is compiled by ``nvcc`` for Hopper
(``sm_90a``) into the repository's ``build/`` directory (listed in
``.gitignore``), under a name that carries a digest of the source and the
flags, so an edited source never loads a stale library.  Nothing is built
when a module is imported: the CPU tests import every module on a host with
no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

_PKG = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build"

#: kernel name -> its CUDA source
KERNEL_SOURCES: Dict[str, pathlib.Path] = {
    "enoki_merge": _PKG / "enoki_merge" / "csrc" / "enoki_merge.cu",
    "flash_attention": _PKG / "flash_attention" / "csrc" / "flash_attention.cu",
    "ssd_chunk": _PKG / "ssd_chunk" / "csrc" / "ssd_chunk.cu",
    "mlstm_chunk": _PKG / "mlstm_chunk" / "csrc" / "mlstm_chunk.cu",
    "decode_attention": _PKG / "decode_attention" / "csrc"
    / "decode_attention.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: seconds each library took to compile in this process (absent: loaded
#: from an earlier build)
BUILD_SECONDS: Dict[str, float] = {}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built on "
                       "a machine with the CUDA toolkit")


def library_path(name: str) -> pathlib.Path:
    src = KERNEL_SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_log(name: str) -> str:
    """What ``nvcc`` printed when it built the library now in use (kept
    beside it), ptxas's report of every kernel among it; "" if none."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def resource_usage(log: str) -> Dict[str, Dict[str, int]]:
    """ptxas's report in an ``nvcc -Xptxas=-v`` log, by kernel (the mangled
    name): registers, static shared memory bytes, spill stores and loads
    in bytes.  Dynamic shared memory is set at launch and is not in it."""
    out: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
            continue
        if fn is None:
            continue
        rec = out.setdefault(fn, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rec["spill_stores"], rec["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rec["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            rec["static_smem"] = int(m.group(1)) if m else 0
    return {k: v for k, v in out.items() if "registers" in v}


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together.  Returns the seconds each took;
    raises with the compiler's output when any build fails."""
    names = list(KERNEL_SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(KERNEL_SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        BUILD_SECONDS[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {n: BUILD_SECONDS[n] for n in procs}


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib
