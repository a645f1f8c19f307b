#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card, and check it.

    python3 chip_smoke.py        # from the repository root; one CUDA card

Phases, each printing one JSON line (any failure raises and exits non-zero):

1. device and build — the card, its power limit, and the time ``nvcc``
   takes to build every kernel from ``src/repro_torch/kernels/*/csrc``;
2. kernels against their plain versions on the card — ``enoki_merge_rows``
   bit-exact over a sweep of shapes, payload dtypes (f32, bf16, int32,
   uint8) and snapshot counts K, then timed (CUDA events, medians, L2
   flushed between launches, the host's enqueue cost reported apart) at
   the main path's geometry: fully populated
   slot-aligned arenas of 64 slots with random versions, with rows of
   100 KB (25,600 f32) and 1 MB (262,144 f32), beside its device-memory
   byte bound at 3.35 TB/s, its plain version and one ``torch.where``;
3. the main path, served — a ``Cluster`` on the paper topology with a
   REPLICATED 64-slot keygroup of 100 KB rows on the two edges, a
   Listing-1-style mutating handler whose static key set fills the arena
   and a read-only handler at the far edge; >= 512 requests through
   ``FaasServer`` (an open-loop burst, then a closed loop, so the 64- and
   256-request buckets both run); replication flushed; replicas byte-identical, aligned
   merges only, the kernel launched exactly once per merge, and a CPU twin
   of the same requests (plain versions) ending in the same arenas;
4. the ``{"kernels": [...]}`` line, then the card's name and power limit
   as ``nvidia-smi`` reports them, then ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (NVIDIA data sheet)
SLOTS = 64                      # KeygroupSpec.slots
ROW_100KB, ROW_1MB = 25_600, 262_144
SWEEP_SHAPES = [(256, 128), (512, 256), (64, 128),
                # odd widths: 4-byte and byte paths, a row over two chunks
                (7, 3), (5, 3), (64, 100), (33, 2049)]
SWEEP_K = (1, 2, 5, 8)
DTYPES = ("float32", "bfloat16", "int32", "uint8")
N_REQUESTS, BURST, CONCURRENCY = 544, 320, 32
SPIN_CYCLES = 2_000_000         # ~1 ms of card time: longer than any enqueue
WINDOW_MS = 20.0
MERGE_SOURCE = "src/repro_torch/kernels/enoki_merge/csrc/enoki_merge.cu"
MERGE_REPLACES = "src/repro/kernels/enoki_merge/kernel.py:37"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: the merge kernel against its plain version
# ---------------------------------------------------------------------------

def _arena(torch, gen, rows, width, dtype, device, versions_hi, nvv=64):
    """One slot-aligned arena as a (keys, values, lengths, versions, vv)
    tuple, made on the device."""
    tdt = getattr(torch, dtype)
    if dtype in ("int32", "uint8"):
        values = torch.randint(0, 100, (rows, width), generator=gen,
                               device=device).to(tdt)
    else:
        values = torch.randn((rows, width), generator=gen,
                             device=device).to(tdt)
    return (torch.arange(1000, 1000 + rows, dtype=torch.int32, device=device),
            values,
            torch.randint(-1, width + 1, (rows,), generator=gen,
                          device=device, dtype=torch.int32),
            torch.randint(0, versions_hi, (rows,), generator=gen,
                          device=device, dtype=torch.int32),
            torch.randint(0, 50, (nvv,), generator=gen, device=device,
                          dtype=torch.int32))


def _clone(rows):
    return tuple(t.clone() for t in rows)


def _max_abs_err(torch, got, want) -> float:
    return max(float((g.double() - w.double()).abs().max())
               for g, w in zip(got, want))


def check_sweep(torch, kernel):
    """Kernel vs plain, bit-exact, over the sweep; returns the max error."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst, cases = 0.0, 0
    for rows, width in SWEEP_SHAPES:
        for dtype in DTYPES:
            for k in SWEEP_K:
                acc = _arena(torch, gen, rows, width, dtype, "cuda", 4)
                snaps = [_arena(torch, gen, rows, width, dtype, "cuda", 4)
                         for _ in range(k)]
                want = kernel.enoki_merge_rows_plain(_clone(acc), snaps)
                got = kernel.enoki_merge_rows(_clone(acc), snaps)
                torch.cuda.synchronize()
                err = _max_abs_err(torch, got, want)
                if err != 0.0:
                    raise AssertionError(f"kernel != plain at rows={rows} "
                                         f"width={width} {dtype} K={k}: {err}")
                worst, cases = max(worst, err), cases + 1
    return worst, cases


def _median_ms(torch, fn, reset, flush, reps):
    """(device ms, host enqueue ms) of one ``fn()``, medians over ``reps``.

    The card spins before each timed call, so the host has enqueued the
    whole call before the start event runs: the events then time device
    work only, and the host's own cost of the call is reported apart."""
    pairs, host = [], []
    for _ in range(reps + 3):
        reset()
        flush.zero_()               # evict the 50 MB L2: snapshots arrive cold
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        pairs.append((start, end))
        torch.cuda.synchronize()
    return (statistics.median(s.elapsed_time(e) for s, e in pairs[3:]),
            statistics.median(host[3:]))


def time_geometry(torch, kernel, width, k, flush, reps=20):
    """Time one launch at a main-path geometry; check it against plain."""
    gen = torch.Generator(device="cuda").manual_seed(width + k)
    pristine = _arena(torch, gen, SLOTS, width, "float32", "cuda", 1000)
    snaps = [_arena(torch, gen, SLOTS, width, "float32", "cuda", 1000)
             for _ in range(k)]
    # every slot holds a live row (fully populated arenas)
    for a in [pristine] + snaps:
        a[2].fill_(width)
    acc = _clone(pristine)

    def reset():
        for d, s in zip(acc, pristine):
            d.copy_(s)

    want = kernel.enoki_merge_rows_plain(_clone(pristine), snaps)
    got = kernel.enoki_merge_rows(_clone(pristine), snaps)
    torch.cuda.synchronize()
    err = _max_abs_err(torch, got, want)
    if err != 0.0:
        raise AssertionError(f"kernel != plain at the {width}-wide geometry")

    # bytes the merge must move for THIS data: every version once, and for
    # each row a snapshot wins, the winner's row read and the accumulator's
    # row written, plus its metadata; vv read and written
    best = pristine[3].clone()
    for s in snaps:
        best = torch.maximum(best, s[3])
    winners = int((best > pristine[3]).sum())
    row_bytes = width * 4
    nbytes = ((k + 1) * SLOTS * 4 + winners * (2 * row_bytes + 20)
              + (k + 2) * 64 * 4)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3

    ms, host_ms = _median_ms(
        torch, lambda: kernel.enoki_merge_rows(acc, snaps), reset, flush,
        reps)
    plain_ms, plain_host_ms = _median_ms(
        torch, lambda: kernel.enoki_merge_rows_plain(acc, snaps), reset,
        flush, reps)
    library_ms = None
    if k == 1:
        take = (snaps[0][3] > pristine[3])[:, None]
        library_ms, _ = _median_ms(
            torch, lambda: torch.where(take, snaps[0][1], acc[1]), reset,
            flush, reps)
    return {"rows": SLOTS, "row_bytes": row_bytes, "k": k,
            "winning_rows": winners, "bytes": nbytes, "ms": ms,
            "host_ms": host_ms, "plain_ms": plain_ms,
            "plain_host_ms": plain_host_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "max_abs_err": err}


# ---------------------------------------------------------------------------
# phase 3: the main path, served
# ---------------------------------------------------------------------------

def register_handlers(torch, enoki_function, width):
    """Listing-1-style functions over one 64-slot keygroup whose static key
    set ("current" + 63 history keys) fills the arena."""
    hist = [f"h{i}" for i in range(SLOTS - 1)]

    @enoki_function(name="smoke_fill", keygroups=["smoke_kg"],
                    codec_width=width)
    def smoke_fill(kv, x):
        for i, key in enumerate(["current"] + hist):
            kv.set(key, (x[0] + i).expand(width))
        return x[:1]

    @enoki_function(name="smoke_ingest", keygroups=["smoke_kg"],
                    codec_width=width)
    def smoke_ingest(kv, x):
        cur, _ = kv.get("current")
        rows, _ = kv.scan(hist)
        kv.set("current", cur + x[0])
        return torch.stack([cur[0] + x[0], rows[:, 0].sum()])

    @enoki_function(name="smoke_peek", keygroups=["smoke_kg"],
                    codec_width=width)
    def smoke_peek(kv, x):
        cur, _ = kv.get("current")
        return cur[:2] + x[:2]


def build_cluster(device, width, measure_compute):
    """Ingest at both edges (the keygroup's replicas), the read-only peek at
    the far edge only, so reads there fold in the replicated writes."""
    import numpy as np
    from repro_torch.core import Cluster, get_function
    c = Cluster({"edge": "edge", "edge2": "edge", "cloud": "cloud"},
                measure_compute=measure_compute, device=device)
    example = np.zeros(8, np.float32)
    for fn, nodes in (("smoke_fill", ["edge", "edge2"]),
                      ("smoke_ingest", ["edge", "edge2"]),
                      ("smoke_peek", ["edge2"])):
        c.deploy(get_function(fn), nodes, value_width=width,
                 example_input=example)
    return c


def request_plan(n):
    """The request sequence: 3 of 4 mutating, integer-valued inputs (so the
    accumulated sums are exact in any order)."""
    import numpy as np
    return [("smoke_peek" if i % 4 == 3 else "smoke_ingest",
             np.full(8, float(i % 7 + 1), np.float32)) for i in range(n)]


def record_buckets(cluster, seen):
    """Wrap each batched handler to note the bucket sizes it is called with."""
    import functools
    for nd in cluster.nodes.values():
        for fn, bh in list(nd.batched_handlers.items()):
            def wrapped(store, clock, xs, valid, independent=False, _bh=bh):
                seen.add(int(valid.shape[0]))
                return _bh(store, clock, xs, valid, independent=independent)
            nd.batched_handlers[fn] = functools.wraps(bh)(wrapped)


def serve(cluster, plan):
    """Serve ``plan`` through one FaasServer: an open-loop burst of the first
    BURST requests (one arrival window, so the 256 bucket fills), then a
    closed loop of CONCURRENCY client threads for the rest.  Returns
    (results, per-request wall ms, wall seconds)."""
    from repro_torch.launch.faas_server import FaasServer
    n = len(plan)
    results, lat, done = [None] * n, [None] * n, [None] * n
    errors, lock = [], threading.Lock()
    nxt = iter(range(BURST, n))

    def client(srv):
        while True:
            with lock:
                i = next(nxt, None)
            if i is None:
                return
            t0 = time.perf_counter()
            try:
                results[i] = srv.submit(*plan[i]).result(timeout=300)
            except BaseException as e:     # re-raised after the join
                errors.append(e)
                return
            lat[i] = (time.perf_counter() - t0) * 1e3

    def stamp(i):
        return lambda _: done.__setitem__(i, time.perf_counter())

    with FaasServer(cluster, window_ms=WINDOW_MS, time_scale=1.0,
                    workers=2) as srv:
        t_start = time.perf_counter()
        burst = []
        for i in range(BURST):
            t0 = time.perf_counter()
            fut = srv.submit(*plan[i])
            fut.add_done_callback(stamp(i))
            burst.append((i, t0, fut))
        for i, t0, fut in burst:
            results[i] = fut.result(timeout=300)
        threads = [threading.Thread(target=client, args=(srv,))
                   for _ in range(CONCURRENCY)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t_start
        if any(t.is_alive() for t in threads):
            raise RuntimeError("serving clients did not finish")
    if errors:
        raise errors[0]
    for i, t0, _ in burst:
        lat[i] = (done[i] - t0) * 1e3
    return results, lat, wall


def run_main_path(torch, kernel, width, device, plan):
    """Fill, serve, flush on ``device``; returns (cluster, stats dict)."""
    from repro_torch.device import synchronize
    c = build_cluster(device, width, measure_compute=True)
    prewarm = c.engine.prewarm()
    buckets = set()
    record_buckets(c, buckets)
    # -- the counted run: counts zeroed just before the path is driven
    kernel.enoki_merge_rows.launches = 0
    d0 = c.stats.merge_dispatches
    c.invoke("smoke_fill", "edge", torch.ones(8).numpy())
    results, lat, wall = serve(c, plan)
    c.flush_replication()
    synchronize(c.device)
    launches = kernel.enoki_merge_rows.launches
    merges = c.stats.merge_dispatches - d0
    return c, {"prewarm_runs": prewarm, "buckets": sorted(buckets),
               "results": results, "lat": lat, "wall": wall,
               "launches": launches, "merges": merges}


def cpu_twin(width, plan):
    """The same requests through the port on the CPU (plain versions)."""
    import numpy as np
    c = build_cluster("cpu", width, measure_compute=False)
    c.invoke("smoke_fill", "edge", np.ones(8, np.float32))
    for fn in ("smoke_ingest", "smoke_peek"):
        xs = [x for f, x in plan if f == fn]
        c.invoke_batch(fn, "edge" if fn == "smoke_ingest" else "edge2", xs)
    c.flush_replication()
    return c


def check_main_path(torch, c, twin, st, plan):
    from repro_torch.core.store import to_numpy
    edge, edge2 = c.store_of("smoke_kg", "edge"), c.store_of("smoke_kg",
                                                               "edge2")
    for t in edge + edge2:
        assert t.is_cuda, "arena left the card"
    assert all(torch.equal(a, b) for a, b in zip(edge, edge2)), \
        "replicas differ after the flush"
    assert c.stats.merge_aligned > 0 and c.stats.merge_fallback == 0, \
        c.stats
    assert st["launches"] == st["merges"] > 0, (st["launches"], st["merges"])
    assert {64, 256} <= set(st["buckets"]), st["buckets"]
    for node in ("edge", "edge2"):
        for a, b in zip(c.store_of("smoke_kg", node),
                        twin.store_of("smoke_kg", node)):
            assert (to_numpy(a) == to_numpy(b)).all(), f"CPU twin differs at {node}"
    served = [r for r in st["results"] if r is not None]
    assert len(served) == len(plan) >= 512
    for r in served:
        out = r.output
        assert out.shape == (2,) and all(math.isfinite(float(v)) for v in out)
    # "current" = fill value 1 + every ingested x[0], exactly
    expect = 1.0 + sum(float(x[0]) for f, x in plan if f == "smoke_ingest")
    got = float(c.store_of("smoke_kg", "edge").values[0, 0])
    assert got == expect, (got, expect)


def time_batches(cluster, plan):
    """Wall ms per request of one ``invoke_batch`` of the ingest handler at
    the 64 and 256 buckets, after the checks (it writes to the arena).
    ``output`` is a host array, so each call ends with the card drained."""
    xs = [x for f, x in plan if f == "smoke_ingest"]
    out = {}
    for n in (64, 256):
        cluster.invoke_batch("smoke_ingest", "edge", xs[:n])    # warm
        t0 = time.perf_counter()
        cluster.invoke_batch("smoke_ingest", "edge", xs[:n])
        out[str(n)] = (time.perf_counter() - t0) * 1e3 / n
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from repro_torch.core import enoki_function
        from repro_torch.kernels import build
        from repro_torch.kernels.enoki_merge import kernel
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2

    # -- 1. device and build
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    built = build.build_all()
    emit({"phase": "build", "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc_s": built, "build_s": time.perf_counter() - t0})

    # -- 2. kernels against their plain versions
    worst, cases = check_sweep(torch, kernel)
    emit({"phase": "kernel_sweep", "kernel": "enoki_merge_rows",
          "cases": cases, "max_abs_err": worst})
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device="cuda")
    timings = {}
    for width, label in ((ROW_100KB, "100KB"), (ROW_1MB, "1MB")):
        for k in (1, 8):
            timings[(label, k)] = t = time_geometry(torch, kernel, width, k,
                                                    flush)
            emit({"phase": "kernel_time", "kernel": "enoki_merge_rows",
                  "geometry": label, "nvidia_smi": smi, **t})
    del flush

    # -- 3. the main path, served
    register_handlers(torch, enoki_function, ROW_100KB)
    plan = request_plan(N_REQUESTS)
    c, st = run_main_path(torch, kernel, ROW_100KB, "cuda", plan)
    twin = cpu_twin(ROW_100KB, plan)
    check_main_path(torch, c, twin, st, plan)
    batch_ms = time_batches(c, plan)
    lat = sorted(st["lat"])
    emit({"phase": "serve", "requests": len(plan),
          "requests_per_s": len(plan) / st["wall"], "wall_s": st["wall"],
          "p50_ms": statistics.median(lat),
          "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
          "buckets": st["buckets"], "prewarm_runs": st["prewarm_runs"],
          "merge_dispatches": st["merges"],
          "merge_snapshots": c.stats.merge_snapshots,
          "merge_aligned": c.stats.merge_aligned,
          "merge_fallback": c.stats.merge_fallback,
          "kernel_launches": st["launches"],
          "launches_per_request": st["launches"] / len(plan),
          "batch_ms_per_request": batch_ms,
          "replicas_identical": True, "cpu_twin_identical": True,
          "nvidia_smi": smi})

    # -- 4. the kernels line, the card, the result
    t = timings[("100KB", 1)]
    emit({"kernels": [{
        "name": "enoki_merge_rows", "route": "cuda", "source": MERGE_SOURCE,
        "replaces": MERGE_REPLACES, "launches": st["launches"],
        "max_abs_err": max(worst, t["max_abs_err"]), "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
