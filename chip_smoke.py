#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card, and check it.

    python3 chip_smoke.py        # from the repository root; one CUDA card

Phases, each printing one JSON line (any failure raises and exits non-zero):

1. device and build — the card, its power limit, and the time ``nvcc``
   takes to build every kernel from ``src/repro_torch/kernels/*/csrc``
   (one ``nvcc`` per source, all started together); then the registers,
   static shared memory and spills that ``-Xptxas=-v`` reported for the
   wgmma flash kernel (by head dim, D=256 included), the three SSD
   kernels, the two mLSTM kernels and the merge kernel;
2. the merge kernel against its plain version on the card — ``enoki_merge_rows``
   (snapshot pointers by value, a row's chunk blocks one cluster) bit-exact
   over a sweep of shapes, payload dtypes (f32, bf16, int32, uint8) and
   snapshot counts K, K = 65 folding in two launches, then timed (CUDA
   events, medians, L2
   flushed between launches, the host's enqueue cost reported apart) at
   the main path's geometry: fully populated
   slot-aligned arenas of 64 slots with random versions, with rows of
   100 KB (25,600 f32) and 1 MB (262,144 f32), beside its device-memory
   byte bound at 3.35 TB/s, its plain version and one ``torch.where``;
3. the FaaS main path, served — a ``Cluster`` on the paper topology with a
   REPLICATED 64-slot keygroup of 100 KB rows on the two edges, a
   Listing-1-style mutating handler whose static key set fills the arena
   and a read-only handler at the far edge; >= 512 requests through
   ``FaasServer`` (an open-loop burst, then a closed loop, so the 64- and
   256-request buckets both run); replication flushed; replicas byte-identical, aligned
   merges only, the kernel launched exactly once per merge, and a CPU twin
   of the same requests (plain versions) ending in the same arenas.  The
   batched fold is a captured CUDA graph per (bucket block, arena):
   ``prewarm`` captures them (count, ms) and serving captures none; then
   the ``warm`` phase, ``tests/test_perf_paths.py``'s guarantee at the
   served width: the handlers on three nodes, prewarm, a settling round,
   3 warm rounds of every bucket on every node with ZERO captures
   (``analysis.jitprof.CompileCounter``), fold ms a request by bucket,
   replicas byte-identical and equal to a CPU twin, one launch per merge,
   and one batched dispatch of 64 at >= 2.5x the throughput of 64
   sequential invokes (the reference's floor and method);
4. crash, partition and checkpoint recovery (``repro_torch.runtime`` and
   ``repro_torch.checkpoint``) at the served width, every catch-up, drain
   and delivery merge through ``enoki_merge_rows``: (a) the seeded chaos
   plan of ``tests/test_partition_tolerance.py`` (seed 7, 12 rounds: lossy
   links, a partition and a crash + restore of edge2) over the keygroup
   REPLICATED on edge, edge2 and cloud — accounting balanced, replicas
   byte-identical with "current" = the number of writes, byte-identical
   to the fault-free twin on the card and to a CPU twin of the faulty run,
   aligned merges only and one launch per merge; (b) a PEER_FETCH keygroup
   of 1 MB rows (64 MB) owned by edge checkpointed, written past the
   checkpoint, its sole replica crashed and revived on edge2 from the file
   equal to the checkpointed arena, a routed invoke continuing from it,
   and the same file restored onto the card and onto the CPU leaf for
   leaf; (c) 256 requests through ``FaasServer`` with the membership
   attached, edge2 killed while they are in flight — every one served by
   edge within 30 s — then edge2 restored byte-identical to edge;
   then pod-axis replication (``core/replication.py``): P = 2 and 4 pods
   of one slot-aligned arena of 64 x 1 MB (64 MB a pod) stacked on the
   card, keys from one ``store_assign_slots`` layout, versions in 1..1000
   and payloads seeded, every 4th slot one write replicated to every pod;
   one ``make_pod_replicate_step`` round with ``merge_arena_aligned`` over
   "full" and P - 1 rounds over "ring": every pod byte-identical, full and
   ring alike, full equal to ``converge`` over the pods as a logical list,
   each equal to its CPU twin (the same seed through the plain version),
   one ring round's pod i equal to merge(pod i, pod i + 1), the kernel
   launched once per merge; ``merge_arena`` (plain PyTorch) gives the same
   bytes with no launch; ms a round for both topologies beside the byte
   bound (every arena of the stack read once and written once);
5. ``flash_attention_bhsd`` against its plain version on the card: f32
   (2e-5) and bf16 (2e-2, the reference's own tolerances) over the
   reference's sweep shapes, head dims 112, 96 and 256 (an odd number of
   128-row query tiles too), a ragged S=100, Sq=100 against Skv=300,
   Sq=128 against Skv=256 and the internlm2 prefill geometry, causal,
   non-causal and window 64, directly and through the model-layout
   wrapper, and zamba2's shared-block geometry (B=4, S=4096, H=KV=32,
   D=112, bf16, causal, window 4096); every bf16 case is also held, row
   by row at the output's own scale, to the error that the plain
   version's bf16 rounding makes against the same function in f32; then
   timed at four prefill geometries
   (internlm2's D=128, zamba2's D=112, phi-3-vision's D=96 with H=KV=32,
   gemma-7b's D=256 with H=KV=16; B=4, S=4096) beside its tensor-core FLOP
   bound, its plain version and ``scaled_dot_product_attention``; after
   each of these and after every prefill of phase 8 the kernel's give-up
   word is read (``check_give_ups``: a D=256 wait that gave up raises);
6. ``ssd_chunk_bhcp`` (three kernels a call) against its plain version
   on the card, y and the final state: f32 (1e-4) and bf16 (5e-2, the
   reference's tolerances) over the reference's sweep shapes, ragged S and
   the main-path geometry (B=4, H=112, S=4096, P=N=64, chunk 128, f32),
   directly and through the model-layout wrapper; then timed there beside
   its bound (3xTF32 tensor cores or bytes), its f32 FMA bound and its
   plain version (no single PyTorch call computes the scan);
7. ``mlstm_chunk_bhsd`` (q kᵀ of every chunk at once, then ceil(d/64) CTAs
   per (b, h) for the chunk loop, 3xTF32 tensor cores) against its plain
   version on the card, h and the final
   carry (C, n, m): f32 (1e-4) and bf16 (5e-2, the reference's tolerances)
   over the reference's sweep shapes, head dims 80 (a ragged column tile),
   128 and 512, and the main-path geometry (B=4, H=4, S=2048, d=512, chunk
   64, f32), directly and through the model-layout wrapper; then timed there
   beside its bound (3xTF32 tensor cores or bytes), its f32 FMA bound, its
   plain version (no single PyTorch call computes the chunkwise mLSTM);
8. the sessions path, served, for each of six models at full width with
   bf16 weights from a seed — internlm2-1.8b (dense), zamba2-7b (hybrid:
   Mamba-2 states and a ring-cached shared attention block), xlstm-350m
   (recurrent: mLSTM matrix memories and sLSTM cells), grok-1-314b (moe, 8
   experts of 32,768, top-2; depth cut to 4 of its 64 layers, 42.6 GB of
   weights), phi-3-vision-4.2b (vlm: 576 seeded patch embeddings in front
   of the text, head dim 96) and whisper-tiny (audio: an encoder over 1,500
   seeded frame embeddings, a decoder with cross-attention): 2 pods x 4
   sessions prefill 4,096-token prompts (xlstm: 2,048; whisper: 384)
   through the kernels (internlm2: 2 x 24 attention launches; zamba2: 2 x
   81 SSD and 2 x 13 attention launches; xlstm: 2 x 21 mLSTM launches;
   grok-1: 2 x 4; phi-3-vision: 2 x 32; whisper: 2 x (4 encoder + 4
   decoder) attention launches), the FLASH prefill's logits agree with the
   REFERENCE path's (rel < 5e-2; grok-1's on the tokens whose routes agree
   on both paths, the differing routes counted), 60 greedy decode
   steps (zamba2's wrap its 4,096-slot ring) with ``replicate_sessions``
   every R=8 and every leaf of each backup equal to its peer's live state,
   pod 0 fails and ``migrate_sessions`` restores it with staleness 4 <= R, 4
   more steps; then one pod's prefill and one pod's decode step under
   ``torch.profiler`` (device ms by kernel kind, idle share, launches).
   Decode is one captured graph a pod-step (2 captures: the live cache,
   then the migrated one), held against the eager pod-step for 4 steps on
   copies of the state (tokens and every leaf equal; both timed) and
   profiled (host graph launches against device kernels); xlstm's sLSTM
   scan replays 64-step graphs: prefill ms of the capturing pod and the
   warm one, and the scan against the eager loop, bit for bit, at the
   prompt's length and at a ragged 100; then gemma-7b (head dim 256) at
   full width and depth, one pod's prefill only: 28 attention launches, the
   FLASH logits against the REFERENCE path's (rel < 5e-2), profiled;
9. the smoke's seconds, the ``{"kernels": [...]}`` line (the merge
   kernel's launches by path: served, warm, runtime and replication;
   flash's by model, its give-ups (0) and its times at the four
   geometries), then the card's name and power limit
   as ``nvidia-smi`` reports them, then ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
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
SWEEP_K = (1, 2, 5, 8, 65)     # 65: past the 64 records a launch takes
DTYPES = ("float32", "bfloat16", "int32", "uint8")
N_REQUESTS, BURST, CONCURRENCY = 544, 320, 32
SPIN_CYCLES = 2_000_000         # ~1 ms of card time: longer than any enqueue
WINDOW_MS = 20.0
# the runtime phase: tests/test_partition_tolerance.py's chaos plan
CHAOS_SEED, CHAOS_ROUNDS = 7, 12
RT_NODES = ("edge", "edge2", "cloud")
N_CRASH_REQUESTS = 256
# the replication phase: P pods of one slot-aligned 64 x 1 MB arena stacked
# on the card (the checkpoint phase's width), one slot in TIE_EVERY holding
# the same write on every pod (its version, payload and length)
REPL_PODS = (2, 4)
REPL_SEED, TIE_EVERY = 11, 4
MERGE_SOURCE = "src/repro_torch/kernels/enoki_merge/csrc/enoki_merge.cu"
MERGE_REPLACES = "src/repro/kernels/enoki_merge/kernel.py:37"
FLASH_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                "flash_attention.cu")
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:75"
SSD_SOURCE = "src/repro_torch/kernels/ssd_chunk/csrc/ssd_chunk.cu"
SSD_REPLACES = "src/repro/kernels/ssd_chunk/kernel.py:65"
MLSTM_SOURCE = "src/repro_torch/kernels/mlstm_chunk/csrc/mlstm_chunk.cu"
MLSTM_REPLACES = "src/repro/kernels/mlstm_chunk/kernel.py:80"
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor cores (data sheet)
F32_FLOPS_PER_S = 66.9e12       # H100 SXM f32 FMAs, no tensor cores (data sheet)
TF32_FLOPS_PER_S = 495e12       # H100 SXM dense TF32 tensor cores (data sheet)
# the SSD and mLSTM kernels run every product as three TF32 products (3xTF32)
SSD_PRODUCT_FLOPS_PER_S = TF32_FLOPS_PER_S / 3
# the kernels whose registers, shared memory and spills the build reports:
# (library, kernel)
RESOURCE_KERNELS = (("flash_attention", "flash_fwd_bf16_wgmma"),
                    ("ssd_chunk", "ssd_chunk_state_kernel"),
                    ("ssd_chunk", "ssd_chunk_pass_kernel"),
                    ("ssd_chunk", "ssd_chunk_scan_kernel"),
                    ("mlstm_chunk", "mlstm_qk_kernel"),
                    ("mlstm_chunk", "mlstm_chunk_kernel"),
                    ("enoki_merge", "enoki_merge_rows_kernel"))
# (B, Sq, Skv, H, KV, D): tests/test_kernels.py's sweep, head dim 112 (zamba2's
# shared block), a ragged S, Sq != Skv, head dims 96 (phi-3-vision) and 256
# (gemma-7b) square, ragged and uneven, D=256 over five 128-row query tiles
# (an odd number; GQA), and internlm2's prefill geometry (last)
FLASH_CASES = [(1, 128, 128, 4, 4, 32), (2, 256, 256, 4, 2, 64),
               (1, 512, 512, 8, 2, 32), (2, 128, 128, 2, 1, 128),
               (1, 128, 128, 4, 4, 112), (1, 100, 100, 4, 2, 64),
               (1, 128, 256, 4, 2, 64), (1, 128, 128, 4, 4, 96),
               (2, 100, 100, 4, 2, 96), (1, 128, 128, 4, 4, 256),
               (2, 100, 300, 4, 2, 256), (1, 640, 640, 4, 2, 256),
               (4, 4096, 4096, 16, 8, 128)]
FLASH_MASKS = [(True, 0), (False, 0), (True, 64), (False, 64)]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# bf16 outputs are held to at most this multiple of the plain version's own
# bf16 rounding error against the f32 function (row-scaled, max and mean):
# the kernel rounds at the same points (p, the output), so its error is that
# rounding up to summation order; a mis-weighted tile shows as a multiple
BF16_ROUNDING_FACTOR = 2.0
# B, S, H, KV, D, window of one prefill attention layer: internlm2-1.8b's,
# and zamba2-7b's shared block (bf16, causal)
MAIN_FLASH = (4, 4096, 16, 8, 128, 0)
ZAMBA_FLASH = (4, 4096, 32, 32, 112, 4096)
# phi-3-vision-4.2b's and gemma-7b's prefill layers (bf16, causal)
PHI_FLASH = (4, 4096, 32, 32, 96, 0)
GEMMA_FLASH = (4, 4096, 16, 16, 256, 0)
# (B, H, S, P, N, chunk): tests/test_kernels.py's sweep, ragged S (a last
# chunk of 72 and of 4 rows), in f32 and bf16; then the main path's geometry
# (zamba2-7b's Mamba-2 prefill, f32 as the model feeds it)
SSD_CASES = [(1, 2, 128, 32, 16, 32), (2, 4, 256, 64, 64, 64),
             (1, 1, 64, 16, 8, 16), (1, 3, 200, 64, 64, 128),
             (2, 2, 100, 32, 16, 32)]
SSD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
MAIN_SSD = (4, 112, 4096, 64, 64, 128)
# (B, H, S, d, chunk): tests/test_kernels.py's sweep, reduced xlstm-350m's
# head dim 128, xlstm-350m's 512 and a ragged column tile (d=80: two CTAs a
# (b, h), the second 16 columns wide; chunk 20), in f32 and bf16; then the
# main path's
# geometry (one xlstm-350m mLSTM layer's prefill, f32 as the model feeds it)
MLSTM_CASES = [(1, 2, 128, 32, 32), (2, 2, 64, 64, 16), (1, 4, 256, 16, 64),
               (2, 2, 128, 128, 16), (1, 2, 256, 512, 64), (1, 3, 100, 80, 20)]
MLSTM_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
MAIN_MLSTM = (4, 4, 2048, 512, 64)
# sessions path: 2 pods x 4 sessions for each model; 4,096-token prompts,
# 2,048 for xlstm-350m (the xLSTM paper's training context, which also keeps
# its sequential sLSTM loop inside the smoke's time), 384 for whisper-tiny
# (with 64 decode positions its cache is 448, whisper's decoder context);
# phi-3-vision's prompt holds 576 patch positions and 3,520 text tokens
SESSION_ARCHS = ("internlm2-1.8b", "zamba2-7b", "xlstm-350m", "grok-1-314b",
                 "phi-3-vision-4.2b", "whisper-tiny")
PROMPTS = {"internlm2-1.8b": 4096, "zamba2-7b": 4096, "xlstm-350m": 2048,
           "grok-1-314b": 4096, "phi-3-vision-4.2b": 4096,
           "whisper-tiny": 384, "gemma-7b": 4096}
# depth cut to fit one card: grok-1's 64 layers hold 628 GB of bf16 weights;
# 4 layers at full width hold 42.6 GB (21.3 B parameters)
SESSION_LAYERS = {"grok-1-314b": 4}
# one pod's prefill only, FLASH against REFERENCE: gemma-7b (head dim 256)
PREFILL_ARCHS = ("gemma-7b",)
WARM_PROMPT = 256               # the prefill that warms the path
N_PODS, SESSIONS, CACHE_EXTRA = 2, 4, 64
DECODE_STEPS, FAILOVER_STEPS = 60, 4
GRAPH_CHECK_STEPS = 4           # decode graph against the eager pod-step
PREFILL_REL_TOL = 5e-2          # tests/test_arch_smoke.py's prefill/decode bound


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


def _median_ms(torch, fn, reset, flush, reps, spin=SPIN_CYCLES):
    """(device ms, host enqueue ms) of one ``fn()``, medians over ``reps``.

    The card spins (``spin`` cycles) before each timed call, so the host
    has enqueued the whole call before the start event runs: the events
    then time device work only, and the host's own cost of the call is
    reported apart."""
    pairs, host = [], []
    for _ in range(reps + 3):
        reset()
        flush.zero_()               # evict the 50 MB L2: snapshots arrive cold
        torch.cuda._sleep(spin)
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
# phase 3: the FaaS main path, served
# ---------------------------------------------------------------------------

def register_handlers(torch, enoki_function, width, prefix="smoke"):
    """Listing-1-style functions ``<prefix>_fill``/``_ingest``/``_peek``
    over one 64-slot keygroup ``<prefix>_kg`` whose static key set
    ("current" + 63 history keys) fills the arena."""
    hist = [f"h{i}" for i in range(SLOTS - 1)]
    kg = [f"{prefix}_kg"]

    @enoki_function(name=f"{prefix}_fill", keygroups=kg, codec_width=width)
    def smoke_fill(kv, x):
        for i, key in enumerate(["current"] + hist):
            kv.set(key, (x[0] + i).expand(width))
        return x[:1]

    @enoki_function(name=f"{prefix}_ingest", keygroups=kg,
                    codec_width=width)
    def smoke_ingest(kv, x):
        cur, _ = kv.get("current")
        rows, _ = kv.scan(hist)
        kv.set("current", cur + x[0])
        return torch.stack([cur[0] + x[0], rows[:, 0].sum()])

    @enoki_function(name=f"{prefix}_peek", keygroups=kg, codec_width=width)
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
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.mlstm_chunk import kernel as mk
    from repro_torch.kernels.ssd_chunk import kernel as sk
    from repro_torch.analysis.jitprof import CompileCounter
    c = build_cluster(device, width, measure_compute=True)
    synchronize(c.device)
    t0 = time.perf_counter()
    prewarm = c.engine.prewarm()
    prewarm_ms = (time.perf_counter() - t0) * 1e3
    captures, capture_ms = fold_captures(c)
    buckets = set()
    record_buckets(c, buckets)
    # -- the counted run: counts zeroed just before the path is driven
    kernel.enoki_merge_rows.launches = fk.flash_attention_bhsd.launches = 0
    sk.ssd_chunk_bhcp.launches = mk.mlstm_chunk_bhsd.launches = 0
    d0 = c.stats.merge_dispatches
    with CompileCounter() as cc:
        c.invoke("smoke_fill", "edge", torch.ones(8).numpy())
        results, lat, wall = serve(c, plan)
        c.flush_replication()
        synchronize(c.device)
    assert cc.events == 0, f"{cc.events} fold captures while serving"
    launches = kernel.enoki_merge_rows.launches
    assert fk.flash_attention_bhsd.launches == 0, "attention on the FaaS path"
    assert sk.ssd_chunk_bhcp.launches == 0, "an SSD scan on the FaaS path"
    assert mk.mlstm_chunk_bhsd.launches == 0, "an mLSTM on the FaaS path"
    merges = c.stats.merge_dispatches - d0
    return c, {"prewarm_runs": prewarm, "prewarm_ms": prewarm_ms,
               "prewarm_captures": captures,
               "prewarm_capture_ms": capture_ms, "serve_captures": cc.events,
               "buckets": sorted(buckets),
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


def fold_steps(cluster):
    """Every batched handler's fold step cache."""
    return [bh.steps for nd in cluster.nodes.values()
            for bh in nd.batched_handlers.values()]


def fold_captures(cluster):
    """(captures, host ms) of the cluster's fold step caches."""
    steps = fold_steps(cluster)
    return (sum(st.captures for st in steps),
            sum(st.capture_ms for st in steps))


def warm_cluster(device, width):
    """The served handlers on three nodes, the keygroup REPLICATED on all
    three (``tests/test_perf_paths.py``'s warm-serving layout)."""
    import numpy as np
    from repro_torch.core import Cluster, get_function
    c = Cluster({n: ("cloud" if n == "cloud" else "edge") for n in RT_NODES},
                measure_compute=False, device=device)
    example = np.zeros(8, np.float32)
    for fn, nodes in (("smoke_fill", RT_NODES), ("smoke_ingest", RT_NODES),
                      ("smoke_peek", ("edge2",))):
        c.deploy(get_function(fn), list(nodes), value_width=width,
                 example_input=example)
    c.invoke("smoke_fill", "edge", np.ones(8, np.float32))    # "current" = 1
    return c


def warm_round(cluster, fold_ms=None):
    """Every bucket of the ingest handler on every node, a peek batch at
    edge2, replication flushed; each batch's wall ms a request (its outputs
    are host arrays, so the card is drained) into ``fold_ms[bucket]``."""
    import numpy as np
    from repro_torch.core.engine import DEFAULT_BUCKETS
    x = np.full(8, 2.0, np.float32)
    for node in RT_NODES:
        for b in DEFAULT_BUCKETS:
            t0 = time.perf_counter()
            cluster.invoke_batch("smoke_ingest", node, [x] * b)
            if fold_ms is not None:
                fold_ms.setdefault(b, []).append(
                    (time.perf_counter() - t0) * 1e3 / b)
    cluster.invoke_batch("smoke_peek", "edge2", [x] * 8)
    cluster.flush_replication()


def batched_vs_sequential(torch, device, n=64, repeats=5, warmup=1):
    """``tests/test_perf_paths.py``'s §4.2 measurement through the port on
    ``device``: one ``invoke_batch`` of ``n`` against ``n`` sequential
    ``invoke``s of its 8-wide accumulator, each pass ending with the
    device drained; ``warmup`` unrecorded rounds, then ``repeats`` rounds
    visiting both in turn; median ops/s of each and their ratio."""
    import numpy as np
    from repro_torch.core import Cluster, enoki_function, get_function
    from repro_torch.core.faas import registry
    from repro_torch.device import synchronize
    if "perfthr_acc" not in registry():
        @enoki_function(name="perfthr_acc", keygroups=["perfthrkg"],
                        codec_width=8)
        def perfthr_acc(kv, x):
            cur, _ = kv.get("acc")
            kv.set("acc", cur + x)
            return cur[:1] + x[:1]
    c = Cluster({"edge": "edge"}, measure_compute=False, device=device)
    c.deploy(get_function("perfthr_acc"), ["edge"])
    x = np.ones((8,), np.float32)

    def sequential():
        for i in range(n):
            c.invoke("perfthr_acc", "edge", x, t_send=float(i))
        synchronize(c.device)

    def batched():
        c.invoke_batch("perfthr_acc", "edge", [x] * n)
        synchronize(c.device)

    variants = {"sequential": sequential, "batched": batched}
    for _ in range(warmup):
        for fn in variants.values():
            fn()
    samples = {k: [] for k in variants}
    for _ in range(repeats):
        for k, fn in variants.items():
            t0 = time.perf_counter()
            fn()
            samples[k].append(n / (time.perf_counter() - t0))
    med = {k: statistics.median(v) for k, v in samples.items()}
    return {"requests": n, "repeats": repeats,
            "batched_ops_per_s": med["batched"],
            "sequential_ops_per_s": med["sequential"],
            "ratio": med["batched"] / med["sequential"]}


def check_warm(torch, counters, width):
    """``tests/test_perf_paths.py``'s zero-compile guarantee at the served
    width: ``prewarm`` captures every fold graph (count, ms); a settling
    round; then 3 warm rounds under ``CompileCounter``, which must count 0;
    replicas byte-identical, equal to a CPU twin of the same rounds, one
    merge launch per merge."""
    from repro_torch.analysis.jitprof import CompileCounter
    from repro_torch.core.store import to_numpy
    from repro_torch.device import synchronize
    c = warm_cluster("cuda", width)
    synchronize(c.device)
    t0 = time.perf_counter()
    runs = c.engine.prewarm()
    prewarm_ms = (time.perf_counter() - t0) * 1e3
    captures, capture_ms = fold_captures(c)
    warm_round(c)                                   # settling round
    d0 = c.stats.merge_dispatches
    _zero(counters)
    fold_ms = {}
    with CompileCounter() as cc:
        for _ in range(3):
            warm_round(c, fold_ms)
        synchronize(c.device)
    launches = _merge_launches(counters)
    merges = c.stats.merge_dispatches - d0
    assert cc.events == 0, f"{cc.events} captures in warm rounds"
    assert fold_captures(c)[0] == captures
    assert launches == merges > 0, (launches, merges)
    assert c.stats.merge_fallback == 0, c.stats
    twin = warm_cluster("cpu", width)
    for _ in range(4):
        warm_round(twin)
    edge = c.store_of("smoke_kg", "edge")
    for node in RT_NODES:
        for x, y, z in zip(edge, c.store_of("smoke_kg", node),
                           twin.store_of("smoke_kg", node)):
            assert x.is_cuda and torch.equal(x, y), f"replica {node} differs"
            assert (to_numpy(y) == to_numpy(z)).all(), \
                f"CPU twin differs at {node}"
    ratio = batched_vs_sequential(torch, "cuda")
    assert ratio["ratio"] >= 2.5, ratio     # tests/test_perf_paths.py's floor
    return {"prewarm_runs": runs, "prewarm_ms": prewarm_ms,
            "prewarm_captures": captures, "prewarm_capture_ms": capture_ms,
            "warm_rounds": 3, "warm_captures": cc.events,
            "replays": sum(st.replays for st in fold_steps(c)),
            "fold_ms_per_request": {str(b): statistics.median(v)
                                    for b, v in fold_ms.items()},
            "merge_dispatches": merges, "kernel_launches": launches,
            "replicas_identical": True, "cpu_twin_identical": True,
            "batched_vs_sequential": ratio}


# ---------------------------------------------------------------------------
# phase 4: crash, partition and checkpoint recovery (the runtime)
# ---------------------------------------------------------------------------

def _timed(device, fn, into):
    """``fn`` with the card synchronised around each call, its wall ms
    appended to ``into``."""
    from repro_torch.device import synchronize

    def run(*args, **kwargs):
        synchronize(device)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        synchronize(device)
        into.append((time.perf_counter() - t0) * 1e3)
        return out
    return run


def _zero(counters):
    for k in counters:
        k.launches = 0


def _merge_launches(counters) -> int:
    """The merge kernel's count; every other kernel must not have run."""
    got = {k.__name__: k.launches for k in counters}
    assert all(v == 0 for name, v in got.items()
               if name != "enoki_merge_rows"), got
    return got["enoki_merge_rows"]


def chaos_run(device, width, apply_faults, counters=()):
    """``tests/test_partition_tolerance.py``'s chaos run over the served
    keygroup, REPLICATED on all three nodes: seed 7, 12 rounds, victim
    edge2, a +1 write per writer per round each followed by a drain, and a
    probe at edge2 (the read-only peek, deployed there only).  The
    ``counters`` are zeroed just before the run and read just after it."""
    import numpy as np
    from repro_torch.core import Cluster, get_function
    from repro_torch.device import synchronize
    from repro_torch.runtime import (ElasticMembership, FailureInjector,
                                     chaos_schedule, run_chaos)
    c = Cluster({n: ("cloud" if n == "cloud" else "edge") for n in RT_NODES},
                measure_compute=False, fault_seed=CHAOS_SEED, device=device)
    example = np.zeros(8, np.float32)
    for fn, nodes in (("smoke_fill", RT_NODES), ("smoke_ingest", RT_NODES),
                      ("smoke_peek", ("edge2",))):
        c.deploy(get_function(fn), list(nodes), value_width=width,
                 example_input=example)
    c.invoke("smoke_fill", "edge", np.zeros(8, np.float32))  # "current" = 0
    c.flush_replication()
    m = ElasticMembership(c)
    inj = FailureInjector(c, membership=m)
    plan = chaos_schedule(CHAOS_SEED, CHAOS_ROUNDS, RT_NODES, victim="edge2")
    times = {"crash_ms": [], "restore_ms": []}
    m.crash = _timed(c.device, m.crash, times["crash_ms"])
    m.restore = _timed(c.device, m.restore, times["restore_ms"])
    one = np.ones(8, np.float32)
    served, lost = [], []

    def write(node, r, t):
        c.invoke("smoke_ingest", node, one, t_send=t + 1.0)
        c.drain_transport(t + 1.0)

    def probe(r, t):
        ticket = c.engine.submit("smoke_peek", "edge2", one, t_send=t + 2.0)
        (served if ticket in c.engine.flush() else lost).append(r)

    synchronize(c.device)
    d0 = c.stats.merge_dispatches
    _zero(counters)
    t0 = time.perf_counter()
    run_chaos(c, m, inj, plan, write, probe=probe, apply_faults=apply_faults)
    synchronize(c.device)
    wall = (time.perf_counter() - t0) * 1e3
    launches = _merge_launches(counters) if counters else None
    return c, {"plan": plan, "served": served, "lost": lost, "wall_ms": wall,
               "merges": c.stats.merge_dispatches - d0, "launches": launches,
               "membership": m, **times}


def _same_arenas(torch, a, b, kg, what):
    """Every leaf of ``kg``'s arena equal, node by node (vv included)."""
    for node in RT_NODES:
        for x, y in zip(a.store_of(kg, node), b.store_of(kg, node)):
            assert torch.equal(x.cpu(), y.cpu()), f"{what} differs at {node}"


def check_chaos(torch, counters, width):
    """Part 1: the seeded chaos run on the card, its fault-free twin on the
    card, and a CPU twin of the faulty run (plain merges)."""
    c, r = chaos_run("cuda", width, True, counters)
    launches = r["launches"]
    plan, rounds = r["plan"], CHAOS_ROUNDS
    # (a) the engine's accounting balances; the crash window dropped probes
    st_ = c.engine.stats
    assert st_.submitted == st_.requests_flushed + st_.dropped_dead, st_
    assert r["lost"] and len(r["lost"]) == st_.dropped_dead, r["lost"]
    assert len(r["served"]) + len(r["lost"]) == rounds
    assert c.stats.repl_retries > 0, c.stats
    assert c.stats.repl_dropped > 0 or c.stats.repl_duped > 0, c.stats
    # (b) all three replicas byte-identical, and no write lost
    edge = c.store_of("smoke_kg", "edge")
    for node in RT_NODES:
        for x, y in zip(edge, c.store_of("smoke_kg", node)):
            assert x.is_cuda and torch.equal(x, y), f"replica {node} differs"
    writes = sum(len(plan.writers_for(i)) for i in range(rounds))
    assert float(edge.values[0, 0]) == writes, (float(edge.values[0, 0]),
                                                writes)
    # (e) aligned merges only, one launch per merge dispatch
    assert c.stats.merge_fallback == 0 and c.stats.merge_aligned > 0, c.stats
    assert launches == r["merges"] > 0, (launches, r["merges"])
    # (c) the fault-free twin on the card, byte-identical (vv included)
    twin, rt_ = chaos_run("cuda", width, False)
    assert (rt_["served"], rt_["lost"]) == (r["served"], r["lost"])
    _same_arenas(torch, c, twin, "smoke_kg", "fault-free twin")
    # (d) a CPU twin of the faulty run, plain merges
    cpu, rc = chaos_run("cpu", width, True)
    assert (rc["served"], rc["lost"]) == (r["served"], r["lost"])
    _same_arenas(torch, c, cpu, "smoke_kg", "CPU twin")
    assert _stats(cpu.stats) == _stats(c.stats), "transport counters differ"
    m = r["membership"]
    return {"rounds": rounds, "writes": writes, "served": len(r["served"]),
            "lost": len(r["lost"]), "events": len(plan.events),
            "repl_retries": c.stats.repl_retries,
            "repl_dropped": c.stats.repl_dropped,
            "repl_duped": c.stats.repl_duped,
            "epoch_rejections": c.stats.epoch_rejections,
            "dropped_deliveries": m.stats.dropped_deliveries,
            "caught_up": m.stats.caught_up,
            "merge_dispatches": r["merges"],
            "merge_snapshots": c.stats.merge_snapshots,
            "merge_fallback": c.stats.merge_fallback,
            "kernel_launches": launches, "wall_ms": r["wall_ms"],
            "crash_ms": r["crash_ms"], "restore_ms": r["restore_ms"],
            "twin_identical": True, "cpu_twin_identical": True}


def _stats(stats) -> dict:
    import dataclasses
    return {f.name: getattr(stats, f.name)
            for f in dataclasses.fields(stats) if not f.name.startswith("_")}


def check_checkpoint(torch, counters, ckpt_dir):
    """Part 2: a PEER_FETCH keygroup of 1 MB rows owned by edge is
    checkpointed, written past the checkpoint, and its sole replica
    crashes: the crash revives it on edge2 from the checkpoint
    (``tests/test_failure_recovery.py``'s checkpoint scenario at full
    width); then the same file restores onto the CPU."""
    import dataclasses
    import os

    import numpy as np
    from repro_torch.configs.base import ReplicationPolicy
    from repro_torch.core import Cluster, Router, get_function
    from repro_torch.core.keygroup import arena_new
    from repro_torch.core.store import arena_clone, stores_equal
    from repro_torch.core.versioning import MAX_NODES
    from repro_torch.device import synchronize
    from repro_torch.runtime import ElasticMembership
    c = Cluster({"edge": "edge", "edge2": "edge", "cloud": "cloud"},
                measure_compute=False, device="cuda")
    example = np.zeros(8, np.float32)
    for fn in ("ckpt_fill", "ckpt_ingest"):
        c.deploy(get_function(fn), ["edge", "edge2"],
                 policy=ReplicationPolicy.PEER_FETCH, owner="edge",
                 value_width=ROW_1MB, example_input=example)
    m = ElasticMembership(c, checkpoint_dir=ckpt_dir)
    one = np.ones(8, np.float32)
    d0 = c.stats.merge_dispatches
    _zero(counters)
    c.invoke("ckpt_fill", "edge", example)                   # "current" = 0
    c.invoke("ckpt_ingest", "edge", one, t_send=100.0)       # "current" = 1
    save_ms = []
    _timed(c.device, m.checkpoint, save_ms)("edge", 1)
    expected = arena_clone(c.store_of("ckpt_kg", "edge"))
    c.invoke("ckpt_ingest", "edge", one, t_send=200.0)       # not in the file
    crash_ms = []
    rehomed = _timed(c.device, m.crash, crash_ms)("edge")
    assert rehomed == {"ckpt_kg": "edge2"}, rehomed
    assert m.stats.checkpoint_restores == 1, m.stats
    revived = c.store_of("ckpt_kg", "edge2")
    assert all(t.is_cuda for t in revived), "the revived arena left the card"
    assert stores_equal(expected, revived), "revived arena != checkpoint"
    assert all(torch.equal(x, y) for x, y in zip(expected, revived))
    assert c.policies["ckpt_kg"].owner == "edge2", c.policies["ckpt_kg"]
    res = Router(c).invoke("ckpt_ingest", one, t_send=300.0)
    assert res.node == "edge2" and float(res.output[0]) == 2.0, res
    synchronize(c.device)
    launches = _merge_launches(counters)
    merges = c.stats.merge_dispatches - d0
    assert launches == merges, (launches, merges)
    # the same file, restored straight onto the card and onto the CPU
    mgr = m._ckpt("edge")
    kspec = c.policies["ckpt_kg"]
    restore_ms = []
    card = _timed(c.device, mgr.restore, restore_ms)(
        {"ckpt_kg": arena_new(kspec, MAX_NODES)})["ckpt_kg"]
    host = mgr.restore({"ckpt_kg": arena_new(
        dataclasses.replace(kspec, device="cpu"), MAX_NODES)})["ckpt_kg"]
    for x, y, z in zip(expected, card, host):
        assert y.is_cuda and z.device.type == "cpu"
        assert torch.equal(x, y) and torch.equal(x.cpu(), z), \
            "a restored leaf differs"
    raw = sum(t.numel() * t.element_size() for t in expected)
    path = mgr._path(mgr.latest_step())
    return {"row_bytes": ROW_1MB * 4, "raw_bytes": raw,
            "file_bytes": os.path.getsize(path),
            "codec": "zstd" if _zstd_frame(path) else "zlib",
            "save_ms": save_ms[0], "crash_ms": crash_ms[0],
            "restore_ms": restore_ms[0],
            "save_mb_per_s": raw / 1e6 / (save_ms[0] / 1e3),
            "restore_mb_per_s": raw / 1e6 / (restore_ms[0] / 1e3),
            "checkpoint_restores": m.stats.checkpoint_restores,
            "merge_dispatches": merges, "kernel_launches": launches}


def _zstd_frame(path) -> bool:
    with open(path, "rb") as f:
        return f.read(4) == b"\x28\xb5\x2f\xfd"


def _latencies(futs, done):
    """Sorted ms from each submit to its future's completion."""
    return sorted((d - t0) * 1e3 for (t0, _), d in zip(futs, done))


def _p50_p99(lat):
    return {"p50_ms": statistics.median(lat),
            "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))]}


def check_crash_serving(torch, counters, width):
    """Part 3: ``tests/test_faas_server.py``'s node death mid-serving at the
    served configuration: N_CRASH_REQUESTS ingests through a FaasServer
    with the membership attached, edge2 killed while they are in flight;
    then edge2 restored and caught up WHILE the survivors go on serving
    (one ingest every 2 ms until the restore returns): the restore makes
    edge2's fold graphs before the node is routable, and the latencies of
    the requests it overlapped say what that costs the others; a last
    wave after it makes no capture."""
    import numpy as np
    from repro_torch.analysis.jitprof import CompileCounter
    from repro_torch.device import synchronize
    from repro_torch.launch.faas_server import FaasServer, RequestLost
    from repro_torch.runtime import ElasticMembership, FailureInjector
    c = build_cluster("cuda", width, measure_compute=True)
    c.invoke("smoke_fill", "edge", np.ones(8, np.float32))   # "current" = 1
    c.flush_replication()
    c.engine.prewarm()
    m = ElasticMembership(c)
    inj = FailureInjector(c, membership=m)
    one = np.ones(8, np.float32)
    n = N_CRASH_REQUESTS
    synchronize(c.device)
    d0 = c.stats.merge_dispatches
    _zero(counters)
    e0 = c.engine.stats.dispatches

    def survivors():
        return sum(bh.steps.captures for node, nd in c.nodes.items()
                   if node != "edge2"
                   for bh in nd.batched_handlers.values())

    def submit(srv, futs, done):
        i = len(futs)
        done.append(None)
        fut = srv.submit("smoke_ingest", one)
        fut.add_done_callback(
            lambda _, i=i: done.__setitem__(i, time.perf_counter()))
        futs.append((time.perf_counter(), fut))

    def settle(futs):
        served = lost = 0
        for _, fut in futs:
            try:
                fut.result(timeout=30.0)
                served += 1
            except RequestLost:
                lost += 1
        return served, lost

    t_start = time.perf_counter()
    with FaasServer(c, window_ms=WINDOW_MS, time_scale=1.0,
                    membership=m) as srv:
        futs, done = [], []
        with CompileCounter() as cc:
            for _ in range(n):
                submit(srv, futs, done)
            kill_ms = []
            _timed(c.device, inj.kill_node, kill_ms)("edge2")
            served, lost = settle(futs)
        wall = time.perf_counter() - t_start
        assert wall < 30.0, wall
        assert all(f.done() for _, f in futs)
        assert served + lost == n and srv.stats.served == served, srv.stats
        assert served == n and lost == 0, (served, lost)
        assert m.state["edge2"] == "dead", m.state
        # the restore, overlapped by a stream of requests to the survivors
        restore_ms, caught = [], []
        rfuts, rdone = [], []
        s0 = survivors()
        with CompileCounter() as rc:
            th = threading.Thread(target=lambda: caught.append(_timed(
                c.device, m.restore, restore_ms)("edge2")))
            th.start()
            while th.is_alive():
                submit(srv, rfuts, rdone)
                time.sleep(0.002)
            th.join()
            rserved, rlost = settle(rfuts)
        assert caught == [["smoke_kg"]], caught
        assert (rserved, rlost) == (len(rfuts), 0), (rserved, rlost)
        assert survivors() == s0, "a survivor captured during the restore"
        assert rc.events > 0, "the restore made no fold graph"
        # after it: the restored node serves what it captured
        afuts, adone = [], []
        with CompileCounter() as ac:
            for _ in range(n):
                submit(srv, afuts, adone)
            assert settle(afuts) == (n, 0)
        assert ac.events == 0, f"{ac.events} captures after the restore"
    c.flush_replication()
    synchronize(c.device)
    launches = _merge_launches(counters)
    merges = c.stats.merge_dispatches - d0
    assert c.stats.merge_fallback == 0, c.stats
    assert launches == merges, (launches, merges)
    edge, edge2 = (c.store_of("smoke_kg", "edge"),
                   c.store_of("smoke_kg", "edge2"))
    assert all(torch.equal(x, y) for x, y in zip(edge, edge2)), \
        "the restored replica differs"
    writes = 1.0 + 2 * n + len(rfuts)
    assert float(edge.values[0, 0]) == writes, (float(edge.values[0, 0]),
                                                writes)
    return {"requests": n, "served": served, "lost": lost,
            "requests_per_s": n / wall, "wall_s": wall,
            **_p50_p99(_latencies(futs, done)),
            "kill_ms": kill_ms[0], "restore_ms": restore_ms[0],
            "captures": cc.events,
            "during_restore": {"requests": len(rfuts),
                               "restore_captures": rc.events,
                               "survivor_captures": 0,
                               **_p50_p99(_latencies(rfuts, rdone))},
            "after_restore": {"requests": n, "captures": ac.events,
                              **_p50_p99(_latencies(afuts, adone))},
            "dispatches": c.engine.stats.dispatches - e0,
            "crashes": m.stats.crashes, "caught_up": m.stats.caught_up,
            "merge_dispatches": merges, "kernel_launches": launches}


# ---------------------------------------------------------------------------
# phase 4b: pod-axis replication (core/replication.py)
# ---------------------------------------------------------------------------

def replication_state(torch, pods, width):
    """``pods`` slot-aligned arenas of SLOTS x ``width`` f32 stacked on a
    leading pod dim, on the CPU, from REPL_SEED: keys from one
    ``store_assign_slots`` layout, versions in 1..1000, payloads, lengths
    and vv seeded; one slot in TIE_EVERY holds pod 0's write on every pod
    (one write already replicated: equal versions, equal rows)."""
    from repro_torch.core.store import Store, store_assign_slots, store_new
    from repro_torch.core.versioning import MAX_NODES, fnv1a
    gen = torch.Generator().manual_seed(REPL_SEED + pods)
    layout, ok = store_assign_slots(
        store_new(SLOTS, 1, MAX_NODES, device="cpu"),
        {fnv1a(f"replica/{i}"): i for i in range(SLOTS)})
    assert ok and bool((layout.keys != 0).all())
    versions = torch.randint(1, 1001, (pods, SLOTS), generator=gen,
                             dtype=torch.int32)
    values = torch.randn((pods, SLOTS, width), generator=gen)
    lengths = torch.randint(0, width + 1, (pods, SLOTS), generator=gen,
                            dtype=torch.int32)
    tied = torch.arange(0, SLOTS, TIE_EVERY)
    for t in (versions, values, lengths):
        t[:, tied] = t[0, tied]
    return Store(keys=layout.keys.expand(pods, SLOTS).contiguous(),
                 values=values, lengths=lengths, versions=versions,
                 vv=torch.randint(0, 1000, (pods, MAX_NODES), generator=gen,
                                  dtype=torch.int32))


def _pod(state, i):
    return type(state)(*(x[i] for x in state))


def _same_stores(torch, a, b, what):
    for f, x, y in zip(a._fields, a, b):
        assert torch.equal(x.cpu(), y.cpu()), f"{what}: {f} differs"


def check_replication(torch, counters, flush, width=ROW_1MB):
    """``make_pod_replicate_step`` over REPL_PODS pods on the card, with
    ``merge_arena_aligned`` (the merge kernel) and ``merge_arena`` (plain
    PyTorch): every check raises.  Returns the phase's record."""
    from repro_torch.core import replication as rep
    kernel = next(k for k in counters if k.__name__ == "enoki_merge_rows")
    out, launches = {}, 0
    for pods in REPL_PODS:
        cpu = replication_state(torch, pods, width)
        state = type(cpu)(*(x.to("cuda") for x in cpu))
        torch.cuda.synchronize()
        arena_bytes = sum(x[0].numel() * x.element_size() for x in state)
        rec = {"pods": pods, "arena_bytes": arena_bytes,
               "tied_slots": len(range(0, SLOTS, TIE_EVERY))}
        steps = {topo: rep.make_pod_replicate_step(
            rep.merge_arena_aligned, pods, topo, device="cuda")
            for topo in rep.TOPOLOGIES}
        twins = {topo: rep.make_pod_replicate_step(
            rep.merge_arena_aligned, pods, topo, device="cpu")
            for topo in rep.TOPOLOGIES}
        results = {}
        for topo, step in steps.items():
            rounds = 1 if topo == "full" else pods - 1
            # -- the counted run: counts zeroed just before the path
            _zero(counters)
            got = state
            for r in range(rounds):
                got = step(got)
                if r == 0:
                    first = got
            torch.cuda.synchronize()
            n = _merge_launches(counters)
            # -- end of the counted run
            merges = (pods - 1) if topo == "full" else rounds * pods
            assert n == merges, \
                f"{topo} P={pods}: {n} launches, {merges} merges"
            launches += n
            for i in range(1, pods):
                _same_stores(torch, _pod(got, 0), _pod(got, i),
                             f"{topo} P={pods}: pod {i} against pod 0")
            twin = cpu
            for _ in range(rounds):
                twin = twins[topo](twin)
            _same_stores(torch, got, twin, f"{topo} P={pods}: CPU twin")
            results[topo] = (got, first)
            rec[topo] = {"rounds": rounds, "merges": merges,
                         "kernel_launches": n, "pods_identical": True,
                         "cpu_twin_identical": True}
        # full and ring end in the same bytes, and the logical converge
        # (replica 0: the fold from pod 0, as the pods' all_gather folds)
        full, first = results["full"][0], results["ring"][1]
        _same_stores(torch, full, results["ring"][0],
                     f"P={pods}: ring against full")
        logical = rep.converge([_pod(state, i) for i in range(pods)],
                               rep.merge_arena_aligned, "full")
        _same_stores(torch, _pod(full, 0), logical[0],
                     f"P={pods}: full against converge")
        rec["full"]["equals_converge"] = True
        # one ring round: pod i = merge(pod i, pod i + 1), on the CPU twin
        for i in range(pods):
            want = rep.merge_arena_aligned(rep.replica_clone(_pod(cpu, i)),
                                           _pod(cpu, (i + 1) % pods))
            _same_stores(torch, _pod(first, i), want,
                         f"ring P={pods}: pod {i} after one round")
        rec["ring"]["first_round_is_merge_with_next_pod"] = True
        # the unaligned merge (plain PyTorch): the same bytes, no launch
        _zero(counters)
        plain = rep.make_pod_replicate_step(rep.merge_arena, pods, "full",
                                            device="cuda")(state)
        torch.cuda.synchronize()
        assert _merge_launches(counters) == 0
        _same_stores(torch, plain, full,
                     f"P={pods}: merge_arena against merge_arena_aligned")
        rec["merge_arena"] = {"kernel_launches": 0,
                              "equals_aligned": True}
        # ms a round: every arena of the stack read once and written once.
        # A round's host enqueue reaches ~1.2 ms at P=4 (a clone, the
        # merges and a stack of five leaves a pod), past one SPIN_CYCLES
        nbytes = 2 * pods * arena_bytes
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        none = lambda: None
        for topo, step in steps.items():
            ms, host_ms = _median_ms(torch, lambda: step(state), none, flush,
                                     20, spin=4 * SPIN_CYCLES)
            rec[topo].update(ms=ms, host_ms=host_ms, bytes=nbytes,
                             bound_ms=bound_ms, bound_by="bytes",
                             share_of_bound=bound_ms / ms)
        plain_ms, _ = _median_ms(
            torch, lambda: rep.replicate_pod_axis(
                state, rep.merge_arena, pods, "full"), none, flush, 5)
        rec["merge_arena"]["full_ms"] = plain_ms
        out[f"P={pods}"] = rec
        del state, cpu, results, full, first, plain, logical, twin, got
        torch.cuda.empty_cache()
    return out, launches


# ---------------------------------------------------------------------------
# phase 5: the flash-attention kernel against its plain version
# ---------------------------------------------------------------------------

def _qkv(torch, gen, B, Sq, Skv, H, KV, D, dtype):
    tdt = getattr(torch, dtype)
    return (torch.randn((B, H, Sq, D), generator=gen, device="cuda").to(tdt),
            torch.randn((B, KV, Skv, D), generator=gen, device="cuda").to(tdt),
            torch.randn((B, KV, Skv, D), generator=gen, device="cuda").to(tdt))


def resource_report(build):
    """ptxas's registers, static shared memory and spills (bytes) of the
    RESOURCE_KERNELS, from the build's ``-Xptxas=-v`` log, by kernel name
    with its template argument; dynamic shared memory is set at launch."""
    import re
    args = {"f": "float", "13__nv_bfloat16": "bf16"}
    out = {}
    for lib, kernel in RESOURCE_KERNELS:
        for mangled, usage in build.resource_usage(
                build.build_log(lib)).items():
            m = re.search(kernel + r"(?:I(\w+?)E)?E", mangled)
            if m is None:
                continue
            arg = m.group(1)
            name = kernel if arg is None else \
                f"{kernel}<{args.get(arg, arg.removeprefix('Li'))}>"
            out[name] = usage
    return out


def _row_scaled(torch, x, oracle):
    """(max, mean) over output rows of max_d |x - oracle| / rms_d(oracle)."""
    e = ((x.float() - oracle).abs().amax(dim=-1)
         / oracle.square().mean(dim=-1).sqrt().clamp_min(1e-30))
    return float(e.max()), float(e.mean())


def _flash_close(torch, fk, q, k, v, got, want, causal, window, what):
    """(max |got - want|, bf16 ratio) for the kernel's ``got`` and the plain
    version's ``want`` on q, k, v; raises unless allclose at the dtype's
    tolerance and, in bf16, unless the kernel's row-scaled error against the
    f32 function is within BF16_ROUNDING_FACTOR of the plain version's (the
    ratio returned; None in f32)."""
    dtype = str(q.dtype).removeprefix("torch.")
    tol = FLASH_TOL[dtype]
    err = float((got.float() - want.float()).abs().max())
    if not (torch.isfinite(got.float()).all() and
            torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)):
        raise AssertionError(f"flash kernel != plain at {what}: max abs err "
                             f"{err} (tol {tol})")
    if q.dtype != torch.bfloat16:
        return err, None
    oracle = fk.flash_attention_bhsd_plain(q.float(), k.float(), v.float(),
                                           causal=causal, window=window)
    kmax, kmean = _row_scaled(torch, got, oracle)
    cmax, cmean = _row_scaled(torch, want, oracle)
    ratio = max(kmax / max(cmax, 1e-30), kmean / max(cmean, 1e-30))
    if ratio > BF16_ROUNDING_FACTOR:
        raise AssertionError(
            f"flash kernel off scale at {what}: row-scaled error max {kmax} "
            f"mean {kmean} against the plain version's bf16 rounding max "
            f"{cmax} mean {cmean}")
    return err, ratio


def check_flash_sweep(torch, fk, fops):
    """Kernel vs plain over FLASH_CASES x dtypes x FLASH_MASKS, in the kernel
    layout, then zamba2's geometry (bf16, causal, its window); the
    model-layout wrapper (strided reads, no transposes) on the first and
    the last two cases.  Returns (max abs err per dtype, the largest bf16
    ratio to the rounding control, cases)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst, cases, worst_ratio = {d: 0.0 for d in FLASH_TOL}, 0, 0.0
    B, S, H, KV, D, win = ZAMBA_FLASH
    runs = [(c, tuple(FLASH_TOL), FLASH_MASKS) for c in FLASH_CASES] + [
        ((B, S, S, H, KV, D), ("bfloat16",), [(True, win)])]
    for i, ((B, Sq, Skv, H, KV, D), dtypes, masks) in enumerate(runs):
        for dtype in dtypes:
            q, k, v = _qkv(torch, gen, B, Sq, Skv, H, KV, D, dtype)
            for causal, window in masks:
                what = (f"B={B} Sq={Sq} Skv={Skv} H={H} KV={KV} D={D} "
                        f"{dtype} causal={causal} window={window}")
                want = fk.flash_attention_bhsd_plain(q, k, v, causal=causal,
                                                     window=window)
                got = fk.flash_attention_bhsd(q, k, v, causal=causal,
                                              window=window)
                checks = [(got, what)]
                if i in (0, len(runs) - 2, len(runs) - 1) and \
                        window in (0, Sq):
                    checks.append((fops.flash_attention(
                        q.transpose(1, 2).contiguous(),
                        k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(), causal=causal,
                        window=window).transpose(1, 2),
                        what + " (model layout)"))
                torch.cuda.synchronize()
                for out, label in checks:
                    err, ratio = _flash_close(torch, fk, q, k, v, out, want,
                                              causal, window, label)
                    worst[dtype] = max(worst[dtype], err)
                    worst_ratio = max(worst_ratio, ratio or 0.0)
                    cases += 1
                del want, got, checks
            del q, k, v
    return worst, worst_ratio, cases


def time_flash(torch, fk, flush, geometry, reps=20):
    """The kernel at one prefill layer's ``geometry`` (B, S, H, KV, D,
    window; bf16, causal), beside its bound, its plain version and one SDPA
    call on the same inputs."""
    B, S, H, KV, D, window = geometry
    if 0 < window < S:      # the pair count and SDPA's mask below assume it
        raise ValueError(f"window {window} < S {S} is not timed here")
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = _qkv(torch, gen, B, S, S, H, KV, D, "bfloat16")
    run = lambda: fk.flash_attention_bhsd(q, k, v, causal=True,
                                          window=window)
    want = fk.flash_attention_bhsd_plain(q, k, v, causal=True, window=window)
    got = run()
    torch.cuda.synchronize()
    err, ratio = _flash_close(torch, fk, q, k, v, got, want, True, window,
                              f"the D={D} prefill geometry")
    del want, got
    # causal attention needs the S(S+1)/2 query-key pairs on or below the
    # diagonal (a window >= S masks none of them): 2·D FLOPs for q·k and
    # 2·D for p·v each, per head
    flops = 4.0 * B * H * D * S * (S + 1) / 2
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    flop_ms = flops / BF16_FLOPS_PER_S * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    none = lambda: None
    ms, host_ms = _median_ms(torch, run, none, flush, reps)
    plain_ms, _ = _median_ms(
        torch, lambda: fk.flash_attention_bhsd_plain(q, k, v, causal=True,
                                                     window=window),
        none, flush, 5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms, _ = _median_ms(
        torch, lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), none,
        flush, reps)
    return {"B": B, "S": S, "H": H, "KV": KV, "D": D, "window": window,
            "dtype": "bfloat16", "causal": True, "flops": flops,
            "bytes": nbytes, "ms": ms,
            "host_ms": host_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "tflops_per_s": flops / (ms * 1e-3) / 1e12,
            "share_of_bound": max(flop_ms, byte_ms) / ms,
            "max_abs_err": err, "bf16_ratio_to_rounding": ratio,
            "give_ups": fk.check_give_ups()}


# ---------------------------------------------------------------------------
# phase 6: the SSD chunk kernel against its plain version
# ---------------------------------------------------------------------------

def _ssd_inputs(torch, gen, B, H, S, P, N, dtype):
    """tests/test_kernels.py's inputs: x normal, a_dt = -softplus(normal)/2,
    b and c normal * 0.3, made on the card."""
    tdt = getattr(torch, dtype)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    return (rnd(B, H, S, P).to(tdt),
            (-torch.nn.functional.softplus(rnd(B, H, S)) * 0.5).to(tdt),
            (rnd(B, 1, S, N) * 0.3).to(tdt), (rnd(B, 1, S, N) * 0.3).to(tdt))


def _ssd_close(torch, got, want, dtype, what):
    """max |got - want| over y and the final state; raises unless both are
    finite and allclose at the dtype's tolerance."""
    tol, err = SSD_TOL[dtype], 0.0
    for g, w, name in zip(got, want, ("y", "final state")):
        err = max(err, float((g.float() - w.float()).abs().max()))
        if not (torch.isfinite(g.float()).all() and torch.allclose(
                g.float(), w.float(), rtol=tol, atol=tol)):
            raise AssertionError(f"ssd kernel != plain ({name}) at {what}: "
                                 f"max abs err {err} (tol {tol})")
    return err


def check_ssd_sweep(torch, sk, sops):
    """Kernel vs plain over SSD_CASES x dtypes and the main geometry in f32,
    in the kernel layout; the model-layout wrapper (strided reads of x,
    a_dt and y; dt weighting) on a ragged case and at the main geometry.
    Returns (max abs err per dtype, cases)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst, cases = {d: 0.0 for d in SSD_TOL}, 0
    runs = [(c, tuple(SSD_TOL)) for c in SSD_CASES] + [(MAIN_SSD,
                                                        ("float32",))]
    for i, ((B, H, S, P, N, chunk), dtypes) in enumerate(runs):
        for dtype in dtypes:
            what = f"B={B} H={H} S={S} P={P} N={N} chunk={chunk} {dtype}"
            x, a, b, c = _ssd_inputs(torch, gen, B, H, S, P, N, dtype)
            want = sk.ssd_chunk_bhcp_plain(x, a, b, c, chunk=chunk)
            got = sk.ssd_chunk_bhcp(x, a, b, c, chunk=chunk)
            torch.cuda.synchronize()
            worst[dtype] = max(worst[dtype], _ssd_close(torch, got, want,
                                                        dtype, what))
            cases += 1
            if i in (3, len(runs) - 1) and dtype == "float32":
                # the model layout: x (B,S,H,P) with dt apart, b/c (B,S,N)
                dt = torch.rand((B, S, H), generator=gen, device="cuda") + 0.5
                xm = x.transpose(1, 2).contiguous()
                am = (a.transpose(1, 2) * dt).contiguous()
                got = sops.ssd_chunk(xm, am, b[:, 0], c[:, 0], dt,
                                     chunk=chunk)
                want = sk.ssd_chunk_bhcp_plain(
                    (xm * dt[..., None]).transpose(1, 2), am.transpose(1, 2),
                    b, c, chunk=chunk)
                torch.cuda.synchronize()
                worst[dtype] = max(worst[dtype], _ssd_close(
                    torch, (got[0].transpose(1, 2), got[1]), want, dtype,
                    what + " (model layout)"))
                cases += 1
            del x, a, b, c, want, got
    return worst, cases


def ssd_work(B, H, S, P, N, chunk, itemsize):
    """(FLOPs, bytes) the chunked scan needs on these shapes.  Per chunk of
    l rows: C Bᵀ over the l(l+1)/2 pairs on or below the diagonal at 2N
    FLOPs, once per (b, chunk) since B and C are shared across heads; per
    (b, h, chunk) the (S ⊙ L) x product over the same pairs at 2P, and
    2·l·N·P each for C stateᵀ and the state update.  The elementwise terms
    (mask, decays, exps) are left out, so the bound stays a lower bound.
    Bytes: x, a_dt, b, c read once, y and the f32 state written once."""
    flops = 0.0
    for s0 in range(0, S, chunk):
        l = min(chunk, S - s0)
        pairs = l * (l + 1) / 2
        flops += B * pairs * 2 * N + B * H * (pairs * 2 * P + 4 * l * N * P)
    nbytes = itemsize * (2 * B * H * S * P + B * H * S + 2 * B * S * N) \
        + 4 * B * H * P * N
    return flops, nbytes


def time_ssd(torch, sk, flush, reps=20):
    """The kernels at the main-path geometry (one Mamba-2 layer's prefill,
    f32), beside their bound and their plain version.  The bound takes the
    products at the TF32 tensor-core rate spent three times a product
    (3xTF32, as the kernels run them) and the bytes at the memory rate;
    ``fma_bound_ms`` takes the products on f32 FMAs instead, the units of
    the one-kernel version before it.  No single PyTorch call computes the
    chunked scan, so there is no library time."""
    B, H, S, P, N, chunk = MAIN_SSD
    gen = torch.Generator(device="cuda").manual_seed(5)
    x, a, b, c = _ssd_inputs(torch, gen, B, H, S, P, N, "float32")
    run = lambda: sk.ssd_chunk_bhcp(x, a, b, c, chunk=chunk)
    err = _ssd_close(torch, run(), sk.ssd_chunk_bhcp_plain(
        x, a, b, c, chunk=chunk), "float32", "the main geometry")
    flops, nbytes = ssd_work(B, H, S, P, N, chunk, 4)
    flop_ms = flops / SSD_PRODUCT_FLOPS_PER_S * 1e3
    fma_ms = flops / F32_FLOPS_PER_S * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    none = lambda: None
    ms, host_ms = _median_ms(torch, run, none, flush, reps)
    plain_ms, _ = _median_ms(
        torch, lambda: sk.ssd_chunk_bhcp_plain(x, a, b, c, chunk=chunk),
        none, flush, 5)
    return {"B": B, "H": H, "S": S, "P": P, "N": N, "chunk": chunk,
            "dtype": "float32", "flops": flops, "bytes": nbytes, "ms": ms,
            "host_ms": host_ms, "plain_ms": plain_ms, "library_ms": None,
            "library_note": "no single PyTorch call computes the chunked "
                            "SSD scan",
            "bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "bound_units": "3xTF32 tensor cores (495/3 TFLOP/s) or 3.35 TB/s",
            "fma_bound_ms": max(fma_ms, byte_ms),
            "tflops_per_s": flops / (ms * 1e-3) / 1e12,
            "share_of_bound": max(flop_ms, byte_ms) / ms,
            "max_abs_err": err}


# ---------------------------------------------------------------------------
# phase 7: the mLSTM chunk kernel against its plain version
# ---------------------------------------------------------------------------

def _mlstm_inputs(torch, gen, B, H, S, d, dtype):
    """tests/test_kernels.py's inputs: q/k/v normal, log_i =
    log_sigmoid(normal - 2), log_f = log_sigmoid(normal + 2) in f32, made
    on the card."""
    tdt = getattr(torch, dtype)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    logsig = torch.nn.functional.logsigmoid
    return (rnd(B, H, S, d).to(tdt), rnd(B, H, S, d).to(tdt),
            rnd(B, H, S, d).to(tdt), logsig(rnd(B, H, S) - 2.0),
            logsig(rnd(B, H, S) + 2.0))


def _mlstm_close(torch, got, want, dtype, what):
    """max |got - want| over h, C, n and m; raises unless each is finite and
    allclose at the dtype's tolerance."""
    tol, err = MLSTM_TOL[dtype], 0.0
    (gh, gcarry), (wh, wcarry) = got, want
    for g, w, name in zip((gh, *gcarry), (wh, *wcarry), ("h", "C", "n", "m")):
        err = max(err, float((g.float() - w.float()).abs().max()))
        if not (torch.isfinite(g.float()).all() and torch.allclose(
                g.float(), w.float(), rtol=tol, atol=tol)):
            raise AssertionError(f"mlstm kernel != plain ({name}) at {what}: "
                                 f"max abs err {err} (tol {tol})")
    return err


def check_mlstm_sweep(torch, mk, mops):
    """Kernel vs plain over MLSTM_CASES x dtypes and the main geometry in
    f32, in the kernel layout; the model-layout wrapper (strided reads of
    q/k/v and the gates, h written through a view) at d=128 and at the main
    geometry.  Returns (max abs err per dtype, cases)."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst, cases = {d: 0.0 for d in MLSTM_TOL}, 0
    runs = [(c, tuple(MLSTM_TOL)) for c in MLSTM_CASES] + [(MAIN_MLSTM,
                                                            ("float32",))]
    for i, ((B, H, S, d, chunk), dtypes) in enumerate(runs):
        for dtype in dtypes:
            what = f"B={B} H={H} S={S} d={d} chunk={chunk} {dtype}"
            ins = _mlstm_inputs(torch, gen, B, H, S, d, dtype)
            want = mk.mlstm_chunk_bhsd_plain(*ins, chunk=chunk)
            got = mk.mlstm_chunk_bhsd(*ins, chunk=chunk)
            torch.cuda.synchronize()
            worst[dtype] = max(worst[dtype], _mlstm_close(
                torch, got, want, dtype, what))
            cases += 1
            if i in (3, len(runs) - 1) and dtype == "float32":
                # the model layout: q/k/v (B,S,H,d), gates (B,S,H)
                model = [x.transpose(1, 2).contiguous() for x in ins]
                h, carry = mops.mlstm_chunk(*model, chunk=chunk)
                torch.cuda.synchronize()
                worst[dtype] = max(worst[dtype], _mlstm_close(
                    torch, (h.transpose(1, 2), carry), want, dtype,
                    what + " (model layout)"))
                cases += 1
            del ins, want, got
    return worst, cases


def mlstm_work(B, H, S, d, chunk, itemsize):
    """(FLOPs, bytes) the chunkwise mLSTM needs on these shapes.  Per chunk
    of l rows and per (b, h): q kᵀ and W v over the l(l+1)/2 query-key
    pairs on or below the diagonal at 2d FLOPs each, 2·l·d² each for q C
    and the carry update (k w)ᵀ v.  The elementwise terms (gates, decays,
    normaliser) are left out, so the bound stays a lower bound.  Bytes:
    q, k, v and the f32 gates read once, h and the f32 final carry written
    once."""
    flops = 0.0
    for _ in range(0, S, chunk):
        pairs = chunk * (chunk + 1) / 2
        flops += B * H * (2 * pairs * 2 * d + 2 * 2 * chunk * d * d)
    nbytes = itemsize * 4 * B * H * S * d + 4 * 2 * B * H * S \
        + 4 * B * H * (d * d + d + 1)
    return flops, nbytes


def time_mlstm(torch, mk, flush, reps=20):
    """The kernel at the main-path geometry (one xlstm-350m mLSTM layer's
    prefill, f32), beside its bound and its plain version.  The bound takes
    the products at the TF32 tensor-core rate spent three times a product
    (3xTF32, as the kernel runs them) and the bytes at the memory rate;
    ``fma_bound_ms`` takes the products on f32 FMAs instead, the units of
    the kernel before it.  No single PyTorch call computes the chunkwise
    mLSTM, so there is no library time."""
    B, H, S, d, chunk = MAIN_MLSTM
    gen = torch.Generator(device="cuda").manual_seed(7)
    ins = _mlstm_inputs(torch, gen, B, H, S, d, "float32")
    run = lambda: mk.mlstm_chunk_bhsd(*ins, chunk=chunk)
    err = _mlstm_close(torch, run(), mk.mlstm_chunk_bhsd_plain(
        *ins, chunk=chunk), "float32", "the main geometry")
    flops, nbytes = mlstm_work(B, H, S, d, chunk, 4)
    flop_ms = flops / SSD_PRODUCT_FLOPS_PER_S * 1e3
    fma_ms = flops / F32_FLOPS_PER_S * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    none = lambda: None
    ms, host_ms = _median_ms(torch, run, none, flush, reps)
    plain_ms, _ = _median_ms(
        torch, lambda: mk.mlstm_chunk_bhsd_plain(*ins, chunk=chunk), none,
        flush, 5)
    return {"B": B, "H": H, "S": S, "d": d, "chunk": chunk,
            "dtype": "float32", "flops": flops, "bytes": nbytes, "ms": ms,
            "host_ms": host_ms, "plain_ms": plain_ms, "library_ms": None,
            "library_note": "no single PyTorch call computes the chunkwise "
                            "mLSTM",
            "bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "bound_units": "3xTF32 tensor cores (495/3 TFLOP/s) or 3.35 TB/s",
            "fma_bound_ms": max(fma_ms, byte_ms),
            "blocks": B * H * mk.column_tiles(d),
            "tflops_per_s": flops / (ms * 1e-3) / 1e12,
            "share_of_bound": max(flop_ms, byte_ms) / ms,
            "max_abs_err": err}


# ---------------------------------------------------------------------------
# phase 8: the sessions path, served
# ---------------------------------------------------------------------------

def _wall_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _leaves(tree):
    """The tensors of a nested dict, with their paths."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}" if p else k, x) for k, v in tree.items()
                for p, x in _leaves(v)]
    return [("", tree)]


GEMM_NAMES = ("gemm", "gemv", "xmma", "cutlass", "nvjet", "cublas")


def profile_device(torch, fn):
    """One ``fn()`` under ``torch.profiler``: its wall ms, the device ms of
    its kernels by kind (the flash, SSD and mLSTM kernels, cuBLAS GEMMs,
    everything else) and of the costliest "other" kernels by name, the
    device's idle share of the wall, the kernels the device ran
    (``kernel_launches``, graph nodes included), what the host issued
    apart (``host_kernel_launches``: kernels launched one by one;
    ``graph_launches``: CUDA graph replays), and the seconds spent reading
    the trace.  The device fields are None when the trace holds no
    kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ms = {"flash_attention": 0.0, "ssd_chunk": 0.0, "mlstm_chunk": 0.0,
          "gemm": 0.0, "other": 0.0}
    launches, other, host = 0, [], {"graph": 0, "kernel": 0}
    t_read = time.perf_counter()
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            if e.key.startswith("cudaGraphLaunch"):
                host["graph"] += e.count
            elif e.key.startswith("cudaLaunchKernel"):
                host["kernel"] += e.count
            continue
        name = e.key.lower()
        kind = ("flash_attention" if "flash_fwd" in name else "ssd_chunk"
                if "ssd_chunk" in name else "mlstm_chunk"
                if "mlstm_chunk" in name else "gemm"
                if any(t in name for t in GEMM_NAMES) else "other")
        ms[kind] += e.self_device_time_total / 1e3
        launches += e.count
        if kind == "other":
            other.append((e.self_device_time_total / 1e3, e.count,
                          e.key[:90]))
    busy = sum(ms.values())
    return {"wall_ms": wall, "trace_read_s": time.perf_counter() - t_read,
            "device_ms": ms if launches else None,
            "other_top": [{"ms": t, "launches": n, "kernel": k}
                          for t, n, k in sorted(other, reverse=True)[:8]],
            "device_busy_ms": busy if launches else None,
            "idle_share": 1.0 - busy / wall if launches else None,
            "kernel_launches": launches or None,
            "host_kernel_launches": host["kernel"],
            "graph_launches": host["graph"]}


def _rel_err(torch, a, b) -> float:
    """max |a - b| / max |b| over (B, S, V) logits, one sequence at a time."""
    num = den = 0.0
    for i in range(a.shape[0]):
        x, y = a[i].float(), b[i].float()
        num = max(num, float((x - y).abs().max()))
        den = max(den, float(y.abs().max()))
    return num / (den + 1e-6)


def check_slstm_scan(torch, xlstm, params, arch):
    """The captured sLSTM scan against the eager loop over time, bit for
    bit (hs and the carry), on the first sLSTM layer's weights and card
    inputs at the prefill's shape (B=SESSIONS, S=the prompt) and at a
    ragged S of 100 (a 36-step tail: blocks of 32 and 4); the loop's and
    the scan's wall ms at the prefill's shape."""
    cell = params["blocks"]["slstm"]["cell"]
    r, b = cell["r"][0], cell["b"][0]
    h = arch.xlstm.num_heads
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for S in (PROMPTS[arch.name], 100):
        wx = torch.randn((SESSIONS, S, 4 * arch.d_model), generator=gen,
                         device="cuda").to(torch.bfloat16)
        init = xlstm.slstm_cache_init(arch, SESSIONS, torch.bfloat16,
                                      device="cuda")
        carry = (init["c"], init["n"], init["m"], init["h"])
        (ghs, gc), scan_ms = _wall_ms(
            torch, lambda: xlstm.slstm_scan(wx, r, b, carry, h))
        (ehs, ec), loop_ms = _wall_ms(
            torch, lambda: xlstm.slstm_loop(wx, r, b, carry, h))
        assert torch.equal(ghs, ehs), f"sLSTM scan != loop at S={S}"
        for x, y in zip(gc, ec):
            assert torch.equal(x, y), f"sLSTM carry != loop at S={S}"
        out[str(S)] = {"scan_ms": scan_ms, "loop_ms": loop_ms}
    return {"block": xlstm.SLSTM_BLOCK, "bit_identical": True, **out}


def session_arch(arch_id):
    """The registry's config, depth cut as SESSION_LAYERS says, and the
    cut as ``{"num_layers": "64 -> 4"}`` (None when there is none)."""
    from repro_torch.configs import get_arch
    arch = get_arch(arch_id)
    if arch_id not in SESSION_LAYERS:
        return arch, None
    cut = dataclasses.replace(arch, num_layers=SESSION_LAYERS[arch_id])
    return cut, {"num_layers": f"{arch.num_layers} -> {cut.num_layers}"}


def stub_inputs(torch, arch, batch, gen):
    """The front-end stub's inputs for ``batch`` sequences on the card
    (``example_batch``'s ``patch_embeds`` or ``frame_embeds``: (batch,
    num_patches, d) f32), {} for a text-only model."""
    from repro_torch.configs import ShapeConfig, StepKind
    from repro_torch.models import model_zoo as zoo
    out = zoo.example_batch(arch, ShapeConfig("stub", 1, batch,
                                              StepKind.PREFILL), gen)
    return {k: v for k, v in out.items() if k != "tokens"}


def flash_vs_reference(torch, zoo, arch, params, batch):
    """FLASH against the REFERENCE path (plain torch) on one pod's batch:
    the relative max error of the logits.  For a moe model, the routes of
    every (token, layer) are recorded on both paths (``dispatch_indices``'
    experts and kept flags): a change in attention rounding can flip a
    near-tied route, so the error is taken over the tokens whose routes
    all agree, and the (token, layer) routes that differ are counted."""
    from repro_torch.configs import AttnImpl
    from repro_torch.models import moe
    routes, logits = {}, {}
    orig = moe.dispatch_indices

    for impl in (AttnImpl.FLASH, AttnImpl.REFERENCE):
        rec = routes[impl] = []

        def spy(expert_idx, num_experts, cap):
            slot, kept = orig(expert_idx, num_experts, cap)
            rec.append((expert_idx.clone(), kept.reshape(expert_idx.shape)))
            return slot, kept
        moe.dispatch_indices = spy
        try:
            logits[impl], _, _ = zoo.forward_seq(arch, params,
                                                 batch["tokens"],
                                                 extra=batch, impl=impl)
        finally:
            moe.dispatch_indices = orig
    flash, ref = logits[AttnImpl.FLASH], logits[AttnImpl.REFERENCE]
    out = {"rel_err_all_tokens": _rel_err(torch, flash, ref)}
    if not routes[AttnImpl.FLASH]:
        out["rel_err"] = out["rel_err_all_tokens"]
        return out
    B, S = batch["tokens"].shape
    agree = torch.ones(B * S, dtype=torch.bool, device=flash.device)
    differ = 0
    for (fi, fk), (ri, rk) in zip(routes[AttnImpl.FLASH],
                                  routes[AttnImpl.REFERENCE]):
        same = (fi == ri).all(-1) & (fk == rk).all(-1)
        differ += int((~same).sum())
        agree &= same
    agree = agree.reshape(B, S)
    num = den = 0.0
    for i in range(B):
        x, y = flash[i][agree[i]].float(), ref[i][agree[i]].float()
        if x.numel():
            num = max(num, float((x - y).abs().max()))
        den = max(den, float(ref[i].float().abs().max()))
    out.update(rel_err=num / (den + 1e-6), routes=len(routes[AttnImpl.FLASH])
               * B * S, routes_differing=differ,
               tokens_with_differing_routes=int((~agree).sum()),
               tokens=B * S)
    return out


def run_sessions(torch, arch_id, counters, expect):
    """One model's sessions path: prefill, decode with replication,
    failover; every check raises.  ``counters`` maps each kernel's name to
    its wrapper; ``expect`` gives the launches of the counted run (the
    others must be 0)."""
    from repro_torch.configs import (AttnImpl, EnokiConfig, ShapeConfig,
                                     StepKind)
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels.flash_attention.kernel import check_give_ups
    from repro_torch.launch import serve
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import xlstm
    arch, cut = session_arch(arch_id)
    enoki = EnokiConfig()
    R = enoki.replication_period
    prompt = PROMPTS[arch_id]
    cache_len = prompt + CACHE_EXTRA
    pshape = ShapeConfig("sessions_prefill", prompt, SESSIONS,
                         StepKind.PREFILL)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = zoo.init_params(arch, seed=0, dtype=serve.serve_param_dtype(arch),
                             device="cuda")
    if zoo.transformer.plan(arch)["kind"] == "xlstm":
        # the reference's init zeroes the xLSTM groupnorm scales, which
        # multiply (no 1 + scale), so every block would add 0 and the
        # prefill's logits would not see the mLSTM kernel: unit scales
        blocks = params["blocks"]
        for cell in (blocks["mlstm"]["cell"], blocks["slstm"]["cell"]):
            cell["norm"].fill_(1.0)
    gen = torch.Generator(device="cuda").manual_seed(3)
    prompts = torch.randint(0, arch.vocab_size, (N_PODS, SESSIONS, prompt),
                            generator=gen, device="cuda", dtype=torch.int32)
    # each pod's batch: its prompts, and the vlm's patch embeddings or
    # whisper's frame embeddings from the seed
    batches = [{"tokens": prompts[pod], **stub_inputs(torch, arch, SESSIONS,
                                                      gen)}
               for pod in range(N_PODS)]
    prefill = serve.make_prefill_step(arch, pshape, impl=AttnImpl.FLASH,
                                      device="cuda")
    step = serve.make_decode_step(arch, n_pods=N_PODS, device="cuda")
    replicate = serve.make_replicate_sessions_step(device="cuda")
    migrate = serve.make_migrate_sessions_step(device="cuda")
    # warm the path on one sequence; the vlm's prompt holds its patch
    # positions and text beyond them
    warm = WARM_PROMPT + (arch.num_patches
                          if arch.frontend_stub == "clip_patches" else 0)
    prefill(params, {k: v[:1, :warm] if k == "tokens" else v[:1]
                     for k, v in batches[0].items()})
    slstm0 = (xlstm.SLSTM_STEPS.captures, xlstm.SLSTM_STEPS.capture_ms)

    # -- the counted run: counts zeroed just before the path is driven
    for fn in counters.values():
        fn.launches = 0
    live = tree_map(lambda v: torch.stack([v] * N_PODS), zoo.init_cache(
        arch, SESSIONS, cache_len, device="cuda"))
    first, prefill_pod_ms = [], []
    for pod in range(N_PODS):
        (logits, cache), ms = _wall_ms(
            torch, lambda: prefill(params, batches[pod]))
        prefill_pod_ms.append(ms)
        # into the decode cache's leading corner: the K/V of internlm2,
        # grok-1, phi-3-vision and whisper's decoder fill the first prompt
        # of cache_len positions (as tests/test_arch_smoke.py pads them),
        # whisper's cross K/V all 1,500 frames; zamba2's ring of 4,096
        # slots takes its 4,096 positions; xlstm's recurrent states have
        # no positions
        tree_map(lambda dst, src: dst[pod][tuple(
            slice(0, n) for n in src.shape)].copy_(src),
            {k: live[k] for k in cache}, cache)
        assert torch.isfinite(logits.float()).all(), "prefill logits"
        check_give_ups()
        first.append(torch.argmax(logits[:, -1, :], dim=-1)[:, None])
        del cache
    token = torch.stack(first).to(torch.int32)
    decode_ms, backup, replicate_ms, replications = [], None, [], 0
    for t in range(DECODE_STEPS):
        (token, live), ms = _wall_ms(torch, lambda: step(params, live, token))
        decode_ms.append(ms)
        if (t + 1) % R == 0:
            backup, ms = _wall_ms(torch, lambda: replicate(live))
            replicate_ms.append(ms)
            replications += 1
            for (path, b), (_, x) in zip(_leaves(backup), _leaves(live)):
                # pod 1's slot backs up pod 0
                assert torch.equal(b[1], x[0]), f"backup {path}"
    lost = live["length"].clone()
    dead = torch.tensor([True] + [False] * (N_PODS - 1), device="cuda")
    restored, migrate_ms = _wall_ms(torch, lambda: migrate(live, backup, dead))
    for (path, r), (_, b), (_, x) in zip(_leaves(restored), _leaves(backup),
                                         _leaves(live)):
        assert torch.equal(r[0], b[0]) and torch.equal(r[1:], x[1:]), path
    staleness = int(lost[0]) - int(restored["length"][0])
    assert 0 <= staleness <= R and staleness == DECODE_STEPS % R, staleness
    del live, backup
    for _ in range(FAILOVER_STEPS):
        (token, restored), ms = _wall_ms(
            torch, lambda: step(params, restored, token))
        decode_ms.append(ms)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    # -- end of the counted run
    assert launches == {name: expect.get(name, 0) for name in counters}, \
        (launches, expect)
    prefill_ms = sum(prefill_pod_ms)
    slstm_captures = xlstm.SLSTM_STEPS.captures - slstm0[0]
    slstm_capture_ms = xlstm.SLSTM_STEPS.capture_ms - slstm0[1]
    decode_graph = {"captures": step.steps.captures,
                    "capture_ms": step.steps.capture_ms,
                    "replays": step.steps.replays}
    # the live cache's graph, then the migrated cache's
    assert step.steps.captures == 2, decode_graph
    assert all(x.is_cuda for tree in (params, restored)
               for _, x in _leaves(tree)) and token.is_cuda
    assert int((token < 0).sum() + (token >= arch.vocab_size).sum()) == 0
    assert torch.equal(restored["length"], lost - torch.tensor(
        [staleness] + [0] * (N_PODS - 1), device="cuda",
        dtype=lost.dtype) + FAILOVER_STEPS)
    # the graph against the eager pod-step: two copies of the session
    # state, GRAPH_CHECK_STEPS steps each, tokens and every leaf equal
    graph_twin = tree_map(torch.clone, restored)
    eager_twin = tree_map(torch.clone, restored)
    gtok, etok, graph_ms, eager_ms = token, token, [], []
    for _ in range(GRAPH_CHECK_STEPS):
        (gtok, graph_twin), ms = _wall_ms(
            torch, lambda: step(params, graph_twin, gtok))
        graph_ms.append(ms)
        (etok, eager_twin), ms = _wall_ms(
            torch, lambda: step.eager(params, eager_twin, etok))
        eager_ms.append(ms)
        assert torch.equal(gtok, etok), "decode graph != eager tokens"
    for (path, x), (_, y) in zip(_leaves(graph_twin), _leaves(eager_twin)):
        assert torch.equal(x, y), f"decode graph != eager at {path}"
    decode_graph.update(check_steps=GRAPH_CHECK_STEPS,
                        graph_ms_per_step=statistics.median(graph_ms[1:]),
                        eager_ms_per_step=statistics.median(eager_ms),
                        tokens_and_cache_equal=True)
    graph_profile = profile_device(
        torch, lambda: step(params, graph_twin, gtok))
    del graph_twin, eager_twin
    # where the time goes: one pod's decode step and one pod's prefill,
    # profiled after the counted run
    pod_cache = tree_map(lambda v: v[1].clone(), restored)
    out = {}
    decode_profile = profile_device(torch, lambda: out.setdefault(
        "logits", zoo.decode_step(arch, params, pod_cache, token[1])[0]))
    assert torch.isfinite(out["logits"].float()).all(), "decode logits"
    del restored, pod_cache, out
    t_prof = time.perf_counter()
    prefill_profile = profile_device(
        torch, lambda: prefill(params, batches[0]))
    prefill_profile["profile_s"] = time.perf_counter() - t_prof

    # FLASH against the REFERENCE path (plain torch) on pod 0's batch (a
    # moe model: on the tokens whose routes agree, with the count of the
    # routes that do not)
    versus = flash_vs_reference(torch, zoo, arch, params, batches[0])
    rel = versus["rel_err"]
    assert rel < PREFILL_REL_TOL, f"FLASH vs REFERENCE prefill: {versus}"

    tokens_in = N_PODS * SESSIONS * prompt
    mflops = zoo.model_flops(arch, ShapeConfig(
        "p", prompt, N_PODS * SESSIONS, StepKind.PREFILL))
    # model_flops counts every parameter once; zamba2 applies its one
    # shared block (counted once) after each of its groups
    shared = sum(x.numel() for _, x in _leaves(params.get("shared", {})))
    groups = zoo.transformer.plan(arch).get("groups", 1)
    applied = mflops + 2.0 * (groups - 1) * shared * tokens_in
    step_ms = statistics.median(decode_ms)
    slstm_check = (check_slstm_scan(torch, xlstm, params, arch)
                   if zoo.transformer.plan(arch)["kind"] == "xlstm" else None)
    return {"arch": arch_id, "reduced": cut, "params": arch.param_count(),
            "shared_block_params": shared, "shared_block_applications":
            groups if shared else 0, "pods": N_PODS,
            "sessions_per_pod": SESSIONS, "prompt": prompt,
            "cache_len": cache_len, "launches": launches,
            "prefill_ms": prefill_ms, "prefill_pod_ms": prefill_pod_ms,
            "slstm_captures": slstm_captures,
            "slstm_capture_ms": slstm_capture_ms,
            "decode_graph": decode_graph, "slstm_scan_check": slstm_check,
            "prefill_tokens_per_s": tokens_in / (prefill_ms * 1e-3),
            "prefill_model_flops_share": mflops / (prefill_ms * 1e-3)
            / BF16_FLOPS_PER_S,
            "prefill_applied_flops_share": applied / (prefill_ms * 1e-3)
            / BF16_FLOPS_PER_S,
            "decode_steps": len(decode_ms), "decode_ms_per_step": step_ms,
            "decode_tokens_per_s": N_PODS * SESSIONS / (step_ms * 1e-3),
            "replications": replications,
            "replicate_ms": statistics.median(replicate_ms),
            "migrate_ms": migrate_ms, "staleness_tokens": staleness,
            "replication_period": R, "flash_vs_reference_rel_err": rel,
            "flash_vs_reference": versus,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "profile_prefill_one_pod": prefill_profile,
            "profile_decode_one_pod": decode_profile,
            "profile_decode_graph_step": graph_profile,
            "give_ups": check_give_ups()}


def run_prefill_only(torch, arch_id, counters, expect):
    """One pod's prefill (SESSIONS prompts) through the FLASH path, counted
    (``expect``: its launches), profiled, and held against the REFERENCE
    path (rel < PREFILL_REL_TOL)."""
    from repro_torch.configs import ShapeConfig, StepKind, AttnImpl
    from repro_torch.kernels.flash_attention.kernel import check_give_ups
    from repro_torch.launch import serve
    from repro_torch.models import model_zoo as zoo
    arch, cut = session_arch(arch_id)
    prompt = PROMPTS[arch_id]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = zoo.init_params(arch, seed=0, dtype=serve.serve_param_dtype(arch),
                             device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    batch = {"tokens": torch.randint(0, arch.vocab_size, (SESSIONS, prompt),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32),
             **stub_inputs(torch, arch, SESSIONS, gen)}
    prefill = serve.make_prefill_step(
        arch, ShapeConfig("prefill", prompt, SESSIONS, StepKind.PREFILL),
        impl=AttnImpl.FLASH, device="cuda")
    prefill(params, {k: v[:1, :WARM_PROMPT] if k == "tokens" else v[:1]
                     for k, v in batch.items()})
    # -- the counted run: counts zeroed just before the path is driven
    for fn in counters.values():
        fn.launches = 0
    (logits, cache), prefill_ms = _wall_ms(torch,
                                           lambda: prefill(params, batch))
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    # -- end of the counted run
    assert launches == {name: expect.get(name, 0) for name in counters}, \
        (launches, expect)
    assert torch.isfinite(logits.float()).all(), "prefill logits"
    check_give_ups()
    assert int(cache["length"]) == prompt
    del logits, cache
    profile = profile_device(torch, lambda: prefill(params, batch))
    versus = flash_vs_reference(torch, zoo, arch, params, batch)
    assert versus["rel_err"] < PREFILL_REL_TOL, \
        f"FLASH vs REFERENCE prefill: {versus}"
    tokens_in = SESSIONS * prompt
    mflops = zoo.model_flops(arch, ShapeConfig("p", prompt, SESSIONS,
                                               StepKind.PREFILL))
    return {"arch": arch_id, "reduced": cut, "params": arch.param_count(),
            "sessions": SESSIONS, "prompt": prompt, "launches": launches,
            "prefill_ms": prefill_ms,
            "prefill_tokens_per_s": tokens_in / (prefill_ms * 1e-3),
            "prefill_model_flops_share": mflops / (prefill_ms * 1e-3)
            / BF16_FLOPS_PER_S,
            "flash_vs_reference_rel_err": versus["rel_err"],
            "flash_vs_reference": versus,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "profile_prefill": profile, "give_ups": check_give_ups()}


def expected_launches(arch):
    """The kernel launches of one pod's prefill: attention layers through
    flash, Mamba-2 layers through SSD, mLSTM layers through mLSTM."""
    from repro_torch.models.transformer import plan as layer_plan
    p = layer_plan(arch)
    if p["kind"] in ("dense", "moe"):
        return {"flash_attention_bhsd": p["layers"]}
    if p["kind"] == "whisper":
        return {"flash_attention_bhsd": p["enc"] + p["dec"]}
    if p["kind"] == "xlstm":
        return {"mlstm_chunk_bhsd": p["groups"] * p["mlstm_per"]}
    return {"flash_attention_bhsd": p["groups"],
            "ssd_chunk_bhcp": arch.num_layers}


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
        from repro_torch.kernels.flash_attention import kernel as fk
        from repro_torch.kernels.flash_attention import ops as fops
        from repro_torch.kernels.mlstm_chunk import kernel as mk
        from repro_torch.kernels.mlstm_chunk import ops as mops
        from repro_torch.kernels.ssd_chunk import kernel as sk
        from repro_torch.kernels.ssd_chunk import ops as sops
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2

    # f32 products in full f32 on the card (the tolerances assume it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. device and build
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    built = build.build_all()
    emit({"phase": "build", "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc_s": built, "build_s": time.perf_counter() - t0})
    emit({"phase": "resources", "kernels": resource_report(build)})

    # -- 2. the merge kernel against its plain version
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

    # -- 3. the FaaS main path, served
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
          "prewarm_ms": st["prewarm_ms"],
          "prewarm_captures": st["prewarm_captures"],
          "prewarm_capture_ms": st["prewarm_capture_ms"],
          "serve_captures": st["serve_captures"],
          "merge_dispatches": st["merges"],
          "merge_snapshots": c.stats.merge_snapshots,
          "merge_aligned": c.stats.merge_aligned,
          "merge_fallback": c.stats.merge_fallback,
          "kernel_launches": st["launches"],
          "launches_per_request": st["launches"] / len(plan),
          "batch_ms_per_request": batch_ms,
          "replicas_identical": True, "cpu_twin_identical": True,
          "nvidia_smi": smi})

    del c, twin

    # -- 3b. the warm paths: prewarm's captures, none in warm rounds
    kernels = (kernel.enoki_merge_rows, fk.flash_attention_bhsd,
               sk.ssd_chunk_bhcp, mk.mlstm_chunk_bhsd)
    t_phase = time.perf_counter()
    warm = check_warm(torch, kernels, ROW_100KB)
    emit({"phase": "warm", **warm,
          "wall_s": time.perf_counter() - t_phase, "nvidia_smi": smi})

    # -- 4. crash, partition and checkpoint recovery (the runtime)
    t_phase = time.perf_counter()
    register_handlers(torch, enoki_function, ROW_1MB, prefix="ckpt")
    chaos = check_chaos(torch, kernels, ROW_100KB)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt_dir:
        ckpt = check_checkpoint(torch, kernels, ckpt_dir)
    crash = check_crash_serving(torch, kernels, ROW_100KB)
    runtime_launches = {"chaos": chaos["kernel_launches"],
                        "checkpoint": ckpt["kernel_launches"],
                        "crash_serving": crash["kernel_launches"]}
    emit({"phase": "runtime", "chaos": chaos, "checkpoint": ckpt,
          "crash_serving": crash, "kernel_launches": runtime_launches,
          "wall_s": time.perf_counter() - t_phase, "nvidia_smi": smi})
    torch.cuda.empty_cache()

    # -- 4b. pod-axis replication: P pods stacked on the card
    t_phase = time.perf_counter()
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device="cuda")
    repl, repl_launches = check_replication(torch, kernels, flush)
    del flush
    emit({"phase": "replication", **repl, "kernel_launches": repl_launches,
          "wall_s": time.perf_counter() - t_phase, "nvidia_smi": smi})

    # -- 5. the flash-attention kernel against its plain version
    fworst, fratio, fcases = check_flash_sweep(torch, fk, fops)
    emit({"phase": "kernel_sweep", "kernel": "flash_attention_bhsd",
          "cases": fcases, "max_abs_err": fworst, "tolerance": FLASH_TOL,
          "bf16_ratio_to_rounding": fratio,
          "bf16_ratio_limit": BF16_ROUNDING_FACTOR,
          "give_ups": fk.check_give_ups()})
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device="cuda")
    ft = time_flash(torch, fk, flush, MAIN_FLASH)
    emit({"phase": "kernel_time", "kernel": "flash_attention_bhsd",
          "geometry": "internlm2-1.8b prefill layer", "nvidia_smi": smi,
          **ft})
    fz = time_flash(torch, fk, flush, ZAMBA_FLASH)
    emit({"phase": "kernel_time", "kernel": "flash_attention_bhsd",
          "geometry": "zamba2-7b shared block, prefill", "nvidia_smi": smi,
          **fz})
    fp = time_flash(torch, fk, flush, PHI_FLASH)
    emit({"phase": "kernel_time", "kernel": "flash_attention_bhsd",
          "geometry": "phi-3-vision-4.2b prefill layer (D=96)",
          "nvidia_smi": smi, **fp})
    fg = time_flash(torch, fk, flush, GEMMA_FLASH)
    emit({"phase": "kernel_time", "kernel": "flash_attention_bhsd",
          "geometry": "gemma-7b prefill layer (D=256, wgmma fed by TMA)",
          "nvidia_smi": smi, **fg})
    flash_times = {"internlm2-1.8b D=128": ft, "zamba2-7b D=112": fz,
                   "phi-3-vision-4.2b D=96": fp, "gemma-7b D=256": fg}

    # -- 6. the SSD chunk kernel against its plain version
    sworst, scases = check_ssd_sweep(torch, sk, sops)
    emit({"phase": "kernel_sweep", "kernel": "ssd_chunk_bhcp",
          "cases": scases, "max_abs_err": sworst, "tolerance": SSD_TOL})
    sd = time_ssd(torch, sk, flush)
    emit({"phase": "kernel_time", "kernel": "ssd_chunk_bhcp",
          "geometry": "zamba2-7b Mamba-2 layer, prefill", "nvidia_smi": smi,
          **sd})

    # -- 7. the mLSTM chunk kernel against its plain version
    mworst, mcases = check_mlstm_sweep(torch, mk, mops)
    emit({"phase": "kernel_sweep", "kernel": "mlstm_chunk_bhsd",
          "cases": mcases, "max_abs_err": mworst, "tolerance": MLSTM_TOL})
    ml = time_mlstm(torch, mk, flush)
    emit({"phase": "kernel_time", "kernel": "mlstm_chunk_bhsd",
          "geometry": "xlstm-350m mLSTM layer, prefill", "nvidia_smi": smi,
          **ml})
    del flush

    # -- 8. the sessions path, served, for each model
    counters = {"enoki_merge_rows": kernel.enoki_merge_rows,
                "flash_attention_bhsd": fk.flash_attention_bhsd,
                "ssd_chunk_bhcp": sk.ssd_chunk_bhcp,
                "mlstm_chunk_bhsd": mk.mlstm_chunk_bhsd}
    sessions = {}
    for arch_id in SESSION_ARCHS:
        expect = {k: N_PODS * n for k, n in
                  expected_launches(session_arch(arch_id)[0]).items()}
        sessions[arch_id] = ss = run_sessions(torch, arch_id, counters,
                                              expect)
        emit({"phase": "sessions", "nvidia_smi": smi, **ss})
    for arch_id in PREFILL_ARCHS:
        sessions[arch_id] = ss = run_prefill_only(
            torch, arch_id, counters,
            expected_launches(session_arch(arch_id)[0]))
        emit({"phase": "prefill_only", "nvidia_smi": smi, **ss})

    # -- 9. the kernels line, the card, the result
    flash_launches = {a: ss["launches"]["flash_attention_bhsd"]
                      for a, ss in sessions.items()
                      if ss["launches"]["flash_attention_bhsd"]}
    emit({"phase": "done", "smoke_s": time.perf_counter() - t_start})
    t = timings[("100KB", 1)]
    merge_launches = {"serve": st["launches"],
                      "warm": warm["kernel_launches"],
                      "runtime": sum(runtime_launches.values()),
                      "replication": repl_launches}
    emit({"kernels": [{
        "name": "enoki_merge_rows", "route": "cuda", "source": MERGE_SOURCE,
        "replaces": MERGE_REPLACES,
        "launches": sum(merge_launches.values()),
        "launches_by_path": merge_launches,
        "max_abs_err": max(worst, t["max_abs_err"]), "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]}, {
        "name": "flash_attention_bhsd", "route": "cuda",
        "source": FLASH_SOURCE, "replaces": FLASH_REPLACES,
        "launches": sum(flash_launches.values()),
        "launches_by_path": flash_launches,
        "give_ups": fk.check_give_ups(),
        "max_abs_err": max([max(fworst.values())] + [
            t["max_abs_err"] for t in flash_times.values()]),
        "ms": ft["ms"], "plain_ms": ft["plain_ms"],
        "bound_ms": ft["bound_ms"], "bound_by": ft["bound_by"],
        "library_ms": ft["library_ms"],
        "by_geometry": {g: {k: t[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            for g, t in flash_times.items()}}, {
        "name": "ssd_chunk_bhcp", "route": "cuda", "source": SSD_SOURCE,
        "replaces": SSD_REPLACES,
        "launches": sessions["zamba2-7b"]["launches"]["ssd_chunk_bhcp"],
        "max_abs_err": max(max(sworst.values()), sd["max_abs_err"]),
        "ms": sd["ms"], "plain_ms": sd["plain_ms"],
        "bound_ms": sd["bound_ms"], "bound_by": sd["bound_by"],
        "bound_units": sd["bound_units"], "fma_bound_ms": sd["fma_bound_ms"],
        "library_ms": None}, {
        "name": "mlstm_chunk_bhsd", "route": "cuda", "source": MLSTM_SOURCE,
        "replaces": MLSTM_REPLACES,
        "launches": sessions["xlstm-350m"]["launches"]["mlstm_chunk_bhsd"],
        "max_abs_err": max(max(mworst.values()), ml["max_abs_err"]),
        "ms": ml["ms"], "plain_ms": ml["plain_ms"],
        "bound_ms": ml["bound_ms"], "bound_by": ml["bound_by"],
        "bound_units": ml["bound_units"], "fma_bound_ms": ml["fma_bound_ms"],
        "library_ms": None}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
