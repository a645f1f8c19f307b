#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card, and check it.

    python3 chip_smoke.py        # from the repository root; one CUDA card

Phases, each printing one JSON line (any failure raises and exits non-zero):

1. device and build — the card, its power limit, and the time ``nvcc``
   takes to build every kernel from ``src/repro_torch/kernels/*/csrc``
   (one ``nvcc`` per source, all started together); then the registers,
   static shared memory and spills that ``-Xptxas=-v`` reported for the
   wgmma flash kernel (by head dim, D=256 included), the three SSD
   kernels, the two mLSTM kernels and the merge kernel.  The dry-run's
   three children (phase 9c) start before the build, and the sweeps of
   phases 2, 5, 6 and 7 run right after it, before anything is timed:
   the children run beside untimed work only;
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
   on both paths, the differing routes counted), 28 greedy decode
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
9. the training stack (``launch/train.py``, ``optim``, ``data``,
   ``lm_loss`` under remat), phase ``train``; no kernel is on its path
   (training runs ``AttnImpl.REFERENCE``, as the reference does), so every
   kernel's count, zeroed before each part, must read 0 after it:
   ``full``: internlm2-1.8b at full width and depth (f32 params, bf16
   compute, AdamW, remat "block", seq 4,096, batch 1 of 256) for 4 steps
   on one repeated ``DataPipeline`` batch: losses and grad norms finite,
   the loss at step 4 below step 1, every state leaf finite; ms a step
   (median of steps 2-4), tokens/s, model-FLOPs share at 989 TFLOP/s,
   peak memory, and one more step profiled (idle share);
   ``cpu_twin``: depth 24 -> 2, seq 128, f32 compute, one AdamW step on
   the card and on the CPU from the same state and batch: loss, grad norm
   and every gradient leaf within 1e-4, params within 2 x lr (elements
   beyond 1e-6 counted); ``replicated``: REPLICATED, 2 pods stacked,
   depth 24 -> 2, seq 4,096, batch 1 a pod, an anti-entropy round every 2
   of 4 steps, int8 compression off and on: pods differ before each round
   and are bit-identical after it, the outer round 2, ms a step and a
   round (CUDA events), payload bytes a round; ``xlstm_grads``: xlstm-350m
   at full width and depth, seq 1,024, one loss and backward: every
   gradient finite, the sLSTM weights' non-zero, ``SLSTM_STEPS`` neither
   capturing nor replaying; ``flash_refuses``: the three model kernels and
   ``lm_loss(impl=FLASH)`` raise under autograd;
10. the mesh (``torch.distributed``), phase ``mesh``: one world of 4
   ranks spawned on the card (gloo over a ``file://`` store in ``build/``:
   NCCL takes no two ranks on one device, so every CUDA tensor a
   collective moves is staged through host memory, and these times
   measure that transport, never NCCL), every wait under a time limit,
   one JSON line a part: ``flash_decode`` (qwen1.5-110b's attention layer
   at full width, batch 128 -> 32, S = 32,768 sharded on the sequence over
   model = 4, ``length`` 20,000 so one rank's shard is part-masked and one
   wholly: the output within 5e-2 of the unsharded step on the same card,
   the caches equal bit for bit), ``moe_ep`` (kimi-k2's MoE layer at full
   width, 384 experts of 7,168 x 2,048, top-8, 96 experts and 8.5 GB a
   rank, each drawn from its own seed, 4,096 tokens, against
   ``moe_apply`` over all 384 run when the ranks' experts are freed:
   routes equal, aux within 1e-6, output within 5e-2, the same
   assignments dropped), ``pod_replicate`` (P = 2 and 4, one 64 x 1 MB
   arena a rank, "full" and "ring": every rank byte-identical to its pod
   of the stacked step on the card, P - 1 and 1 merge launches a rank,
   ms a round and its transport), ``remesh`` (internlm2-1.8b's bf16
   params at depth 24 -> 8 placed by ``param_partition_specs`` on (pod 2, model 2), a pod
   lost, every leaf re-meshed onto the survivors bit-identical),
   ``train_pods`` (REPLICATED, one pod a rank on 2 ranks, ``train.
   replicated``'s settings, int8 off: pods differ before each round,
   bit-identical after it, and equal to the stacked run's bit for bit)
   and ``sessions_pods`` (internlm2-1.8b at depth 24 -> 8, 2 ranks x 4
   sessions, 4 decode steps, replicate, pod 0 dead, migrate: equal to the
   stacked run);
11. tensor parallelism, phase ``tensor_parallel``:
   another world of 4 ranks on the card (gloo, staged through host
   memory, as in phase 10), one JSON line a part, each rank's ms beside
   its transport's and the unsharded twin's on the same card: ``prefill``
   (internlm2-1.8b at full width, depth 24 -> 8, bf16, FLASH, (data 2,
   model 2), 4 prompts of 4,096 tokens, 2 a data rank: each rank runs the
   flash kernel on its 8 query and 4 KV heads, 8 launches a rank,
   give-ups 0;
   the gathered last logits and caches within 5e-2 of rank 0's unsharded
   FLASH prefill), ``decode`` (4 greedy steps from that cache: each
   step's logits within 5e-2 of the unsharded step fed the same tokens,
   the greedy tokens that differ counted), ``train_zero1`` and
   ``train_fsdp`` (internlm2-1.8b at full width, depth 24 -> 2, seq
   4,096, a batch of 2, AdamW, remat "block", a step with ZeRO-1, then
   with FSDP: loss and grad norm within 1e-3 of the unsharded step's,
   params within 2 x lr x steps) and ``pods`` ((pod 2, model 2):
   REPLICATED steps and a round with int8 off and on, pods unequal before
   and bit-identical after; tensor-parallel session caches decoded,
   replicated round the pod ring and migrated; one PEER_FETCH step within
   f32 rounding of one CLOUD_CENTRAL step); then the moe and vlm
   families, every rank's weights drawn block by block from seeds so no
   rank holds the whole model (``_family_params``): ``moe_prefill``
   (grok-1 at full width, depth 64 -> 2, (data 2, model 2), 4 prompts of
   4,096, FLASH under "auto" and "ep", then 4 greedy steps: logits within
   5e-2 of the unsharded card run on the tokens whose (token, layer)
   routes and kept flags agree, the rest counted), ``moe_block`` (kimi-k2
   at full width, depth 61 -> 1, (data 1, model 4): 96 experts, 16 query
   and 2 KV heads of D=112 a rank, the shared expert column/row),
   ``moe_train`` (grok-1, depth 64 -> 1, (data 1, model 4), the
   reference's choices for it: bf16 params, Adafactor, remat "full",
   FSDP; a step: loss and grad norm within 1e-3, params within the
   bound ``moe_train`` derives) and ``vlm`` (phi-3-vision at full width,
   depth 32 -> 8, (data 2, model 2), 4 prompts of 4,096 behind 576 patch
   positions, 4 greedy steps, then a ZeRO-1 AdamW step at depth 32 -> 2);
   then ``audio`` (whisper-tiny at full width and depth, (data 2, model
   2): 3 of its 6 heads a rank, its odd vocabulary whole on every rank; 4
   prompts of 384 tokens behind 1,500 frames, FLASH, 4 greedy steps,
   every cache leaf against the twin's; one ZeRO-1 AdamW step in f32
   compute) and ``seq_shard`` (the ``prefill`` part's prompts under
   ``ParallelConfig(seq_shard=True)``: each rank holds (2, 2,048) tokens;
   the logits and cache against the twin's and the ``prefill`` part's);
   flash launches = the layers a rank runs, give-ups 0;
9b. the cost walker, phase ``roofline`` (``launch.roofline``): one pod's
   FLASH prefill of internlm2-1.8b, zamba2-7b and xlstm-350m (the
   sessions phase's prompts) run once under ``CostMode``, untimed: FLOPs,
   bytes, the kernels' launches (each equal to its wrapper's counter
   delta: 24 flash; 81 SSD and 13 flash; 21 mLSTM), the roofline's bound
   at the card's data-sheet peaks, its dominant term, the roofline
   fraction and the useful-FLOPs ratio against ``model_flops``, the
   walker's peak bytes beside ``max_memory_allocated``; then the same
   step timed; then ``serving_costs()`` (the batched fold per bucket, the
   K-way merges), its merge launches equal to the merge kernel's counter;
9c. the dry-run, phase ``dryrun`` (``launch.dryrun``): the train phase's
   ``full`` configuration (internlm2-1.8b, seq 4,096, batch 1, AdamW,
   remat "block") run on fake tensors in a one-rank fake world, its peak
   bytes within 10 % of the train phase's measured peak, its matmul FLOPs
   beside 6·N·D; and two production cells, gemma-7b x train_4k on (16,
   16) and phi-3-vision x decode_32k REPLICATED on (2, 16, 16) with its
   session ring (GiB a rank, dominant term, collective and pod-crossing
   bytes: 0 on the hot step, above 0 on the ring); each of the three in a
   child process that runs beside phases 1 and 2 (the children's wall and
   the seconds spent waiting for them printed apart);
12. the smoke's seconds, the ``{"kernels": [...]}`` line (the merge
   kernel's launches by path: served, warm, runtime, replication and mesh;
   flash's by model and the tensor-parallel prefills', its give-ups (0)
   and its times at the four geometries), then the card's name and power
   limit
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
# name -> B, S, H, KV, D of one rank's prefill attention layer in phase
# tensor_parallel's family parts (bf16, causal): grok-1 on (data 2, model
# 2), kimi-k2 on (data 1, model 4) (GQA 8:1 at D=112), phi-3-vision on
# (data 2, model 2)
TP_FAMILY_FLASH = {"grok-1-314b rank": (2, 4096, 24, 4, 128),
                   "kimi-k2-1t-a32b rank": (1, 4096, 16, 2, 112),
                   "phi-3-vision-4.2b rank": (2, 4096, 16, 16, 96),
                   "zamba2-7b shared block rank": (2, 4096, 16, 16, 112)}
GEMMA_FLASH = (4, 4096, 16, 16, 256, 0)
# name -> B, S, H, KV, D, causal of one rank's whisper-tiny attention in
# phase tensor_parallel's audio part (bf16): its encoder over 1,500 frames,
# its decoder over 384 tokens, 3 of the 6 heads on (data 2, model 2)
TP_AUDIO_FLASH = {"whisper-tiny encoder rank": (2, 1500, 3, 3, 64, False),
                  "whisper-tiny decoder rank": (2, 384, 3, 3, 64, True)}
# (B, H, S, P, N, chunk): tests/test_kernels.py's sweep, ragged S (a last
# chunk of 72 and of 4 rows), in f32 and bf16; then the main path's geometry
# (zamba2-7b's Mamba-2 prefill, f32 as the model feeds it)
SSD_CASES = [(1, 2, 128, 32, 16, 32), (2, 4, 256, 64, 64, 64),
             (1, 1, 64, 16, 8, 16), (1, 3, 200, 64, 64, 128),
             (2, 2, 100, 32, 16, 32)]
SSD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
MAIN_SSD = (4, 112, 4096, 64, 64, 128)
# name -> (B, H, S, P, N, chunk) of one rank's Mamba-2 layer in phase
# tensor_parallel's hybrid parts (f32 as the model feeds it): zamba2-7b's
# 112 SSM heads over model 2 and 4, 2 prompts a data rank
TP_RECURRENT_SSD = {"zamba2-7b rank, model 2": (2, 56, 4096, 64, 64, 128),
                    "zamba2-7b rank, model 4": (2, 28, 4096, 64, 64, 128)}
# (B, H, S, d, chunk): tests/test_kernels.py's sweep, reduced xlstm-350m's
# head dim 128, xlstm-350m's 512 and a ragged column tile (d=80: two CTAs a
# (b, h), the second 16 columns wide; chunk 20), in f32 and bf16; then the
# main path's
# geometry (one xlstm-350m mLSTM layer's prefill, f32 as the model feeds it)
MLSTM_CASES = [(1, 2, 128, 32, 32), (2, 2, 64, 64, 16), (1, 4, 256, 16, 64),
               (2, 2, 128, 128, 16), (1, 2, 256, 512, 64), (1, 3, 100, 80, 20)]
MLSTM_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
MAIN_MLSTM = (4, 4, 2048, 512, 64)
# name -> (B, H, S, d, chunk) of one rank's mLSTM layer in phase
# tensor_parallel's ssm parts (f32): xlstm-350m's 4 heads over model 2
TP_RECURRENT_MLSTM = {"xlstm-350m rank, model 2": (2, 2, 2048, 512, 64)}
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
# decode steps 60 -> 28 in PR 28, for the smoke's time (28 mod R = 4, as
# 60 mod R was: the same staleness check)
DECODE_STEPS, FAILOVER_STEPS = 28, 4
GRAPH_CHECK_STEPS = 4           # decode graph against the eager pod-step
PREFILL_REL_TOL = 5e-2          # tests/test_arch_smoke.py's prefill/decode bound


def roofline():
    """The port's cost module (``repro_torch.launch.roofline``): the
    card's data-sheet peaks (``HBM_BYTES_PER_S``, ``BF16_FLOPS_PER_S``,
    ``F32_FLOPS_PER_S``, ``SSD_PRODUCT_FLOPS_PER_S``: three TF32 products
    a product) and each kernel's work (``flash_work``, ``ssd_work``,
    ``mlstm_work``, ``merge_work``), so this script's kernel table and the
    walker count the same work.  Imported once ``main`` has found the port
    beside this script."""
    from repro_torch.launch import roofline as rl
    return rl


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
    rl = roofline()
    _, nbytes = rl.merge_work(k, SLOTS, row_bytes, 64, winners)
    bound_ms = nbytes / rl.HBM_BYTES_PER_S * 1e3

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
        bound_ms = nbytes / roofline().HBM_BYTES_PER_S * 1e3
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
    layout, then zamba2's geometry (bf16, causal, its window) and the
    tensor-parallel ranks' (TP_FAMILY_FLASH; bf16, causal; TP_AUDIO_FLASH,
    whisper's, its encoder's not causal); the
    model-layout wrapper (strided reads, no transposes) on the first and
    last of FLASH_CASES and on every geometry after them.  Returns (max
    abs err per dtype, the largest bf16 ratio to the rounding control,
    cases, {TP_FAMILY_FLASH and TP_AUDIO_FLASH name: its max abs err and
    bf16 ratio})."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst, cases, worst_ratio = {d: 0.0 for d in FLASH_TOL}, 0, 0.0
    B, S, H, KV, D, win = ZAMBA_FLASH
    ends = (FLASH_CASES[0], FLASH_CASES[-1])
    runs = [(c, tuple(FLASH_TOL), FLASH_MASKS, c in ends, None)
            for c in FLASH_CASES] + [
        ((B, S, S, H, KV, D), ("bfloat16",), [(True, win)], True, None)] + [
        ((B, S, S, H, KV, D), ("bfloat16",), [(True, 0)], True, name)
        for name, (B, S, H, KV, D) in TP_FAMILY_FLASH.items()] + [
        ((B, S, S, H, KV, D), ("bfloat16",), [(causal, 0)], True, name)
        for name, (B, S, H, KV, D, causal) in TP_AUDIO_FLASH.items()]
    named = {}
    for (B, Sq, Skv, H, KV, D), dtypes, masks, layout, name in runs:
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
                if layout and window in (0, Sq):
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
                    if name is not None:
                        mine = named.setdefault(name, {"max_abs_err": 0.0,
                                                       "bf16_ratio": 0.0})
                        mine["max_abs_err"] = max(mine["max_abs_err"], err)
                        mine["bf16_ratio"] = max(mine["bf16_ratio"], ratio)
                del want, got, checks
            del q, k, v
    return worst, worst_ratio, cases, named


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
    # 2·D for p·v each, per head (``roofline.flash_work``)
    rl = roofline()
    flops, nbytes = rl.flash_work(B, H, KV, S, S, D, 2, True, window)
    flop_ms = flops / rl.BF16_FLOPS_PER_S * 1e3
    byte_ms = nbytes / rl.HBM_BYTES_PER_S * 1e3
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
    """Kernel vs plain over SSD_CASES x dtypes, the main geometry and the
    tensor-parallel ranks' (TP_RECURRENT_SSD) in f32, in the kernel
    layout; the model-layout wrapper (strided reads of x, a_dt and y; dt
    weighting) on a ragged case and at the main geometry.  Returns (max
    abs err per dtype, cases, {TP_RECURRENT_SSD name: its max abs
    err})."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst, cases, named = {d: 0.0 for d in SSD_TOL}, 0, {}
    main = len(SSD_CASES)
    runs = [(c, tuple(SSD_TOL), None) for c in SSD_CASES] + [
        (MAIN_SSD, ("float32",), None)] + [
        (c, ("float32",), name) for name, c in TP_RECURRENT_SSD.items()]
    for i, ((B, H, S, P, N, chunk), dtypes, name) in enumerate(runs):
        for dtype in dtypes:
            what = f"B={B} H={H} S={S} P={P} N={N} chunk={chunk} {dtype}"
            x, a, b, c = _ssd_inputs(torch, gen, B, H, S, P, N, dtype)
            want = sk.ssd_chunk_bhcp_plain(x, a, b, c, chunk=chunk)
            got = sk.ssd_chunk_bhcp(x, a, b, c, chunk=chunk)
            torch.cuda.synchronize()
            err = _ssd_close(torch, got, want, dtype, what)
            worst[dtype] = max(worst[dtype], err)
            if name is not None:
                named[name] = {"max_abs_err": err,
                               "tolerance": SSD_TOL[dtype]}
            cases += 1
            if i in (3, main) and dtype == "float32":
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
    return worst, cases, named


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
    rl = roofline()
    flops, nbytes = rl.ssd_work(B, H, S, P, N, chunk, 4)
    flop_ms = flops / rl.SSD_PRODUCT_FLOPS_PER_S * 1e3
    fma_ms = flops / rl.F32_FLOPS_PER_S * 1e3
    byte_ms = nbytes / rl.HBM_BYTES_PER_S * 1e3
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
    """Kernel vs plain over MLSTM_CASES x dtypes, the main geometry and the
    tensor-parallel ranks' (TP_RECURRENT_MLSTM) in f32, in the kernel
    layout; the model-layout wrapper (strided reads of q/k/v and the
    gates, h written through a view) at d=128 and at the main geometry.
    Returns (max abs err per dtype, cases, {TP_RECURRENT_MLSTM name: its
    max abs err})."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst, cases, named = {d: 0.0 for d in MLSTM_TOL}, 0, {}
    main = len(MLSTM_CASES)
    runs = [(c, tuple(MLSTM_TOL), None) for c in MLSTM_CASES] + [
        (MAIN_MLSTM, ("float32",), None)] + [
        (c, ("float32",), name) for name, c in TP_RECURRENT_MLSTM.items()]
    for i, ((B, H, S, d, chunk), dtypes, name) in enumerate(runs):
        for dtype in dtypes:
            what = f"B={B} H={H} S={S} d={d} chunk={chunk} {dtype}"
            ins = _mlstm_inputs(torch, gen, B, H, S, d, dtype)
            want = mk.mlstm_chunk_bhsd_plain(*ins, chunk=chunk)
            got = mk.mlstm_chunk_bhsd(*ins, chunk=chunk)
            torch.cuda.synchronize()
            err = _mlstm_close(torch, got, want, dtype, what)
            worst[dtype] = max(worst[dtype], err)
            if name is not None:
                named[name] = {"max_abs_err": err,
                               "tolerance": MLSTM_TOL[dtype]}
            cases += 1
            if i in (3, main) and dtype == "float32":
                # the model layout: q/k/v (B,S,H,d), gates (B,S,H)
                model = [x.transpose(1, 2).contiguous() for x in ins]
                h, carry = mops.mlstm_chunk(*model, chunk=chunk)
                torch.cuda.synchronize()
                worst[dtype] = max(worst[dtype], _mlstm_close(
                    torch, (h.transpose(1, 2), carry), want, dtype,
                    what + " (model layout)"))
                cases += 1
            del ins, want, got
    return worst, cases, named


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
    rl = roofline()
    flops, nbytes = rl.mlstm_work(B, H, S, d, chunk, 4)
    flop_ms = flops / rl.SSD_PRODUCT_FLOPS_PER_S * 1e3
    fma_ms = flops / rl.F32_FLOPS_PER_S * 1e3
    byte_ms = nbytes / rl.HBM_BYTES_PER_S * 1e3
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
    kernel.  The trace is read from the profiler's kineto events as they
    came (``_trace_events``), not through ``key_averages()``, which first
    builds the tree of every host op: tens of seconds for a step of many
    small ops."""
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
    t_read = time.perf_counter()
    device, host = _trace_events(prof)
    launches, other = 0, []
    for key, (n, t) in device.items():
        name = key.lower()
        kind = ("flash_attention" if "flash_fwd" in name else "ssd_chunk"
                if "ssd_chunk" in name else "mlstm_chunk"
                if "mlstm_chunk" in name else "gemm"
                if any(g in name for g in GEMM_NAMES) else "other")
        ms[kind] += t
        launches += n
        if kind == "other":
            other.append((t, n, key[:90]))
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


def _trace_events(prof):
    """A finished ``torch.profiler`` run's device work, ``{kernel name:
    [count, ms]}``, and the host's launch calls, ``{"kernel": n, "graph":
    n}`` (``cudaLaunchKernel*`` and ``cudaGraphLaunch*``), read from its
    kineto events one by one.  What ``key_averages()`` would give for the
    same keys: user annotations and hidden events are left out, and an
    asynchronous event counts with no device time."""
    from torch.autograd import DeviceType
    device, host = {}, {"kernel": 0, "graph": 0}
    no = lambda: False                  # noqa: E731 (a method torch lacks)
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_user_annotation", no)() or \
                getattr(e, "is_hidden_event", no)():
            continue
        name = e.name()
        if e.device_type() != DeviceType.CUDA:
            if name.startswith("cudaGraphLaunch"):
                host["graph"] += 1
            elif name.startswith("cudaLaunchKernel"):
                host["kernel"] += 1
            continue
        row = device.setdefault(name, [0, 0.0])
        row[0] += 1
        if not (e.is_async() or e.start_thread_id() != e.end_thread_id()):
            row[1] += e.duration_ns() / 1e6
    return device, host


def _rel_err(torch, a, b) -> float:
    """max |a - b| / max |b| over (B, S, V) logits, one sequence at a time."""
    num = den = 0.0
    for i in range(a.shape[0]):
        x, y = a[i].float(), b[i].float()
        num = max(num, float((x - y).abs().max()))
        den = max(den, float(y.abs().max()))
    return num / (den + 1e-6)


def check_slstm_scan(torch, xlstm, params, arch, batch=None, prompt=None,
                     device="cuda"):
    """The captured sLSTM scan against the eager loop over time, bit for
    bit (hs and the carry), on the first sLSTM layer's weights and card
    inputs at the prefill's shape (B = ``batch``, SESSIONS by default; S =
    ``prompt``, the model's prompt by default) and at a ragged S of 100 (a
    36-step tail: blocks of 32 and 4); the loop's and the scan's wall ms
    at the prefill's shape."""
    cell = params["blocks"]["slstm"]["cell"]
    r, b = cell["r"][0], cell["b"][0]
    h = arch.xlstm.num_heads
    B = batch or SESSIONS
    dev = torch.device(device)
    timed = (lambda fn: _wall_ms(torch, fn)) if dev.type == "cuda" else \
        (lambda fn: _rank_ms(torch, dev, fn))      # a CPU rehearsal
    gen = torch.Generator(device=device).manual_seed(5)
    out = {}
    for S in (prompt or PROMPTS[arch.name], 100):
        wx = torch.randn((B, S, 4 * arch.d_model), generator=gen,
                         device=device).to(torch.bfloat16)
        init = xlstm.slstm_cache_init(arch, B, torch.bfloat16,
                                      device=device)
        carry = (init["c"], init["n"], init["m"], init["h"])
        (ghs, gc), scan_ms = timed(
            lambda: xlstm.slstm_scan(wx, r, b, carry, h))
        (ehs, ec), loop_ms = timed(
            lambda: xlstm.slstm_loop(wx, r, b, carry, h))
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
            / roofline().BF16_FLOPS_PER_S,
            "prefill_applied_flops_share": applied / (prefill_ms * 1e-3)
            / roofline().BF16_FLOPS_PER_S,
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
            / roofline().BF16_FLOPS_PER_S,
            "flash_vs_reference_rel_err": versus["rel_err"],
            "flash_vs_reference": versus,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "profile_prefill": profile, "give_ups": check_give_ups()}


# ---------------------------------------------------------------------------
# phase 9: the training stack
# ---------------------------------------------------------------------------

TRAIN_ARCH = "internlm2-1.8b"
TRAIN_SEQ = 4096                # train_4k's sequence
TRAIN_STEPS = 4
TRAIN_CFG = dict(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
TWIN_LAYERS, TWIN_SEQ = 2, 128  # train.cpu_twin: depth 24 -> 2
TWIN_TOL = 1e-4                 # loss, grad_norm and gradients, card vs CPU
# train.replicated and the mesh's train_pods: depth 24 -> 2 (4 -> 2 in
# PR 28, for the smoke's time), 2 pods
PODS_LAYERS, PODS = 2, 2
PODS_PERIOD = 2
XLSTM_TRAIN_SEQ = 1024          # 2,048 -> 1,024 in PR 28, for the time


def _finite_tree(torch, tree, what):
    for path, x in _leaves(tree):
        if x.is_floating_point():
            assert torch.isfinite(x).all(), f"{what}/{path} not finite"


def _no_launch(counters, what):
    """The training path runs AttnImpl.REFERENCE: no kernel launched."""
    got = {name: fn.launches for name, fn in counters.items()}
    assert not any(got.values()), f"{what} launched kernels: {got}"
    return got


def _event_ms(torch, fn):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def train_full(torch, counters):
    """internlm2-1.8b at full width and depth: f32 params, bf16 compute,
    AdamW, remat "block" (``default_parallel``), REFERENCE attention, seq
    4,096, batch 1, 4 steps on one repeated batch of the port's
    ``DataPipeline``; then one more step under the profiler."""
    from repro_torch.configs import (EnokiConfig, ShapeConfig, StepKind,
                                     TrainConfig, get_arch)
    from repro_torch.data import DataPipeline
    from repro_torch.launch import train
    from repro_torch.models import model_zoo as zoo
    arch = get_arch(TRAIN_ARCH)
    shape = ShapeConfig("train_4k", TRAIN_SEQ, 1, StepKind.TRAIN)
    par = train.default_parallel(arch, shape)
    assert (par.remat, par.optimizer) == ("block", "adamw"), par
    assert train.param_dtype_for(arch) == torch.float32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step, _ = train.make_train_step(arch, shape, 1, par, EnokiConfig(),
                                    TrainConfig(**TRAIN_CFG), device="cuda")
    state = train.init_state(arch, 0, par, device="cuda")
    state_bytes = sum(x.numel() * x.element_size()
                      for _, x in _leaves(state))
    batch = DataPipeline(arch, shape, seed=0, device="cuda").next()
    _zero(counters.values())
    losses, norms, ms = [], [], []
    for _ in range(TRAIN_STEPS):
        (_, m), t = _wall_ms(torch, lambda: step(state, batch))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        ms.append(t)
    launches = _no_launch(counters, "train.full")
    peak = torch.cuda.max_memory_allocated()
    assert all(math.isfinite(x) for x in losses + norms), (losses, norms)
    assert losses[-1] < losses[0], f"the loss did not fall: {losses}"
    _finite_tree(torch, state, "train.full state")
    assert int(state["step"]) == TRAIN_STEPS
    step_ms = statistics.median(ms[1:])
    mflops = zoo.model_flops(arch, shape)
    profile = profile_device(torch, lambda: step(state, batch))
    del state, batch
    torch.cuda.empty_cache()
    return {"arch": TRAIN_ARCH, "params": arch.param_count(),
            "reduced": {"global_batch": "256 -> 1"}, "seq": TRAIN_SEQ,
            "param_dtype": "float32", "compute_dtype": "bfloat16",
            "optimizer": par.optimizer, "remat": par.remat,
            "attention": "reference", "steps": TRAIN_STEPS,
            "losses": losses, "grad_norms": norms, "step_ms_all": ms,
            "step_ms": step_ms,
            "tokens_per_s": TRAIN_SEQ / (step_ms * 1e-3),
            "model_flops": mflops,
            "model_flops_share": mflops / (step_ms * 1e-3)
            / roofline().BF16_FLOPS_PER_S,
            "state_bytes": state_bytes, "peak_memory_bytes": peak,
            "kernel_launches": launches, "profile_step": profile}


def train_cpu_twin(torch, counters):
    """internlm2-1.8b at full width, depth 24 -> 2, seq 128, batch 1, f32
    compute: one AdamW step on the card and one on the CPU from the same
    ``init_state(seed=0)`` (made on the CPU, copied to the card) and
    batch; loss, grad_norm and every gradient leaf held to TWIN_TOL, the
    params after the step to 2 x lr (Adam's first step is ~lr x sign(g),
    so a gradient element near 0 may flip; the count of params that differ
    by more than 1e-6 is reported)."""
    from repro_torch.configs import (ShapeConfig, StepKind, TrainConfig,
                                     get_arch)
    from repro_torch.core.tree import tree_map
    from repro_torch.data import synthetic_batch
    from repro_torch.launch import train
    arch = dataclasses.replace(get_arch(TRAIN_ARCH), num_layers=TWIN_LAYERS)
    shape = ShapeConfig("twin", TWIN_SEQ, 1, StepKind.TRAIN)
    par = train.default_parallel(arch, shape)
    cfg = TrainConfig(**TRAIN_CFG)
    cpu = train.init_state(arch, 0, par, device="cpu")
    card = tree_map(lambda t: t.to("cuda", copy=True), cpu)
    bcpu = synthetic_batch(arch, shape, 0, 0, device="cpu")
    bcard = {k: v.to("cuda") for k, v in bcpu.items()}
    loss_fn = train.make_loss_fn(arch, par, compute_dtype=torch.float32)
    _zero(counters.values())
    (lc, _, gc), (lg, _, gg) = (
        train.value_and_grad(loss_fn, st["params"], b)
        for st, b in ((cpu, bcpu), (card, bcard)))
    grad_err = 0.0
    want = dict(_leaves(gc))
    for path, x in _leaves(gg):
        y = want[path]
        e = float((x.cpu() - y).abs().max()) / (float(y.abs().max()) + 1e-30)
        assert e <= TWIN_TOL, f"gradient {path}: {e}"
        grad_err = max(grad_err, e)
    del gc, gg
    step = train.make_step_fn(arch, par, cfg, compute_dtype=torch.float32)
    _, mc = step(cpu, bcpu)
    _, mg = step(card, bcard)
    torch.cuda.synchronize()
    launches = _no_launch(counters, "train.cpu_twin")
    rel = {k: abs(float(mg[k]) - float(mc[k])) / abs(float(mc[k]))
           for k in ("loss", "grad_norm")}
    assert all(v <= TWIN_TOL for v in rel.values()), rel
    assert abs(float(lg) - float(lc)) <= TWIN_TOL * abs(float(lc))
    worst, over, total = 0.0, 0, 0
    want = dict(_leaves(cpu["params"]))
    for path, x in _leaves(card["params"]):
        d = (x.cpu() - want[path]).abs()
        worst = max(worst, float(d.max()))
        over += int((d > 1e-6).sum())
        total += d.numel()
    assert worst <= 2 * cfg.lr, f"params after the step: {worst}"
    del cpu, card
    torch.cuda.empty_cache()
    return {"arch": TRAIN_ARCH,
            "reduced": {"num_layers": f"24 -> {TWIN_LAYERS}",
                        "seq_len": f"4096 -> {TWIN_SEQ}"},
            "compute_dtype": "float32", "loss_rel_err": rel["loss"],
            "grad_norm_rel_err": rel["grad_norm"],
            "grad_max_err_of_leaf_max": grad_err,
            "params_max_abs_diff": worst, "params_over_1e-6": over,
            "params_total": total, "tolerance": TWIN_TOL,
            "params_bound": 2 * cfg.lr, "kernel_launches": launches}


def _pods_differ(torch, params) -> float:
    return max(float((x[0].float() - x[1].float()).abs().max())
               for _, x in _leaves(params))


def train_replicated(torch, counters, compress):
    """REPLICATED, 2 pods stacked on the card: internlm2-1.8b at full width,
    depth 24 -> 2, seq 4,096, batch 1 a pod, pod-sharded data, an
    anti-entropy round every 2 of 4 steps; the pods differ before each
    round and are bit-identical after it."""
    from repro_torch.configs import (EnokiConfig, ReplicationPolicy,
                                     ShapeConfig, StepKind, TrainConfig,
                                     get_arch)
    from repro_torch.core.tree import tree_map
    from repro_torch.data import DataPipeline
    from repro_torch.launch import train
    from repro_torch.optim import diloco_init, diloco_local_delta
    from repro_torch.optim.compression import (compressed_bytes,
                                               tree_int8_compress)
    arch = dataclasses.replace(get_arch(TRAIN_ARCH), num_layers=PODS_LAYERS)
    shape = ShapeConfig("pods", TRAIN_SEQ, PODS, StepKind.TRAIN)
    par = train.default_parallel(arch, shape)
    enoki = EnokiConfig(policy=ReplicationPolicy.REPLICATED,
                        replication_period=PODS_PERIOD,
                        compress_deltas=compress)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step, _ = train.make_train_step(arch, shape, PODS, par, enoki,
                                    TrainConfig(**TRAIN_CFG), device="cuda")
    replicate, _ = train.make_replicate_step(arch, PODS, par, enoki,
                                             device="cuda")
    single = train.init_state(arch, 0, par, device="cuda")
    state = tree_map(lambda l: torch.stack([l] * PODS), single)
    outer = diloco_init(single["params"])
    del single
    pipes = [DataPipeline(arch, shape, seed=0, shard=p, num_shards=PODS,
                          device="cuda") for p in range(PODS)]
    _zero(counters.values())
    step_ms, round_ms, before, losses, payload = [], [], [], [], None
    for i in range(TRAIN_STEPS):
        shards = [p.next() for p in pipes]
        batch = tree_map(lambda *xs: torch.stack(xs), *shards)
        (_, m), t = _event_ms(torch, lambda: step(state, batch))
        step_ms.append(t)
        losses.append([float(x) for x in m["loss"]])
        if (i + 1) % PODS_PERIOD:
            continue
        before.append(_pods_differ(torch, state["params"]))
        assert before[-1] > 0, "pods must differ before anti-entropy"
        if payload is None:     # what one pod puts on the wire a round
            delta = diloco_local_delta(outer["outer_params"], tree_map(
                lambda x: x[0], state["params"]))
            payload = PODS * compressed_bytes(
                tree_int8_compress(delta) if compress else delta)
            del delta
        (_, outer), t = _event_ms(torch, lambda: replicate(state, outer))
        round_ms.append(t)
        for path, x in _leaves(state["params"]):
            assert torch.equal(x[0], x[1]), f"pods differ after: {path}"
    launches = _no_launch(counters, "train.replicated")
    assert int(outer["round"]) == TRAIN_STEPS // PODS_PERIOD
    assert all(math.isfinite(x) for l in losses for x in l), losses
    _finite_tree(torch, state, "train.replicated state")
    peak = torch.cuda.max_memory_allocated()
    del state, outer, pipes
    torch.cuda.empty_cache()
    return {"compress_deltas": compress, "pods": PODS,
            "reduced": {"num_layers": f"24 -> {PODS_LAYERS}",
                        "global_batch": f"256 -> {PODS}"},
            "params_a_pod": arch.param_count(), "seq": TRAIN_SEQ,
            "period": PODS_PERIOD, "steps": TRAIN_STEPS, "losses": losses,
            "step_ms": step_ms, "round_ms": round_ms,
            "pods_max_diff_before": before, "pods_identical_after": True,
            "outer_round": TRAIN_STEPS // PODS_PERIOD,
            "payload_bytes_a_round": payload, "peak_memory_bytes": peak,
            "kernel_launches": launches}


def train_xlstm_grads(torch, counters):
    """xlstm-350m at full width and depth, seq 1,024, batch 1, the
    groupnorm scales set to 1: one loss and backward (f32 params, bf16
    compute, remat "block"); every parameter leaf gets a finite gradient,
    the sLSTM leaves a non-zero one, and ``SLSTM_STEPS`` captures and
    replays nothing across the step (under autograd the scan runs the
    eager loop)."""
    from repro_torch.configs import ShapeConfig, StepKind, get_arch
    from repro_torch.data import synthetic_batch
    from repro_torch.launch import train
    from repro_torch.models import xlstm
    arch = get_arch("xlstm-350m")
    shape = ShapeConfig("train", XLSTM_TRAIN_SEQ, 1, StepKind.TRAIN)
    par = train.default_parallel(arch, shape)
    state = train.init_state(arch, 0, par, device="cuda")
    params = state["params"]
    for group in ("mlstm", "slstm"):
        params["blocks"][group]["cell"]["norm"].fill_(1.0)
    batch = synthetic_batch(arch, shape, 0, 0, device="cuda")
    cache = xlstm.SLSTM_STEPS
    before = (cache.captures, cache.replays)
    _zero(counters.values())
    (loss, _, grads), ms = _wall_ms(torch, lambda: train.value_and_grad(
        train.make_loss_fn(arch, par), params, batch))
    launches = _no_launch(counters, "train.xlstm_grads")
    assert (cache.captures, cache.replays) == before, "SLSTM_STEPS moved"
    assert math.isfinite(float(loss))
    _finite_tree(torch, grads, "xlstm grads")
    slstm = {k: float(grads["blocks"]["slstm"]["cell"][k].abs().max())
             for k in ("w_in", "r", "b")}
    assert all(v > 0 for v in slstm.values()), slstm
    del state, params, grads
    torch.cuda.empty_cache()
    return {"arch": "xlstm-350m", "seq": XLSTM_TRAIN_SEQ, "loss": float(loss),
            "loss_and_backward_ms": ms, "slstm_grad_max_abs": slstm,
            "slstm_steps_captures_replays": list(before),
            "kernel_launches": launches}


def train_flash_refuses(torch, counters):
    """Under autograd on the card each of the three model kernels raises,
    and so does ``lm_loss(impl=FLASH)`` with its backward; nothing is
    launched."""
    from repro_torch.configs import AttnImpl, get_arch, reduced
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.mlstm_chunk import kernel as mk
    from repro_torch.kernels.ssd_chunk import kernel as sk
    from repro_torch.models import model_zoo as zoo
    gen = torch.Generator(device="cuda").manual_seed(0)
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")
    q, k, v = r(1, 2, 128, 64), r(1, 2, 128, 64), r(1, 2, 128, 64)
    calls = {
        "flash_attention_bhsd": lambda t: fk.flash_attention_bhsd(t, k, v),
        "ssd_chunk_bhcp": lambda t: sk.ssd_chunk_bhcp(
            t, r(1, 2, 128), r(1, 1, 128, 64), r(1, 1, 128, 64)),
        "mlstm_chunk_bhsd": lambda t: mk.mlstm_chunk_bhsd(
            t, k, v, r(1, 2, 128), r(1, 2, 128)),
    }
    arch = reduced(get_arch(TRAIN_ARCH))
    params = zoo.init_params(arch, seed=0, device="cuda")
    for p in (x for _, x in _leaves(params)):
        p.requires_grad_()
    batch = {"tokens": torch.zeros((1, 64), dtype=torch.int32,
                                   device="cuda")}
    batch["labels"] = batch["tokens"]

    def flash_loss(_):
        zoo.lm_loss(arch, params, batch, impl=AttnImpl.FLASH)[0].backward()
    calls["lm_loss(impl=FLASH)"] = flash_loss
    _zero(counters.values())
    refused = {}
    for name, call in calls.items():
        try:
            call(q.clone().requires_grad_())
        except RuntimeError as e:
            assert "no backward" in str(e), e
            refused[name] = str(e).split(":")[0]
        else:
            raise AssertionError(f"{name} ran under autograd")
    torch.cuda.synchronize()
    return {"refused": refused,
            "kernel_launches": _no_launch(counters, "train.flash_refuses")}


def run_train(torch, counters):
    """The ``train`` phase: its five parts, in turn."""
    t0 = time.perf_counter()
    out = {"full": train_full(torch, counters),
           "cpu_twin": train_cpu_twin(torch, counters),
           "replicated": [train_replicated(torch, counters, c)
                          for c in (False, True)],
           "xlstm_grads": train_xlstm_grads(torch, counters),
           "flash_refuses": train_flash_refuses(torch, counters)}
    out["wall_s"] = time.perf_counter() - t0
    return out


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


# ---------------------------------------------------------------------------
# phases 9b and 9c: the cost walker and the dry-run
# ---------------------------------------------------------------------------

ROOFLINE_ARCHS = ("internlm2-1.8b", "zamba2-7b", "xlstm-350m")
# the dry-run's cells, each in a child process: the train phase's ``full``
# configuration on one card (seq 4,096, batch 1), and two production cells
# (arch, shape, multi_pod)
DRYRUN_FULL = {"arch": TRAIN_ARCH, "shape": "train_4k", "multi_pod": False,
               "mesh_shape": [1], "seq": TRAIN_SEQ, "batch": 1}
DRYRUN_CELLS = (("gemma-7b", "train_4k", False),
                ("phi-3-vision-4.2b", "decode_32k", True))
DRYRUN_PEAK_TOL = 0.10          # the dry-run's peak against train.full's
DRYRUN_TIMEOUT_S = 600.0

_DRYRUN_CHILD = """
import dataclasses, json, sys
sys.path.insert(0, "src")
from repro_torch.configs import get_shape
from repro_torch.launch import dryrun
cell = json.loads(sys.argv[1])
shape = get_shape(cell["shape"])
if "seq" in cell:
    shape = dataclasses.replace(shape, seq_len=cell["seq"],
                                global_batch=cell["batch"])
rec = dryrun.run_cell(cell["arch"], cell["shape"], cell["multi_pod"],
                      "replicated", verbose=False, shape=shape,
                      mesh_shape=cell.get("mesh_shape"))
rec["fake_device"] = dryrun.fake_device()
print(json.dumps(rec, default=str))
"""


def start_dryrun_cells():
    """Start ``DRYRUN_FULL`` and each of ``DRYRUN_CELLS`` in a child process
    (fake tensors: host work only, no card memory beyond a context), all
    at once.  ``main`` starts them before the build, so they run beside
    the build and the kernel sweeps, where nothing is timed, and
    ``collect_dryrun_cells`` waits for them before the first timed phase.
    Any child still running when this process exits is stopped."""
    import atexit
    cells = [DRYRUN_FULL] + [{"arch": a, "shape": s, "multi_pod": mp}
                             for a, s, mp in DRYRUN_CELLS]
    procs = {(c["arch"], c["shape"]): subprocess.Popen(
        [sys.executable, "-c", _DRYRUN_CHILD, json.dumps(c)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in cells}
    atexit.register(_stop_children, list(procs.values()))
    return {"started": time.perf_counter(), "procs": procs}


def _stop_children(procs) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def collect_dryrun_cells(started):
    """Every child's record (``_collect``) by (arch, shape), the children's
    wall seconds from their start to the last record (``children_s``),
    and the part of it this process spent waiting here (``waited_s``)."""
    t0 = time.perf_counter()
    try:
        records = {key: _collect(proc)
                   for key, proc in started["procs"].items()}
    finally:
        _stop_children(started["procs"].values())
    end = time.perf_counter()
    return {"records": records, "children_s": end - started["started"],
            "waited_s": end - t0}


def _collect(proc):
    """The record a dry-run child printed."""
    try:
        stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, stderr[-4000:]
    rec = json.loads(stdout.splitlines()[-1])
    assert rec.get("ok") is True, rec.get("traceback")
    return rec


def _tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for _, x in _leaves(tree))


def roofline_prefill(torch, arch_id, counters):
    """One pod's FLASH prefill of ``arch_id`` (the sessions phase's
    prompts and weights from the same seed) under the cost walker once,
    then timed; the walker's kernel launches must equal the wrappers'
    counter deltas around the walked call, and that delta and the one
    around the timed call must each equal ``expected_launches``."""
    from repro_torch.configs import AttnImpl, ShapeConfig, StepKind
    from repro_torch.kernels.flash_attention.kernel import check_give_ups
    from repro_torch.launch import serve
    from repro_torch.models import model_zoo as zoo
    rl = roofline()
    arch, _ = session_arch(arch_id)
    prompt = PROMPTS[arch_id]
    shape = ShapeConfig("roofline_prefill", prompt, SESSIONS,
                        StepKind.PREFILL)
    torch.cuda.empty_cache()
    params = zoo.init_params(arch, seed=0, dtype=serve.serve_param_dtype(arch),
                             device="cuda")
    if zoo.transformer.plan(arch)["kind"] == "xlstm":
        blocks = params["blocks"]       # unit groupnorm scales (run_sessions)
        for cell in (blocks["mlstm"]["cell"], blocks["slstm"]["cell"]):
            cell["norm"].fill_(1.0)
    gen = torch.Generator(device="cuda").manual_seed(3)
    batch = {"tokens": torch.randint(0, arch.vocab_size, (SESSIONS, prompt),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32),
             **stub_inputs(torch, arch, SESSIONS, gen)}
    prefill = serve.make_prefill_step(arch, shape, impl=AttnImpl.FLASH,
                                      device="cuda")
    torch.cuda.synchronize()
    before = {k: fn.launches for k, fn in counters.items()}
    t0 = time.perf_counter()
    walk = rl.analyze_step(prefill, params, batch)
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - t0
    check_give_ups()
    delta = {k: fn.launches - before[k] for k, fn in counters.items()
             if fn.launches != before[k]}
    expect = expected_launches(arch)
    assert walk["kernel_launches"] == delta == expect, \
        f"{arch_id}: walker {walk['kernel_launches']}, counters {delta}, " \
        f"expected {expect}"
    arg_bytes = _tree_bytes(params) + _tree_bytes(batch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = {k: fn.launches for k, fn in counters.items()}
    (logits, _), ms = _wall_ms(torch, lambda: prefill(params, batch))
    peak = torch.cuda.max_memory_allocated()
    check_give_ups()
    timed = {k: fn.launches - before[k] for k, fn in counters.items()
             if fn.launches != before[k]}
    assert timed == expect, \
        f"{arch_id}: timed prefill launched {timed}, expected {expect}"
    assert torch.isfinite(logits.float()).all(), f"{arch_id} logits"
    mflops = zoo.model_flops(arch, shape)
    terms = rl.roofline_terms(walk, mflops, 1)
    bound_ms = terms["bound_step_s"] * 1e3
    del params, batch, logits
    torch.cuda.empty_cache()
    launches = {k: delta.get(k, 0) + timed.get(k, 0)
                for k in sorted(set(delta) | set(timed))}
    return {"arch": arch_id, "sessions": SESSIONS, "prompt": prompt,
            "impl": "flash", "flops": walk["flops_per_device"],
            "bytes": walk["bytes_per_device"],
            "kernel_launches": walk["kernel_launches"],
            "kernel_work": walk["kernel_work"],
            "counter_delta": delta, "timed_counter_delta": timed,
            "walk_s": walk_s,
            "compute_ms": terms["compute_s"] * 1e3,
            "memory_ms": terms["memory_s"] * 1e3, "bound_ms": bound_ms,
            "dominant": terms["dominant"], "ms": ms,
            "bound_over_ms": bound_ms / ms,
            "roofline_fraction": terms["roofline_fraction"],
            "useful_flops_ratio": terms["useful_flops_ratio"],
            "model_flops": mflops,
            "model_flops_share": mflops / (ms * 1e-3) / rl.BF16_FLOPS_PER_S,
            "walker_peak_bytes": walk["peak_bytes"],
            "argument_bytes": arg_bytes,
            "max_memory_allocated": peak,
            "measured_peak_bytes": peak - base + arg_bytes,
            "launches": launches}


def run_roofline(torch, counters):
    """Phase ``roofline``: ``roofline_prefill`` for each of
    ``ROOFLINE_ARCHS``, then ``serving_costs()`` on the card, whose merge
    launches must equal the merge kernel's counter delta."""
    rl = roofline()
    out = {arch_id: roofline_prefill(torch, arch_id, counters)
           for arch_id in ROOFLINE_ARCHS}
    merge = counters["enoki_merge_rows"]
    before = merge.launches
    rows = rl.serving_costs()
    torch.cuda.synchronize()
    merges = merge.launches - before
    walked = sum(r["kernel_launches"] for r in rows)
    assert walked == merges, f"serving_costs: walker {walked}, counter " \
        f"{merges}"
    by = {(r["program"], r["size"]): r["bytes"] for r in rows}
    assert 4.0 <= by[("fold", "bucket=64")] / by[("fold", "bucket=8")] \
        <= 12.0, by
    assert by[("merge/aligned", "K=4")] < 0.6 * by[("merge/fallback", "K=4")]
    out["serving_costs"] = {"rows": rows, "merge_launches": merges}
    return out


def _cell_line(rec):
    """What the phase prints of a dry-run record."""
    line = {"arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
            "ok": rec.get("ok"), "chips": rec.get("chips"),
            "build_s": rec.get("build_s")}
    if not rec.get("ok"):
        line["error"] = rec.get("error") or rec.get("refuse_reason")
        return line
    hlo, mem = rec["hlo"], rec["memory"]
    line.update(gib_a_rank=mem["peak_bytes"] / 2**30, fits=mem["fits"],
                argument_bytes=mem["argument_bytes"],
                dominant=rec["roofline"]["dominant"],
                roofline_fraction=rec["roofline"]["roofline_fraction"],
                flops=hlo["flops_per_device"],
                model_flops=rec["model_flops"],
                collective_bytes=hlo["collective_bytes_per_device"],
                pod_crossing_bytes=hlo.get("pod_crossing_bytes_per_device"))
    if "replication_step" in rec:
        rep = rec["replication_step"]
        line["replication_step"] = {
            "collective_bytes": rep["collective_bytes_per_device"],
            "pod_crossing_bytes": rep["pod_crossing_bytes_per_device"]}
    return line


def run_dryrun(torch, train_rec, cells=None):
    """Phase ``dryrun``, on the records of the children of
    ``start_dryrun_cells`` (``cells``, from ``collect_dryrun_cells``;
    started and collected here when None): (a) the train phase's ``full``
    configuration on fake tensors in a one-rank fake world, its peak
    within ``DRYRUN_PEAK_TOL`` of ``train_rec["peak_memory_bytes"]``; (b)
    the production cells: ok, and the REPLICATED multi-pod cell's pods
    crossed on its ring only."""
    if cells is None:
        cells = collect_dryrun_cells(start_dryrun_cells())
    records = dict(cells["records"])
    rec = records.pop((DRYRUN_FULL["arch"], DRYRUN_FULL["shape"]))
    measured = train_rec["peak_memory_bytes"]
    peak = rec["memory"]["peak_bytes"]
    rel = abs(peak - measured) / measured
    assert rel <= DRYRUN_PEAK_TOL, \
        f"dry-run peak {peak} against the train phase's {measured}"
    full = {**_cell_line(rec), "fake_device": rec["fake_device"],
            "seq": DRYRUN_FULL["seq"], "batch": DRYRUN_FULL["batch"],
            "measured_peak_bytes": measured, "peak_rel_err": rel,
            "six_n_d": rec["model_flops"],
            "flops_over_six_n_d": rec["hlo"]["flops_per_device"]
            / rec["model_flops"]}
    lines = {}
    for (arch_id, shape_id), cell in records.items():
        lines[f"{arch_id} x {shape_id}"] = line = _cell_line(cell)
        if "replication_step" in line:
            assert line["pod_crossing_bytes"] == 0, line
            assert line["replication_step"]["pod_crossing_bytes"] > 0, line
    return {"train_full": full, "cells": lines,
            "children_s": cells["children_s"], "waited_s": cells["waited_s"]}


# ---------------------------------------------------------------------------
# phase 10: the mesh (torch.distributed), four ranks sharing the card
# ---------------------------------------------------------------------------

MESH_RANKS = 4
MESH_TIMEOUT_S = 600.0          # the whole world, spawn to last answer
MESH_REPS = 5                   # timed repeats (CUDA events, medians;
                                # 10 -> 5 in PR 28, for the smoke's time)
FD_ARCH = "qwen1.5-110b"        # flash_decode: one attention layer
FD_BATCH = 32                   # decode_32k's 128 sessions cut to 32
FD_SEQ = 32768                  # decode_32k's sequence
FD_LENGTH = 20000               # model shard 2 part-masked, shard 3 wholly
EP_ARCH = "kimi-k2-1t-a32b"     # moe_ep: one MoE layer, 384 experts
EP_TOKENS = 4096
SESS_ARCH = TRAIN_ARCH          # sessions_pods, remesh: internlm2-1.8b
SESS_SESSIONS = 4
SESS_CACHE = 4096
SESS_LENGTH = 4000
SESS_STEPS = 4                  # 8 -> 4 in PR 28, for the smoke's time
SESS_LAYERS = 8                 # remesh, sessions_pods and the pods'
                                # sessions: depth 24 -> 8 in PR 28, for
                                # the smoke's time
MESH_PARTS = ("flash_decode", "moe_ep", "pod_replicate", "remesh",
              "train_pods", "sessions_pods")


def mesh_config(device="cuda", reduce=None):
    """What the ``mesh`` phase runs, at full width on the card; ``reduce``
    (a function of an arch) and smaller sizes rehearse it on the CPU."""
    return {"device": device, "reduce": reduce, "fd_batch": FD_BATCH,
            "fd_seq": FD_SEQ, "fd_length": FD_LENGTH,
            "ep_tokens": EP_TOKENS, "repl_width": ROW_1MB,
            "train_layers": PODS_LAYERS, "train_seq": TRAIN_SEQ,
            "sess_cache": SESS_CACHE, "sess_length": SESS_LENGTH,
            "sess_layers": SESS_LAYERS, "reps": MESH_REPS}


def _arch(cfg, arch_id, **changes):
    from repro_torch.configs import get_arch
    arch = get_arch(arch_id)
    if cfg["reduce"] is not None:
        arch = cfg["reduce"](arch)
    return dataclasses.replace(arch, **changes) if changes else arch


def _depth_cut(arch_id, arch) -> dict:
    """A record's ``reduced`` entry for ``arch`` cut in depth from
    ``arch_id``'s published config."""
    from repro_torch.configs import get_arch
    return {"num_layers": f"{get_arch(arch_id).num_layers} -> "
                          f"{arch.num_layers}"}


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _free(torch, dev):
    if dev.type == "cuda":
        import gc
        gc.collect()                # tensors held only by reference cycles
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def _rank_ms(torch, dev, fn):
    """``fn()`` and its ms: CUDA events on the card, the host clock on the
    CPU (a rehearsal)."""
    if dev.type == "cuda":
        return _event_ms(torch, fn)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def _median_rank_ms(torch, dev, fn, reps):
    return statistics.median(_rank_ms(torch, dev, fn)[1]
                             for _ in range(reps))


def _digest(torch, tree) -> str:
    """sha256 of every leaf's bytes in path order (bit-for-bit checks
    across processes without moving the tensors)."""
    import hashlib
    h = hashlib.sha256()
    for path, x in sorted(_leaves(tree), key=lambda px: px[0]):
        h.update(path.encode())
        h.update(x.detach().contiguous().reshape(-1).view(torch.uint8)
                 .cpu().numpy())
    return h.hexdigest()


def _rel(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max() /
                 want.float().abs().max())


def _gather_obj(obj, group=None) -> list:
    import torch.distributed as dist
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def _normal_(torch, t, seed, scale):
    gen = torch.Generator(device=t.device).manual_seed(seed)
    return t.normal_(generator=gen).mul_(scale)


def mesh_flash_decode(torch, rank, cfg, dev, mesh):
    """qwen1.5-110b's attention layer, the cache sharded on the sequence
    over model = 4; rank 0 then runs the unsharded step on the same
    numbers."""
    from repro_torch.models import attention as attn
    arch = _arch(cfg, FD_ARCH)
    B, S, n = cfg["fd_batch"], cfg["fd_seq"], MESH_RANKS
    KV, D = arch.num_kv_heads, arch.resolved_head_dim
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(11)
    ap = attn.attn_init(gen, arch, dtype=bf16)
    for j, k in enumerate(("bq", "bk", "bv")):
        _normal_(torch, ap[k], 12 + j, 0.02)
    x1 = torch.randn((B, 1, arch.d_model), generator=gen, device=dev,
                     dtype=bf16)
    length = torch.tensor(cfg["fd_length"], dtype=torch.int32, device=dev)

    def chunk(c, which):
        t = torch.empty((B, S // n, KV, D), dtype=bf16, device=dev)
        return _normal_(torch, t, 100 + 2 * c + which, 1.0)

    ck, cv = chunk(rank, 0), chunk(rank, 1)
    step = lambda: attn.decode_self_attention_sharded(
        ap, x1, ck, cv, length, arch, mesh)
    y, _, _ = step()
    _sync(torch, dev)
    ms = [_rank_ms(torch, dev, step)[1] for _ in range(cfg["reps"])]
    mine = {"ms": statistics.median(ms), "y": _digest(torch, y),
            "cache": _digest(torch, {"k": ck, "v": cv})}
    ranks = _gather_obj(mine)
    del ck, cv
    _free(torch, dev)
    if rank != 0:
        return {}
    ckf = torch.cat([chunk(c, 0) for c in range(n)], 1)
    cvf = torch.cat([chunk(c, 1) for c in range(n)], 1)
    plain = lambda: attn.decode_self_attention(ap, x1, ckf, cvf, length,
                                               arch)
    y0, _, _ = plain()
    plain_ms = _median_rank_ms(torch, dev, plain, cfg["reps"])
    s = S // n
    caches = [_digest(torch, {"k": ckf[:, c * s:(c + 1) * s],
                              "v": cvf[:, c * s:(c + 1) * s]})
              for c in range(n)]
    rel = _rel(torch, y, y0)
    rec = {"geometry": {"arch": FD_ARCH, "d_model": arch.d_model,
                        "heads": arch.num_heads, "kv_heads": KV,
                        "head_dim": D, "batch": B, "seq": S,
                        "length": cfg["fd_length"], "model": n,
                        "positions_a_rank": s},
           "reduced": {"global_batch": f"128 -> {B}"},
           "valid_positions_by_rank": [max(0, min(s, cfg["fd_length"] + 1
                                                  - c * s))
                                       for c in range(n)],
           "rel_err": rel, "tolerance": PREFILL_REL_TOL,
           "outputs_equal_across_ranks": len({r["y"] for r in ranks}) == 1,
           "caches_equal": [r["cache"] for r in ranks] == caches,
           "rank_ms": [r["ms"] for r in ranks], "unsharded_ms": plain_ms}
    assert rel < PREFILL_REL_TOL, rec
    assert rec["caches_equal"] and rec["outputs_equal_across_ranks"], rec
    del ckf, cvf
    return rec


def _expert_weights(torch, arch, lo, n, dev):
    """Experts lo..lo+n-1 of the MoE layer, each drawn from its own seed
    (so a rank draws only its own, and the unsharded layer the same
    numbers)."""
    cfg = arch.moe
    d, f, bf16 = arch.d_model, cfg.d_expert, torch.bfloat16
    w = {"w_gate": torch.empty((n, d, f), dtype=bf16, device=dev),
         "w_up": torch.empty((n, d, f), dtype=bf16, device=dev),
         "w_down": torch.empty((n, f, d), dtype=bf16, device=dev)}
    for i in range(n):
        for j, (name, t) in enumerate(w.items()):
            _normal_(torch, t[i], 10_000 + 3 * (lo + i) + j,
                     t.shape[1] ** -0.5)
    return w


def mesh_moe_ep(torch, rank, cfg, dev, mesh):
    """kimi-k2's MoE layer expert-parallel over model = 4 (96 experts a
    rank); rank 0 then runs ``moe_apply`` over all 384 when the ranks'
    experts are freed."""
    from repro_torch.configs import Activation
    from repro_torch.models import moe
    from repro_torch.models.layers import mlp_init
    arch = _arch(cfg, EP_ARCH)
    E, n = arch.moe.num_experts, MESH_RANKS
    e_local = E // n
    gen = torch.Generator(device=dev).manual_seed(21)
    shared = {"router": torch.randn((arch.d_model, E), generator=gen,
                                    device=dev) * arch.d_model ** -0.5,
              "shared": mlp_init(gen, arch.d_model, arch.moe.d_expert,
                                 Activation.SWIGLU, dtype=torch.bfloat16)}
    x = torch.randn((1, cfg["ep_tokens"], arch.d_model), generator=gen,
                    device=dev, dtype=torch.bfloat16)
    params = {**shared, **_expert_weights(torch, arch, rank * e_local,
                                          e_local, dev)}
    layer = lambda: moe.moe_apply_ep(params, x, arch, mesh)
    (y, aux) = layer()
    _sync(torch, dev)
    ms = _median_rank_ms(torch, dev, layer, max(3, cfg["reps"] // 2))
    xt = x.reshape(-1, arch.d_model)
    idx, _, _ = moe.route(shared["router"], xt, arch.moe)
    cap = moe.capacity(xt.shape[0], arch.moe)
    flat = idx.reshape(-1)
    rel = flat - rank * e_local
    kept = (moe.rank_in_expert(flat, E) < cap) & (rel >= 0) & \
        (rel < e_local)
    mine = {"ms": ms, "y": _digest(torch, y), "routes": _digest(torch, idx),
            "kept": kept.cpu().numpy(),
            "weight_bytes": sum(t.numel() * t.element_size()
                                for k, t in params.items()
                                if k.startswith("w_"))}
    ranks = _gather_obj(mine)
    del params
    _free(torch, dev)
    _gather_obj(None)             # every rank's experts freed
    if rank != 0:
        return {}
    full = {**shared, **_expert_weights(torch, arch, 0, E, dev)}
    unsharded = lambda: moe.moe_apply(full, x, arch)
    y0, aux0 = unsharded()
    plain_ms = _median_rank_ms(torch, dev, unsharded,
                               max(3, cfg["reps"] // 2))
    slot0, kept0 = moe.dispatch_indices(idx, E, cap)
    kept_ep = ranks[0]["kept"].copy()
    for r in ranks[1:]:
        kept_ep |= r["kept"]
    rel = _rel(torch, y, y0)
    rec = {"geometry": {"arch": EP_ARCH, "experts": E, "top_k":
                        arch.moe.top_k, "d_model": arch.d_model,
                        "d_expert": arch.moe.d_expert, "tokens":
                        xt.shape[0], "mesh": {"data": 1, "model": n},
                        "experts_a_rank": e_local, "capacity": cap},
           "expert_weight_bytes": sum(r["weight_bytes"] for r in ranks),
           "weight_bytes_a_rank": ranks[0]["weight_bytes"],
           "routes_equal": len({r["routes"] for r in ranks}) == 1 and
           ranks[0]["routes"] == _digest(torch, idx),
           "aux_diff": abs(float(aux) - float(aux0)),
           "rel_err": rel, "tolerance": PREFILL_REL_TOL,
           "dropped": int((~kept0).sum()),
           "dropped_equal": bool((kept_ep == kept0.cpu().numpy()).all()),
           "outputs_equal_across_ranks": len({r["y"] for r in ranks}) == 1,
           "rank_ms": [r["ms"] for r in ranks], "unsharded_ms": plain_ms}
    assert rec["routes_equal"] and rec["dropped_equal"], rec
    assert rec["aux_diff"] < 1e-6 and rel < PREFILL_REL_TOL, rec
    assert rec["outputs_equal_across_ranks"], rec
    del full
    return rec


def mesh_pod_replicate(torch, rank, cfg, dev, meshes, counters):
    """P = 2 (ranks 0, 1) and 4 pods, one 64 x 1 MB slot-aligned arena a
    rank (the ``replication`` phase's state): one round of each topology,
    every rank's replica byte-identical to its pod of the stacked form on
    the same card; launches counted on every rank."""
    from repro_torch.core import replication as rep
    from repro_torch.parallel.collectives import all_gather, ppermute
    out, launches = {}, 0
    for pods in REPL_PODS:
        mesh = meshes[pods]
        if mesh.get_coordinate() is None:
            continue
        group = mesh.get_group("pod")
        cpu = replication_state(torch, pods, cfg["repl_width"])
        mine = type(cpu)(*(x[rank].to(dev) for x in cpu))
        rec = {"pods": pods, "arena_bytes": sum(x.numel() * x.element_size()
                                                 for x in mine)}
        for topo in rep.TOPOLOGIES:
            step = rep.make_pod_replicate_step(rep.merge_arena_aligned, pods,
                                               topo, device=dev, mesh=mesh)
            _sync(torch, dev)
            # -- the counted run: counts zeroed just before the path
            _zero(counters)
            got = step(mine)
            _sync(torch, dev)
            n = _merge_launches(counters)
            # -- end of the counted run
            want_n = pods - 1 if topo == "full" else 1
            assert n == want_n, f"{topo} P={pods}: {n} launches"
            launches += n
            perm = [((i + 1) % pods, i) for i in range(pods)]
            move = (lambda: [all_gather(x, mesh, "pod") for x in mine]) \
                if topo == "full" else \
                (lambda: [ppermute(x, mesh, "pod", perm) for x in mine])
            mine_rec = {"digest": _digest(torch, got._asdict()),
                        "launches": n,
                        "ms": _median_rank_ms(torch, dev,
                                              lambda: step(mine),
                                              max(3, cfg["reps"] // 2)),
                        "transport_ms": _median_rank_ms(
                            torch, dev, move, max(3, cfg["reps"] // 2))}
            ranks = _gather_obj(mine_rec, group)
            if rank == 0:
                stacked = rep.replicate_pod_axis(
                    type(cpu)(*(x.to(dev) for x in cpu)),
                    rep.merge_arena_aligned, pods, topo)
                want = [_digest(torch, _pod(stacked, i)._asdict())
                        for i in range(pods)]
                same = [r["digest"] for r in ranks] == want
                assert same, f"{topo} P={pods}: ranks against stacked"
                identical = len(set(want)) == 1
                assert identical or topo == "ring"
                rec[topo] = {"merges_a_rank": want_n,
                             "kernel_launches": [r["launches"]
                                                 for r in ranks],
                             "equals_stacked": same,
                             "pods_identical": identical,
                             "rank_ms": [r["ms"] for r in ranks],
                             "transport_ms": [r["transport_ms"]
                                              for r in ranks]}
                del stacked
        out[f"P={pods}"] = rec
        del mine, cpu
        _free(torch, dev)
    return out, launches


def mesh_remesh(torch, rank, cfg, dev):
    """internlm2-1.8b's bf16 parameters at full width (depth
    ``sess_layers``) placed by
    ``param_partition_specs`` on (pod 2, model 2); pod 1 lost: the pod axis
    collapses and ``remesh`` moves every leaf onto pod 0's two ranks."""
    from repro_torch.configs import MeshConfig, ParallelConfig
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import sharding as sh
    from repro_torch.runtime.elastic import (degraded_mesh_config, make_mesh,
                                             remesh)
    arch = _arch(cfg, SESS_ARCH, num_layers=cfg["sess_layers"])
    params = zoo.init_params(arch, seed=0, dtype=torch.bfloat16, device=dev)
    mcfg = MeshConfig(shape=(2, 2), axes=("pod", "model"))
    mesh = make_mesh(mcfg)
    specs = sh.param_partition_specs(params, arch, mesh, ParallelConfig())
    placed = sh.place(params, mesh, specs)
    _sync(torch, dev)
    t0 = time.perf_counter()
    degraded = degraded_mesh_config(mcfg, alive_pods=1)
    new_mesh = make_mesh(degraded, parent=mesh)
    moved = remesh(placed, specs, new_mesh)
    _sync(torch, dev)
    remesh_s = time.perf_counter() - t0
    inside = new_mesh.get_coordinate() is not None
    equal = None
    if inside:
        equal = all(torch.equal(sh.gather(m), p) for (_, m), (_, p) in
                    zip(_leaves(moved), _leaves(params)))
    ranks = _gather_obj({"inside": inside, "equal": equal, "s": remesh_s})
    del params, placed, moved
    _free(torch, dev)
    if rank != 0:
        return {}
    rec = {"arch": SESS_ARCH, "reduced": _depth_cut(SESS_ARCH, arch),
           "params": arch.param_count(),
           "param_bytes": 2 * arch.param_count(),
           "mesh": {"pod": 2, "model": 2},
           "degraded": {"shape": list(degraded.shape),
                        "axes": list(degraded.axes)},
           "survivors": [r for r, x in enumerate(ranks) if x["inside"]],
           "leaves_equal": all(x["equal"] for x in ranks if x["inside"]),
           "remesh_s": [x["s"] for x in ranks]}
    assert rec["survivors"] == [0, 1] and rec["leaves_equal"], rec
    return rec


def _pods_setup(cfg):
    from repro_torch.configs import (EnokiConfig, ReplicationPolicy,
                                     ShapeConfig, StepKind)
    from repro_torch.launch import train
    arch = _arch(cfg, TRAIN_ARCH, num_layers=cfg["train_layers"])
    shape = ShapeConfig("pods", cfg["train_seq"], PODS, StepKind.TRAIN)
    par = train.default_parallel(arch, shape)
    enoki = EnokiConfig(policy=ReplicationPolicy.REPLICATED,
                        replication_period=PODS_PERIOD)
    return arch, shape, par, enoki


def _stacked_pods_twin(torch, cfg, dev):
    """The stacked REPLICATED run of ``train_replicated`` (int8 off): each
    pod's params' digest after every round."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core.tree import tree_map
    from repro_torch.data import DataPipeline
    from repro_torch.launch import train
    from repro_torch.optim import diloco_init
    arch, shape, par, enoki = _pods_setup(cfg)
    step, _ = train.make_train_step(arch, shape, PODS, par, enoki,
                                    TrainConfig(**TRAIN_CFG), device=dev)
    replicate, _ = train.make_replicate_step(arch, PODS, par, enoki,
                                             device=dev)
    single = train.init_state(arch, 0, par, device=dev)
    state = tree_map(lambda l: torch.stack([l] * PODS), single)
    outer = diloco_init(single["params"])
    del single
    pipes = [DataPipeline(arch, shape, seed=0, shard=p, num_shards=PODS,
                          device=dev) for p in range(PODS)]
    digests = []
    for i in range(TRAIN_STEPS):
        batch = tree_map(lambda *xs: torch.stack(xs), *[p.next()
                                                        for p in pipes])
        step(state, batch)
        if (i + 1) % PODS_PERIOD == 0:
            replicate(state, outer)
            digests.append([_digest(torch, tree_map(lambda x: x[p],
                                                    state["params"]))
                            for p in range(PODS)])
    del state, outer
    return digests


def mesh_train_pods(torch, rank, cfg, dev, mesh):
    """REPLICATED internlm2-1.8b (depth 24 -> 2, seq 4,096, batch 1 a pod)
    with one pod a rank on ranks 0 and 1: the pods differ before each
    round and are bit-identical after it, and equal to the stacked run's
    pods bit for bit."""
    from repro_torch.configs import TrainConfig
    from repro_torch.data import DataPipeline
    from repro_torch.launch import train
    from repro_torch.optim import diloco_init
    from repro_torch.parallel.collectives import all_gather
    arch, shape, par, enoki = _pods_setup(cfg)
    group = mesh.get_group("pod")
    step, _ = train.make_train_step(arch, shape, parallel=par, enoki=enoki,
                                    cfg=TrainConfig(**TRAIN_CFG), device=dev,
                                    mesh=mesh)
    replicate, _ = train.make_replicate_step(arch, PODS, par, enoki,
                                             device=dev, mesh=mesh)
    state = train.init_state(arch, 0, par, device=dev)
    outer = diloco_init(state["params"])
    pipe = DataPipeline(arch, shape, seed=0, shard=rank, num_shards=PODS,
                        device=dev)
    step_ms, round_ms, before, digests, losses = [], [], [], [], []
    for i in range(TRAIN_STEPS):
        batch = pipe.next()
        (_, m), t = _rank_ms(torch, dev, lambda: step(state, batch))
        step_ms.append(t)
        losses.append(float(m["loss"]))
        if (i + 1) % PODS_PERIOD:
            continue
        wq = all_gather(state["params"]["blocks"]["attn"]["wq"], mesh, "pod")
        before.append(float((wq[0] - wq[1]).abs().max()))
        assert before[-1] > 0, "pods must differ before anti-entropy"
        del wq
        (_, outer), t = _rank_ms(torch, dev,
                                 lambda: replicate(state, outer))
        round_ms.append(t)
        digests.append(_digest(torch, state["params"]))
    ranks = _gather_obj({"digests": digests, "step_ms": step_ms,
                         "round_ms": round_ms, "losses": losses}, group)
    del state, outer, pipe
    _free(torch, dev)
    for r in range(len(digests)):
        assert ranks[0]["digests"][r] == ranks[1]["digests"][r], \
            f"pods differ after round {r + 1}"
    if rank != 0:
        return {}
    stacked = _stacked_pods_twin(torch, cfg, dev)
    same = [[x["digests"][r] for x in ranks] for r in range(len(digests))] \
        == stacked
    assert same, "rank pods against the stacked pods"
    return {"arch": TRAIN_ARCH, "pods": PODS,
            "reduced": {"num_layers": f"24 -> {cfg['train_layers']}",
                        "global_batch": f"256 -> {PODS}"},
            "seq": cfg["train_seq"], "period": PODS_PERIOD,
            "steps": TRAIN_STEPS, "compress_deltas": False,
            "pods_max_diff_before": before,
            "pods_identical_after": True, "equals_stacked": same,
            "losses": [x["losses"] for x in ranks],
            "step_ms": [x["step_ms"] for x in ranks],
            "round_ms": [x["round_ms"] for x in ranks]}


def _session_state(torch, arch, cfg, dev, pods):
    """Pod p's (or, with ``pods`` a tuple, the stacked) seeded session
    cache at ``sess_length`` and its tokens."""
    from repro_torch.models import model_zoo as zoo
    cache = zoo.init_cache(arch, SESS_SESSIONS, cfg["sess_cache"],
                           device=dev)
    if isinstance(pods, int):
        for j, name in enumerate(("k", "v")):
            _normal_(torch, cache[name], 300 + 2 * pods + j, 1.0)
        cache["length"].fill_(cfg["sess_length"])
        gen = torch.Generator(device=dev).manual_seed(400 + pods)
        token = torch.randint(0, arch.vocab_size, (SESS_SESSIONS, 1),
                              generator=gen, device=dev, dtype=torch.int32)
        return cache, token
    parts = [_session_state(torch, arch, cfg, dev, p) for p in pods]
    stacked = {k: torch.stack([c[k] for c, _ in parts]) for k in parts[0][0]}
    return stacked, torch.stack([t for _, t in parts])


def mesh_sessions_pods(torch, rank, cfg, dev, mesh):
    """internlm2-1.8b at full width (depth ``sess_layers``), 2 ranks, 4
    sessions a pod: 4 decode
    steps (a captured graph a step), replicate (a ``ppermute`` ring),
    pod 0 dead, migrate; caches and tokens equal to the stacked
    ``make_decode_step(n_pods=2)`` run."""
    from repro_torch.launch import serve
    from repro_torch.models import model_zoo as zoo
    arch = _arch(cfg, SESS_ARCH, num_layers=cfg["sess_layers"])
    group = mesh.get_group("pod")
    params = zoo.init_params(arch, seed=0, dtype=torch.bfloat16, device=dev)
    cache, token = _session_state(torch, arch, cfg, dev, rank)
    step = serve.make_decode_step(arch, device=dev, mesh=mesh)
    toks, ms = [], []
    for _ in range(SESS_STEPS):
        (token, cache), t = _rank_ms(torch, dev,
                                     lambda: step(params, cache, token))
        toks.append(token.clone())
        ms.append(t)
    replicate = serve.make_replicate_sessions_step(device=dev, mesh=mesh)
    migrate = serve.make_migrate_sessions_step(device=dev, mesh=mesh)
    backup, rep_ms = _rank_ms(torch, dev, lambda: replicate(cache))
    dead = torch.tensor([True, False], device=dev)
    restored, mig_ms = _rank_ms(torch, dev,
                                lambda: migrate(cache, backup, dead))
    mine = {"tokens": _digest(torch, torch.stack(toks)),
            "cache": _digest(torch, cache), "backup": _digest(torch, backup),
            "restored": _digest(torch, restored),
            "decode_ms": ms, "replicate_ms": rep_ms, "migrate_ms": mig_ms,
            "captures": step.steps.captures}
    ranks = _gather_obj(mine, group)
    del params, cache, backup, restored
    _free(torch, dev)
    if rank != 0:
        return {}
    params = zoo.init_params(arch, seed=0, dtype=torch.bfloat16, device=dev)
    cache, token = _session_state(torch, arch, cfg, dev, tuple(range(PODS)))
    stacked = serve.make_decode_step(arch, n_pods=PODS, device=dev)
    toks = []
    for _ in range(SESS_STEPS):
        token, cache = stacked(params, cache, token)
        toks.append(token.clone())
    toks = torch.stack(toks)
    backup = serve.make_replicate_sessions_step(device=dev)(cache)
    restored = serve.make_migrate_sessions_step(device=dev)(
        cache, backup, torch.tensor([True, False], device=dev))
    from repro_torch.core.tree import tree_map
    checks = {}
    for part, tree in (("cache", cache), ("backup", backup),
                       ("restored", restored)):
        checks[part] = [r[part] for r in ranks] == [
            _digest(torch, tree_map(lambda x: x[p], tree))
            for p in range(PODS)]
    checks["tokens"] = [r["tokens"] for r in ranks] == [
        _digest(torch, toks[:, p]) for p in range(PODS)]
    assert all(checks.values()), checks
    return {"arch": SESS_ARCH, "reduced": _depth_cut(SESS_ARCH, arch),
            "pods": PODS, "sessions_a_pod": SESS_SESSIONS,
            "cache_len": cfg["sess_cache"], "length": cfg["sess_length"],
            "decode_steps": SESS_STEPS, "equal_to_stacked": checks,
            "decode_ms": [r["decode_ms"] for r in ranks],
            "replicate_ms": [r["replicate_ms"] for r in ranks],
            "migrate_ms": [r["migrate_ms"] for r in ranks]}


def mesh_rank(rank, cfg):
    """Everything one rank of the ``mesh`` world runs, part by part, with a
    barrier between parts; rank 0 returns the records, every rank its
    merge launches and seconds a part."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.kernels.enoki_merge import kernel
    from repro_torch.launch.mesh import make_mesh_compat, world_device
    dev = world_device()
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    counters = [kernel.enoki_merge_rows]
    dm = make_mesh_compat((1, MESH_RANKS), ("data", "model"))
    pods = {4: make_mesh_compat((MESH_RANKS,), ("pod",)),
            2: DeviceMesh(dev.type, torch.arange(2), mesh_dim_names=("pod",))}
    out, seconds, launches = {}, {}, 0
    for part in MESH_PARTS:
        t0 = time.perf_counter()
        if part == "flash_decode":
            out[part] = mesh_flash_decode(torch, rank, cfg, dev, dm)
        elif part == "moe_ep":
            out[part] = mesh_moe_ep(torch, rank, cfg, dev, dm)
        elif part == "pod_replicate":
            out[part], launches = mesh_pod_replicate(torch, rank, cfg, dev,
                                                     pods, counters)
        elif part == "remesh":
            out[part] = mesh_remesh(torch, rank, cfg, dev)
        elif rank < PODS and part == "train_pods":
            out[part] = mesh_train_pods(torch, rank, cfg, dev, pods[2])
        elif rank < PODS:
            out[part] = mesh_sessions_pods(torch, rank, cfg, dev, pods[2])
        _free(torch, dev)
        _gather_obj(None)         # a barrier on the host
        seconds[part] = time.perf_counter() - t0
    return {"records": out if rank == 0 else None, "seconds": seconds,
            "merge_launches": launches}


def run_mesh(torch, cfg=None):
    """Phase ``mesh``: one world of MESH_RANKS ranks on the card (gloo
    over a ``file://`` store in ``build/``), every part checked; returns
    (the parts' records, the merge kernel's launches on every rank)."""
    import shutil
    from repro_torch.launch.mesh import spawn_world
    cfg = cfg or mesh_config()
    store_dir = ROOT / "build" / "mesh_store"
    shutil.rmtree(store_dir, ignore_errors=True)
    store_dir.mkdir(parents=True)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results = spawn_world(mesh_rank, MESH_RANKS,
                          f"file://{store_dir / 'store'}", args=(cfg,),
                          device=cfg["device"], timeout_s=MESH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    records = results[0]["records"]
    for part in MESH_PARTS:
        records[part]["seconds"] = max(r["seconds"][part] for r in results)
    launches = [r["merge_launches"] for r in results]
    assert all(n > 0 for n in launches), launches
    return records, launches, wall


# ---------------------------------------------------------------------------
# Phase tensor_parallel: the dense family's steps over data and model
# ---------------------------------------------------------------------------

TP_ARCH = TRAIN_ARCH            # internlm2-1.8b
TP_BATCH, TP_SEQ = 4, 4096      # prefill: 2 sessions a data rank
TP_SERVE_LAYERS = 8             # prefill, decode, seq_shard: depth 24 -> 8
                                # in PR 28, for the smoke's time
TP_DECODE_STEPS = 4             # 8 -> 4 in PR 28, for the smoke's time
TP_TRAIN_LAYERS = 2             # depth 24 -> 2 (4 -> 2 in PR 28)
TP_TRAIN_BATCH = 2              # 1 a data rank
TP_TRAIN_STEPS = 1              # 3 -> 1 for the smoke's time (the audio
                                # and seq_shard parts)
TP_TRAIN_CFG = dict(lr=3e-4, warmup_steps=1, total_steps=10)
TP_LOSS_TOL = 1e-3              # loss and grad_norm, TP against unsharded
TP_POD_STEPS = 1                # 2 -> 1 for the smoke's time
TP_SESS_STEPS = 1               # 2 -> 1 for the smoke's time
DENSE_PARTS = ("prefill", "decode", "train_zero1", "train_fsdp", "pods")
#: the audio family and the dense family's prefill under seq_shard, in the
#: first world after the family parts (``tp_audio``, ``tp_seq_shard``)
AUDIO_SEQ_PARTS = ("audio", "seq_shard")

#: host ms and bytes inside the port's collectives on this rank
_TRANSPORT = {"ms": 0.0, "bytes": 0}


def tp_config(device="cuda", reduce=None):
    """What the ``tensor_parallel`` phase runs, at full width on the card;
    ``reduce`` (a function of an arch) and smaller sizes rehearse it on
    the CPU."""
    return {"device": device, "reduce": reduce, "batch": TP_BATCH,
            "seq": TP_SEQ, "decode_steps": TP_DECODE_STEPS,
            "train_layers": TP_TRAIN_LAYERS, "train_seq": TRAIN_SEQ,
            "train_batch": TP_TRAIN_BATCH, "train_steps": TP_TRAIN_STEPS,
            "sess_cache": SESS_CACHE, "sess_length": SESS_LENGTH,
            "sess_layers": SESS_LAYERS, "serve_layers": TP_SERVE_LAYERS,
            "vlm_layers": VLM_LAYERS, "moe_layers": MOE_LAYERS, "block_layers": MOE_BLOCK_LAYERS,
            "block_seq": MOE_BLOCK_SEQ, "moe_train_layers": MOE_TRAIN_LAYERS,
            "moe_train_batch": MOE_TRAIN_BATCH,
            "moe_train_steps": MOE_TRAIN_STEPS,
            "vlm_train_layers": VLM_TRAIN_LAYERS,
            "vlm_train_steps": VLM_TRAIN_STEPS, "warm_seq": WARM_SEQ,
            "hybrid_layers": HYBRID_LAYERS,
            "hybrid_train_layers": HYBRID_TRAIN_LAYERS,
            "ssm_seq": SSM_SEQ, "ssm_train_seq": SSM_TRAIN_SEQ,
            "recurrent_train_batch": RECURRENT_TRAIN_BATCH,
            "recurrent_train_steps": RECURRENT_TRAIN_STEPS,
            "audio_seq": AUDIO_SEQ, "audio_train_steps": AUDIO_TRAIN_STEPS,
            "parts": TP_PARTS}


def _time_transport(torch):
    """Time every collective of ``parallel.collectives`` on this rank: the
    card synchronised first (outside the timer), so the host ms are the
    transport's and the wait for the other ranks'."""
    from repro_torch.parallel import collectives as col
    if getattr(col, "_smoke_timed", False):
        return
    for name in ("_all_reduce", "_all_gather", "ppermute"):
        inner = getattr(col, name)

        def timed(x, *args, _inner=inner, **kwargs):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            t0 = time.perf_counter()
            out = _inner(x, *args, **kwargs)
            _TRANSPORT["ms"] += (time.perf_counter() - t0) * 1e3
            _TRANSPORT["bytes"] += x.numel() * x.element_size()
            return out
        setattr(col, name, timed)
    col._smoke_timed = True


def _transport_ms(torch, dev, fn):
    """``fn()``, its ms on this rank (CUDA events on the card) and the
    transport's ms and bytes inside it."""
    _TRANSPORT["ms"], _TRANSPORT["bytes"] = 0.0, 0
    out, ms = _rank_ms(torch, dev, fn)
    return out, ms, _TRANSPORT["ms"], _TRANSPORT["bytes"]


def _whole(tree, mesh, specs):
    from repro_torch.parallel import sharding as sh
    return sh._zip_specs(lambda x, s: sh.unlocal(x, mesh, s), tree, specs)


def _tp_prefill_shape(cfg, seq):
    from repro_torch.configs import ShapeConfig, StepKind
    return ShapeConfig("tp_prefill", seq, cfg["batch"], StepKind.PREFILL)


def _tp_params(torch, arch, mesh, dev):
    """internlm2-1.8b's bf16 weights from seed 0, this rank's shards."""
    from repro_torch.configs import ParallelConfig
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import sharding as sh
    full = zoo.init_params(arch, seed=0, dtype=torch.bfloat16, device=dev)
    specs = sh.param_partition_specs(full, arch, mesh,
                                     ParallelConfig(fsdp=False))
    mine = sh.local(full, mesh, specs)[0]
    del full
    _free(torch, dev)
    return mine


def _tp_tokens(torch, arch, cfg, dev):
    gen = torch.Generator(device=dev).manual_seed(500)
    return torch.randint(0, arch.vocab_size, (cfg["batch"], cfg["seq"]),
                         generator=gen, device=dev, dtype=torch.int32)


def tp_serve(torch, rank, cfg, dev, mesh, fk, kept=None):
    """Parts ``prefill`` and ``decode``: internlm2-1.8b at full width,
    depth ``serve_layers``, on (data 2, model 2), FLASH, 4 prompts of ``seq`` tokens (2 a
    data rank), then ``decode_steps`` greedy steps from that cache; rank 0
    then runs the unsharded prefill and the unsharded decode step (fed
    the ranks' tokens) on the same card.  Returns (prefill, decode)
    records on rank 0, where ``kept`` (a dict) also takes the gathered last
    logits and K/V in host memory."""
    import repro_torch.launch.serve as serve
    from repro_torch.configs import AttnImpl
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import sharding as sh
    arch = _arch(cfg, TP_ARCH, num_layers=cfg["serve_layers"])
    S = cfg["seq"]
    params = _tp_params(torch, arch, mesh, dev)
    tokens = _tp_tokens(torch, arch, cfg, dev)
    batch = sh.local({"tokens": tokens}, mesh,
                     {"tokens": sh.P("data", None)})[0]
    warm = serve.make_prefill_step(arch, _tp_prefill_shape(cfg, 256),
                                   impl=AttnImpl.FLASH, device=dev, mesh=mesh)
    warm(params, {"tokens": batch["tokens"][:, :256].contiguous()})
    step = serve.make_prefill_step(arch, _tp_prefill_shape(cfg, S),
                                   impl=AttnImpl.FLASH, device=dev, mesh=mesh)
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    n0 = fk.flash_attention_bhsd.launches
    (logits, cache), ms, tms, tbytes = _transport_ms(
        torch, dev, lambda: step(params, batch))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    launches = fk.flash_attention_bhsd.launches - n0
    give_ups = fk.check_give_ups() if dev.type == "cuda" else 0
    cspecs = serve.session_cache_specs(arch, mesh, cfg["batch"])
    whole = _whole({"k": cache["k"], "v": cache["v"]}, mesh,
                   {"k": cspecs["k"], "v": cspecs["v"]})
    if rank != 0:
        del whole
    prefill_rank = {"ms": ms, "transport_ms": tms, "transport_bytes": tbytes,
                    "flash_launches": launches, "give_ups": give_ups,
                    "peak_bytes": peak}

    # decode: the prefill cache in a rank's cache with room for the steps
    room = S + cfg["decode_steps"] + 8
    dcache = zoo.init_cache(arch, cfg["batch"], room, device=dev, mesh=mesh)
    for k in ("k", "v"):
        dcache[k][:, :, :S].copy_(cache[k])
    dcache["length"].copy_(cache["length"])
    del cache
    seen = []
    greedy = serve.greedy_sharded

    def capture(lg, m):        # the logits each step takes its token from
        seen.append(lg)
        return greedy(lg, m)
    serve.greedy_sharded = capture
    dstep = serve.make_decode_step(arch, device=dev, mesh=mesh)
    first = torch.argmax(logits[:, -1, :], -1)[:, None].to(torch.int32)
    token = sh.local({"t": first}, mesh, {"t": sh.P("data", None)})[0]["t"]
    dms, dtms, toks, step_logits = [], [], [], []
    try:
        for _ in range(cfg["decode_steps"]):
            (token, dcache), t, tt, _ = _transport_ms(
                torch, dev, lambda: dstep(params, dcache, token))
            dms.append(t)
            dtms.append(tt)
            toks.append(sh.unlocal(token, mesh, sh.P("data", None)))
            step_logits.append(sh.unlocal(seen.pop().float(), mesh,
                                          sh.P("data", "model")))
    finally:
        serve.greedy_sharded = greedy
    decode_rank = {"ms": dms, "transport_ms": dtms}
    ranks = _gather_obj({"prefill": prefill_rank, "decode": decode_rank})
    del params, dcache
    _free(torch, dev)
    _gather_obj(None)
    if rank != 0:
        return None, None

    full = zoo.init_params(arch, seed=0, dtype=torch.bfloat16, device=dev)
    plain = serve.make_prefill_step(arch, _tp_prefill_shape(cfg, S),
                                    impl=AttnImpl.FLASH, device=dev)
    plain(full, {"tokens": tokens[:, :256].contiguous()})
    (logits0, cache0), ms0 = _rank_ms(torch, dev,
                                      lambda: plain(full, {"tokens": tokens}))
    if dev.type == "cuda":
        fk.check_give_ups()
    rel_logits = _rel(torch, logits, logits0)
    rel_cache = max(_rel(torch, whole[k], cache0[k]) for k in ("k", "v"))
    if kept is not None:                # beside the seq_shard part's
        kept.update({"logits": logits.float().cpu(), "k": whole["k"].cpu(),
                     "v": whole["v"].cpu()})
    del whole
    assert rel_logits < PREFILL_REL_TOL, rel_logits
    assert rel_cache < PREFILL_REL_TOL, rel_cache
    if dev.type == "cuda":
        assert all(r["prefill"]["flash_launches"] == arch.num_layers
                   for r in ranks), [r["prefill"] for r in ranks]
    prefill = {"arch": TP_ARCH, "reduced": _depth_cut(TP_ARCH, arch),
               "mesh": {"data": 2, "model": 2},
               "batch": cfg["batch"], "seq": S, "layers": arch.num_layers,
               "impl": "flash", "rel_err_logits": rel_logits,
               "rel_err_cache": rel_cache, "tolerance": PREFILL_REL_TOL,
               "flash_launches": [r["prefill"]["flash_launches"]
                                  for r in ranks],
               "give_ups": [r["prefill"]["give_ups"] for r in ranks],
               "ms": [r["prefill"]["ms"] for r in ranks],
               "transport_ms": [r["prefill"]["transport_ms"] for r in ranks],
               "transport_bytes": [r["prefill"]["transport_bytes"]
                                   for r in ranks],
               "peak_bytes_a_rank": [r["prefill"]["peak_bytes"]
                                     for r in ranks],
               "unsharded_ms": ms0}

    # the unsharded decode step, fed the ranks' tokens
    dc0 = zoo.init_cache(arch, cfg["batch"], room, device=dev)
    for k in ("k", "v"):
        dc0[k][:, :, :S].copy_(cache0[k])
    dc0["length"].copy_(cache0["length"])
    del cache0
    _free(torch, dev)
    token0 = first
    rels, differ, ms0s = [], 0, []
    for i in range(cfg["decode_steps"]):
        (lg0, dc0), t = _rank_ms(torch, dev, lambda: zoo.decode_step(
            arch, full, dc0, token0))
        ms0s.append(t)
        lg0 = lg0[:, -1, :].float()
        rels.append(_rel(torch, step_logits[i], lg0))
        differ += int((torch.argmax(lg0, -1)[:, None].to(torch.int32)
                       != toks[i]).sum())
        token0 = toks[i]
    del full, dc0
    _free(torch, dev)
    assert max(rels) < PREFILL_REL_TOL, rels
    decode = {"arch": TP_ARCH, "reduced": _depth_cut(TP_ARCH, arch),
              "mesh": {"data": 2, "model": 2},
              "sessions": cfg["batch"], "steps": cfg["decode_steps"],
              "from_length": S, "rel_err_logits": rels,
              "tolerance": PREFILL_REL_TOL,
              "greedy_tokens_differing": differ,
              "greedy_tokens": cfg["batch"] * cfg["decode_steps"],
              "ms": [r["decode"]["ms"] for r in ranks],
              "transport_ms": [r["decode"]["transport_ms"] for r in ranks],
              "unsharded_ms": ms0s}
    return prefill, decode


def _tp_train_parts(torch, cfg, fsdp):
    from repro_torch.configs import ShapeConfig, StepKind, TrainConfig
    from repro_torch.launch import train
    arch = _arch(cfg, TRAIN_ARCH, num_layers=cfg["train_layers"])
    shape = ShapeConfig("tp_train", cfg["train_seq"], cfg["train_batch"],
                        StepKind.TRAIN)
    par = dataclasses.replace(train.default_parallel(arch, shape), fsdp=fsdp)
    return arch, shape, par, TrainConfig(**TP_TRAIN_CFG)


def _rank_state(torch, arch, par, mesh, specs, dev, seed=0):
    """This rank's shards of ``init_state(seed)``: the params made whole
    and cut, the AdamW moments and step made at the shard's shapes (zeros,
    as ``init_state`` makes them; f32 params keep no master)."""
    from repro_torch.core.tree import tree_map
    from repro_torch.launch import train
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import sharding as sh
    shapes = sh.local(train.state_shapes(arch, par), mesh, specs)[0]
    assert "master" not in shapes["opt"], "bf16 params keep a master"
    full = zoo.init_params(arch, seed=seed,
                           dtype=train.param_dtype_for(arch), device=dev)
    params = sh.local(full, mesh, specs["params"])[0]
    del full
    _free(torch, dev)
    zeros = lambda t: tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype,
                                                     device=dev), t)
    return {"params": params, "opt": zeros(shapes["opt"]),
            "step": zeros(shapes["step"])}


def tp_train(torch, rank, cfg, dev, mesh, fsdp):
    """Parts ``train_zero1`` and ``train_fsdp``: internlm2-1.8b at full
    width, depth 24 -> ``train_layers``, seq ``train_seq``, a global batch
    of 2 (1 a data rank), AdamW, remat "block", ``default_parallel`` (ZeRO-1)
    or with ``fsdp``, ``train_steps`` steps on (data 2, model 2); rank 0
    then runs the unsharded step on the concatenated batches."""
    from repro_torch.data import rank_batch, synthetic_batch
    from repro_torch.launch import train
    arch, shape, par, tcfg = _tp_train_parts(torch, cfg, fsdp)
    step, _ = train.make_train_step(arch, shape, parallel=par, cfg=tcfg,
                                    device=dev, mesh=mesh)
    state = _rank_state(torch, arch, par, mesh, step.specs, dev)
    rows = []
    for i in range(cfg["train_steps"]):
        batch = rank_batch(arch, shape, 0, i, mesh, step.batch_axes,
                           device=dev)
        (state, m), t, tt, tb = _transport_ms(torch, dev,
                                              lambda: step(state, batch))
        rows.append({"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]), "ms": t,
                     "transport_ms": tt, "transport_bytes": tb})
    whole = _whole(state["params"], mesh, step.specs["params"])
    ranks = _gather_obj(rows)
    if rank != 0:
        del whole
    del state
    _free(torch, dev)
    _gather_obj(None)
    if rank != 0:
        return None
    plain, _ = train.make_train_step(arch, shape, parallel=par, cfg=tcfg,
                                     device=dev)
    state0 = train.init_state(arch, 0, par, device=dev)
    want, ms0 = [], []
    for i in range(cfg["train_steps"]):
        parts = [synthetic_batch(arch, shape, 0, i, shard=s, num_shards=2,
                                 device=dev) for s in range(2)]
        batch0 = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        (state0, m), t = _rank_ms(torch, dev, lambda: plain(state0, batch0))
        want.append({"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"])})
        ms0.append(t)
    from repro_torch.core.tree import tree_flatten
    diff = max(float((a - b).abs().max()) for a, b in zip(
        tree_flatten(whole)[0], tree_flatten(state0["params"])[0]))
    del whole, state0
    _free(torch, dev)
    rel = {k: max(abs(r[k] - w[k]) / abs(w[k])
                  for r, w in zip(ranks[0], want))
           for k in ("loss", "grad_norm")}
    bound = 2 * tcfg.lr * cfg["train_steps"]
    assert all(v < TP_LOSS_TOL for v in rel.values()), (rel, ranks[0], want)
    assert diff <= bound, (diff, bound)
    return {"arch": TRAIN_ARCH, "mesh": {"data": 2, "model": 2},
            "reduced": {"num_layers": f"24 -> {cfg['train_layers']}",
                        "global_batch": f"256 -> {cfg['train_batch']}"},
            "seq": cfg["train_seq"], "steps": cfg["train_steps"],
            "zero1": par.zero1, "fsdp": par.fsdp, "remat": par.remat,
            "losses": [r["loss"] for r in ranks[0]],
            "unsharded_losses": [w["loss"] for w in want],
            "rel_err": rel, "tolerance": TP_LOSS_TOL,
            "params_max_abs_diff": diff, "params_bound": bound,
            "ms": [[r["ms"] for r in rk] for rk in ranks],
            "transport_ms": [[r["transport_ms"] for r in rk]
                             for rk in ranks],
            "transport_bytes": [rk[0]["transport_bytes"] for rk in ranks],
            "unsharded_ms": ms0}


def tp_pods(torch, rank, cfg, dev, mesh):
    """Part ``pods`` on (pod 2, model 2): REPLICATED steps then a round
    with int8 off and on (pods unequal before it, bit-identical after);
    TP session caches decoded, replicated round the pod ring (each backup
    the neighbour's live cache) and migrated; one PEER_FETCH step against
    one CLOUD_CENTRAL step."""
    from repro_torch.configs import EnokiConfig, ReplicationPolicy
    from repro_torch.core.tree import tree_flatten, tree_map
    from repro_torch.data import rank_batch
    from repro_torch.launch import serve, train
    from repro_torch.models import model_zoo as zoo
    from repro_torch.optim import diloco_init
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel import sharding as sh
    R = ReplicationPolicy
    arch, shape, par, tcfg = _tp_train_parts(torch, cfg, False)
    shape = dataclasses.replace(shape, global_batch=PODS)
    pod = col.axis_index(mesh, "pod")
    group = mesh.get_group("pod")
    out = {}

    def pods_differ(params) -> float:
        leaf = params["blocks"]["attn"]["wq"]
        both = col.all_gather(leaf, mesh, "pod")
        return float((both[0] - both[1]).abs().max())

    enoki = EnokiConfig(policy=R.REPLICATED, replication_period=PODS_PERIOD)
    step, _ = train.make_train_step(arch, shape, parallel=par, enoki=enoki,
                                    cfg=tcfg, device=dev, mesh=mesh)
    state = _rank_state(torch, arch, par, mesh, step.specs, dev)
    ms = []
    for i in range(TP_POD_STEPS):
        batch = rank_batch(arch, shape, 0, i, mesh, ("pod",), device=dev)
        (state, _), t, _, _ = _transport_ms(torch, dev,
                                            lambda: step(state, batch))
        ms.append(t)
    pspecs = step.specs["params"]
    ospecs = {"outer_params": pspecs, "momentum": pspecs, "round": sh.P()}
    kept = tree_map(torch.clone, state["params"])
    rounds = {}
    for c in (0, 1):
        state["params"] = tree_map(torch.clone, kept)
        before = pods_differ(state["params"])
        full = zoo.init_params(arch, seed=0,
                               dtype=train.param_dtype_for(arch), device=dev)
        outer = sh.local(diloco_init(full), mesh, ospecs)[0]
        del full
        _free(torch, dev)
        rstep, _ = train.make_replicate_step(
            arch, PODS, par, dataclasses.replace(enoki,
                                                 compress_deltas=bool(c)),
            device=dev, mesh=mesh)
        (_, outer), t, tt, tb = _transport_ms(
            torch, dev, lambda: rstep(state, outer))
        digests = _gather_obj(_digest(torch, state["params"]), group)
        rounds["int8" if c else "f32"] = {
            "pods_max_diff_before": before,
            "pods_identical_after": digests[0] == digests[1],
            "round_ms": t, "transport_ms": tt, "transport_bytes": tb}
        assert before > 0 and digests[0] == digests[1], rounds
        del outer
    del state, kept
    _free(torch, dev)
    out["replicated"] = {"steps": TP_POD_STEPS, "step_ms": ms, **rounds}

    # sessions: TP caches, one pod's 4 sessions on its 2 ranks
    sarch = _arch(cfg, SESS_ARCH, num_layers=cfg["sess_layers"])
    params = _tp_params(torch, sarch, mesh, dev)
    full, token = _session_state(torch, sarch, cfg, dev, pod)
    cspecs = serve.session_cache_specs(sarch, mesh, SESS_SESSIONS)
    cache = sh.local(full, mesh, cspecs)[0]
    del full
    dstep = serve.make_decode_step(sarch, device=dev, mesh=mesh)
    dms = []
    for _ in range(TP_SESS_STEPS):
        (token, cache), t, _, _ = _transport_ms(
            torch, dev, lambda: dstep(params, cache, token))
        dms.append(t)
    backup, rms, rtms, rtb = _transport_ms(
        torch, dev, lambda: serve.make_replicate_sessions_step(
            device=dev, mesh=mesh)(cache))
    dead = torch.tensor([True, False], device=dev)
    restored = serve.make_migrate_sessions_step(device=dev, mesh=mesh)(
        cache, backup, dead)
    mine = {"cache": _digest(torch, cache), "backup": _digest(torch, backup),
            "restored": _digest(torch, restored)}
    got = _gather_obj(mine, group)          # pod order
    ring = all(got[p]["backup"] == got[(p - 1) % PODS]["cache"]
               for p in range(PODS))
    failover = got[0]["restored"] == got[0]["backup"] and \
        got[1]["restored"] == got[1]["cache"]
    assert ring and failover, got
    out["sessions"] = {"reduced": _depth_cut(SESS_ARCH, sarch),
                       "sessions_a_pod": SESS_SESSIONS,
                       "cache_len": cfg["sess_cache"],
                       "decode_steps": TP_SESS_STEPS, "decode_ms": dms,
                       "backup_is_ring_neighbour": ring,
                       "failover": failover, "replicate_ms": rms,
                       "replicate_transport_ms": rtms,
                       "replicate_transport_bytes": rtb}
    del params, cache, backup, restored
    _free(torch, dev)

    # PEER_FETCH against CLOUD_CENTRAL, one step from the same state
    res = {}
    for name, policy in (("central", R.CLOUD_CENTRAL),
                         ("peer", R.PEER_FETCH)):
        step, _ = train.make_train_step(arch, shape, parallel=par,
                                        enoki=EnokiConfig(policy=policy),
                                        cfg=tcfg, device=dev, mesh=mesh)
        state = _rank_state(torch, arch, par, mesh, step.specs, dev)
        batch = rank_batch(arch, shape, 0, 0, mesh, step.batch_axes,
                           device=dev)
        (state, m), t, tt, tb = _transport_ms(torch, dev,
                                              lambda: step(state, batch))
        cc_specs = train.state_specs(train.state_shapes(arch, par), arch,
                                     mesh, par)["params"]
        flat = [sh.relayout(x, mesh, s, c) for x, s, c in zip(
            tree_flatten(state["params"])[0],
            sh.spec_leaves(step.specs["params"]),
            sh.spec_leaves(cc_specs))]
        res[name] = {"metrics": {k: float(v) for k, v in m.items()},
                     "params": flat, "ms": t, "transport_ms": tt,
                     "transport_bytes": tb}
        del state
        _free(torch, dev)
    diff = max(float((a - b).abs().max()) for a, b in zip(
        res["peer"]["params"], res["central"]["params"]))
    diff = float(col.pmax(torch.tensor(diff), mesh, "model"))
    rel = {k: abs(res["peer"]["metrics"][k] - res["central"]["metrics"][k])
           / abs(res["central"]["metrics"][k]) for k in ("loss", "grad_norm")}
    bound = 2 * tcfg.lr
    assert all(v <= 1e-5 for v in rel.values()) and diff <= bound, \
        (rel, diff)
    out["peer_fetch"] = {
        "rel_err_vs_central": rel, "tolerance": 1e-5,
        "params_max_abs_diff": diff, "params_bound": bound,
        **{f"{n}_{k}": res[n][k] for n in res
           for k in ("ms", "transport_ms", "transport_bytes")}}
    ranks = _gather_obj(out)
    if rank != 0:
        return None
    return {"arch": TRAIN_ARCH, "mesh": {"pod": 2, "model": 2},
            "reduced": {"num_layers": f"24 -> {cfg['train_layers']}",
                        "global_batch": f"256 -> {PODS}"},
            "seq": cfg["train_seq"], "by_rank": ranks}


# ---------------------------------------------------------------------------
# Phase tensor_parallel, the moe and vlm families
# ---------------------------------------------------------------------------

MOE_ARCH, MOE_LAYERS = "grok-1-314b", 2          # moe_prefill: 64 -> 2
MOE_BLOCK_ARCH, MOE_BLOCK_LAYERS = "kimi-k2-1t-a32b", 1   # moe_block: 61 -> 1
MOE_BLOCK_SEQ = 4096            # one prompt
MOE_TRAIN_LAYERS = 1            # moe_train: grok-1, depth 64 -> 1
MOE_TRAIN_BATCH, MOE_TRAIN_STEPS = 2, 1   # steps 2 -> 1 for the time
MOE_TRAIN_CFG = dict(lr=1e-4, warmup_steps=1, total_steps=10)
VLM_ARCH = "phi-3-vision-4.2b"  # vlm
VLM_LAYERS = 8                  # its prefill and decode: depth 32 -> 8 in
                                # PR 28, for the smoke's time
VLM_TRAIN_LAYERS = 2            # its ZeRO-1 step: depth 32 -> 2 (4 -> 2
                                # in PR 28, for the smoke's time)
VLM_TRAIN_STEPS = 1             # 2 -> 1 for the smoke's time (a second
                                # loss read the first update)
FAMILY_PARTS = ("moe_prefill", "moe_block", "moe_train", "vlm")
WARM_SEQ = 1024                 # past the vlm's 576 patch positions
TP_PARTS = DENSE_PARTS + FAMILY_PARTS + AUDIO_SEQ_PARTS
#: the leaves the init leaves at zero (the norms' scales; whisper's
#: cross-attention and encoder-output norms too)
ZERO_LEAVES = ("ln1", "ln2", "final_norm", "ln_x", "enc_norm")
#: the family parts' training check, leaf by leaf: ||ranks' params - the
#: twin's|| <= TRAIN_MOVE_RATIO x ||the twin's params - the initial||.  A
#: step left undone reads exactly 1 (the ranks' params are the initial
#: ones).  Two runs that compute one update up to rounding end an element
#: apart only where their pre-rounding values straddle a rounding point
#: (one bf16 spacing of the element, or for AdamW's first, sign-like
#: step a gradient's sign at rounding level), a share of about eps of the
#: moved elements for updates that differ by eps relative: a ratio of
#: about sqrt(eps), far under 1/2
TRAIN_MOVE_RATIO = 0.5


#: elements one generator draws at a time in ``_seeded_fill`` (256 MB of f32)
SEED_DRAW_ELEMS = 1 << 26


def _seeded_fill(torch, out, seed, coords, scale):
    """``out`` (a block of a leaf, or a view of it in the whole leaf)
    filled with normals x ``scale`` drawn a run of indices of its first
    dim at a time (as many whole indices as fit in ``SEED_DRAW_ELEMS``, at
    least one), each run from a generator seeded by (``seed``, ``coords``,
    run): the same numbers whether a rank draws its block or the twin the
    whole leaf, since both fill a block of one shape.  Drawn into a
    contiguous buffer, then copied (a view's strides do not change what
    is drawn)."""
    import hashlib
    import math
    step = max(1, SEED_DRAW_ELEMS // max(1, math.prod(out.shape[1:])))
    for run, j in enumerate(range(0, out.shape[0], step)):
        rows = out[j:j + step]
        key = hashlib.sha256(repr((seed, coords, run)).encode()).digest()
        gen = torch.Generator(device=out.device).manual_seed(
            int.from_bytes(key[:8], "little") >> 1)
        buf = torch.empty(rows.shape, dtype=out.dtype, device=out.device)
        buf.normal_(generator=gen).mul_(scale)
        rows.copy_(buf)
        del buf


def _family_params(torch, arch, mesh, dev, seed, dtype, parallel=None,
                   whole=False):
    """``arch``'s parameters from ``seed`` at full width, cut in blocks
    along every dim that ``param_partition_specs`` shards on ``mesh``,
    each block drawn from its own seed (``_seeded_fill``): this rank's
    shards, or (``whole``) the whole tree with the same numbers, so no rank
    ever holds the whole model.  The norms' scales are zero, as the init
    makes them; the embedding's scale 1; every other leaf's is its input
    width ** -0.5 (the second-last dim); the router stays f32."""
    import itertools
    from repro_torch.configs import ParallelConfig
    from repro_torch.launch.mesh import axis_sizes
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.collectives import axis_index
    meta = zoo.init_params(arch, dtype=dtype, device="meta")
    specs = sh.param_partition_specs(meta, arch, mesh, parallel or
                                     ParallelConfig(fsdp=False))
    sizes = axis_sizes(mesh)
    mine = {a: axis_index(mesh, a) for a in sizes}

    def leaf(path, x, spec):
        name = path[-1]
        entries = tuple(spec) + (None,) * (x.ndim - len(spec))
        blocks, here = [], []
        for e in entries:
            n, i = 1, 0
            for a in sh._entry_axes(e):
                n, i = n * sizes[a], i * sizes[a] + mine[a]
            blocks.append(n)
            here.append(i)
        bshape = [s // n for s, n in zip(x.shape, blocks)]
        if name in ZERO_LEAVES:
            return torch.zeros(x.shape if whole else bshape, dtype=x.dtype,
                               device=dev)
        scale = 1.0 if name == "embed" else x.shape[-2] ** -0.5
        seed_path = (seed, "/".join(path))
        if not whole:
            t = torch.empty(bshape, dtype=x.dtype, device=dev)
            _seeded_fill(torch, t, seed_path, tuple(here), scale)
            return t
        t = torch.empty(x.shape, dtype=x.dtype, device=dev)
        for coords in itertools.product(*(range(n) for n in blocks)):
            view = t[tuple(slice(c * b, (c + 1) * b)
                           for c, b in zip(coords, bshape))]
            _seeded_fill(torch, view, seed_path, coords, scale)
        return t

    def walk(meta_t, spec_t, path):
        if isinstance(meta_t, dict):
            return {k: walk(meta_t[k], spec_t[k], path + (k,))
                    for k in meta_t}
        return leaf(path, meta_t, spec_t)
    return walk(meta, specs, ())


class _Spy:
    """Within ``with``: the routes of every ``moe.route`` call and the
    last input of ``transformer._head`` (the final hidden state), when
    ``routes``/``hidden`` ask for them.  Inside the ``with`` it only keeps
    references (no device work, no copy to the host), so a timed step
    inside it times the step alone; on leaving, each route becomes its
    assignments' experts sorted in a row, in host memory."""

    def __init__(self, routes=True, hidden=True):
        self.want_routes, self.want_hidden = routes, hidden
        self.routes, self.hidden = [], None

    def __enter__(self):
        from repro_torch.models import moe, transformer
        self._route, self._head = moe.route, transformer._head

        def route(router_w, x, cfg, *args, **kwargs):
            out = self._route(router_w, x, cfg, *args, **kwargs)
            if self.want_routes:
                self.routes.append(out[0])
            return out

        def head(arch, params, x, *args, **kwargs):
            if self.want_hidden:
                self.hidden = x.detach()
            return self._head(arch, params, x, *args, **kwargs)
        moe.route, transformer._head = route, head
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe, transformer
        moe.route, transformer._head = self._route, self._head
        self.routes = [r.sort(dim=-1).values.cpu() for r in self.routes]


def _logits_err_on_agreeing(torch, arch, params, hidden, hidden0, agree):
    """The largest |logits - logits0| over the tokens ``agree`` (B, S)
    marks, relative to the largest |logits0| there, both computed from
    the final hidden states with the one whole head (the vocab-parallel
    head's columns are the same products), 512 tokens at a time."""
    from repro_torch.models import transformer
    x, x0 = hidden.reshape(-1, hidden.shape[-1]), \
        hidden0.reshape(-1, hidden0.shape[-1])
    keep = agree.reshape(-1).to(x.device)
    x, x0 = x[keep], x0[keep]
    num = den = 0.0
    for i in range(0, x.shape[0], 512):
        lg = transformer._head(arch, params, x[i:i + 512][None],
                               torch.bfloat16).float()
        lg0 = transformer._head(arch, params, x0[i:i + 512][None],
                                torch.bfloat16).float()
        num = max(num, float((lg - lg0).abs().max()))
        den = max(den, float(lg0.abs().max()))
    return num / max(den, 1e-30)


def _kept(torch, routes, cfg, groups, multiple=128):
    """(T, k) bool: which of the assignments ``routes`` (T, k), in batch
    order, a dispatch keeps whose ``groups`` runs of tokens each rank
    against their own capacity (1: the global batch, "auto"; data: the
    reference's "ep")."""
    from repro_torch.models import moe
    out = []
    for g in routes.chunk(groups):
        rank = moe.rank_in_expert(g.reshape(-1), cfg.num_experts)
        cap = moe.capacity(g.shape[0], cfg, multiple)
        out.append((rank < cap).reshape(g.shape))
    return torch.cat(out)


def _route_agreement(torch, arch, routes, routes0, B, S, groups,
                     multiple=128):
    """(agree (B, S) bool, differing (token, layer) routes, assignments
    dropped by the ranks, by the twin): the ranks' routes (gathered, in
    batch order) against the twin's, layer by layer; a route agrees when
    its experts and their kept flags (each run's own capacity rule) do."""
    agree = torch.ones(B * S, dtype=torch.bool)
    differ = dropped = dropped0 = 0
    for r, r0 in zip(routes, routes0):
        k = _kept(torch, r, arch.moe, groups, multiple)
        k0 = _kept(torch, r0, arch.moe, 1, multiple)
        dropped += int((~k).sum())
        dropped0 += int((~k0).sum())
        same = (r == r0).all(-1) & (k == k0).all(-1)
        differ += int((~same).sum())
        agree &= same
    return agree.reshape(B, S), differ, dropped, dropped0


def _gather_routes(torch, spy, mesh, axis="data"):
    """Each call's routes over the ranks of ``axis`` in batch order (the
    ranks of ``model`` route alike)."""
    from repro_torch.parallel.collectives import _all_gather
    return [torch.cat(_all_gather(r, mesh, axis).unbind(0)) for r in
            spy.routes]


def _family_batch(torch, arch, batch, seq, dev, seed):
    from repro_torch.configs import ShapeConfig, StepKind
    from repro_torch.models import model_zoo as zoo
    shape = ShapeConfig("family", seq, batch, StepKind.PREFILL)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return zoo.example_batch(arch, shape, gen), shape


def _family_prefill(torch, rank, cfg, dev, mesh, fk, arch, batch, shape,
                    params, impls):
    """The FLASH prefill on this rank's shards under each ``moe_impl`` of
    ``impls``, after a ``warm_seq``-token warm-up: per form the rank's ms,
    transport, flash launches (asserted = the layers), give-ups, the
    gathered last logits, the ranks' routes and final hidden state (the
    model column 0's, gathered over ``data`` in batch order), and the
    cache of the first form."""
    import repro_torch.launch.serve as serve
    from repro_torch.configs import AttnImpl
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.collectives import _all_gather
    bspec = {k: sh.P("data", *([None] * (v.ndim - 1)))
             for k, v in batch.items()}
    mine = sh.local(batch, mesh, bspec)[0]
    warm = {k: v[:, :cfg["warm_seq"]].contiguous() if k == "tokens" else v
            for k, v in mine.items()}
    wshape = dataclasses.replace(shape, seq_len=cfg["warm_seq"])
    serve.make_prefill_step(arch, wshape, impl=AttnImpl.FLASH, device=dev,
                            mesh=mesh)(params, warm)
    _free(torch, dev)
    out, cache = {}, None
    for impl in impls:
        step = serve.make_prefill_step(arch, shape, impl=AttnImpl.FLASH,
                                       device=dev, mesh=mesh, moe_impl=impl)
        _sync(torch, dev)
        n0 = fk.flash_attention_bhsd.launches
        with _Spy() as spy:
            (logits, c), ms, tms, tbytes = _transport_ms(
                torch, dev, lambda: step(params, mine))
        launches = fk.flash_attention_bhsd.launches - n0
        give_ups = fk.check_give_ups() if dev.type == "cuda" else 0
        if dev.type == "cuda":
            assert launches == arch.num_layers, (launches, arch.num_layers)
        assert give_ups == 0
        hidden = torch.cat(_all_gather(spy.hidden.contiguous(), mesh,
                                       "data").unbind(0))
        out[impl] = {"ms": ms, "transport_ms": tms,
                     "transport_bytes": tbytes, "flash_launches": launches,
                     "give_ups": give_ups, "logits": logits,
                     "routes": _gather_routes(torch, spy, mesh),
                     "hidden": hidden if rank == 0 else None}
        del spy, hidden
        if cache is None:
            cache = c
        del c
        _free(torch, dev)
    return out, cache


def _compare_prefill(torch, arch, full, runs, twin_logits, twin_routes,
                     twin_hidden, B, S, data):
    """Per form: last logits against the twin's (all rows), the logits on
    the tokens whose routes agree (from the final hidden states), the
    (token, layer) routes that differ and the assignments each dropped
    ("ep" ranks each of the ``data`` shards against its own capacity)."""
    rec = {}
    for impl, r in runs.items():
        agree, differ, dropped, dropped0 = _route_agreement(
            torch, arch, r["routes"], twin_routes, B, S,
            data if impl == "ep" else 1)
        err = _logits_err_on_agreeing(torch, arch, full, r["hidden"],
                                      twin_hidden, agree)
        rec[impl] = {"rel_err_last_logits": _rel(torch, r["logits"],
                                                 twin_logits),
                     "rel_err_logits_agreeing": err,
                     "routes": len(r["routes"]) * B * S,
                     "routes_differing": differ,
                     "dropped": dropped, "dropped_unsharded": dropped0,
                     "tokens_with_differing_routes": int((~agree).sum()),
                     "tokens": B * S}
        assert err < PREFILL_REL_TOL, (impl, rec[impl])
    return rec


def moe_prefill(torch, rank, cfg, dev, mesh, fk):
    """Part ``moe_prefill``: grok-1 at full width, depth 64 -> 2, bf16, on
    (data 2, model 2) (4 experts, 24 query and 4 KV heads a rank): 4
    prompts of ``seq`` (2 a data rank), FLASH, under "auto" and "ep"; then
    ``decode_steps`` greedy steps from the "auto" cache.  Rank 0 then runs
    the unsharded prefill and decode (fed the ranks' tokens) on the same
    card, the ranks' weights freed.  Logits are compared on the tokens
    whose (token, layer) routes agree with the twin's; the rest are
    counted."""
    import repro_torch.launch.serve as serve
    from repro_torch.configs import AttnImpl
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import sharding as sh
    arch = _arch(cfg, MOE_ARCH, num_layers=cfg["moe_layers"])
    B, S = cfg["batch"], cfg["seq"]
    params = _family_params(torch, arch, mesh, dev, 25, torch.bfloat16)
    batch, shape = _family_batch(torch, arch, B, S, dev, 501)
    runs, cache = _family_prefill(torch, rank, cfg, dev, mesh, fk, arch,
                                  batch, shape, params, ("auto", "ep"))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # decode from the "auto" cache
    room = S + cfg["decode_steps"] + 8
    dcache = zoo.init_cache(arch, B, room, device=dev, mesh=mesh)
    for k in ("k", "v"):
        dcache[k][:, :, :S].copy_(cache[k])
    dcache["length"].copy_(cache["length"])
    del cache
    seen, greedy = [], serve.greedy_sharded

    def capture(lg, m):
        seen.append(lg)
        return greedy(lg, m)
    serve.greedy_sharded = capture
    dstep = serve.make_decode_step(arch, device=dev, mesh=mesh, batch=B)
    first = torch.argmax(runs["auto"]["logits"][:, -1, :], -1)[:, None].to(
        torch.int32)
    token = sh.local({"t": first}, mesh, {"t": sh.P("data", None)})[0]["t"]
    dms, dtms, toks, step_logits, droutes = [], [], [], [], []
    try:
        for _ in range(cfg["decode_steps"]):
            with _Spy(hidden=False) as spy:
                (token, dcache), t, tt, _ = _transport_ms(
                    torch, dev, lambda: dstep(params, dcache, token))
            dms.append(t)
            dtms.append(tt)
            toks.append(sh.unlocal(token, mesh, sh.P("data", None)))
            step_logits.append(sh.unlocal(seen.pop().float(), mesh,
                                          sh.P("data", "model")))
            droutes.append(_gather_routes(torch, spy, mesh))
    finally:
        serve.greedy_sharded = greedy
    mine = {impl: {k: r[k] for k in ("ms", "transport_ms", "transport_bytes",
                                     "flash_launches", "give_ups")}
            for impl, r in runs.items()}
    ranks = _gather_obj({"prefill": mine, "decode": {"ms": dms,
                                                     "transport_ms": dtms},
                         "peak_bytes": peak,
                         "weight_bytes": sum(x.numel() * x.element_size()
                                             for _, x in _leaves(params))})
    del params, dcache
    _free(torch, dev)
    _gather_obj(None)
    if rank != 0:
        return None
    full = _family_params(torch, arch, mesh, dev, 25, torch.bfloat16,
                          whole=True)
    plain = serve.make_prefill_step(arch, shape, impl=AttnImpl.FLASH,
                                    device=dev)
    with _Spy() as spy:
        (logits0, cache0), ms0 = _rank_ms(torch, dev,
                                          lambda: plain(full, batch))
    if dev.type == "cuda":
        fk.check_give_ups()
    rec = _compare_prefill(torch, arch, full, runs, logits0, spy.routes,
                           spy.hidden, B, S, 2)
    del spy
    dc0 = zoo.init_cache(arch, B, room, device=dev)
    for k in ("k", "v"):
        dc0[k][:, :, :S].copy_(cache0[k])
    dc0["length"].copy_(cache0["length"])
    del cache0
    _free(torch, dev)
    rels, differ, ms0s, sess_differ = [], 0, [], 0
    token0 = first
    for i in range(cfg["decode_steps"]):
        with _Spy(hidden=False) as spy:
            (lg0, dc0), t = _rank_ms(torch, dev, lambda: zoo.decode_step(
                arch, full, dc0, token0))
        ms0s.append(t)
        lg0 = lg0[:, -1, :].float()
        same, _, _, _ = _route_agreement(torch, arch, droutes[i],
                                         spy.routes, B, 1, 1, multiple=8)
        same = same.reshape(B)
        sess_differ += int((~same).sum())
        keep = same.to(lg0.device)
        if keep.any():
            rels.append(_rel(torch, step_logits[i][keep], lg0[keep]))
        differ += int((torch.argmax(lg0, -1)[:, None].to(torch.int32)
                       != toks[i]).sum())
        token0 = toks[i]
    del full, dc0
    _free(torch, dev)
    assert max(rels) < PREFILL_REL_TOL, rels
    return {"arch": MOE_ARCH, "mesh": {"data": 2, "model": 2},
            "reduced": {"num_layers": f"64 -> {arch.num_layers}"},
            "batch": B, "seq": S, "layers": arch.num_layers,
            "experts_a_rank": arch.moe.num_experts // 2, "impl": "flash",
            "checks": rec, "tolerance": PREFILL_REL_TOL,
            "flash_launches": {i: [r["prefill"][i]["flash_launches"]
                                   for r in ranks] for i in runs},
            "give_ups": {i: [r["prefill"][i]["give_ups"] for r in ranks]
                         for i in runs},
            "ms": {i: [r["prefill"][i]["ms"] for r in ranks] for i in runs},
            "transport_ms": {i: [r["prefill"][i]["transport_ms"]
                                 for r in ranks] for i in runs},
            "transport_bytes": {i: [r["prefill"][i]["transport_bytes"]
                                    for r in ranks] for i in runs},
            "unsharded_ms": ms0,
            "weight_bytes_a_rank": [r["weight_bytes"] for r in ranks],
            "peak_bytes_a_rank": [r["peak_bytes"] for r in ranks],
            "decode": {"steps": cfg["decode_steps"],
                       "rel_err_logits": rels,
                       "session_steps_with_differing_routes": sess_differ,
                       "greedy_tokens_differing": differ,
                       "greedy_tokens": B * cfg["decode_steps"],
                       "ms": [r["decode"]["ms"] for r in ranks],
                       "transport_ms": [r["decode"]["transport_ms"]
                                        for r in ranks],
                       "unsharded_ms": ms0s}}


def moe_block(torch, rank, cfg, dev, mesh, fk):
    """Part ``moe_block``: kimi-k2 at full width, depth 61 -> 1, bf16, on
    (data 1, model 4): 96 experts, 16 query and 2 KV heads (D=112) a rank,
    the shared expert column/row (1 % 4 != 0); one prompt of
    ``block_seq``, FLASH; rank 0 then runs the unsharded block."""
    import repro_torch.launch.serve as serve
    from repro_torch.configs import AttnImpl
    from repro_torch.models import moe
    arch = _arch(cfg, MOE_BLOCK_ARCH, num_layers=cfg["block_layers"])
    assert moe.expert_layout(arch, 4) == {"experts": "ep", "shared": "tp"}
    S = cfg["block_seq"]
    params = _family_params(torch, arch, mesh, dev, 26, torch.bfloat16)
    batch, shape = _family_batch(torch, arch, 1, S, dev, 502)
    runs, cache = _family_prefill(torch, rank, cfg, dev, mesh, fk, arch,
                                  batch, shape, params, ("auto",))
    del cache
    mine = {k: runs["auto"][k] for k in ("ms", "transport_ms",
                                         "transport_bytes", "flash_launches",
                                         "give_ups")}
    mine["weight_bytes"] = sum(x.numel() * x.element_size()
                               for _, x in _leaves(params))
    ranks = _gather_obj(mine)
    del params
    _free(torch, dev)
    _gather_obj(None)
    if rank != 0:
        return None
    full = _family_params(torch, arch, mesh, dev, 26, torch.bfloat16,
                          whole=True)
    plain = serve.make_prefill_step(arch, shape, impl=AttnImpl.FLASH,
                                    device=dev)
    with _Spy() as spy:
        (logits0, _), ms0 = _rank_ms(torch, dev, lambda: plain(full, batch))
    if dev.type == "cuda":
        fk.check_give_ups()
    rec = _compare_prefill(torch, arch, full, runs, logits0, spy.routes,
                           spy.hidden, 1, S, 1)
    del full, spy
    _free(torch, dev)
    return {"arch": MOE_BLOCK_ARCH, "mesh": {"data": 1, "model": 4},
            "reduced": {"num_layers": f"61 -> {arch.num_layers}"},
            "seq": S, "experts_a_rank": arch.moe.num_experts // 4,
            "heads_a_rank": arch.num_heads // 4,
            "kv_heads_a_rank": arch.num_kv_heads // 4,
            "head_dim": arch.resolved_head_dim, "shared_expert": "tp",
            "impl": "flash", "checks": rec, "tolerance": PREFILL_REL_TOL,
            "flash_launches": [r["flash_launches"] for r in ranks],
            "give_ups": [r["give_ups"] for r in ranks],
            "ms": [r["ms"] for r in ranks],
            "transport_ms": [r["transport_ms"] for r in ranks],
            "transport_bytes": [r["transport_bytes"] for r in ranks],
            "weight_bytes_a_rank": [r["weight_bytes"] for r in ranks],
            "unsharded_ms": ms0}


def _family_state(torch, arch, par, mesh, specs, dev, seed, dtype,
                  whole=False):
    """A train state whose params are ``_family_params``' (this rank's, or
    the whole tree) in ``dtype``, the optimiser's state zeros (as
    ``init_state`` makes it) at the rank's shapes."""
    from repro_torch.core.tree import tree_map
    from repro_torch.launch import train
    from repro_torch.parallel import sharding as sh
    params = _family_params(torch, arch, mesh, dev, seed, dtype,
                            parallel=par, whole=whole)
    shapes = train.state_shapes(arch, par)
    if not whole:
        shapes = sh.local(shapes, mesh, specs)[0]
    assert "master" not in shapes["opt"] or dtype != torch.bfloat16, \
        "bf16 AdamW params keep a master"
    zeros = lambda t: tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype,
                                                     device=dev), t)
    return {"params": params, "opt": zeros(shapes["opt"]),
            "step": zeros(shapes["step"])}


def _whole_in_host(torch, tree, mesh, specs, rank):
    """Rank 0's whole copy in host memory of a tree of this rank's shards:
    leaf by leaf, every rank's shard sent to rank 0 (``dist.gather`` of
    host tensors) and put at its place by its mesh coordinates; the other
    ranks return {}.  No card holds a whole full-width tree, and each
    shard crosses once."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import axis_sizes
    from repro_torch.parallel import sharding as sh
    sizes = axis_sizes(mesh)
    coords = _gather_obj(dict(zip(mesh.mesh_dim_names,
                                  mesh.get_coordinate())))
    out = {}
    for path, spec in sorted(_leaves(specs)):
        node = tree
        for k in path.split("/"):
            node = node[k]
        x = node.detach().to("cpu").contiguous()
        parts = [torch.empty_like(x) for _ in coords] if rank == 0 else None
        dist.gather(x, parts, dst=0)
        if rank != 0:
            continue
        entries = tuple(spec) + (None,) * (x.ndim - len(spec))
        counts = []
        for e in entries:
            n = 1
            for a in sh._entry_axes(e):
                n *= sizes[a]
            counts.append(n)
        whole = torch.empty([s * n for s, n in zip(x.shape, counts)],
                            dtype=x.dtype)
        for part, where in zip(parts, coords):
            index = []
            for e, s in zip(entries, x.shape):
                i = 0
                for a in sh._entry_axes(e):
                    i = i * sizes[a] + where[a]
                index.append(slice(i * s, (i + 1) * s))
            whole[tuple(index)] = part
        out[path] = whole
        del parts
    return out


def _leaf_moves(torch, got, ref, was, chunk=1 << 26):
    """(||got - ref||, ||ref - was||, max |got - ref|, max |ref - was|) of
    three tensors of one shape, in f32 a chunk of elements at a time."""
    g, r, w = (t.reshape(-1) for t in (got, ref, was))
    d2 = m2 = dmax = mmax = 0.0
    for i in range(0, r.numel(), chunk):
        gi, ri, wi = (t[i:i + chunk].float() for t in (g, r, w))
        d, m = gi - ri, ri - wi
        d2 += float(d.square().sum(dtype=torch.float64))
        m2 += float(m.square().sum(dtype=torch.float64))
        dmax = max(dmax, float(d.abs().max()))
        mmax = max(mmax, float(m.abs().max()))
        del gi, ri, wi, d, m
    return d2 ** 0.5, m2 ** 0.5, dmax, mmax


def _family_train(torch, rank, cfg, dev, mesh, arch, shape, par, tcfg,
                  steps, seed, axes, dtype, must_check=(),
                  compute_dtype=None):
    """``steps`` steps of ``make_train_step(mesh=)`` from
    ``_family_state``; rank 0 then runs the unsharded step on the same
    card (the ranks' state freed) on the concatenated batches.  Returns
    rank 0's record: losses and ``grad_norm`` against the twin's (within
    TP_LOSS_TOL), and each leaf's ||ranks - twin|| over the twin's own
    move ||twin - initial|| (within TRAIN_MOVE_RATIO; a step left undone
    reads 1); each leaf path of ``must_check`` must be among the checked
    leaves, and its ratio is reported.  ``compute_dtype``: both runs'
    (None: the steps' default, bf16)."""
    from repro_torch.core.tree import tree_map
    from repro_torch.data import rank_batch, synthetic_batch
    from repro_torch.launch import train
    cd = {} if compute_dtype is None else {"compute_dtype": compute_dtype}
    step, _ = train.make_train_step(arch, shape, parallel=par, cfg=tcfg,
                                    device=dev, mesh=mesh, **cd)
    state = _family_state(torch, arch, par, mesh, step.specs, dev, seed,
                          dtype)
    rows = []
    for i in range(steps):
        batch = rank_batch(arch, shape, 0, i, mesh, step.batch_axes,
                           device=dev)
        (state, m), t, tt, tb = _transport_ms(torch, dev,
                                              lambda: step(state, batch))
        rows.append({"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]), "ms": t,
                     "transport_ms": tt, "transport_bytes": tb})
        del batch, m
        _free(torch, dev)           # four ranks' caches share one card
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    whole = _whole_in_host(torch, state["params"], mesh,
                           step.specs["params"], rank)
    ranks = _gather_obj({"rows": rows, "peak_bytes": peak})
    del state
    _free(torch, dev)
    _gather_obj(None)
    if rank != 0:
        return None
    plain, _ = train.make_train_step(arch, shape, parallel=par, cfg=tcfg,
                                     device=dev, **cd)
    state0 = _family_state(torch, arch, par, mesh, None, dev, seed, dtype,
                           whole=True)
    init = tree_map(lambda x: x.to("cpu", copy=True), state0["params"])
    from repro_torch.launch.mesh import axis_sizes
    n = 1
    for a in axes:
        n *= axis_sizes(mesh).get(a, 1)
    want, ms0 = [], []
    for i in range(steps):
        parts = [synthetic_batch(arch, shape, 0, i, shard=s, num_shards=n,
                                 device=dev) for s in range(n)]
        batch0 = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        (state0, m), t = _rank_ms(torch, dev, lambda: plain(state0, batch0))
        want.append({"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"])})
        ms0.append(t)
    ref = dict(_leaves(state0["params"]))
    init = dict(_leaves(init))
    diff = moved = 0.0
    ratios = {}
    for k, r in ref.items():            # on the card, a leaf at a time
        got, was = whole[k].to(dev), init[k].to(dev)
        dn, mn, dmax, mmax = _leaf_moves(torch, got, r, was)
        ratios[k] = dn / mn if mn > 0 else (0.0 if dn == 0 else math.inf)
        diff, moved = max(diff, dmax), max(moved, mmax)
        del got, was
    del state0, ref
    _free(torch, dev)
    rel = {k: max(abs(r[k] - w[k]) / abs(w[k])
                  for r, w in zip(ranks[0]["rows"], want))
           for k in ("loss", "grad_norm")}
    assert all(v < TP_LOSS_TOL for v in rel.values()), (rel, ranks[0], want)
    worst = max(ratios, key=ratios.get)
    assert ratios[worst] <= TRAIN_MOVE_RATIO, ratios
    missing = [k for k in must_check if k not in ratios]
    assert not missing, (missing, sorted(ratios))
    extra = {"must_check_ratios": {k: ratios[k] for k in must_check}} \
        if must_check else {}
    return {"losses": [r["loss"] for r in ranks[0]["rows"]],
            "unsharded_losses": [w["loss"] for w in want],
            "rel_err": rel, "tolerance": TP_LOSS_TOL,
            "params_move_ratio_max": ratios[worst],
            "params_move_ratio_worst_leaf": worst,
            "params_move_ratio_median": sorted(ratios.values())[
                len(ratios) // 2],
            "params_move_ratio_bound": TRAIN_MOVE_RATIO,
            "params_move_ratio_if_unchanged": 1.0,
            "leaves_unmoved_by_twin": sum(
                1 for k in ratios if ratios[k] == 0.0),
            "params_max_abs_diff": diff, "twin_max_move": moved,
            "ms": [[r["ms"] for r in rk["rows"]] for rk in ranks],
            "transport_ms": [[r["transport_ms"] for r in rk["rows"]]
                             for rk in ranks],
            "transport_bytes": [rk["rows"][0]["transport_bytes"]
                                for rk in ranks],
            "peak_bytes_a_rank": [rk["peak_bytes"] for rk in ranks],
            "unsharded_ms": ms0, **extra}


def moe_train(torch, rank, cfg, dev, mesh):
    """Part ``moe_train``: grok-1 at full width, depth 64 -> 1, on (data
    1, model 4) with the reference's own choices for it
    (``default_parallel``, ``param_dtype_for``): bf16 params, Adafactor,
    remat "full", FSDP (data 1: nothing to shard); seq ``train_seq``, a
    batch of 2, ``moe_train_steps`` steps, against the unsharded step
    (losses, ``grad_norm``, and each leaf's move: ``_family_train``)."""
    from repro_torch.configs import (ShapeConfig, StepKind, TrainConfig,
                                     get_arch)
    from repro_torch.launch import train
    arch = _arch(cfg, MOE_ARCH, num_layers=cfg["moe_train_layers"])
    shape = ShapeConfig("moe_train", cfg["train_seq"], cfg["moe_train_batch"],
                        StepKind.TRAIN)
    # the choices the reference makes for grok-1 itself (314 B parameters),
    # not for its depth-cut copy
    par = train.default_parallel(get_arch(MOE_ARCH), shape)
    dtype = train.param_dtype_for(get_arch(MOE_ARCH))
    assert par.optimizer == "adafactor" and par.fsdp and par.remat == "full"
    assert dtype == torch.bfloat16
    steps = cfg["moe_train_steps"]
    rec = _family_train(torch, rank, cfg, dev, mesh, arch, shape, par,
                        TrainConfig(**MOE_TRAIN_CFG), steps, 27, (), dtype)
    if rec is None:
        return None
    return {"arch": MOE_ARCH, "mesh": {"data": 1, "model": 4},
            "reduced": {"num_layers": f"64 -> {arch.num_layers}",
                        "global_batch": f"256 -> {shape.global_batch}"},
            "seq": shape.seq_len, "steps": steps,
            "optimizer": par.optimizer, "param_dtype": "bfloat16",
            "fsdp": par.fsdp, "remat": par.remat, **rec}


def vlm(torch, rank, cfg, dev, mesh, fk):
    """Part ``vlm``: phi-3-vision at full width, depth ``vlm_layers``, on
    (data 2, model 2): 4 prompts of ``seq`` (576 patch positions, 2 a data rank),
    FLASH, ``decode_steps`` greedy steps, each against the unsharded run;
    then ``vlm_train_steps`` ZeRO-1 AdamW steps at depth 32 ->
    ``vlm_train_layers`` (f32 params, bf16 compute, remat "block")."""
    import repro_torch.launch.serve as serve
    from repro_torch.configs import (AttnImpl, ShapeConfig, StepKind,
                                     TrainConfig, get_arch)
    from repro_torch.launch import train
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import sharding as sh
    arch = _arch(cfg, VLM_ARCH, num_layers=cfg["vlm_layers"])
    B, S = cfg["batch"], cfg["seq"]
    params = _family_params(torch, arch, mesh, dev, 28, torch.bfloat16)
    batch, shape = _family_batch(torch, arch, B, S, dev, 503)
    runs, cache = _family_prefill(torch, rank, cfg, dev, mesh, fk, arch,
                                  batch, shape, params, ("auto",))
    run = runs["auto"]
    room = S + cfg["decode_steps"] + 8
    dcache = zoo.init_cache(arch, B, room, device=dev, mesh=mesh)
    for k in ("k", "v"):
        dcache[k][:, :, :S].copy_(cache[k])
    dcache["length"].copy_(cache["length"])
    del cache
    seen, greedy = [], serve.greedy_sharded

    def capture(lg, m):
        seen.append(lg)
        return greedy(lg, m)
    serve.greedy_sharded = capture
    dstep = serve.make_decode_step(arch, device=dev, mesh=mesh, batch=B)
    first = torch.argmax(run["logits"][:, -1, :], -1)[:, None].to(
        torch.int32)
    token = sh.local({"t": first}, mesh, {"t": sh.P("data", None)})[0]["t"]
    dms, toks, step_logits = [], [], []
    try:
        for _ in range(cfg["decode_steps"]):
            (token, dcache), t, _, _ = _transport_ms(
                torch, dev, lambda: dstep(params, dcache, token))
            dms.append(t)
            toks.append(sh.unlocal(token, mesh, sh.P("data", None)))
            step_logits.append(sh.unlocal(seen.pop().float(), mesh,
                                          sh.P("data", "model")))
    finally:
        serve.greedy_sharded = greedy
    mine = {k: run[k] for k in ("ms", "transport_ms", "transport_bytes",
                                "flash_launches", "give_ups")}
    ranks = _gather_obj({"prefill": mine, "decode_ms": dms})
    del params, dcache
    _free(torch, dev)
    _gather_obj(None)
    serve_rec = None
    if rank == 0:
        full = _family_params(torch, arch, mesh, dev, 28, torch.bfloat16,
                              whole=True)
        plain = serve.make_prefill_step(arch, shape, impl=AttnImpl.FLASH,
                                        device=dev)
        (logits0, cache0), ms0 = _rank_ms(torch, dev,
                                          lambda: plain(full, batch))
        if dev.type == "cuda":
            fk.check_give_ups()
        rel = _rel(torch, run["logits"], logits0)
        assert rel < PREFILL_REL_TOL, rel
        dc0 = zoo.init_cache(arch, B, room, device=dev)
        for k in ("k", "v"):
            dc0[k][:, :, :S].copy_(cache0[k])
        dc0["length"].copy_(cache0["length"])
        del cache0
        rels, differ, ms0s, token0 = [], 0, [], first
        for i in range(cfg["decode_steps"]):
            (lg0, dc0), t = _rank_ms(torch, dev, lambda: zoo.decode_step(
                arch, full, dc0, token0))
            ms0s.append(t)
            lg0 = lg0[:, -1, :].float()
            rels.append(_rel(torch, step_logits[i], lg0))
            differ += int((torch.argmax(lg0, -1)[:, None].to(torch.int32)
                           != toks[i]).sum())
            token0 = toks[i]
        del full, dc0
        _free(torch, dev)
        assert max(rels) < PREFILL_REL_TOL, rels
        serve_rec = {
            "batch": B, "seq": S, "patch_positions": arch.num_patches,
            "reduced": _depth_cut(VLM_ARCH, arch),
            "layers": arch.num_layers, "impl": "flash",
            "rel_err_logits": rel, "tolerance": PREFILL_REL_TOL,
            "flash_launches": [r["prefill"]["flash_launches"] for r in ranks],
            "give_ups": [r["prefill"]["give_ups"] for r in ranks],
            "ms": [r["prefill"]["ms"] for r in ranks],
            "transport_ms": [r["prefill"]["transport_ms"] for r in ranks],
            "transport_bytes": [r["prefill"]["transport_bytes"]
                                for r in ranks],
            "unsharded_ms": ms0,
            "decode": {"steps": cfg["decode_steps"], "rel_err_logits": rels,
                       "greedy_tokens_differing": differ,
                       "greedy_tokens": B * cfg["decode_steps"],
                       "ms": [r["decode_ms"] for r in ranks],
                       "unsharded_ms": ms0s}}
    _gather_obj(None)

    tarch = _arch(cfg, VLM_ARCH, num_layers=cfg["vlm_train_layers"])
    tshape = ShapeConfig("vlm_train", cfg["train_seq"], cfg["train_batch"],
                         StepKind.TRAIN)
    par = train.default_parallel(get_arch(VLM_ARCH), tshape)
    dtype = train.param_dtype_for(get_arch(VLM_ARCH))
    assert par.optimizer == "adamw" and par.zero1 and not par.fsdp
    steps = cfg["vlm_train_steps"]
    tcfg = TrainConfig(**TP_TRAIN_CFG)
    trec = _family_train(torch, rank, cfg, dev, mesh, tarch, tshape, par,
                         tcfg, steps, 29, ("data",), dtype)
    if rank != 0:
        return None
    return {"arch": VLM_ARCH, "mesh": {"data": 2, "model": 2},
            "prefill": serve_rec,
            "train": {"reduced": {"num_layers": f"32 -> {tarch.num_layers}",
                                  "global_batch":
                                  f"256 -> {tshape.global_batch}"},
                      "seq": tshape.seq_len, "steps": steps,
                      "zero1": par.zero1, "fsdp": par.fsdp,
                      "remat": par.remat, **trec}}


def family_flash_launches(tp) -> int:
    """Flash launches of the family parts' timed prefills, every rank."""
    return (sum(sum(v) for v in tp["moe_prefill"]["flash_launches"].values())
            + sum(tp["moe_block"]["flash_launches"])
            + sum(tp["vlm"]["prefill"]["flash_launches"]))


def family_give_ups(tp) -> int:
    return (sum(sum(v) for v in tp["moe_prefill"]["give_ups"].values())
            + sum(tp["moe_block"]["give_ups"])
            + sum(tp["vlm"]["prefill"]["give_ups"]))


# ---------------------------------------------------------------------------
# Phase tensor_parallel, the audio family and seq_shard (the first world)
# ---------------------------------------------------------------------------

AUDIO_ARCH = "whisper-tiny"     # audio: full width and depth (4 + 4 layers)
AUDIO_SEQ = 384                 # audio: decoder tokens behind 1,500 frames
AUDIO_TRAIN_STEPS = 1           # 2 -> 1 in PR 28, for the smoke's time


def tp_audio(torch, rank, cfg, dev, mesh, fk):
    """Part ``audio``: whisper-tiny at full width and depth (6 heads, 3 a
    rank; its 51,865-token vocabulary whole on every rank) on (data 2,
    model 2): 4 prompts of ``audio_seq`` tokens behind 1,500 frames (2 a
    data rank), FLASH, then ``decode_steps`` greedy steps, each against
    the unsharded run on the card; then ``audio_train_steps`` ZeRO-1 AdamW
    steps at seq ``audio_seq`` (f32 params and compute, remat "block")."""
    import repro_torch.launch.serve as serve
    from repro_torch.configs import (AttnImpl, ParallelConfig, ShapeConfig,
                                     StepKind, TrainConfig, get_arch)
    from repro_torch.launch import train
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.transformer import vocab_split
    from repro_torch.parallel import sharding as sh
    arch = _arch(cfg, AUDIO_ARCH)
    B, S = cfg["batch"], cfg["audio_seq"]
    layers = arch.encoder_layers + arch.num_layers
    params = _family_params(torch, arch, mesh, dev, 30, torch.bfloat16)
    batch, shape = _family_batch(torch, arch, B, S, dev, 504)
    mine = sh.local(batch, mesh, sh.batch_specs(arch, shape, mesh,
                                                ParallelConfig()))[0]
    step = serve.make_prefill_step(arch, shape, impl=AttnImpl.FLASH,
                                   device=dev, mesh=mesh)
    step(params, mine)                  # warm: the same shape
    _free(torch, dev)
    n0 = fk.flash_attention_bhsd.launches
    (logits, cache), ms, tms, tbytes = _transport_ms(
        torch, dev, lambda: step(params, mine))
    launches = fk.flash_attention_bhsd.launches - n0
    give_ups = fk.check_give_ups() if dev.type == "cuda" else 0
    if dev.type == "cuda":
        assert launches == layers, (launches, layers)
    assert give_ups == 0
    cspecs = serve.session_cache_specs(arch, mesh, B)
    whole = _whole(cache, mesh, cspecs)
    if rank != 0:
        del whole

    # decode: the prefill cache in a rank's cache with room for the steps
    room = S + cfg["decode_steps"] + 8
    dcache = zoo.init_cache(arch, B, room, device=dev, mesh=mesh)
    for k in ("self_k", "self_v"):
        dcache[k][:, :, :S].copy_(cache[k])
    for k in ("cross_k", "cross_v", "length"):
        dcache[k].copy_(cache[k])
    del cache
    seen, decode_step = [], zoo.decode_step

    def capture(*args, **kwargs):   # the logits each step takes its token from
        out = decode_step(*args, **kwargs)
        seen.append(out[0])
        return out
    zoo.decode_step = capture
    # whisper-tiny's 51,865 logits are whole on every rank; a vocabulary
    # that model divides (the CPU rehearsal's) is cut over it
    vocab = "model" if vocab_split(arch, mesh) else None
    dstep = serve.make_decode_step(arch, device=dev, mesh=mesh, batch=B)
    first = torch.argmax(logits[:, -1, :], -1)[:, None].to(torch.int32)
    token = sh.local({"t": first}, mesh, {"t": sh.P("data", None)})[0]["t"]
    dms, dtms, toks, step_logits = [], [], [], []
    try:
        for _ in range(cfg["decode_steps"]):
            (token, dcache), t, tt, _ = _transport_ms(
                torch, dev, lambda: dstep(params, dcache, token))
            dms.append(t)
            dtms.append(tt)
            toks.append(sh.unlocal(token, mesh, sh.P("data", None)))
            step_logits.append(sh.unlocal(seen.pop()[:, -1].float(), mesh,
                                          sh.P("data", vocab)))
    finally:
        zoo.decode_step = decode_step
    mine_rec = {"ms": ms, "transport_ms": tms, "transport_bytes": tbytes,
                "flash_launches": launches, "give_ups": give_ups,
                "decode_ms": dms, "decode_transport_ms": dtms}
    ranks = _gather_obj(mine_rec)
    del params, dcache
    _free(torch, dev)
    _gather_obj(None)
    serve_rec = None
    if rank == 0:
        full = _family_params(torch, arch, mesh, dev, 30, torch.bfloat16,
                              whole=True)
        plain = serve.make_prefill_step(arch, shape, impl=AttnImpl.FLASH,
                                        device=dev)
        plain(full, batch)
        (logits0, cache0), ms0 = _rank_ms(torch, dev,
                                          lambda: plain(full, batch))
        if dev.type == "cuda":
            fk.check_give_ups()
        rel = _rel(torch, logits, logits0)
        rel_cache = {k: _rel(torch, whole[k], cache0[k])
                     for k in ("self_k", "self_v", "cross_k", "cross_v")}
        assert int(whole["length"]) == int(cache0["length"]) == S
        del whole
        assert rel < PREFILL_REL_TOL, rel
        assert max(rel_cache.values()) < PREFILL_REL_TOL, rel_cache
        dc0 = zoo.init_cache(arch, B, room, device=dev)
        for k in ("self_k", "self_v"):
            dc0[k][:, :, :S].copy_(cache0[k])
        for k in ("cross_k", "cross_v", "length"):
            dc0[k].copy_(cache0[k])
        del cache0
        rels, differ, ms0s, token0 = [], 0, [], first
        for i in range(cfg["decode_steps"]):
            (lg0, dc0), t = _rank_ms(torch, dev, lambda: zoo.decode_step(
                arch, full, dc0, token0))
            ms0s.append(t)
            lg0 = lg0[:, -1, :].float()
            rels.append(_rel(torch, step_logits[i], lg0))
            differ += int((torch.argmax(lg0, -1)[:, None].to(torch.int32)
                           != toks[i]).sum())
            token0 = toks[i]
        del full, dc0
        _free(torch, dev)
        assert max(rels) < PREFILL_REL_TOL, rels
        serve_rec = {
            "batch": B, "seq": S, "frames": arch.num_patches,
            "layers": {"encoder": arch.encoder_layers,
                       "decoder": arch.num_layers},
            "heads_a_rank": arch.num_heads // 2,
            "vocabulary": ("cut over model" if vocab else
                           f"whole on every rank ({arch.vocab_size} % 2 "
                           "!= 0)"),
            "impl": "flash", "rel_err_logits": rel,
            "rel_err_cache": rel_cache, "tolerance": PREFILL_REL_TOL,
            "flash_launches": [r["flash_launches"] for r in ranks],
            "give_ups": [r["give_ups"] for r in ranks],
            "ms": [r["ms"] for r in ranks],
            "transport_ms": [r["transport_ms"] for r in ranks],
            "transport_bytes": [r["transport_bytes"] for r in ranks],
            "unsharded_ms": ms0,
            "decode": {"steps": cfg["decode_steps"], "rel_err_logits": rels,
                       "greedy_tokens_differing": differ,
                       "greedy_tokens": B * cfg["decode_steps"],
                       "ms": [r["decode_ms"] for r in ranks],
                       "transport_ms": [r["decode_transport_ms"]
                                        for r in ranks],
                       "unsharded_ms": ms0s}}
    _gather_obj(None)

    tshape = ShapeConfig("audio_train", S, cfg["train_batch"],
                         StepKind.TRAIN)
    par = train.default_parallel(get_arch(AUDIO_ARCH), tshape)
    dtype = train.param_dtype_for(get_arch(AUDIO_ARCH))
    assert par.optimizer == "adamw" and par.zero1 and not par.fsdp
    steps = cfg["audio_train_steps"]
    trec = _family_train(torch, rank, cfg, dev, mesh, arch, tshape, par,
                         TrainConfig(**TP_TRAIN_CFG), steps, 31, ("data",),
                         dtype, compute_dtype=torch.float32)
    if rank != 0:
        return None
    return {"arch": AUDIO_ARCH, "mesh": {"data": 2, "model": 2},
            "prefill": serve_rec,
            "train": {"seq": S, "frames": arch.num_patches,
                      "global_batch": tshape.global_batch, "steps": steps,
                      "zero1": par.zero1, "fsdp": par.fsdp,
                      "remat": par.remat, "param_dtype": str(dtype),
                      "compute_dtype": "float32", **trec}}


def tp_seq_shard(torch, rank, cfg, dev, mesh, fk, prefill_rec=None,
                 prefill_out=None):
    """Part ``seq_shard``: internlm2-1.8b's prefill at full width, depth
    ``serve_layers``, on (data 2, model 2) under ``ParallelConfig(seq_shard=True)``: the
    ``prefill`` part's 4 prompts of ``seq`` tokens, each rank holding
    (2, seq / 2) of them, FLASH; against the unsharded prefill on the
    card, and beside the ``prefill`` part's times and output (its last
    logits and gathered K/V in rank 0's host memory) when that part ran
    first in this world (``prefill_rec``, ``prefill_out``)."""
    import repro_torch.launch.serve as serve
    from repro_torch.configs import AttnImpl, ParallelConfig
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import sharding as sh
    arch = _arch(cfg, TP_ARCH, num_layers=cfg["serve_layers"])
    S = cfg["seq"]
    par = ParallelConfig(seq_shard=True)
    params = _tp_params(torch, arch, mesh, dev)
    tokens = _tp_tokens(torch, arch, cfg, dev)
    spec = {"tokens": sh.P("data", "model")}
    batch = sh.local({"tokens": tokens}, mesh, spec)[0]
    warm = serve.make_prefill_step(arch, _tp_prefill_shape(cfg, 256),
                                   impl=AttnImpl.FLASH, device=dev,
                                   mesh=mesh, parallel=par)
    warm(params, sh.local({"tokens": tokens[:, :256].contiguous()}, mesh,
                          spec)[0])
    step = serve.make_prefill_step(arch, _tp_prefill_shape(cfg, S),
                                   impl=AttnImpl.FLASH, device=dev,
                                   mesh=mesh, parallel=par)
    _free(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    n0 = fk.flash_attention_bhsd.launches
    (logits, cache), ms, tms, tbytes = _transport_ms(
        torch, dev, lambda: step(params, batch))
    launches = fk.flash_attention_bhsd.launches - n0
    give_ups = fk.check_give_ups() if dev.type == "cuda" else 0
    if dev.type == "cuda":
        assert launches == arch.num_layers, (launches, arch.num_layers)
    assert give_ups == 0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    cspecs = serve.session_cache_specs(arch, mesh, cfg["batch"])
    whole = _whole(cache, mesh, cspecs)
    ranks = _gather_obj({"ms": ms, "transport_ms": tms,
                         "transport_bytes": tbytes,
                         "flash_launches": launches, "give_ups": give_ups,
                         "peak_bytes": peak,
                         "rank_tokens": list(batch["tokens"].shape)})
    del params, cache
    if rank != 0:
        del whole
    _free(torch, dev)
    _gather_obj(None)
    if rank != 0:
        return None
    full = zoo.init_params(arch, seed=0, dtype=torch.bfloat16, device=dev)
    plain = serve.make_prefill_step(arch, _tp_prefill_shape(cfg, S),
                                    impl=AttnImpl.FLASH, device=dev)
    plain(full, {"tokens": tokens[:, :256].contiguous()})
    (logits0, cache0), ms0 = _rank_ms(torch, dev,
                                      lambda: plain(full, {"tokens": tokens}))
    if dev.type == "cuda":
        fk.check_give_ups()
    del full
    rel = _rel(torch, logits, logits0)
    rel_cache = {k: _rel(torch, whole[k], cache0[k]) for k in ("k", "v")}
    assert int(whole["length"]) == int(cache0["length"]) == S
    del cache0, logits0
    assert rel < PREFILL_REL_TOL, rel
    assert max(rel_cache.values()) < PREFILL_REL_TOL, rel_cache
    beside = None
    if prefill_out:
        beside = {"max_abs_diff_logits": float(
            (logits.float().cpu() - prefill_out["logits"]).abs().max())}
        for k in ("k", "v"):
            beside[f"max_abs_diff_{k}"] = float(
                (whole[k].cpu().float() - prefill_out[k].float()).abs()
                .max())
        beside["rel_err_logits"] = _rel(torch, logits.float().cpu(),
                                        prefill_out["logits"])
    del whole
    _free(torch, dev)
    keys = ("ms", "transport_ms", "transport_bytes", "peak_bytes_a_rank")
    return {"arch": TP_ARCH, "reduced": _depth_cut(TP_ARCH, arch),
            "mesh": {"data": 2, "model": 2},
            "batch": cfg["batch"], "seq": S, "layers": arch.num_layers,
            "impl": "flash", "rank_tokens": ranks[0]["rank_tokens"],
            "rel_err_logits": rel, "rel_err_cache": rel_cache,
            "tolerance": PREFILL_REL_TOL,
            "flash_launches": [r["flash_launches"] for r in ranks],
            "give_ups": [r["give_ups"] for r in ranks],
            **{k: [r[k] for r in ranks] for k in keys[:3]},
            "peak_bytes_a_rank": [r["peak_bytes"] for r in ranks],
            "unsharded_ms": ms0,
            "prefill_part": ({k: prefill_rec[k] for k in keys}
                             if prefill_rec else None),
            "against_prefill_part": beside}


# ---------------------------------------------------------------------------
# Phase tensor_parallel, the hybrid and ssm families (a world of their own)
# ---------------------------------------------------------------------------

HYBRID_ARCH, HYBRID_LAYERS = "zamba2-7b", 7    # hybrid_prefill: 81 -> 7
                                # (13 until PR 27: one group and a tail
                                # still run every kernel)
HYBRID_TRAIN_LAYERS = 7         # hybrid_train: 81 -> 7 (one group, a tail)
SSM_ARCH = "xlstm-350m"         # full depth: 21 mLSTM and 3 sLSTM layers
SSM_SEQ = 2048                  # ssm_prefill's prompts (PROMPTS)
SSM_TRAIN_SEQ = 128             # ssm_train: three eager sLSTM loops a step
                                # (256 -> 128 in PR 28, for the time)
                                # (74.8 s for the part at 1,024; 512 until
                                # the audio and seq_shard parts came)
RECURRENT_TRAIN_BATCH = 2       # 1 a data rank
RECURRENT_TRAIN_STEPS = 1       # 2 -> 1 for the smoke's time
RECURRENT_PARTS = ("hybrid_prefill", "ssm_prefill", "hybrid_train",
                   "ssm_train")


def _kernel_counters():
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.mlstm_chunk import kernel as mk
    from repro_torch.kernels.ssd_chunk import kernel as sk
    return {"flash_attention_bhsd": fk.flash_attention_bhsd,
            "ssd_chunk_bhcp": sk.ssd_chunk_bhcp,
            "mlstm_chunk_bhsd": mk.mlstm_chunk_bhsd}


def _tp_cut_leaves(arch):
    """The leaf paths ``transformer.tp_view`` cuts with ``shard`` (the
    Mamba-2 and mLSTM leaves the specs leave whole)."""
    from repro_torch.models import transformer
    if arch.family == "hybrid":
        stacks = ["blocks"] + (["tail"] if transformer.plan(arch)["tail"]
                               else [])
        return [f"{st}/mamba/{k}" for st in stacks
                for k in transformer.MAMBA_CUTS]
    return [f"blocks/mlstm/cell/{k}" for k in transformer.MLSTM_CUTS]


def _recurrent_serve(torch, rank, cfg, dev, mesh, fk, arch, S, seed, pseed):
    """A FLASH prefill of ``cfg["batch"]`` prompts of ``S`` tokens (2 a data
    rank) on this rank's shards after a ``warm_seq``-token warm-up, then
    ``decode_steps`` greedy steps from its cache; every kernel's launches
    in the timed prefill (asserted: ``expected_launches`` a rank), flash
    give-ups (0), the rank's ms, transport and peak bytes.  Rank 0 then
    runs the unsharded prefill and decode (fed the ranks' tokens) on the
    same card, the ranks' weights freed: the last logits and every cache
    leaf (gathered) within PREFILL_REL_TOL, each decode step's logits too,
    greedy tokens that differ counted.  Returns (rank 0's record or None,
    the rank's own params freed)."""
    import repro_torch.launch.serve as serve
    from repro_torch.configs import AttnImpl
    from repro_torch.core.tree import tree_map
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import sharding as sh
    B = cfg["batch"]
    counters = _kernel_counters()
    params = _family_params(torch, arch, mesh, dev, seed, torch.bfloat16)
    batch, shape = _family_batch(torch, arch, B, S, dev, pseed)
    mine = sh.local(batch, mesh, {"tokens": sh.P("data", None)})[0]
    warm = {"tokens": mine["tokens"][:, :cfg["warm_seq"]].contiguous()}
    wshape = dataclasses.replace(shape, seq_len=cfg["warm_seq"])
    serve.make_prefill_step(arch, wshape, impl=AttnImpl.FLASH, device=dev,
                            mesh=mesh)(params, warm)
    _free(torch, dev)
    step = serve.make_prefill_step(arch, shape, impl=AttnImpl.FLASH,
                                   device=dev, mesh=mesh)
    _sync(torch, dev)
    n0 = {k: c.launches for k, c in counters.items()}
    (logits, cache), ms, tms, tbytes = _transport_ms(
        torch, dev, lambda: step(params, mine))
    launches = {k: c.launches - n0[k] for k, c in counters.items()}
    give_ups = fk.check_give_ups() if dev.type == "cuda" else 0
    want = {k: expected_launches(arch).get(k, 0) for k in counters}
    if dev.type == "cuda":
        assert launches == want, (launches, want)
    assert give_ups == 0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    cspecs = serve.session_cache_specs(arch, mesh, B)
    whole = tree_map(lambda x: x.clone(), _whole(cache, mesh, cspecs))

    seen, greedy = [], serve.greedy_sharded

    def capture(lg, m):
        seen.append(lg)
        return greedy(lg, m)
    serve.greedy_sharded = capture
    dstep = serve.make_decode_step(arch, device=dev, mesh=mesh, batch=B)
    first = torch.argmax(logits[:, -1, :], -1)[:, None].to(torch.int32)
    token = sh.local({"t": first}, mesh, {"t": sh.P("data", None)})[0]["t"]
    dms, dtms, toks, step_logits = [], [], [], []
    try:
        for _ in range(cfg["decode_steps"]):
            (token, cache), t, tt, _ = _transport_ms(
                torch, dev, lambda: dstep(params, cache, token))
            dms.append(t)
            dtms.append(tt)
            toks.append(sh.unlocal(token, mesh, sh.P("data", None)))
            step_logits.append(sh.unlocal(seen.pop().float(), mesh,
                                          sh.P("data", "model")))
    finally:
        serve.greedy_sharded = greedy
    ranks = _gather_obj({"ms": ms, "transport_ms": tms,
                         "transport_bytes": tbytes, "launches": launches,
                         "give_ups": give_ups, "peak_bytes": peak,
                         "weight_bytes": sum(x.numel() * x.element_size()
                                             for _, x in _leaves(params)),
                         "decode_ms": dms, "decode_transport_ms": dtms})
    del params, cache
    _free(torch, dev)
    _gather_obj(None)
    if rank != 0:
        return None
    full = _family_params(torch, arch, mesh, dev, seed, torch.bfloat16,
                          whole=True)
    plain = serve.make_prefill_step(arch, shape, impl=AttnImpl.FLASH,
                                    device=dev)
    (logits0, cache0), ms0 = _rank_ms(torch, dev, lambda: plain(full, batch))
    if dev.type == "cuda":
        fk.check_give_ups()
    rel = _rel(torch, logits, logits0)
    cache_rel = {k: _rel(torch, x, dict(_leaves(cache0))[k])
                 for k, x in _leaves(whole) if x.is_floating_point()}
    del whole
    rels, differ, ms0s, token0 = [], 0, [], first
    for i in range(cfg["decode_steps"]):
        (lg0, cache0), t = _rank_ms(torch, dev, lambda: zoo.decode_step(
            arch, full, cache0, token0))
        ms0s.append(t)
        lg0 = lg0[:, -1, :].float()
        rels.append(_rel(torch, step_logits[i], lg0))
        differ += int((torch.argmax(lg0, -1)[:, None].to(torch.int32)
                       != toks[i]).sum())
        token0 = toks[i]
    del full, cache0
    _free(torch, dev)
    assert rel < PREFILL_REL_TOL, rel
    assert max(cache_rel.values()) < PREFILL_REL_TOL, cache_rel
    assert max(rels) < PREFILL_REL_TOL, rels
    worst = max(cache_rel, key=cache_rel.get)
    return {"batch": B, "seq": S, "impl": "flash", "layers": arch.num_layers,
            "rel_err_last_logits": rel, "tolerance": PREFILL_REL_TOL,
            "rel_err_cache_max": cache_rel[worst],
            "rel_err_cache_worst_leaf": worst,
            "cache_leaves_checked": len(cache_rel),
            "launches": [r["launches"] for r in ranks],
            "expected_launches_a_rank": want,
            "give_ups": [r["give_ups"] for r in ranks],
            "ms": [r["ms"] for r in ranks],
            "transport_ms": [r["transport_ms"] for r in ranks],
            "transport_bytes": [r["transport_bytes"] for r in ranks],
            "unsharded_ms": ms0,
            "weight_bytes_a_rank": [r["weight_bytes"] for r in ranks],
            "peak_bytes_a_rank": [r["peak_bytes"] for r in ranks],
            "decode": {"steps": cfg["decode_steps"], "rel_err_logits": rels,
                       "greedy_tokens_differing": differ,
                       "greedy_tokens": B * cfg["decode_steps"],
                       "ms": [r["decode_ms"] for r in ranks],
                       "transport_ms": [r["decode_transport_ms"]
                                        for r in ranks],
                       "unsharded_ms": ms0s}}


def hybrid_prefill(torch, rank, cfg, dev, mesh, fk):
    """Part ``hybrid_prefill``: zamba2-7b at full width, depth 81 ->
    ``hybrid_layers`` (7: a group of 6 Mamba-2 layers with the shared
    block, then a tail layer), bf16, on (data 2, model 2): each rank's SSD
    on 56 of the 112 SSM heads (a call a Mamba-2 layer) and flash on 16 of
    the 32 attention heads (a launch a group), 4
    prompts of ``seq`` (2 a data rank), FLASH, then ``decode_steps``
    greedy steps (``_recurrent_serve``)."""
    arch = _arch(cfg, HYBRID_ARCH, num_layers=cfg["hybrid_layers"])
    rec = _recurrent_serve(torch, rank, cfg, dev, mesh, fk, arch,
                           cfg["seq"], 30, 504)
    if rec is None:
        return None
    from repro_torch.models.ssm import ssm_dims
    return {"arch": HYBRID_ARCH, "mesh": {"data": 2, "model": 2},
            "reduced": {"num_layers": f"81 -> {arch.num_layers}"},
            "ssm_heads_a_rank": ssm_dims(arch)[1] // 2,
            "heads_a_rank": arch.num_heads // 2,
            "kv_heads_a_rank": arch.num_kv_heads // 2,
            "head_dim": arch.resolved_head_dim, **rec}


def ssm_prefill(torch, rank, cfg, dev, mesh, fk):
    """Part ``ssm_prefill``: xlstm-350m at full width and depth (21 mLSTM
    and 3 sLSTM layers) on (data 2, model 2): each rank's mLSTM kernel on
    2 of the 4 heads (21 calls), the sLSTM recurrence whole on every rank;
    4 prompts of ``ssm_seq`` (2 a data rank), FLASH, then
    ``decode_steps`` greedy steps (``_recurrent_serve``); every rank's
    captured sLSTM scan against its eager loop, bit for bit, on the rank's
    sLSTM weights at its prefill's shape."""
    from repro_torch.models import xlstm
    arch = _arch(cfg, SSM_ARCH)
    rec = _recurrent_serve(torch, rank, cfg, dev, mesh, fk, arch,
                           cfg["ssm_seq"], 31, 505)
    params = _family_params(torch, arch, mesh, dev, 31, torch.bfloat16)
    scan = check_slstm_scan(torch, xlstm, params, arch,
                            batch=cfg["batch"] // 2, prompt=cfg["ssm_seq"],
                            device=dev)
    del params
    _free(torch, dev)
    scans = _gather_obj(scan)
    if rec is None:
        return None
    return {"arch": SSM_ARCH, "mesh": {"data": 2, "model": 2},
            "reduced": {}, "mlstm_heads_a_rank":
            arch.xlstm.num_heads // 2, "slstm_scan_check": scans, **rec}


def _recurrent_train(torch, rank, cfg, dev, mesh, arch_id, arch, seq, seed,
                     compute_dtype=None):
    """``recurrent_train_steps`` steps of the reference's own choices for
    the arch (``default_parallel``, ``param_dtype_for``: f32 AdamW params,
    ZeRO-1, remat "block"; bf16 compute unless ``compute_dtype``) at
    ``seq``, a batch of 2 on (data 2, model 2), against the unsharded step
    (``_family_train``), every leaf that ``tp_view`` cuts among the
    checked ones."""
    from repro_torch.configs import (ShapeConfig, StepKind, TrainConfig,
                                     get_arch)
    from repro_torch.launch import train
    shape = ShapeConfig(f"{arch_id}_train", seq,
                        cfg["recurrent_train_batch"], StepKind.TRAIN)
    par = train.default_parallel(get_arch(arch_id), shape)
    dtype = train.param_dtype_for(get_arch(arch_id))
    assert par.optimizer == "adamw" and par.zero1 and not par.fsdp
    steps = cfg["recurrent_train_steps"]
    rec = _family_train(torch, rank, cfg, dev, mesh, arch, shape, par,
                        TrainConfig(**TP_TRAIN_CFG), steps, seed, ("data",),
                        dtype, must_check=_tp_cut_leaves(arch),
                        compute_dtype=compute_dtype)
    if rec is None:
        return None
    return {"arch": arch_id, "mesh": {"data": 2, "model": 2},
            "seq": seq, "steps": steps, "optimizer": par.optimizer,
            "zero1": par.zero1, "fsdp": par.fsdp, "remat": par.remat,
            "param_dtype": str(dtype).removeprefix("torch."),
            "compute_dtype": str(compute_dtype or torch.bfloat16)
            .removeprefix("torch."), **rec}


def hybrid_train(torch, rank, cfg, dev, mesh):
    """Part ``hybrid_train``: zamba2-7b at full width, depth 81 -> 7 (one
    group of 6 Mamba-2 layers and the shared block, then a tail layer),
    seq ``train_seq`` (``_recurrent_train``)."""
    arch = _arch(cfg, HYBRID_ARCH, num_layers=cfg["hybrid_train_layers"])
    rec = _recurrent_train(torch, rank, cfg, dev, mesh, HYBRID_ARCH, arch,
                           cfg["train_seq"], 32)
    if rec is not None:
        rec["reduced"] = {"num_layers": f"81 -> {arch.num_layers}",
                          "global_batch": "256 -> "
                          f"{cfg['recurrent_train_batch']}"}
    return rec


def ssm_train(torch, rank, cfg, dev, mesh):
    """Part ``ssm_train``: xlstm-350m at full width and depth, seq
    ``ssm_train_seq`` (``_recurrent_train``; the sLSTM's eager loop under
    autograd), in f32 compute: its tied embedding (scale 1, as the
    reference draws it) gives logits of std ~sqrt(d), and the extra bf16
    rounding of each row-parallel partial sum moved the gradient norm by
    3e-3 against the unsharded bf16 step in the CPU rehearsal (reduced
    width), past TP_LOSS_TOL; in f32 the CPU tests hold the two to 1e-5."""
    arch = _arch(cfg, SSM_ARCH)
    rec = _recurrent_train(torch, rank, cfg, dev, mesh, SSM_ARCH, arch,
                           cfg["ssm_train_seq"], 33, torch.float32)
    if rec is not None:
        rec["reduced"] = {"seq_len": f"4096 -> {cfg['ssm_train_seq']}",
                          "global_batch": "256 -> "
                          f"{cfg['recurrent_train_batch']}"}
    return rec


def recurrent_launches(rtp) -> dict:
    """Each kernel's launches in the recurrent parts' timed prefills,
    every rank."""
    out = {}
    for part in ("hybrid_prefill", "ssm_prefill"):
        for r in rtp[part]["launches"]:
            for k, n in r.items():
                out[k] = out.get(k, 0) + n
    return out


def recurrent_give_ups(rtp) -> int:
    return sum(sum(rtp[p]["give_ups"]) for p in ("hybrid_prefill",
                                                 "ssm_prefill"))


def tp_rank(rank, cfg):
    """One rank of the ``tensor_parallel`` world: every part in turn with a
    barrier between; rank 0 returns the records, every rank its seconds a
    part."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.mesh import make_mesh_compat, world_device
    dev = world_device()
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    _time_transport(torch)
    dm = make_mesh_compat((2, 2), ("data", "model"))
    pm = make_mesh_compat((2, 2), ("pod", "model"))
    m4 = make_mesh_compat((1, 4), ("data", "model"))
    parts = cfg["parts"]
    out, seconds, memory = {}, {}, {}
    # rank 0's host copy of the prefill part's output, for the seq_shard part
    kept = {} if "seq_shard" in parts else None
    if "prefill" in parts:
        t0 = time.perf_counter()
        out["prefill"], out["decode"] = tp_serve(torch, rank, cfg, dev, dm,
                                                 fk, kept)
        _gather_obj(None)
        seconds["prefill"] = seconds["decode"] = time.perf_counter() - t0
    for part, fn in (("train_zero1", lambda: tp_train(torch, rank, cfg, dev,
                                                      dm, False)),
                     ("train_fsdp", lambda: tp_train(torch, rank, cfg, dev,
                                                     dm, True)),
                     ("pods", lambda: tp_pods(torch, rank, cfg, dev, pm)),
                     ("moe_prefill", lambda: moe_prefill(torch, rank, cfg,
                                                         dev, dm, fk)),
                     ("moe_block", lambda: moe_block(torch, rank, cfg, dev,
                                                     m4, fk)),
                     ("moe_train", lambda: moe_train(torch, rank, cfg, dev,
                                                     m4)),
                     ("vlm", lambda: vlm(torch, rank, cfg, dev, dm, fk)),
                     ("audio", lambda: tp_audio(torch, rank, cfg, dev, dm,
                                                fk)),
                     ("seq_shard", lambda: tp_seq_shard(
                         torch, rank, cfg, dev, dm, fk, out.get("prefill"),
                         kept)),
                     ("hybrid_prefill", lambda: hybrid_prefill(
                         torch, rank, cfg, dev, dm, fk)),
                     ("ssm_prefill", lambda: ssm_prefill(torch, rank, cfg,
                                                         dev, dm, fk)),
                     ("hybrid_train", lambda: hybrid_train(torch, rank, cfg,
                                                           dev, dm)),
                     ("ssm_train", lambda: ssm_train(torch, rank, cfg, dev,
                                                     dm))):
        if part not in parts:
            continue
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
            memory[part] = {"before": torch.cuda.memory_allocated(dev)}
        t0 = time.perf_counter()
        out[part] = fn()
        _free(torch, dev)
        _gather_obj(None)
        seconds[part] = time.perf_counter() - t0
        if dev.type == "cuda":
            memory[part]["peak"] = torch.cuda.max_memory_allocated(dev)
    return {"records": out if rank == 0 else None, "seconds": seconds,
            "memory": memory}


def run_tp(torch, cfg=None):
    """Phase ``tensor_parallel``: one world of 4 ranks on the card (gloo
    over a ``file://`` store in ``build/``); returns (the parts' records,
    wall seconds)."""
    import os
    import shutil
    from repro_torch.launch.mesh import spawn_world
    cfg = cfg or tp_config()
    # four ranks' caching allocators share the card: segments that grow in
    # place keep each rank's freed blocks usable for other sizes (the
    # spawned ranks read this at their first CUDA allocation)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    store_dir = ROOT / "build" / "tp_store"
    shutil.rmtree(store_dir, ignore_errors=True)
    store_dir.mkdir(parents=True)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results = spawn_world(tp_rank, MESH_RANKS,
                          f"file://{store_dir / 'store'}", args=(cfg,),
                          device=cfg["device"], timeout_s=MESH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    records = results[0]["records"]
    for part in cfg["parts"]:
        records[part]["seconds"] = max(r["seconds"][part] for r in results)
        if part in results[0]["memory"]:
            records[part]["device_bytes_a_rank"] = [r["memory"][part]
                                                    for r in results]
    return records, wall


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

    # -- 1. device and build; the dry-run's children (phase 9c) start first
    # and run beside the build and the kernel sweeps, where nothing is timed
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    dry_cells = start_dryrun_cells()
    t0 = time.perf_counter()
    built = build.build_all()
    emit({"phase": "build", "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc_s": built, "build_s": time.perf_counter() - t0})
    emit({"phase": "resources", "kernels": resource_report(build)})

    # -- 2. each kernel against its plain version, over its sweep
    worst, cases = check_sweep(torch, kernel)
    emit({"phase": "kernel_sweep", "kernel": "enoki_merge_rows",
          "cases": cases, "max_abs_err": worst})
    fworst, fratio, fcases, fnamed = check_flash_sweep(torch, fk, fops)
    emit({"phase": "kernel_sweep", "kernel": "flash_attention_bhsd",
          "cases": fcases, "max_abs_err": fworst, "tolerance": FLASH_TOL,
          "tp_family_ranks": fnamed,
          "bf16_ratio_to_rounding": fratio,
          "bf16_ratio_limit": BF16_ROUNDING_FACTOR,
          "give_ups": fk.check_give_ups()})
    sworst, scases, snamed = check_ssd_sweep(torch, sk, sops)
    emit({"phase": "kernel_sweep", "kernel": "ssd_chunk_bhcp",
          "cases": scases, "max_abs_err": sworst, "tolerance": SSD_TOL,
          "tp_recurrent_ranks": snamed})
    mworst, mcases, mnamed = check_mlstm_sweep(torch, mk, mops)
    emit({"phase": "kernel_sweep", "kernel": "mlstm_chunk_bhsd",
          "cases": mcases, "max_abs_err": mworst, "tolerance": MLSTM_TOL,
          "tp_recurrent_ranks": mnamed})
    dry_cells = collect_dryrun_cells(dry_cells)

    # -- 2b. the merge kernel's times
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

    # -- 5. the flash-attention kernel's times (its sweep ran in phase 2)
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

    # -- 6. the SSD chunk kernel's time
    sd = time_ssd(torch, sk, flush)
    emit({"phase": "kernel_time", "kernel": "ssd_chunk_bhcp",
          "geometry": "zamba2-7b Mamba-2 layer, prefill", "nvidia_smi": smi,
          **sd})

    # -- 7. the mLSTM chunk kernel's time
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

    # -- 9. the training stack (no kernel on its path: REFERENCE)
    torch.cuda.empty_cache()
    train_rec = run_train(torch, counters)
    emit({"phase": "train", "nvidia_smi": smi, **train_rec})

    # -- 9b. the cost walker on the sessions prefills and the served path
    t_phase = time.perf_counter()
    roof = run_roofline(torch, counters)
    emit({"phase": "roofline", **roof,
          "wall_s": time.perf_counter() - t_phase, "nvidia_smi": smi})

    # -- 9c. the dry-run against the train phase, and two production cells
    # (their children ran beside phases 1 and 2)
    t_dry = time.perf_counter()
    dry = run_dryrun(torch, train_rec["full"], dry_cells)
    emit({"phase": "dryrun", **dry, "wall_s": time.perf_counter() - t_dry,
          "phases_s": time.perf_counter() - t_phase, "nvidia_smi": smi})

    # -- 10. the mesh: four ranks sharing the card over gloo
    torch.cuda.empty_cache()
    mesh, mesh_launches, mesh_wall = run_mesh(torch)
    for part in MESH_PARTS:
        emit({"phase": "mesh", "part": part, "ranks": MESH_RANKS,
              "transport": "gloo, staged through host memory",
              "nvidia_smi": smi, **mesh[part]})

    # -- 11. tensor parallelism: four ranks sharing the card over gloo
    torch.cuda.empty_cache()
    tp, tp_wall = run_tp(torch)
    for part in TP_PARTS:
        emit({"phase": "tensor_parallel", "part": part, "ranks": MESH_RANKS,
              "transport": "gloo, staged through host memory",
              "nvidia_smi": smi, **tp[part]})

    # -- 11b. tensor parallelism of the hybrid and ssm families: a world of
    # four ranks of their own
    torch.cuda.empty_cache()
    rtp, rtp_wall = run_tp(torch, dict(tp_config(), parts=RECURRENT_PARTS))
    for part in RECURRENT_PARTS:
        emit({"phase": "tensor_parallel", "part": part, "ranks": MESH_RANKS,
              "transport": "gloo, staged through host memory",
              "nvidia_smi": smi, **rtp[part]})
    rlaunch = recurrent_launches(rtp)

    # -- 12. the kernels line, the card, the result
    flash_launches = {a: ss["launches"]["flash_attention_bhsd"]
                      for a, ss in sessions.items()
                      if ss["launches"]["flash_attention_bhsd"]}
    flash_launches["tensor_parallel"] = sum(tp["prefill"]["flash_launches"])
    flash_launches["tensor_parallel_families"] = family_flash_launches(tp)
    flash_launches["tensor_parallel_recurrent"] = rlaunch[
        "flash_attention_bhsd"]
    flash_launches["tensor_parallel_audio"] = sum(
        tp["audio"]["prefill"]["flash_launches"])
    flash_launches["tensor_parallel_seq_shard"] = sum(
        tp["seq_shard"]["flash_launches"])
    roof_launches = {}
    for arch_id in ROOFLINE_ARCHS:
        for name, n in roof[arch_id]["launches"].items():
            roof_launches[name] = roof_launches.get(name, 0) + n
    flash_launches["roofline"] = roof_launches.get("flash_attention_bhsd", 0)
    emit({"phase": "done", "smoke_s": time.perf_counter() - t_start,
          "mesh_s": mesh_wall, "tensor_parallel_s": tp_wall,
          "tensor_parallel_recurrent_s": rtp_wall})
    ssd_launches = {
        "zamba2-7b": sessions["zamba2-7b"]["launches"]["ssd_chunk_bhcp"],
        "tensor_parallel_recurrent": rlaunch["ssd_chunk_bhcp"],
        "roofline": roof_launches.get("ssd_chunk_bhcp", 0)}
    mlstm_launches = {
        "xlstm-350m": sessions["xlstm-350m"]["launches"]["mlstm_chunk_bhsd"],
        "tensor_parallel_recurrent": rlaunch["mlstm_chunk_bhsd"],
        "roofline": roof_launches.get("mlstm_chunk_bhsd", 0)}
    t = timings[("100KB", 1)]
    merge_launches = {"serve": st["launches"],
                      "warm": warm["kernel_launches"],
                      "runtime": sum(runtime_launches.values()),
                      "replication": repl_launches,
                      "mesh": sum(mesh_launches),
                      "roofline": roof["serving_costs"]["merge_launches"]}
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
        "give_ups": fk.check_give_ups() + sum(tp["prefill"]["give_ups"])
        + family_give_ups(tp) + recurrent_give_ups(rtp)
        + sum(tp["audio"]["prefill"]["give_ups"])
        + sum(tp["seq_shard"]["give_ups"]),
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
        "launches": sum(ssd_launches.values()),
        "launches_by_path": ssd_launches,
        "max_abs_err": max([max(sworst.values()), sd["max_abs_err"]] + [
            t["max_abs_err"] for t in snamed.values()]),
        "ms": sd["ms"], "plain_ms": sd["plain_ms"],
        "bound_ms": sd["bound_ms"], "bound_by": sd["bound_by"],
        "bound_units": sd["bound_units"], "fma_bound_ms": sd["fma_bound_ms"],
        "library_ms": None}, {
        "name": "mlstm_chunk_bhsd", "route": "cuda", "source": MLSTM_SOURCE,
        "replaces": MLSTM_REPLACES,
        "launches": sum(mlstm_launches.values()),
        "launches_by_path": mlstm_launches,
        "max_abs_err": max([max(mworst.values()), ml["max_abs_err"]] + [
            t["max_abs_err"] for t in mnamed.values()]),
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
