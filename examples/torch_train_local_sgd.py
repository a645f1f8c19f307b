"""End-to-end training driver on the PyTorch port: Enoki-replicated
(DiLoCo-style) local SGD; the twin of ``examples/train_local_sgd.py``.

Trains a small LM with TWO logical pods stacked on one device (the pod axis
is a leading dim of every state leaf), running the whole production loop:

  data pipeline (sharded, cursor keygroup) -> pod-local train steps ->
  periodic anti-entropy (delta exchange + outer Nesterov) ->
  async checkpointing -> crash -> restore -> continue.

The default model is laptop-sized (~9M params); ``--params-100m`` gives the
~100M one.  It runs on the CUDA card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_train_local_sgd.py [--steps N] \\
        [--device cpu|cuda] [--crash-at STEP]
"""
import argparse
import dataclasses
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import (EnokiConfig, ParallelConfig,
                                 ReplicationPolicy, TrainConfig, get_arch)
from repro_torch.configs.base import ArchConfig, ShapeConfig, StepKind
from repro_torch.core.keygroup import TensorKeygroup
from repro_torch.core.tree import tree_map
from repro_torch.data import DataPipeline
from repro_torch.launch import train as train_mod
from repro_torch.runtime import HealthMonitor


def small_arch(big: bool) -> ArchConfig:
    base = get_arch("internlm2-1.8b")
    if big:   # ~100M params
        return dataclasses.replace(base, num_layers=12, d_model=768,
                                   num_heads=12, num_kv_heads=4, d_ff=2048,
                                   vocab_size=32768)
    return dataclasses.replace(base, num_layers=6, d_model=256, num_heads=4,
                               num_kv_heads=2, d_ff=1024, vocab_size=4096)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--params-100m", action="store_true")
    ap.add_argument("--replication-period", type=int, default=5)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a temporary directory")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--crash-at", type=int, default=None,
                    help="simulate a failure at this step and restore")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)

    arch = small_arch(args.params_100m)
    shape = ShapeConfig("local", seq_len=128, global_batch=8,
                        step=StepKind.TRAIN)
    n_pods = 2
    par = ParallelConfig(fsdp=False, remat="none", optimizer="adamw")
    cfg = TrainConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    enoki = EnokiConfig(policy=ReplicationPolicy.REPLICATED,
                        replication_period=args.replication_period)
    print(f"arch: {arch.param_count()/1e6:.1f}M params, "
          f"{n_pods} logical pods on {args.device}, anti-entropy every "
          f"{enoki.replication_period} steps")

    step, _ = train_mod.make_train_step(arch, shape, n_pods, par, enoki, cfg,
                                        device=args.device)
    replicate, _ = train_mod.make_replicate_step(arch, n_pods, par, enoki,
                                                 device=args.device)
    single = train_mod.init_state(arch, 0, par, device=args.device)
    state = tree_map(lambda l: torch.stack([l] * n_pods), single)
    from repro_torch.optim import diloco_init
    outer = diloco_init(single["params"])
    del single
    pipes = [DataPipeline(arch, shape, seed=0, shard=p, num_shards=n_pods,
                          device=args.device) for p in range(n_pods)]
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="enoki_ckpt_")
    mgr = CheckpointManager(ckpt_dir, keep=2)
    health = HealthMonitor()

    def snapshot():
        return {"state": state, "outer": outer,
                "cursors": [{"step": p.cursor.tree["step"],
                             "version": p.cursor.version} for p in pipes]}

    def batch():
        shards = [p.next() for p in pipes]
        return tree_map(lambda *xs: torch.stack(xs), *shards)

    t0 = time.time()
    mgr.save(0, snapshot(), blocking=True)  # step-0 base
    losses = []
    for i in range(args.steps):
        if args.crash_at is not None and i == args.crash_at:
            print(f"-- simulated crash at step {i}; restoring from "
                  f"checkpoint --")
            mgr.wait()
            restored = mgr.restore(snapshot())
            state, outer = restored["state"], restored["outer"]
            # the cursors max-merge: a restored host never rewinds its data
            for p, c in zip(pipes, restored["cursors"]):
                p.restore(TensorKeygroup({"step": c["step"]}, c["version"],
                                         "max"))
            args.crash_at = None
        state, metrics = step(state, batch())
        for p in range(n_pods):
            health.beat(f"pod{p}", i)
        if (i + 1) % enoki.replication_period == 0:
            state, outer = replicate(state, outer)
            tag = " +anti-entropy"
        else:
            tag = ""
        loss = [float(x) for x in metrics["loss"]]
        losses.append(loss)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss/pod={['%.3f' % l for l in loss]} "
                  f"lr={float(metrics['lr'][0]):.2e} "
                  f"{time.time()-t0:6.1f}s{tag}")
        if (i + 1) % args.ckpt_every == 0:
            mgr.save(i, snapshot())
    mgr.wait()
    print(f"done: {args.steps} steps in {time.time()-t0:.1f}s; "
          f"checkpoints at {ckpt_dir}: steps {mgr.steps()}")
    print(f"stragglers seen: {health.stragglers() or 'none'}")
    return {"losses": losses, "state": state, "outer": outer,
            "checkpoints": mgr.steps(), "cursors": [p.step for p in pipes]}


if __name__ == "__main__":
    main()
