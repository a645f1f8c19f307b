"""Serving driver on the PyTorch port: decode sessions as replicated Enoki
keygroups; the twin of ``examples/serve_sessions.py``.

Two logical pods serve separate session batches; every R tokens the session
keygroups anti-entropy to the peer pod (ring backup).  Pod 0 then "fails";
its sessions resume on pod 1 from the backup with ≤R tokens of staleness —
the serving analogue of the paper's §4.3 measurement.  One weight tree
serves both pods (the reference stacks a copy a pod and ``vmap``s).  It
runs on the CUDA card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_serve_sessions.py [--device cpu|cuda]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core.store import to_numpy
from repro_torch.core.tree import tree_map
from repro_torch.device import resolve_device
from repro_torch.launch.serve import (make_decode_step,
                                      make_migrate_sessions_step,
                                      make_replicate_sessions_step)
from repro_torch.models import model_zoo as zoo


def _pod_logits(arch, params, live, token, dtype) -> np.ndarray:
    """Each pod's last-position logits (P, B, V) for ``token``, from an
    eager ``decode_step`` on a copy of its cache (``live`` is untouched)."""
    out = []
    for pod in range(token.shape[0]):
        cache = tree_map(lambda v: v[pod].clone(), live)
        logits, _ = zoo.decode_step(arch, params, cache, token[pod],
                                    compute_dtype=dtype)
        out.append(to_numpy(logits[:, -1, :]))
    return np.stack(out)


def run(device=None, params=None, dtype=torch.bfloat16,
        arch_id="internlm2-1.8b", n_pods=2, batch=2, max_len=64, R=4,
        steps=10, seed=0, logits=False, log=None) -> dict:
    """The example's decode, backup, failure and migration on ``device``
    in ``dtype`` (weights, cache and compute).  ``params``: a weight tree
    for the reduced ``arch_id`` (e.g. the reference's, through
    ``core.carry.params_from_numpy``); by default one drawn on the host
    from ``seed``, so every device decodes with the same weights.
    ``logits`` also records each step's logits (P, B, V) before its
    argmax.  ``log`` takes each line ``main`` prints."""
    say = log or (lambda line: None)
    dev = resolve_device(device)
    arch = reduced(get_arch(arch_id))
    if params is None:
        params = zoo.init_params(arch, seed, dtype=dtype, device="cpu")
    params = tree_map(lambda t: t.to(dev, dtype) if t.is_floating_point()
                      else t.to(dev), params)

    step = make_decode_step(arch, n_pods=n_pods, device=dev,
                            compute_dtype=dtype)
    live = tree_map(lambda l: torch.stack([l] * n_pods),
                    zoo.init_cache(arch, batch, max_len, dtype=dtype,
                                   device=dev))
    backup = live
    replicate = make_replicate_sessions_step(device=dev)
    migrate = make_migrate_sessions_step(device=dev)

    token = torch.ones((n_pods, batch, 1), dtype=torch.int32, device=dev)
    say(f"decoding on {n_pods} pods × {batch} sessions, backup every "
        f"{R} tokens")
    tokens, step_logits, backups = [], [], []
    for t in range(steps):
        if logits:
            step_logits.append(_pod_logits(arch, params, live, token, dtype))
        token, live = step(params, live, token)
        tokens.append(to_numpy(token)[..., 0].copy())
        if (t + 1) % R == 0:
            backup = replicate(live)
            backups.append(int(live["length"][0]))
            say(f"  t={t+1}: anti-entropy -> peer backup "
                f"(session length {backups[-1]})")

    tokens = np.stack(tokens)                   # (steps, P, B)
    say(f"generated (pod0 session0): {[int(v) for v in tokens[:, 0, 0]]}")
    # ---- pod 0 dies; its sessions live on in pod 1's backup slot ----------
    lost_len = int(live["length"][0])
    dead = torch.arange(n_pods, device=dev) == 0
    restored = migrate(live, backup, dead)
    restored_len = int(restored["length"][0])
    staleness = lost_len - restored_len
    say(f"pod0 failed at token {lost_len}; restored session is at token "
        f"{restored_len} -> staleness = {staleness} tokens (bound: R={R})")
    assert staleness <= R
    migrated = tree_map(lambda t: to_numpy(t).copy(), restored)
    # continue decoding the restored sessions
    onward, restored = step(params, restored, token)
    say("restored sessions decode onward: OK")
    return {"tokens": tokens, "logits": step_logits, "backups": backups,
            "lost_length": lost_len, "restored_length": restored_len,
            "staleness": staleness, "R": R, "migrated": migrated,
            "onward": to_numpy(onward)[..., 0].copy()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    # None is the card, and raises where there is none: no CPU fallback
    return run(device=None if args.device == "cuda" else "cpu", log=print)


if __name__ == "__main__":
    main()
