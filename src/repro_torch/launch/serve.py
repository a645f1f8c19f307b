"""Serving: sessions are Enoki keygroups; the counterpart of
``repro.launch.serve`` on one device.

A decode session's state is a keygroup whose home is the pod serving it:
a KV cache (dense, vlm and moe), recurrent states (xlstm: per-layer mLSTM
matrix memories and sLSTM cells), both (zamba2), or whisper's decoder cache
beside the encoder output's K/V.  The decode hot path touches only
pod-local state, the paper's core property.  Four steps, each made by a
``make_*`` factory:

  prefill                   builds a session batch from prompts (last-position
                            logits + the layer-stacked session state)
  decode                    one greedy token for every session of every pod
  replicate_sessions        anti-entropy: ring-copy session state to the next
                            pod (pod i backs up pod i-1) into a backup copy;
                            a pod failure loses <= R tokens of session state
                            (R = ``EnokiConfig.replication_period``)
  migrate_sessions          failover: adopt the backup copy as live state for
                            the pods flagged dead

There is no mesh and no sharding: multi-pod state is pod-stacked on a
leading dimension of ``n_pods`` logical pods, as
``examples/serve_sessions.py`` runs the reference on one device.  The pods
share ONE copy of the weights (the reference stacks identical copies only
because each pod is another set of chips).  Decode loops over the pods,
each with its own ``length``, and writes every pod's cache IN PLACE (the
counterpart of the reference step's donated cache).  The whole pod-step is
one ``core.graphs.StepCache`` entry, the counterpart of the reference's
``jax.jit(jax.vmap(step))``: on CUDA one captured graph per (weights,
cache geometry and addresses, token shape), replayed by every step; a
cache that ``migrate_sessions`` replaces is a new entry.

Each factory takes ``device=None``, which means the CUDA card (it raises
without one); a step refuses tensors that are not on that device.  The
reference's mesh, sharding, parallelism, donation and ``EnokiConfig``
arguments have no counterpart here: the replication period is the caller's
loop (every R decode steps).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig, AttnImpl, ShapeConfig
from repro_torch.core.graphs import StepCache
from repro_torch.core.tree import tree_map
from repro_torch.device import resolve_device
from repro_torch.models import model_zoo as zoo

#: a (nested) dict of tensors: dense and moe ``k``/``v``, whisper's
#: ``self_k``/``self_v``/``cross_k``/``cross_v``, xlstm's ``mlstm`` and
#: ``slstm`` recurrent states, or zamba2's ``mamba``, ``tail`` and
#: shared-block ring; ``length`` always
Cache = dict


def serve_param_dtype(arch: ArchConfig):
    return torch.bfloat16      # serving always runs bf16 weights


def params_shape_tree(arch: ArchConfig) -> dict:
    """The serving parameter tree on the ``meta`` device: shapes and
    dtypes, no storage (the reference's ``jax.eval_shape`` of its init)."""
    return zoo.init_params(arch, seed=0, dtype=serve_param_dtype(arch),
                           device="meta")


def _on(device: torch.device, tree, what: str) -> None:
    leaves = tree.values() if isinstance(tree, dict) else [tree]
    for leaf in leaves:
        if isinstance(leaf, dict):
            _on(device, leaf, what)
        elif leaf.device.type != device.type or (
                device.index is not None and leaf.device != device):
            raise ValueError(f"{what} is on {leaf.device}; this step runs on "
                             f"{device}")


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def make_prefill_step(arch: ArchConfig, shape: ShapeConfig,
                      impl: AttnImpl = AttnImpl.REFERENCE, device=None,
                      compute_dtype=torch.bfloat16
                      ) -> Callable[[dict, dict], tuple]:
    """``prefill(params, batch) -> (logits (B, 1, V), cache)`` for one pod:
    ``batch["tokens"]`` is (B, shape.seq_len), and the batch goes to
    ``forward_seq`` as its ``extra`` (the vlm's ``patch_embeds``,
    whisper's ``frame_embeds``: ``model_zoo.example_batch`` makes them);
    the cache is ``forward_seq``'s, with ``length`` = ``shape.seq_len``."""
    dev = resolve_device(device)

    def prefill(params: dict, batch: dict):
        _on(dev, params, "params")
        _on(dev, batch, "batch")
        logits, _, cache = zoo.forward_seq(arch, params, batch["tokens"],
                                           extra=batch, impl=impl,
                                           return_cache=True,
                                           compute_dtype=compute_dtype)
        cache["length"] = torch.tensor(shape.seq_len, dtype=torch.int32,
                                       device=dev)
        # a copy, so the (B, S, V) logits are freed as the step returns
        return logits[:, -1:, :].clone(), cache

    return prefill


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def make_decode_step(arch: ArchConfig, n_pods: int = 1, device=None,
                     compute_dtype=torch.bfloat16
                     ) -> Callable[[dict, Cache, torch.Tensor], tuple]:
    """``step(params, cache, token) -> (next_token, cache)``, greedy.

    The cache is pod-stacked (``init_cache``'s leaves stacked on a leading
    dim of ``n_pods``, ``length`` of shape (n_pods,)), ``token`` is
    (n_pods, B, 1), and the one ``params`` tree serves every pod.  The
    cache is written in place and returned.  The pod-step runs through a
    ``StepCache`` (``step.steps``): the token is copied into the graph's
    static buffer and ``next_token`` out of it; ``step.eager`` runs the
    same pod-step without the cache."""
    dev = resolve_device(device)

    def pod_step(cache: Cache, params: dict, token: torch.Tensor):
        out = torch.empty(token.shape, dtype=torch.int32, device=dev)
        for pod in range(n_pods):
            pod_cache = tree_map(lambda v: v[pod], cache)
            logits, pod_cache = zoo.decode_step(arch, params, pod_cache,
                                                token[pod],
                                                compute_dtype=compute_dtype)
            out[pod] = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
            cache["length"][pod] = pod_cache["length"]
        return out

    steps = StepCache(f"decode:{arch.name}x{n_pods}", pod_step)

    def _checked(params: dict, cache: Cache, token: torch.Tensor) -> dict:
        _on(dev, params, "params")
        _on(dev, cache, "cache")
        _on(dev, token, "token")
        if cache["length"].shape != (n_pods,) or token.shape[0] != n_pods:
            raise ValueError(f"pod-stacked state must lead with {n_pods} pods")
        return {"state": cache, "params": params, "inputs": token}

    def step(params: dict, cache: Cache, token: torch.Tensor):
        return steps(**_checked(params, cache, token)), cache

    def eager(params: dict, cache: Cache, token: torch.Tensor):
        return steps.eager(**_checked(params, cache, token)), cache

    step.steps = steps
    step.eager = eager
    return step


# ---------------------------------------------------------------------------
# Session anti-entropy / migration (multi-pod)
# ---------------------------------------------------------------------------

def make_replicate_sessions_step(device=None) -> Callable[[Cache], Cache]:
    """``replicate(live) -> backup``: every leaf of the (nested) tree
    ``torch.roll(·, 1, 0)`` over the pod dim (pod i's backup slot holds pod
    i-1's sessions); the backup is a fresh copy, off the decode path."""
    dev = resolve_device(device)

    def replicate(live: Cache) -> Cache:
        _on(dev, live, "live sessions")
        return tree_map(lambda v: torch.roll(v, 1, 0), live)

    return replicate


def make_migrate_sessions_step(device=None
                               ) -> Callable[[Cache, Cache, torch.Tensor],
                                             Cache]:
    """``migrate(live, backup, dead) -> live'``: every leaf of the (nested)
    tree ``torch.where(dead[pod], backup, live)``, keygroup restore from the
    surviving replica (paper §2)."""
    dev = resolve_device(device)

    def migrate(live: Cache, backup: Cache, dead: torch.Tensor) -> Cache:
        _on(dev, live, "live sessions")
        _on(dev, backup, "backup sessions")
        _on(dev, dead, "dead mask")
        n_pods = dead.shape[0]

        def sel(l, b):
            return torch.where(dead.reshape((n_pods,) + (1,) * (l.ndim - 1)),
                               b, l)
        return tree_map(sel, live, backup)

    return migrate
