"""Rank bodies of ``tests/test_torch_seq_shard.py``: what each rank of a
gloo world of 4 CPU ranks on (data 2, model 2) runs for the prefill under
``ParallelConfig(seq_shard=True)``, one reduced config a family.  Spawned
children import this module by name, so it imports neither jax nor the
reference (nor pytest); inputs arrive as the path of an ``.npz`` of numpy
arrays and results leave as numpy arrays.  Everything computes in f32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import configs as tc
from repro_torch.core.carry import params_to_rank, train_state_to_rank
from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import attention as attn
from repro_torch.models import transformer
from repro_torch.parallel import sharding as sh
from torch_tp_ranks import F32, TP_CHANGES, _flat, _t, _tree, _whole
from torch_tp_family_ranks import FAMILY_CHANGES

MESH = (2, 2)
#: case -> (arch id, changes to its reduced config, moe_impl): one a
#: family, at head counts model = 2 divides (the dense and moe families'
#: TP test configs)
CASES = {"dense": ("internlm2-1.8b", TP_CHANGES["internlm2-1.8b"], "auto"),
         "moe": ("grok-1-314b", FAMILY_CHANGES["grok-1-314b"], "auto"),
         "vlm": ("phi-3-vision-4.2b", {}, "auto"),
         "hybrid": ("zamba2-7b", {}, "auto"),
         "ssm": ("xlstm-350m", {}, "auto"),
         "audio": ("whisper-tiny", {}, "auto")}
PREFILL_BATCH, PREFILL_SEQ = 4, 32
#: the leaves the init leaves constant: perturbed, so a slice or a head
#: cut in the wrong place shows
PERTURBED = ("ln1", "ln2", "ln_x", "ln", "final_norm", "enc_norm", "norm",
             "A_log", "D", "dt_bias", "b_i", "b_f", "b")
TRAIN_BATCH, TRAIN_SEQ = 4, 32


def case_arch(configs, case: str):
    """The test config of ``case`` from either package's configs."""
    arch_id, changes, _ = CASES[case]
    arch = configs.reduced(configs.get_arch(arch_id))
    changes = dict(changes)
    if "moe" in changes:
        changes["moe"] = dataclasses.replace(arch.moe, **changes["moe"])
    return dataclasses.replace(arch, **changes)


def prefill_shape(configs, seq: int = PREFILL_SEQ):
    return dataclasses.replace(
        configs.reduced_shape(configs.SHAPES_BY_NAME["prefill_32k"]),
        seq_len=seq, global_batch=PREFILL_BATCH)


def train_shape(configs):
    return dataclasses.replace(
        configs.reduced_shape(configs.SHAPES_BY_NAME["train_4k"]),
        seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)


def perturb(params: dict, rng: np.random.Generator) -> dict:
    """A numpy params tree with every ``PERTURBED`` leaf moved by 0.2 x a
    normal draw (in place; returned)."""
    for k, v in params.items():
        if isinstance(v, dict):
            perturb(v, rng)
        elif k in PERTURBED:
            params[k] = (v + 0.2 * rng.standard_normal(v.shape)).astype(
                v.dtype)
    return params


def _prefill(case: str, inputs: dict, mesh, impl, seq_shard=True):
    arch = case_arch(tc, case)
    full = _tree(inputs, f"{case}/params")
    pspecs = sh.param_partition_specs(tree_map(_t, full), arch, mesh,
                                      tc.ParallelConfig(fsdp=False))
    params = params_to_rank(arch, full, mesh, pspecs, device="cpu")
    shape = prefill_shape(tc)
    par = tc.ParallelConfig(seq_shard=seq_shard, moe_impl=CASES[case][2])
    batch = {k[len(case) + 8:]: _t(v) for k, v in inputs.items()
             if k.startswith(f"{case}/prompt/")}
    rank_batch = sh.local(batch, mesh, sh.batch_specs(arch, shape, mesh,
                                                      par))[0]
    step = serve.make_prefill_step(arch, shape, impl=impl, device="cpu",
                                   compute_dtype=F32, mesh=mesh,
                                   parallel=par)
    logits, cache = step(params, rank_batch)
    cspecs = serve.session_cache_specs(arch, mesh, PREFILL_BATCH)
    return logits, _whole(cache, mesh, cspecs), rank_batch


def _slice_only(model: int):
    """``blockwise_attention`` whose queries see only the keys of their
    own rank's slice of the sequence (a port that skipped the gather)."""
    real = attn.blockwise_attention

    def sliced(q, k, v, qp, kp, causal=True, window=0, kv_block=512):
        parts = zip(*(t.chunk(model, 1) for t in (q, k, v, qp, kp)))
        return torch.cat([real(*p, causal=causal, window=window,
                               kv_block=kv_block) for p in parts], 1)
    return real, sliced


def seq_shard_world(rank: int, path: str) -> dict:
    """Each case's ``seq_shard`` prefill (REFERENCE; the dense case under
    FLASH too, the kernel's plain version on the CPU): the last logits and
    the gathered cache; the two mutants' logits (dense, REFERENCE); the
    dense family's ZeRO-1 step with and without ``seq_shard`` (rank 0
    reports)."""
    inputs = dict(np.load(path))
    mesh = make_test_mesh(MESH, ("data", "model"))
    out = {}
    for case in CASES:
        impls = (tc.AttnImpl.REFERENCE, tc.AttnImpl.FLASH) \
            if case == "dense" else (tc.AttnImpl.REFERENCE,)
        for impl in impls:
            logits, cache, rank_batch = _prefill(case, inputs, mesh, impl)
            out[f"{case}/{impl.value}/logits"] = logits.numpy()
            _flat(cache, f"{case}/{impl.value}/cache", out)
        if case == "dense":
            out[f"{case}/rank_tokens_shape"] = tuple(
                rank_batch["tokens"].shape)
    real, sliced = _slice_only(MESH[1])
    attn.blockwise_attention = sliced
    try:
        logits, _, _ = _prefill("dense", inputs, mesh,
                                tc.AttnImpl.REFERENCE)
    finally:
        attn.blockwise_attention = real
    out["mutant/slice_only/logits"] = logits.numpy()
    positions = transformer._positions
    transformer._positions = lambda B, S, device: positions(
        B, S // MESH[1], device).repeat(1, MESH[1])
    try:
        logits, _, _ = _prefill("dense", inputs, mesh,
                                tc.AttnImpl.REFERENCE)
    finally:
        transformer._positions = positions
    out["mutant/local_positions/logits"] = logits.numpy()
    out.update(train_twins(mesh, inputs))
    return out if rank == 0 else {}


def train_twins(mesh, inputs: dict) -> dict:
    """One AdamW ZeRO-1 step of the dense case from the same state and
    batch, with ``seq_shard`` and without: every leaf of the two states
    after it, and the metrics, side by side."""
    arch = case_arch(tc, "dense")
    shape = train_shape(tc)
    init = {"params": _tree(inputs, "train/init/params"),
            "opt": _tree(inputs, "train/init/opt"),
            "step": inputs["train/init/step"]}
    batch = {k: _t(inputs[f"train/batch/{k}"])
             for k in ("tokens", "labels", "loss_mask")}
    out = {}
    for flag in (False, True):
        par = tc.ParallelConfig(zero1=True, remat="block", seq_shard=flag)
        step, _ = train.make_train_step(
            arch, shape, parallel=par, cfg=tc.TrainConfig(lr=1e-3,
                                                          warmup_steps=1),
            device="cpu", compute_dtype=F32, mesh=mesh)
        state = train_state_to_rank(arch, init, mesh, step.specs,
                                    device="cpu")
        rank_batch = sh.local(batch, mesh, {
            k: sh.P(*step.batch_axes or (None,), None) for k in batch})[0]
        state, m = step(state, rank_batch)
        whole = _whole(state, mesh, step.specs)
        out[f"train/{flag}/leaves"] = [a.numpy().copy() for a in
                                       tree_flatten(whole)[0]]
        out[f"train/{flag}/metrics"] = {k: float(v) for k, v in m.items()}
        out[f"train/{flag}/batch_axes"] = step.batch_axes
    return out
