"""Rank bodies of ``tests/test_torch_tensor_parallel_audio.py``: what each
rank of a gloo world on the CPU runs for the audio family (whisper-tiny)
and for the dense family at a vocabulary that ``model`` does not divide.
Spawned children import this module by name, so it imports neither jax
nor the reference (nor pytest); inputs arrive as the path of an ``.npz``
of numpy arrays (each rank loads it: no copy through the spawn pipes)
and results leave as numpy arrays.  The helpers are ``torch_tp_ranks``'
(the dense family's bodies).  Everything computes in f32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import configs as tc
from repro_torch.core.carry import params_to_rank
from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import attention as attn
from repro_torch.models import model_zoo as zoo
from repro_torch.parallel import collectives as col
from repro_torch.parallel import sharding as sh
from torch_tp_ranks import (F32, TP_CHANGES, TRAIN_CFG, TRAIN_STEPS, _flat,
                            _init_state, _rank_batch, _steps, _t, _tree,
                            _whole)

ARCH = "whisper-tiny"
#: the reduced vocabulary (model 2 and 4 cut it) and an odd one (every
#: rank holds the whole embedding and head, as for whisper's 51,865)
VOCABS = (512, 515)
#: the dense family's case at the odd vocabulary: internlm2's TP config
DENSE_ARCH, DENSE_VOCAB = "internlm2-1.8b", 515
SERVE_MESHES = ((2, 2), (1, 4))
PREFILL_BATCH, PREFILL_SEQ = 4, 16
DECODE_STEPS = 3
TRAIN_BATCH, TRAIN_SEQ = 4, 16
#: name -> (optimizer, fsdp, remat) of the (data 2, model 2) train modes
TRAIN_MODES = {"adamw_zero1": ("adamw", False, "block"),
               "adamw_fsdp": ("adamw", True, "full"),
               "adafactor": ("adafactor", False, "none")}
#: the norm scales the init leaves at zero: perturbed, so a column cut in
#: the wrong place shows
PERTURBED = ("ln1", "ln2", "ln_x", "final_norm", "enc_norm")


def audio_arch(configs, vocab: int):
    """The reduced whisper-tiny (4 heads of 32, 2 encoder and 2 decoder
    layers, 8 frames) at ``vocab`` from either package's configs."""
    return dataclasses.replace(configs.reduced(configs.get_arch(ARCH)),
                               vocab_size=vocab)


def dense_arch(configs):
    return dataclasses.replace(configs.reduced(configs.get_arch(DENSE_ARCH)),
                               vocab_size=DENSE_VOCAB,
                               **TP_CHANGES[DENSE_ARCH])


def arch_of(configs, case: str):
    """A case name of the inputs ("512", "515" or "dense") -> its arch."""
    return dense_arch(configs) if case == "dense" else \
        audio_arch(configs, int(case))


#: every case's prefix in the inputs, whisper's first
CASES = tuple(str(v) for v in VOCABS) + ("dense",)


def shapes(configs):
    """(prefill, decode, train) shapes from either package's configs; a
    decode cache is the prefill's (the same sequence)."""
    r = configs.reduced_shape
    by = configs.SHAPES_BY_NAME
    return (dataclasses.replace(r(by["prefill_32k"]), seq_len=PREFILL_SEQ,
                                global_batch=PREFILL_BATCH),
            dataclasses.replace(r(by["decode_32k"]), seq_len=PREFILL_SEQ,
                                global_batch=PREFILL_BATCH),
            dataclasses.replace(r(by["train_4k"]), seq_len=TRAIN_SEQ,
                                global_batch=TRAIN_BATCH))


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


def _params(case: str, inputs: dict, mesh):
    arch = arch_of(tc, case)
    full = _tree(inputs, f"{case}/params")
    pspecs = sh.param_partition_specs(tree_map(_t, full), arch, mesh,
                                      tc.ParallelConfig(fsdp=False))
    return arch, params_to_rank(arch, full, mesh, pspecs, device="cpu")


def _prompt(case: str, inputs: dict, mesh) -> dict:
    keys = [k for k in ("tokens", "frame_embeds")
            if f"{case}/prompt/{k}" in inputs]
    return _rank_batch({k: _t(inputs[f"{case}/prompt/{k}"]) for k in keys},
                       mesh, ("data",))


# ---------------------------------------------------------------------------
# prefill and decode on (data, model)
# ---------------------------------------------------------------------------

def _prefill(arch, params, batch, mesh, impl):
    step = serve.make_prefill_step(arch, shapes(tc)[0], impl=impl,
                                   device="cpu", compute_dtype=F32,
                                   mesh=mesh)
    return step(params, batch)


def serve_case(case: str, mesh, inputs: dict) -> dict:
    """The prefill (REFERENCE, and FLASH: the kernel's plain version on
    the CPU) of ``PREFILL_BATCH`` prompts, then ``DECODE_STEPS`` greedy
    steps from the REFERENCE prefill's cache: the gathered logits, caches
    and tokens."""
    arch, params = _params(case, inputs, mesh)
    batch = _prompt(case, inputs, mesh)
    cspecs = serve.session_cache_specs(arch, mesh, PREFILL_BATCH)
    out = {}
    for impl in (tc.AttnImpl.FLASH, tc.AttnImpl.REFERENCE):
        logits, cache = _prefill(arch, params, batch, mesh, impl)
        # copies: decode then writes the cache in place
        whole = tree_map(torch.clone, _whole(cache, mesh, cspecs))
        out[f"{case}/prefill/{impl.value}/logits"] = logits.numpy()
        _flat(whole, f"{case}/prefill/{impl.value}/cache", out)
    token = _rank_batch({"t": _t(inputs[f"{case}/dtoken"])}, mesh,
                        ("data",))["t"]
    step = serve.make_decode_step(arch, device="cpu", compute_dtype=F32,
                                  mesh=mesh, batch=PREFILL_BATCH)
    toks = []
    for _ in range(DECODE_STEPS):
        token, cache = step(params, cache, token)
        toks.append(sh.unlocal(token, mesh, sh.P("data", None)))
    out[f"{case}/decode/tokens"] = torch.stack(toks).numpy()
    _flat(_whole(cache, mesh, cspecs), f"{case}/decode/cache", out)
    fresh = zoo.init_cache(arch, PREFILL_BATCH, PREFILL_SEQ, device="cpu",
                           mesh=mesh)
    out[f"{case}/init_cache/same_shapes"] = [
        tuple(a.shape) for a in tree_flatten(fresh)[0]] == \
        [tuple(a.shape) for a in tree_flatten(cache)[0]]
    return out


def cross_psum_mutant(case: str, mesh, inputs: dict) -> dict:
    """The prefill with cross-attention's row-parallel ``wo`` left
    without its ``psum`` (each rank keeps its heads' part): its logits,
    which the test holds past the tolerance."""
    arch, params = _params(case, inputs, mesh)
    batch = _prompt(case, inputs, mesh)
    real = attn.cross_attention
    attn.cross_attention = lambda p, x, k, v, arch, mesh=None: \
        real(p, x, k, v, arch)
    try:
        logits, _ = _prefill(arch, params, batch, mesh,
                             tc.AttnImpl.REFERENCE)
    finally:
        attn.cross_attention = real
    return {f"mutant/{case}/cross_psum/logits": logits.numpy()}


def serve_world(rank: int, mesh_shape: tuple, inputs: dict) -> dict:
    """Every whisper case on a (data, model) mesh; on (data 2, model 2)
    also the dense case and the cross-attention mutant."""
    mesh = make_test_mesh(mesh_shape, ("data", "model"))
    out = {}
    for case in CASES:
        if case != "dense" or mesh_shape == (2, 2):
            out.update(serve_case(case, mesh, inputs))
    if mesh_shape == (2, 2):
        out.update(cross_psum_mutant(CASES[0], mesh, inputs))
    return out if rank == 0 else {}


# ---------------------------------------------------------------------------
# training on (data 2, model 2)
# ---------------------------------------------------------------------------

def _batches(inputs: dict, prefix: str, pod=None) -> list:
    keys = [k for k in ("tokens", "labels", "loss_mask", "frame_embeds")
            if f"{prefix}/0/{k}" in inputs]
    return [{k: (inputs[f"{prefix}/{i}/{k}"] if pod is None else
                 inputs[f"{prefix}/{i}/{k}"][pod]) for k in keys}
            for i in range(TRAIN_STEPS)]


def train_world(rank: int, inputs: dict) -> dict:
    """Every ``TRAIN_MODES`` mode's ``TRAIN_STEPS`` steps of each whisper
    case from the same init, and the dense case's ZeRO-1 steps: metrics,
    the first step's gradients and the state after (rank 0 reports)."""
    mesh = make_test_mesh((2, 2), ("data", "model"))
    shape = shapes(tc)[2]
    cfg = tc.TrainConfig(**TRAIN_CFG)
    out = {}
    for case in CASES:
        arch = arch_of(tc, case)
        modes = ("adamw_zero1",) if case == "dense" else TRAIN_MODES
        for name in modes:
            opt, fsdp, remat = TRAIN_MODES[name]
            par = tc.ParallelConfig(fsdp=fsdp, zero1=True, remat=remat,
                                    optimizer=opt)
            got, _, _ = _steps(rank == 0, mesh, arch, shape, par, cfg,
                               tc.EnokiConfig(),
                               _init_state(inputs, f"{case}/init/{opt}"),
                               _batches(inputs, f"{case}/batch"),
                               f"{case}/{name}", TRAIN_STEPS)
            out.update(got)
    return out if rank == 0 else {}


# ---------------------------------------------------------------------------
# (pod 2, data 2, model 2): a REPLICATED round
# ---------------------------------------------------------------------------

def pods_world(rank: int, path: str) -> dict:
    """For each whisper case: each pod (4 ranks) takes ``TRAIN_STEPS``
    REPLICATED AdamW ZeRO-1 steps on its own batch; then one anti-entropy
    round from the pods' params of ``pods/rstate`` (the init moved apart a
    pod, the same in both packages); each pod's first rank reports its
    metrics and state, and its params and outer state after the round."""
    from repro_torch.optim import diloco_init
    inputs = dict(np.load(path))
    mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
    pod = col.axis_index(mesh, "pod")
    par = tc.ParallelConfig(fsdp=False, zero1=True, remat="none",
                            optimizer="adamw")
    R = tc.ReplicationPolicy
    report = rank in (0, 4)
    out = {}
    for case in CASES[:len(VOCABS)]:
        arch = arch_of(tc, case)
        init = _init_state(inputs, f"{case}/init/adamw")
        got, state, step = _steps(
            report, mesh, arch, shapes(tc)[2], par,
            tc.TrainConfig(**TRAIN_CFG), tc.EnokiConfig(policy=R.REPLICATED),
            init, _batches(inputs, f"{case}/pods/batch", pod),
            f"{case}/pods/replicated{pod}", TRAIN_STEPS)
        out.update(got)
        pspecs = step.specs["params"]
        ospecs = {"outer_params": pspecs, "momentum": pspecs,
                  "round": sh.P()}
        rstep, _ = train.make_replicate_step(
            arch, 2, par, tc.EnokiConfig(policy=R.REPLICATED), device="cpu",
            mesh=mesh)
        outer = sh.local(diloco_init(tree_map(_t, init["params"])), mesh,
                         ospecs)[0]
        mine = tree_map(lambda a: _t(a)[pod],
                        _tree(inputs, f"{case}/pods/rstate"))
        s2, o2 = rstep({"params": sh.local(mine, mesh, pspecs)[0]}, outer)
        p_whole = _whole(s2["params"], mesh, pspecs)
        o_whole = _whole(o2, mesh, ospecs)
        if report:
            _flat(p_whole, f"{case}/pods/replicate/params{pod}", out)
            _flat(o_whole, f"{case}/pods/replicate/outer{pod}", out)
    return out if report else {}


def four_ranks(rank: int, path: str) -> dict:
    """One world of 4 ranks for both serving meshes and the training:
    ``{"serve": {mesh shape: serve_world's}, "train": train_world's}``."""
    inputs = dict(np.load(path))
    return {"serve": {ms: serve_world(rank, ms, inputs)
                      for ms in SERVE_MESHES},
            "train": train_world(rank, inputs)}


# ---------------------------------------------------------------------------
# on the card (tests/test_torch_cuda.py, two ranks sharing it)
# ---------------------------------------------------------------------------

CARD_TOL = 5e-2               # the reference's prefill/decode bound (bf16)
CARD_PROMPTS, CARD_SEQ = 2, 384


def card_audio_forms(rank: int) -> dict:
    """whisper-tiny at full width and depth, bf16, FLASH on (data 1, model
    2), 2 prompts of 384 tokens behind 1,500 frames: the prefill against
    the unsharded prefill on the card (the logits, and every cache leaf
    gathered), then internlm2-1.8b at 4 layers under ``seq_shard`` against
    its unsharded prefill; flash launches a rank and give-ups."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.mesh import make_mesh_compat, world_device
    dev = world_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh_compat((1, 2), ("data", "model"))
    rel = lambda a, b: float((a.float() - b.float()).abs().max()
                             / b.float().abs().max().clamp(min=1e-30))
    out = {}
    cases = (("audio", tc.get_arch(ARCH), None),
             ("seq_shard", dataclasses.replace(tc.get_arch(DENSE_ARCH),
                                               num_layers=4),
              tc.ParallelConfig(seq_shard=True)))
    for name, arch, par in cases:
        gen = torch.Generator(device=dev).manual_seed(3)
        full = zoo.init_params(arch, seed=0, dtype=torch.bfloat16, device=dev)
        for path, leaf in _norm_leaves(full):
            leaf.add_(0.2 * torch.randn(leaf.shape, generator=gen,
                                        device=dev, dtype=leaf.dtype))
        pspecs = sh.param_partition_specs(full, arch, mesh,
                                          tc.ParallelConfig(fsdp=False))
        params = sh.local(full, mesh, pspecs)[0]
        shape = tc.ShapeConfig("card", CARD_SEQ, CARD_PROMPTS,
                               tc.StepKind.PREFILL)
        batch = zoo.example_batch(arch, shape, gen)
        batch["tokens"] = torch.randint(0, arch.vocab_size,
                                        (CARD_PROMPTS, CARD_SEQ),
                                        generator=gen, device=dev,
                                        dtype=torch.int32)
        bspecs = sh.batch_specs(arch, shape, mesh,
                                par or tc.ParallelConfig())
        step = serve.make_prefill_step(arch, shape, impl=tc.AttnImpl.FLASH,
                                       device=dev, mesh=mesh, parallel=par)
        n0 = fk.flash_attention_bhsd.launches
        logits, cache = step(params, sh.local(batch, mesh, bspecs)[0])
        torch.cuda.synchronize()
        out[f"{name}/flash_launches"] = fk.flash_attention_bhsd.launches - n0
        out[f"{name}/give_ups"] = fk.check_give_ups()
        whole = _whole(cache, mesh, serve.session_cache_specs(
            arch, mesh, CARD_PROMPTS))
        del params, cache
        plain = serve.make_prefill_step(arch, shape, impl=tc.AttnImpl.FLASH,
                                        device=dev)
        logits0, cache0 = plain(full, batch)
        out[f"{name}/prefill_rel"] = rel(logits, logits0)
        out[f"{name}/cache_rel"] = max(
            rel(a, b) for a, b in zip(tree_flatten(whole)[0],
                                      tree_flatten(cache0)[0])
            if a.is_floating_point())
        out[f"{name}/layers"] = (arch.encoder_layers + arch.num_layers
                                 if arch.is_encoder_decoder
                                 else arch.num_layers)
        del full, whole, cache0, logits0
        torch.cuda.empty_cache()
    return out


def _norm_leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _norm_leaves(v, path + (k,))
        elif k in PERTURBED:
            yield path + (k,), v
