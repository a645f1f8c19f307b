"""Rank bodies of ``tests/test_torch_tensor_parallel_hybrid.py`` and
``tests/test_torch_tensor_parallel_ssm.py``: what each rank of a gloo
world on the CPU runs for the hybrid (zamba2) and ssm (xlstm) families.
Spawned children import this module by name, so it imports neither jax
nor the reference (nor pytest); inputs arrive as numpy arrays and results
leave as numpy arrays.  The helpers are ``torch_tp_ranks``' (the dense
family's bodies).  Everything computes in f32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import configs as tc
from repro_torch.core.carry import params_to_rank
from repro_torch.core.tree import tree_map
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import layers
from repro_torch.models import ssm as ssm_mod
from repro_torch.parallel import collectives as col
from repro_torch.parallel import sharding as sh
from torch_tp_ranks import (F32, _flat, _init_state, _rank_batch, _steps, _t,
                            _tree, _whole)

#: family -> arch id (the reduced config: zamba2 at 5 layers, d 128, 8 SSM
#: heads; xlstm at 8 layers, 2 mLSTM heads)
ARCHS = {"hybrid": "zamba2-7b", "ssm": "xlstm-350m"}
#: the (data, model) meshes each family serves on: xlstm's reduced sLSTM
#: feed-forward (170) does not split by 4
SERVE_MESHES = {"hybrid": ((2, 2), (1, 4)), "ssm": ((2, 2),)}
PREFILL_BATCH, PREFILL_SEQ = 4, 32
DECODE_STEPS = 3
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 32, 2
TRAIN_CFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)
#: name -> (optimizer, fsdp, remat) of the (data 2, model 2) train modes
TRAIN_MODES = {"adamw_zero1": ("adamw", False, "block"),
               "adamw_fsdp": ("adamw", True, "full"),
               "adafactor": ("adafactor", False, "none")}
#: leaves the init leaves constant (zero norm scales, a constant A, D,
#: dt bias and gate biases a head): perturbed, so a head or a column cut
#: in the wrong place shows
PERTURBED = ("ln", "final_norm", "norm", "A_log", "D", "dt_bias", "b_i",
             "b_f", "b")
#: the Mamba-2 leaves whose gradient a B/C left out of ``vary`` gets
#: 1 / model of
SHARED_FOR_HEADS = ("w_B", "w_C", "conv_B", "conv_C")


def family_arch(configs, family: str):
    """The test config of ``family`` from either package's configs."""
    return configs.reduced(configs.get_arch(ARCHS[family]))


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


def _params(family: str, inputs: dict, mesh):
    arch = family_arch(tc, family)
    full = _tree(inputs, "params")
    pspecs = sh.param_partition_specs(tree_map(_t, full), arch, mesh,
                                      tc.ParallelConfig(fsdp=False))
    return arch, params_to_rank(arch, full, mesh, pspecs, device="cpu")


# ---------------------------------------------------------------------------
# prefill and decode on (data, model)
# ---------------------------------------------------------------------------

def _prefill(arch, params, tokens, mesh, impl):
    pshape = shapes(tc)[0]
    step = serve.make_prefill_step(arch, pshape, impl=impl, device="cpu",
                                   compute_dtype=F32, mesh=mesh)
    return step(params, tokens)


def serve_world(rank: int, family: str, mesh_shape: tuple,
                inputs: dict) -> dict:
    """The prefill (REFERENCE, and FLASH: the kernels' plain versions on
    the CPU) of ``PREFILL_BATCH`` prompts, then ``DECODE_STEPS`` greedy
    steps from the REFERENCE prefill's cache; rank 0 reports the gathered
    logits, caches and tokens."""
    mesh = make_test_mesh(mesh_shape, ("data", "model"))
    arch, params = _params(family, inputs, mesh)
    tokens = _rank_batch({"tokens": _t(inputs["prompt"])}, mesh, ("data",))
    cspecs = serve.session_cache_specs(arch, mesh, PREFILL_BATCH)
    out = {}
    for impl in (tc.AttnImpl.FLASH, tc.AttnImpl.REFERENCE):
        logits, cache = _prefill(arch, params, tokens, mesh, impl)
        # copies: decode then writes the cache (and a replicated leaf's
        # whole is the rank's own tensor) in place
        whole = tree_map(torch.clone, _whole(cache, mesh, cspecs))
        out[f"prefill/{impl.value}/logits"] = logits.numpy()
        _flat(whole, f"prefill/{impl.value}/cache", out)
    token = _rank_batch({"t": _t(inputs["dtoken"])}, mesh, ("data",))["t"]
    step = serve.make_decode_step(arch, device="cpu", compute_dtype=F32,
                                  mesh=mesh, batch=PREFILL_BATCH)
    toks = []
    for _ in range(DECODE_STEPS):
        token, cache = step(params, cache, token)
        toks.append(sh.unlocal(token, mesh, sh.P("data", None)))
    out["decode/tokens"] = torch.stack(toks).numpy()
    _flat(_whole(cache, mesh, cspecs), "decode/cache", out)
    from repro_torch.core.tree import tree_flatten
    from repro_torch.models import model_zoo as zoo
    fresh = zoo.init_cache(arch, PREFILL_BATCH, PREFILL_SEQ, device="cpu",
                           mesh=mesh)
    out["init_cache/same_shapes"] = [tuple(a.shape) for a in
                                     tree_flatten(fresh)[0]] == \
        [tuple(a.shape) for a in tree_flatten(cache)[0]]
    if family == "hybrid" and mesh_shape == (2, 2):
        out.update(local_norm_mutant(arch, params, tokens, mesh))
    return out if rank == 0 else {}


def local_norm_mutant(arch, params, tokens, mesh) -> dict:
    """The prefill with the Mamba-2 gated norm's mean square taken over
    the rank's own d_inner columns (a naive port's ``rmsnorm``): its
    logits, which the test holds past the tolerance."""
    whole_row = ssm_mod.rmsnorm
    ssm_mod.rmsnorm = lambda x, scale, eps=1e-5, mesh=None: \
        layers.rmsnorm(x, scale, eps)
    try:
        logits, _ = _prefill(arch, params, tokens, mesh,
                             tc.AttnImpl.REFERENCE)
    finally:
        ssm_mod.rmsnorm = whole_row
    return {"mutant/local_norm/logits": logits.numpy()}


# ---------------------------------------------------------------------------
# training on (data 2, model 2)
# ---------------------------------------------------------------------------

def _batches(inputs: dict, prefix: str, pod=None) -> list:
    keys = ("tokens", "labels", "loss_mask")
    return [{k: (inputs[f"{prefix}/{i}/{k}"] if pod is None else
                 inputs[f"{prefix}/{i}/{k}"][pod]) for k in keys}
            for i in range(TRAIN_STEPS)]


def train_world(rank: int, family: str, inputs: dict) -> dict:
    """Every ``TRAIN_MODES`` mode's ``TRAIN_STEPS`` steps from the same
    init: metrics, the first step's gradients and the state after (rank 0
    reports); for the hybrid family also the first step's gradients with
    B and C left out of ``shared_for_heads``."""
    mesh = make_test_mesh((2, 2), ("data", "model"))
    arch = family_arch(tc, family)
    shape = shapes(tc)[2]
    cfg = tc.TrainConfig(**TRAIN_CFG)
    out = {}
    for name, (opt, fsdp, remat) in TRAIN_MODES.items():
        par = tc.ParallelConfig(fsdp=fsdp, zero1=True, remat=remat,
                                optimizer=opt)
        got, _, _ = _steps(rank == 0, mesh, arch, shape, par, cfg,
                           tc.EnokiConfig(), _init_state(inputs,
                                                         f"init/{opt}"),
                           _batches(inputs, "batch"), name, TRAIN_STEPS)
        out.update(got)
    if family == "hybrid":
        out.update(no_vary_mutant(rank, mesh, arch, shape, inputs))
    return out if rank == 0 else {}


def no_vary_mutant(rank: int, mesh, arch, shape, inputs: dict) -> dict:
    """The first ZeRO-1 step's gradients with B and C fed to the rank's
    heads as they are (no ``vary``): each rank's cotangent covers only its
    heads, so ``w_B``, ``w_C``, ``conv_B`` and ``conv_C`` get 1 / model of
    their gradient."""
    par = tc.ParallelConfig(fsdp=False, zero1=True, remat="none",
                            optimizer="adamw")
    step, _ = train.make_train_step(arch, shape, parallel=par, device="cpu",
                                    compute_dtype=F32, mesh=mesh)
    from repro_torch.core.carry import train_state_to_rank
    state = train_state_to_rank(arch, _init_state(inputs, "init/adamw"),
                                mesh, step.specs, device="cpu")
    batch = _rank_batch({k: _t(v) for k, v in
                         _batches(inputs, "batch")[0].items()}, mesh,
                        step.batch_axes)
    shared = ssm_mod.shared_for_heads
    ssm_mod.shared_for_heads = lambda t, mesh: t
    try:
        grads = step.grads(state["params"], batch)
    finally:
        ssm_mod.shared_for_heads = shared
    whole = _whole(grads, mesh, step.specs["params"])
    return _flat(whole, "mutant/no_vary/grads", {}) if rank == 0 else {}


# ---------------------------------------------------------------------------
# (pod 2, data 2, model 2): a REPLICATED round
# ---------------------------------------------------------------------------

def pods_world(rank: int, family: str, inputs: dict) -> dict:
    """Each pod (4 ranks) takes ``TRAIN_STEPS`` REPLICATED AdamW ZeRO-1
    steps on its own batch; then one anti-entropy round from the pods'
    params of ``pods/rstate`` (the init moved apart a pod, the same in
    both packages); each pod's first rank reports its metrics and state,
    and its params and outer state after the round."""
    from repro_torch.optim import diloco_init
    mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
    pod = col.axis_index(mesh, "pod")
    arch = family_arch(tc, family)
    par = tc.ParallelConfig(fsdp=False, zero1=True, remat="none",
                            optimizer="adamw")
    R = tc.ReplicationPolicy
    init = _init_state(inputs, "init/adamw")
    report = rank in (0, 4)
    out, state, step = _steps(report, mesh, arch, shapes(tc)[2], par,
                              tc.TrainConfig(**TRAIN_CFG),
                              tc.EnokiConfig(policy=R.REPLICATED), init,
                              _batches(inputs, "pods/batch", pod),
                              f"pods/replicated{pod}", TRAIN_STEPS)
    pspecs = step.specs["params"]
    ospecs = {"outer_params": pspecs, "momentum": pspecs, "round": sh.P()}
    rstep, _ = train.make_replicate_step(
        arch, 2, par, tc.EnokiConfig(policy=R.REPLICATED), device="cpu",
        mesh=mesh)
    outer = sh.local(diloco_init(tree_map(_t, init["params"])), mesh,
                     ospecs)[0]
    mine = tree_map(lambda a: _t(a)[pod], _tree(inputs, "pods/rstate"))
    s2, o2 = rstep({"params": sh.local(mine, mesh, pspecs)[0]}, outer)
    p_whole = _whole(s2["params"], mesh, pspecs)
    o_whole = _whole(o2, mesh, ospecs)
    if report:
        _flat(p_whole, f"pods/replicate/params{pod}", out)
        _flat(o_whole, f"pods/replicate/outer{pod}", out)
    return out if report else {}


def four_ranks(rank: int, family: str, inputs: dict) -> dict:
    """One world of 4 ranks for the family's serving meshes and its
    training: ``{"serve": {mesh shape: serve_world's}, "train":
    train_world's}``."""
    return {"serve": {ms: serve_world(rank, family, ms, inputs)
                      for ms in SERVE_MESHES[family]},
            "train": train_world(rank, family, inputs)}


# ---------------------------------------------------------------------------
# on the card (tests/test_torch_cuda.py, two ranks sharing it)
# ---------------------------------------------------------------------------

CARD_TOL = 5e-2               # the reference's prefill/decode bound (bf16)
#: family -> (layers, seq): zamba2 at 7 layers (one group of 6 Mamba-2
#: layers and the shared block, then a tail layer: every kernel of the
#: family), xlstm at 8 (7 mLSTM layers and an sLSTM)
CARD_CASES = {"hybrid": (7, 512), "ssm": (8, 512)}


def _perturb_(tree: dict, gen) -> None:
    """``perturb`` of a tree of card tensors, in place."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb_(v, gen)
        elif k in PERTURBED:
            v.add_(0.2 * torch.randn(v.shape, generator=gen, device=v.device,
                                     dtype=v.dtype))


def card_recurrent_forms(rank: int) -> dict:
    """At full width, bf16, FLASH on (data 1, model 2), 2 prompts: each
    family's prefill against the unsharded prefill on the card (the
    logits, and every cache leaf gathered), the kernels' launches a rank
    (SSD on zamba2's 56 heads, flash on its 16; mLSTM on xlstm's 2 heads)
    and flash give-ups."""
    from repro_torch.core.tree import tree_flatten
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.mlstm_chunk import kernel as mk
    from repro_torch.kernels.ssd_chunk import kernel as sk
    from repro_torch.launch.mesh import make_mesh_compat, world_device
    from repro_torch.models import model_zoo as zoo
    dev = world_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh_compat((1, 2), ("data", "model"))
    counters = {"flash": fk.flash_attention_bhsd, "ssd": sk.ssd_chunk_bhcp,
                "mlstm": mk.mlstm_chunk_bhsd}
    rel = lambda a, b: float((a.float() - b.float()).abs().max()
                             / b.float().abs().max().clamp(min=1e-30))
    out = {}
    for family, (layers_, seq) in CARD_CASES.items():
        arch = dataclasses.replace(tc.get_arch(ARCHS[family]),
                                   num_layers=layers_)
        gen = torch.Generator(device=dev).manual_seed(3)
        full = zoo.init_params(arch, seed=0, dtype=torch.bfloat16, device=dev)
        _perturb_(full, gen)
        pspecs = sh.param_partition_specs(full, arch, mesh,
                                          tc.ParallelConfig(fsdp=False))
        params = sh.local(full, mesh, pspecs)[0]
        tokens = torch.randint(0, arch.vocab_size, (2, seq), generator=gen,
                               device=dev, dtype=torch.int32)
        shape = tc.ShapeConfig("card", seq, 2, tc.StepKind.PREFILL)
        step = serve.make_prefill_step(arch, shape, impl=tc.AttnImpl.FLASH,
                                       device=dev, mesh=mesh)
        n0 = {k: c.launches for k, c in counters.items()}
        logits, cache = step(params, {"tokens": tokens})
        torch.cuda.synchronize()
        for k, c in counters.items():
            out[f"{family}/{k}_launches"] = c.launches - n0[k]
        out[f"{family}/give_ups"] = fk.check_give_ups()
        cspecs = serve.session_cache_specs(arch, mesh, 2)
        whole = _whole(cache, mesh, cspecs)
        del params, cache
        plain = serve.make_prefill_step(arch, shape, impl=tc.AttnImpl.FLASH,
                                        device=dev)
        logits0, cache0 = plain(full, {"tokens": tokens})
        out[f"{family}/prefill_rel"] = rel(logits, logits0)
        out[f"{family}/cache_rel"] = max(
            rel(a, b) for a, b in zip(tree_flatten(whole)[0],
                                      tree_flatten(cache0)[0])
            if a.is_floating_point())
        out[f"{family}/layers"] = layers_
        del full, whole, cache0, logits0
        torch.cuda.empty_cache()
    return out
