"""Rank bodies of ``tests/test_torch_tensor_parallel_kv.py``: what each rank
of a gloo world on the CPU runs where ``model`` exceeds the KV heads
(Megatron's replicated KV heads: each group of ``rep = model / KV``
consecutive ranks holds one KV head whole).  Spawned children import this
module by name, so it imports neither jax nor the reference (nor pytest);
inputs arrive as the path of an ``.npz`` of numpy arrays and results
leave as numpy arrays.  The helpers are ``torch_tp_ranks``'.  Everything
computes in f32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import configs as tc
from repro_torch.core.carry import params_to_rank
from repro_torch.core.tree import tree_map
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.transformer import kv_split
from repro_torch.parallel import collectives as col
from repro_torch.parallel import sharding as sh
from torch_tp_ranks import (F32, _flat, _init_state, _rank_batch, _steps,
                            _t, _tree, _whole)

MODEL = 4
#: case -> (arch id, changes to its reduced config): the dense and moe
#: families as they are reduced (internlm2 KV 2: rep 2; qwen1.5-110b and
#: grok-1 KV 1: rep 4), the vlm, the hybrid's shared block and the audio
#: family's self- and cross-attention with their KV heads lowered
CASES = {"dense_rep2": ("internlm2-1.8b", {}),
         "dense_rep4": ("qwen1.5-110b", {}),
         "moe": ("grok-1-314b", {}),
         "vlm": ("phi-3-vision-4.2b", {"num_kv_heads": 2}),
         "hybrid": ("zamba2-7b", {"num_kv_heads": 1}),
         "audio": ("whisper-tiny", {"num_kv_heads": 2})}
SERVE_MESHES = ((1, MODEL), (2, MODEL))
PREFILL_BATCH, PREFILL_SEQ = 4, 32
DECODE_STEPS = 3
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 32, 2
TRAIN_CFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)
#: name -> (fsdp, remat) of the (data 2, model 4) train modes
TRAIN_MODES = {"zero1": (False, "block"), "fsdp": (True, "full")}
#: the modes each case trains in: both for the dense family at rep 2 and
#: 4, one a family elsewhere
TRAIN_CASES = {"dense_rep2": ("zero1", "fsdp"),
               "dense_rep4": ("zero1", "fsdp"), "moe": ("zero1",),
               "vlm": ("fsdp",), "hybrid": ("zero1",), "audio": ("fsdp",)}
#: the case the mutant trains (ZeRO-1: the group gather is the step's only
#: ``gather_param``)
MUTANT_CASE = "dense_rep2"
#: the leaves the init leaves constant: perturbed, so a cut in the wrong
#: place shows
PERTURBED = ("ln1", "ln2", "ln_x", "ln", "final_norm", "enc_norm", "norm",
             "A_log", "D", "dt_bias", "bq", "bk", "bv")


def case_arch(configs, case: str):
    """The test config of ``case`` from either package's configs."""
    arch_id, changes = CASES[case]
    return dataclasses.replace(configs.reduced(configs.get_arch(arch_id)),
                               **changes)


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
    arch = case_arch(tc, case)
    full = _tree(inputs, f"{case}/params")
    pspecs = sh.param_partition_specs(tree_map(_t, full), arch, mesh,
                                      tc.ParallelConfig(fsdp=False))
    return arch, params_to_rank(arch, full, mesh, pspecs, device="cpu")


def _prompt(case: str, inputs: dict) -> dict:
    pre = f"{case}/prompt/"
    return {k[len(pre):]: _t(v) for k, v in inputs.items()
            if k.startswith(pre)}


def copies_identical(cache: dict, mesh, specs: dict) -> bool:
    """Every ``Grouped`` leaf of a rank's cache equal bit for bit on the
    ranks of each KV group (gathered over ``model``)."""
    flags = []

    def check(x, spec):
        grouped = [e for e in spec if isinstance(e, sh.Grouped)]
        if grouped:
            parts = col._all_gather(x.contiguous(), mesh, "model")
            rep = parts.shape[0] // grouped[0].parts
            flags.append(all(torch.equal(parts[i], parts[i - i % rep])
                             for i in range(parts.shape[0])))
    sh._zip_specs(check, cache, specs)
    return bool(flags) and all(flags)


# ---------------------------------------------------------------------------
# prefill, decode and seq_shard on (data, model 4)
# ---------------------------------------------------------------------------

def serve_case(case: str, mesh, inputs: dict) -> dict:
    """The prefill (REFERENCE, and FLASH: the kernel's plain version on
    the CPU) of ``PREFILL_BATCH`` prompts, then ``DECODE_STEPS`` greedy
    steps from the REFERENCE prefill's cache; with ``data`` > 1 the
    prefill under ``seq_shard`` too: the gathered logits, caches and
    tokens, and whether each group's copies agree bit for bit."""
    arch, params = _params(case, inputs, mesh)
    pshape = shapes(tc)[0]
    prompt = _prompt(case, inputs)
    cspecs = serve.session_cache_specs(arch, mesh, PREFILL_BATCH)
    out = {f"{case}/rep": kv_split(arch, MODEL)[1]}
    forms = [("reference", tc.AttnImpl.REFERENCE, False),
             ("flash", tc.AttnImpl.FLASH, False)]
    if col.axis_size(mesh, "data") > 1:
        forms.append(("seq_shard", tc.AttnImpl.REFERENCE, True))
    for name, impl, seq_shard in forms:
        par = tc.ParallelConfig(seq_shard=seq_shard)
        batch = sh.local(prompt, mesh, sh.batch_specs(arch, pshape, mesh,
                                                      par))[0]
        step = serve.make_prefill_step(arch, pshape, impl=impl,
                                       device="cpu", compute_dtype=F32,
                                       mesh=mesh, parallel=par)
        logits, cache = step(params, batch)
        out[f"{case}/{name}/copies_identical"] = copies_identical(
            cache, mesh, cspecs)
        # copies: decode then writes the cache in place
        whole = tree_map(torch.clone, _whole(cache, mesh, cspecs))
        out[f"{case}/{name}/logits"] = logits.numpy()
        _flat(whole, f"{case}/{name}/cache", out)
        if name == "reference":
            kept = cache
    token = _rank_batch({"t": _t(inputs[f"{case}/dtoken"])}, mesh,
                        ("data",))["t"]
    step = serve.make_decode_step(arch, device="cpu", compute_dtype=F32,
                                  mesh=mesh, batch=PREFILL_BATCH)
    toks, cache = [], kept
    for _ in range(DECODE_STEPS):
        token, cache = step(params, cache, token)
        toks.append(sh.unlocal(token, mesh, sh.P("data", None)))
    out[f"{case}/decode/tokens"] = torch.stack(toks).numpy()
    out[f"{case}/decode/copies_identical"] = copies_identical(cache, mesh,
                                                              cspecs)
    _flat(_whole(cache, mesh, cspecs), f"{case}/decode/cache", out)
    return out


# ---------------------------------------------------------------------------
# training on (data 2, model 4): ZeRO-1 and FSDP, and the mutant
# ---------------------------------------------------------------------------

def _batches(inputs: dict, prefix: str) -> list:
    keys = [k for k in ("tokens", "labels", "loss_mask", "patch_embeds",
                        "frame_embeds") if f"{prefix}/0/{k}" in inputs]
    return [{k: inputs[f"{prefix}/{i}/{k}"] for k in keys}
            for i in range(TRAIN_STEPS)]


def _train_parts(case: str, mode: str):
    fsdp, remat = TRAIN_MODES[mode]
    par = tc.ParallelConfig(fsdp=fsdp, zero1=True, remat=remat,
                            optimizer="adamw")
    return case_arch(tc, case), shapes(tc)[2], par, \
        tc.TrainConfig(**TRAIN_CFG)


def train_case(rank: int, case: str, mesh, inputs: dict) -> dict:
    """Each of the case's ``TRAIN_CASES`` modes: ``TRAIN_STEPS`` steps
    from the same init, the metrics, the first step's gradients and the
    state after (rank 0 reports)."""
    out = {}
    for mode in TRAIN_CASES[case]:
        arch, shape, par, cfg = _train_parts(case, mode)
        got, _, _ = _steps(rank == 0, mesh, arch, shape, par, cfg,
                           tc.EnokiConfig(),
                           _init_state(inputs, f"{case}/init"),
                           _batches(inputs, f"{case}/batch"),
                           f"{case}/{mode}", TRAIN_STEPS)
        out.update(got)
    return out


def sliced_group_gather(rank: int, mesh, inputs: dict) -> dict:
    """The mutant: the KV group's gather of ``wk``/``wv`` with its
    cotangent sliced to the rank's columns (``all_gather_dim``) instead of
    reduce-scattered over the group: the first step's gradients."""
    real = col.gather_param
    col.gather_param = col.all_gather_dim
    try:
        arch, shape, par, cfg = _train_parts(MUTANT_CASE, "zero1")
        got, _, _ = _steps(rank == 0, mesh, arch, shape, par, cfg,
                           tc.EnokiConfig(),
                           _init_state(inputs, f"{MUTANT_CASE}/init"),
                           _batches(inputs, f"{MUTANT_CASE}/batch")[:1],
                           "mutant", 1)
    finally:
        col.gather_param = real
    return {k: v for k, v in got.items() if k.startswith("mutant/grads")}


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------

def serve_world(rank: int, path: str) -> dict:
    """A world of 4 ranks: every case on (data 1, model 4)."""
    inputs = dict(np.load(path))
    mesh = make_test_mesh((1, MODEL), ("data", "model"))
    out = {}
    for case in CASES:
        out.update(serve_case(case, mesh, inputs))
    return out if rank == 0 else {}


def data_world(rank: int, path: str) -> dict:
    """A world of 8 ranks on (data 2, model 4): every case's serving, its
    ``seq_shard`` prefill and its training, then the mutant."""
    inputs = dict(np.load(path))
    mesh = make_test_mesh((2, MODEL), ("data", "model"))
    out = {}
    for case in CASES:
        out.update(serve_case(case, mesh, inputs))
        out.update(train_case(rank, case, mesh, inputs))
    out.update(sliced_group_gather(rank, mesh, inputs))
    return out if rank == 0 else {}


# ---------------------------------------------------------------------------
# on the card (tests/test_torch_cuda.py, two ranks sharing it)
# ---------------------------------------------------------------------------

CARD_LAYERS, CARD_SEQ, CARD_BATCH, CARD_DECODE = 2, 256, 2, 2
CARD_TOL = 5e-2               # the reference's prefill/decode bound (bf16)


def card_kv_forms(rank: int) -> dict:
    """internlm2-1.8b at full width with one KV head, depth 2, bf16, on
    (data 1, model 2): rep 2, both ranks hold the head.  The FLASH prefill
    (the CUDA kernel on each rank's 8 query heads and the group's head)
    and ``CARD_DECODE`` greedy steps, against the unsharded runs on the
    card fed the ranks' tokens: logits and the caches gathered from the
    group's leader; the group's copies of the cache."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.mesh import make_mesh_compat, world_device
    from repro_torch.models import model_zoo as zoo
    dev = world_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    arch = dataclasses.replace(tc.get_arch("internlm2-1.8b"),
                               num_layers=CARD_LAYERS, num_kv_heads=1)
    mesh = make_mesh_compat((1, 2), ("data", "model"))
    full = zoo.init_params(arch, seed=0, dtype=torch.bfloat16, device=dev)
    pspecs = sh.param_partition_specs(full, arch, mesh,
                                      tc.ParallelConfig(fsdp=False))
    params = sh.local(full, mesh, pspecs)[0]
    gen = torch.Generator(device=dev).manual_seed(3)
    tokens = torch.randint(0, arch.vocab_size, (CARD_BATCH, CARD_SEQ),
                           generator=gen, device=dev, dtype=torch.int32)
    shape = tc.ShapeConfig("card", CARD_SEQ, CARD_BATCH, tc.StepKind.PREFILL)
    step = serve.make_prefill_step(arch, shape, impl=tc.AttnImpl.FLASH,
                                   device=dev, mesh=mesh)
    n0 = fk.flash_attention_bhsd.launches
    logits, cache = step(params, {"tokens": tokens})
    torch.cuda.synchronize()
    out = {"rep": kv_split(arch, 2)[1],
           "flash_launches": fk.flash_attention_bhsd.launches - n0,
           "give_ups": fk.check_give_ups()}
    cspecs = serve.session_cache_specs(arch, mesh, CARD_BATCH)
    out["copies_identical"] = copies_identical(cache, mesh, cspecs)
    plain = serve.make_prefill_step(arch, shape, impl=tc.AttnImpl.FLASH,
                                    device=dev)
    logits0, cache0 = plain(full, {"tokens": tokens})
    rel = lambda a, b: float((a.float() - b.float()).abs().max()
                             / b.float().abs().max())
    whole = _whole(cache, mesh, cspecs)
    out["prefill_rel"] = rel(logits, logits0)
    out["cache_rel"] = max(rel(whole[k], cache0[k]) for k in ("k", "v"))
    room = CARD_SEQ + CARD_DECODE
    dc = zoo.init_cache(arch, CARD_BATCH, room, device=dev, mesh=mesh)
    dc0 = zoo.init_cache(arch, CARD_BATCH, room, device=dev)
    for d, c in ((dc, cache), (dc0, cache0)):
        for k in ("k", "v"):
            d[k][:, :, :CARD_SEQ].copy_(c[k])
        d["length"].copy_(c["length"])
    dstep = serve.make_decode_step(arch, device=dev, mesh=mesh,
                                   batch=CARD_BATCH)
    token = torch.argmax(logits[:, -1, :], -1)[:, None].to(torch.int32)
    differ = 0
    for _ in range(CARD_DECODE):
        lg0, dc0 = zoo.decode_step(arch, full, dc0, token)
        token, dc = dstep(params, dc, token)
        differ += int((torch.argmax(lg0[:, -1, :], -1)[:, None].to(
            torch.int32) != token).sum())
    whole = _whole(dc, mesh, cspecs)
    out["decode_cache_rel"] = max(rel(whole[k], dc0[k]) for k in ("k", "v"))
    out["decode_copies_identical"] = copies_identical(dc, mesh, cspecs)
    out["decode_tokens_differing"] = differ
    return out
