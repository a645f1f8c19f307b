"""Rank bodies of ``tests/test_torch_tensor_parallel_families.py``: what each
rank of a gloo world on the CPU runs for the moe (grok-1, kimi-k2) and vlm
(phi-3-vision) families.  Spawned children import this module by name, so
it imports neither jax nor the reference (nor pytest); inputs arrive as
numpy arrays and results leave as numpy arrays.  The helpers are
``torch_tp_ranks``' (the dense family's bodies).  Everything computes in
f32.
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
from repro_torch.models import moe as moe_mod
from repro_torch.parallel import collectives as col
from repro_torch.parallel import sharding as sh
from torch_tp_ranks import (F32, _flat, _init_state, _rank_batch, _remesh,
                            _steps, _t, _tree, _whole)

FAMILY_ARCHS = ("grok-1-314b", "kimi-k2-1t-a32b", "phi-3-vision-4.2b")
#: the reduced configs with head counts that model = 4 divides, the GQA
#: ratio kept (6:1 and 8:1); grok-1 with 6 experts, so model = 4 takes its
#: experts column/row on d_expert (6 % 4 != 0) and model = 2 by expert;
#: kimi-k2's 4 layers put its shared expert on the layer dim at model 2
#: and 4 (the reference's rule)
FAMILY_CHANGES = {
    "grok-1-314b": {"num_heads": 24, "num_kv_heads": 4, "head_dim": 32,
                    "moe": {"num_experts": 6}},
    "kimi-k2-1t-a32b": {"num_heads": 32, "num_kv_heads": 4, "head_dim": 32},
    "phi-3-vision-4.2b": {}}
#: the training config of an arch: kimi-k2 at 3 layers, whose shared
#: expert then runs column/row (3 % 2 != 0)
TRAIN_LAYERS = {"kimi-k2-1t-a32b": 3}
MOE_IMPLS = ("auto", "ep")
#: the archs each serving mesh runs: (data 1, model 4) only grok-1, whose
#: experts go column/row there (kimi-k2 and the vlm split there as at
#: model 2)
SERVE_ARCHS = {(2, 2): FAMILY_ARCHS, (1, 4): ("grok-1-314b",)}
PREFILL_BATCH, PREFILL_SEQ = 4, 32
DECODE_BATCH, DECODE_SEQ, DECODE_LENGTH, DECODE_STEPS = 4, 32, 13, 3
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 32, 2
TRAIN_CFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)
#: name -> (optimizer, fsdp, remat) of the (data 2, model 2) train modes,
#: and the modes each arch trains in: Adafactor FSDP for the moe family
#: (the reference's choice above 200 B parameters), AdamW ZeRO-1 for the
#: vlm
TRAIN_MODES = {"adamw_zero1": ("adamw", False, "block"),
               "adafactor_fsdp": ("adafactor", True, "full")}
TRAIN_CASES = {"grok-1-314b": ("adafactor_fsdp",),
               "kimi-k2-1t-a32b": ("adafactor_fsdp",),
               "phi-3-vision-4.2b": ("adamw_zero1",)}
#: the layer cases: 4 x 64 tokens, data shard 1's pushed toward expert 0
LAYER_B, LAYER_S = 4, 64
POD_ARCH = "kimi-k2-1t-a32b"
POD_SESSIONS = 2


def family_arch(configs, arch_id: str, train_config: bool = False):
    """The test config of ``arch_id`` from either package's configs."""
    arch = configs.reduced(configs.get_arch(arch_id))
    changes = dict(FAMILY_CHANGES[arch_id])
    if "moe" in changes:
        changes["moe"] = dataclasses.replace(arch.moe, **changes["moe"])
    if train_config and arch_id in TRAIN_LAYERS:
        changes["num_layers"] = TRAIN_LAYERS[arch_id]
    return dataclasses.replace(arch, **changes)


def shapes(configs):
    """(prefill, decode, train) shapes from either package's configs."""
    r = configs.reduced_shape
    by = configs.SHAPES_BY_NAME
    return (dataclasses.replace(r(by["prefill_32k"]), seq_len=PREFILL_SEQ,
                                global_batch=PREFILL_BATCH),
            dataclasses.replace(r(by["decode_32k"]), seq_len=DECODE_SEQ,
                                global_batch=DECODE_BATCH),
            dataclasses.replace(r(by["train_4k"]), seq_len=TRAIN_SEQ,
                                global_batch=TRAIN_BATCH))


def _batch(inputs: dict, prefix: str, keys, mesh, axes) -> dict:
    """The rank's shard over ``axes`` of the batch ``keys`` under
    ``prefix`` (every leaf cut on its first dim)."""
    batch = {k: _t(inputs[f"{prefix}/{k}"]) for k in keys
             if f"{prefix}/{k}" in inputs}
    entry = None if not axes else (axes[0] if len(axes) == 1 else
                                   tuple(axes))
    return sh.local(batch, mesh, {k: sh.P(entry, *([None] * (v.ndim - 1)))
                                  for k, v in batch.items()})[0]


def _routes_margin(calls: list) -> callable:
    """Wrap ``moe.route`` to record each call's smallest top-k margin (the
    k-th probability less the next): a margin at f32 rounding is a route
    the two packages may break apart."""
    inner = moe_mod.route

    def route(router_w, x, cfg, *args, **kwargs):
        probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
        top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
        calls.append(float((top[:, -2] - top[:, -1]).min()))
        return inner(router_w, x, cfg, *args, **kwargs)
    return route


# ---------------------------------------------------------------------------
# prefill and decode on (data, model), and the layer cases
# ---------------------------------------------------------------------------

def serve_world(rank: int, mesh_shape: tuple, inputs: dict) -> dict:
    """Each arch of ``SERVE_ARCHS``' prefill (REFERENCE under "auto" and
    "ep", FLASH under "auto": the plain kernel on the CPU) and
    ``DECODE_STEPS`` greedy steps on a (data, model) mesh; on (data 2,
    model 2) the layer cases too."""
    mesh = make_test_mesh(mesh_shape, ("data", "model"))
    pshape, _, _ = shapes(tc)
    out = {}
    margins: list = []
    moe_mod.route = _routes_margin(margins)
    for arch_id in SERVE_ARCHS[mesh_shape]:
        arch = family_arch(tc, arch_id)
        full = _tree(inputs, f"{arch_id}/params")
        pspecs = sh.param_partition_specs(tree_map(_t, full), arch, mesh,
                                          tc.ParallelConfig(fsdp=False))
        params = params_to_rank(arch, full, mesh, pspecs, device="cpu")
        batch = _batch(inputs, f"{arch_id}/prompt",
                       ("tokens", "patch_embeds"), mesh, ("data",))
        cspecs = serve.session_cache_specs(arch, mesh, PREFILL_BATCH)
        impls = MOE_IMPLS if arch.family == "moe" else ("auto",)
        runs = [(tc.AttnImpl.REFERENCE, m) for m in impls] + \
            [(tc.AttnImpl.FLASH, "auto")]
        for impl, moe_impl in runs:
            step = serve.make_prefill_step(arch, pshape, impl=impl,
                                           device="cpu", compute_dtype=F32,
                                           mesh=mesh, moe_impl=moe_impl)
            logits, cache = step(params, batch)
            whole = _whole(cache, mesh, cspecs)
            tag = f"{arch_id}/prefill/{impl.value}/{moe_impl}"
            if rank == 0:
                out[f"{tag}/logits"] = logits.numpy()
                _flat(whole, f"{tag}/cache", out)
        cache_full = tree_map(_t, _tree(inputs, f"{arch_id}/dcache"))
        dspecs = serve.session_cache_specs(arch, mesh, DECODE_BATCH)
        cache = sh.local(cache_full, mesh, dspecs)[0]
        token = _rank_batch({"t": _t(inputs[f"{arch_id}/dtoken"])}, mesh,
                            ("data",))["t"]
        step = serve.make_decode_step(arch, device="cpu", compute_dtype=F32,
                                      mesh=mesh, batch=DECODE_BATCH)
        toks = []
        for _ in range(DECODE_STEPS):
            token, cache = step(params, cache, token)
            toks.append(sh.unlocal(token, mesh, sh.P("data", None)))
        whole = _whole(cache, mesh, dspecs)
        if rank == 0:
            out[f"{arch_id}/decode/tokens"] = torch.stack(toks).numpy()
            _flat(whole, f"{arch_id}/decode/cache", out)
    out["route/min_margin"] = min(margins)
    if mesh_shape == (2, 2):
        out.update(layer_cases(rank, mesh, inputs))
    return out if rank == 0 else {k: v for k, v in out.items()
                                  if k.endswith("equal")
                                  or k.startswith("patches/")}


def layer_cases(rank: int, mesh, inputs: dict) -> dict:
    """The moe layer on (data 2, model 2) under "auto" and "ep", data
    shard 1's tokens pushed toward expert 0 so that its bucket overflows
    the global capacity (128) but not a data shard's; the aux beside the
    mean of the ranks' own auxes; the vlm's ``rank_batch``."""
    arch = family_arch(tc, "kimi-k2-1t-a32b")
    m, d = col.axis_index(mesh, "model"), col.axis_index(mesh, "data")
    full = tree_map(_t, _tree(inputs, "layer/params"))
    e_local = arch.moe.num_experts // 2
    params = {k: (v[m * e_local:(m + 1) * e_local] if k in
                  ("w_gate", "w_up", "w_down") else v)
              for k, v in full.items()}
    x = _t(inputs["layer/x"])
    x_l = x.chunk(2)[d]
    out = {}
    for impl in MOE_IMPLS:
        y, aux = moe_mod.moe_apply_tp(params, x_l, arch, mesh, ("data",),
                                      impl)
        y = sh.unlocal(y, mesh, sh.P("data", None, None))
        out[f"layer/{impl}/y"] = y.numpy()
        out[f"layer/{impl}/aux"] = float(aux)
        # the whole batch on every data rank (a batch that data does not
        # divide): "auto" dispatches it alone, "ep" cuts it over data
        y, aux = moe_mod.moe_apply_tp(params, x, arch, mesh, (), impl)
        out[f"layer/{impl}/replicated_y"] = y.detach().numpy()
        out[f"layer/{impl}/replicated_aux"] = float(aux)
    own = moe_mod.route(params["router"], x_l.reshape(-1, x.shape[-1]),
                        arch.moe)[2] * arch.moe.aux_loss_weight
    out["layer/mean_of_auxes"] = float(col.psum(own, mesh, "data")) / 2

    # the vlm's patch columns: each model rank projects its d / model
    # columns, all_gather_dim makes them whole (a naive port would put the
    # rank's columns, or a sum, in front of the text)
    pe = _t(inputs["phi-3-vision-4.2b/prompt/patch_embeds"])
    proj = _t(inputs["phi-3-vision-4.2b/params/patch_proj"])
    cols = proj.shape[1] // 2
    mine = pe @ proj[:, m * cols:(m + 1) * cols]
    out["patches/err"] = float((col.all_gather_dim(mine, mesh, "model", -1)
                                - pe @ proj).abs().max())
    out["patches/rank_cols_err"] = float((mine - (pe @ proj)[..., :cols])
                                         .abs().max())

    from repro_torch.data import rank_batch, synthetic_batch
    varch = family_arch(tc, "phi-3-vision-4.2b")
    tshape = shapes(tc)[2]
    got = rank_batch(varch, tshape, 3, 1, mesh, device="cpu")
    want = synthetic_batch(varch, tshape, 3, 1, shard=d, num_shards=2,
                           device="cpu")
    out["rank_batch/keys"] = sorted(got)
    out["rank_batch/equal"] = all(torch.equal(got[k], want[k])
                                  for k in want)
    return out


# ---------------------------------------------------------------------------
# training on (data 2, model 2): AdamW ZeRO-1 and Adafactor FSDP
# ---------------------------------------------------------------------------

def _train_parts(arch_id: str, optimizer: str, fsdp: bool, remat: str):
    arch = family_arch(tc, arch_id, train_config=True)
    par = tc.ParallelConfig(fsdp=fsdp, zero1=True, remat=remat,
                            optimizer=optimizer)
    return arch, shapes(tc)[2], par, tc.TrainConfig(**TRAIN_CFG)


def train_world(rank: int, inputs: dict) -> dict:
    mesh = make_test_mesh((2, 2), ("data", "model"))
    out = {}
    for arch_id in FAMILY_ARCHS:
        for name in TRAIN_CASES[arch_id]:
            arch, shape, par, cfg = _train_parts(arch_id,
                                                 *TRAIN_MODES[name])
            keys = ("tokens", "labels", "loss_mask", "patch_embeds")
            batches = [{k: inputs[f"{arch_id}/batch/{i}/{k}"] for k in keys
                        if f"{arch_id}/batch/{i}/{k}" in inputs}
                       for i in range(TRAIN_STEPS)]
            got, _, _ = _steps(rank == 0, mesh, arch, shape, par, cfg,
                               tc.EnokiConfig(),
                               _init_state(inputs, f"{arch_id}/init/"
                                           f"{par.optimizer}"),
                               batches, f"{arch_id}/{name}", TRAIN_STEPS)
            out.update(got)
    return out


def four_ranks(rank: int, meshes, inputs: dict) -> dict:
    """One world of 4 ranks for the serving meshes and the training (a
    spawn a world costs more than the bodies): ``{"serve": {mesh shape:
    serve_world's}, "train": train_world's}``."""
    return {"serve": {ms: serve_world(rank, ms, inputs) for ms in meshes},
            "train": train_world(rank, inputs)}


# ---------------------------------------------------------------------------
# (pod 2, data 2, model 2): the policies, replication, remesh, sessions
# ---------------------------------------------------------------------------

def pods_world(rank: int, inputs: dict) -> dict:
    """kimi-k2 with Adafactor (the reference's optimiser for the family):
    REPLICATED (each pod its own batch), CLOUD_CENTRAL (the batch and the
    moe dispatch over ("pod", "data")) and PEER_FETCH (every leaf and
    factor also over ``pod``); the anti-entropy round; the REPLICATED state
    re-meshed onto pod 0; sessions decoded on each pod's ranks."""
    from repro_torch.optim import diloco_init
    mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
    pod = col.axis_index(mesh, "pod")
    arch = family_arch(tc, POD_ARCH)
    shape = shapes(tc)[2]
    par = tc.ParallelConfig(fsdp=False, zero1=True, remat="none",
                            optimizer="adafactor")
    cfg = tc.TrainConfig(**TRAIN_CFG)
    R = tc.ReplicationPolicy
    init = _init_state(inputs, "pods/init")
    keys = ("tokens", "labels", "loss_mask")
    out = {}

    def batches(policy):
        if policy == R.REPLICATED:      # the pod's own batch (P, b, ...)
            return [{k: inputs[f"pods/batch/{i}/{k}"][pod] for k in keys}
                    for i in range(TRAIN_STEPS)]
        return [{k: inputs[f"pods/batch/{i}/{k}"].reshape(
            (-1,) + inputs[f"pods/batch/{i}/{k}"].shape[2:]) for k in keys}
            for i in range(TRAIN_STEPS)]

    report = rank in (0, 4)             # each pod's first rank
    got, state, step = _steps(report, mesh, arch, shape, par, cfg,
                              tc.EnokiConfig(policy=R.REPLICATED), init,
                              batches(R.REPLICATED), f"pods/replicated{pod}",
                              TRAIN_STEPS)
    out.update(got)
    out.update(_remesh(rank, mesh, state, step.specs))
    pspecs = step.specs["params"]
    ospecs = {"outer_params": pspecs, "momentum": pspecs, "round": sh.P()}
    mine = tree_map(lambda a: _t(a)[pod], _tree(inputs, "pods/rstate"))
    enoki = tc.EnokiConfig(policy=R.REPLICATED, compress_deltas=True)
    rstep, _ = train.make_replicate_step(arch, 2, par, enoki, device="cpu",
                                         mesh=mesh)
    s2 = {"params": sh.local(mine, mesh, pspecs)[0]}
    outer = sh.local(diloco_init(tree_map(_t, init["params"])), mesh,
                     ospecs)[0]
    s2, o2 = rstep(s2, outer)
    p_whole = _whole(s2["params"], mesh, pspecs)
    o_whole = _whole(o2, mesh, ospecs)
    if report:
        _flat(p_whole, f"pods/replicate/params{pod}", out)
        _flat(o_whole, f"pods/replicate/outer{pod}", out)

    for name, policy in (("central", R.CLOUD_CENTRAL),
                         ("peer", R.PEER_FETCH)):
        got, _, _ = _steps(rank == 0, mesh, arch, shape, par, cfg,
                           tc.EnokiConfig(policy=policy), init,
                           batches(policy), f"pods/{name}", TRAIN_STEPS)
        if rank == 0:
            out.update(got)

    # sessions on (pod, data, model): each pod's 2 sessions on its ranks
    full = _tree(inputs, "pods/sess/params")
    sspecs = sh.param_partition_specs(tree_map(_t, full), arch, mesh,
                                      tc.ParallelConfig(fsdp=False))
    params = params_to_rank(arch, full, mesh, sspecs, device="cpu")
    cspecs = serve.session_cache_specs(arch, mesh, POD_SESSIONS)
    cache_full = tree_map(lambda a: _t(a)[pod], _tree(inputs,
                                                      "pods/sess/cache"))
    cache = sh.local(cache_full, mesh, cspecs)[0]
    token = _rank_batch({"t": _t(inputs["pods/sess/token"])[pod]}, mesh,
                        ("data",))["t"]
    dstep = serve.make_decode_step(arch, device="cpu", compute_dtype=F32,
                                   mesh=mesh, batch=POD_SESSIONS)
    toks = []
    for _ in range(DECODE_STEPS):
        token, cache = dstep(params, cache, token)
        toks.append(sh.unlocal(token, mesh, sh.P("data", None)))
    backup = serve.make_replicate_sessions_step(device="cpu", mesh=mesh)(cache)
    whole = {"cache": _whole(cache, mesh, cspecs),
             "backup": _whole(backup, mesh, cspecs)}
    if report:
        out[f"pods/sess/tokens{pod}"] = torch.stack(toks).numpy()
        for name, tree in whole.items():
            _flat(tree, f"pods/sess/{name}{pod}", out)
    return out if report else {k: v for k, v in out.items()
                               if k.startswith("remesh/")}


# ---------------------------------------------------------------------------
# on the card (tests/test_torch_cuda.py, two ranks sharing it)
# ---------------------------------------------------------------------------

CARD_BATCH = 2
CARD_TOL = 5e-2               # the reference's prefill/decode bound (bf16)
#: (arch, layers, mesh, seq): a moe prefill by experts on (data 1, model
#: 2), the vlm's on (data 2, model 1) past its 576 patch positions
CARD_CASES = (("grok-1-314b", 1, (1, 2), 256),
              ("phi-3-vision-4.2b", 2, (2, 1), 1024))


def card_family_forms(rank: int) -> dict:
    """At full width, bf16, FLASH: grok-1's prefill (1 layer; 4 experts, 24
    query and 4 KV heads a rank) on (data 1, model 2) and phi-3-vision's
    (2 layers, 576 patch positions in front of the text, one prompt a
    rank) on (data 2, model 1), each against the unsharded prefill on the
    card; flash launches a rank and give-ups."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.mesh import make_mesh_compat, world_device
    from repro_torch.models import model_zoo as zoo
    dev = world_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for arch_id, layers, ms, seq in CARD_CASES:
        arch = dataclasses.replace(tc.get_arch(arch_id), num_layers=layers)
        mesh = make_mesh_compat(ms, ("data", "model"))
        full = zoo.init_params(arch, seed=0, dtype=torch.bfloat16, device=dev)
        pspecs = sh.param_partition_specs(full, arch, mesh,
                                          tc.ParallelConfig(fsdp=False))
        params = sh.local(full, mesh, pspecs)[0]
        shape = tc.ShapeConfig("card", seq, CARD_BATCH, tc.StepKind.PREFILL)
        gen = torch.Generator(device=dev).manual_seed(3)
        batch = zoo.example_batch(arch, shape, gen)
        mine = sh.local(batch, mesh, {
            k: sh.P("data" if ms[0] > 1 else None, *([None] * (v.ndim - 1)))
            for k, v in batch.items()})[0]
        step = serve.make_prefill_step(arch, shape, impl=tc.AttnImpl.FLASH,
                                       device=dev, mesh=mesh)
        n0 = fk.flash_attention_bhsd.launches
        logits, _ = step(params, mine)
        torch.cuda.synchronize()
        out[f"{arch_id}/flash_launches"] = fk.flash_attention_bhsd.launches \
            - n0
        out[f"{arch_id}/layers"] = layers
        out[f"{arch_id}/give_ups"] = fk.check_give_ups()
        del params
        plain = serve.make_prefill_step(arch, shape, impl=tc.AttnImpl.FLASH,
                                        device=dev)
        logits0, _ = plain(full, batch)
        out[f"{arch_id}/prefill_rel"] = float(
            (logits.float() - logits0.float()).abs().max()
            / logits0.float().abs().max())
        del full, logits0
        torch.cuda.empty_cache()
    return out
