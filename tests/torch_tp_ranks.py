"""Rank bodies of ``tests/test_torch_tensor_parallel.py``: what each rank of
a gloo world on the CPU runs.  Spawned children import this module by
name, so it imports neither jax nor the reference (nor pytest); inputs
arrive as numpy arrays and results leave as numpy arrays.

Every body runs after ``launch.mesh.init_world(..., device="cpu")``, takes
full trees (the reference's weights, batches and caches, carried across
as numpy), cuts its shards with ``parallel.sharding.local`` and returns
what it computed gathered back (``sharding.unlocal``) from rank 0, plus a
few flags every rank reports.  Everything computes in f32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import configs as tc
from repro_torch.core.carry import params_to_rank, to_numpy, \
    train_state_to_rank
from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import model_zoo as zoo
from repro_torch.parallel import collectives as col
from repro_torch.parallel import sharding as sh

F32 = torch.float32
TP_ARCHS = ("internlm2-1.8b", "gemma-7b", "qwen1.5-110b")
#: the reduced configs with head counts that model = 4 divides (the
#: reduced qwen1.5 has one KV head), the GQA ratio kept where it fits, at
#: a head dim the flash kernel takes
TP_CHANGES = {"internlm2-1.8b": {"num_heads": 8, "num_kv_heads": 4,
                                 "head_dim": 32},
              "gemma-7b": {},
              "qwen1.5-110b": {"num_heads": 16, "num_kv_heads": 4,
                               "head_dim": 32}}
PREFILL_BATCH, PREFILL_SEQ = 4, 32
DECODE_BATCH, DECODE_SEQ, DECODE_LENGTH, DECODE_STEPS = 4, 32, 13, 3
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 32, 2
TRAIN_CFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)
#: (name, fsdp, remat) of the (data 2, model 2) train cases
TRAIN_MODES = (("zero1", False, "block"), ("fsdp", True, "full"))
POD_STEPS = 20               # tests/test_pod_replication.py's loop


def tp_arch(configs, arch_id: str):
    """The TP test config of ``arch_id`` from either package's configs."""
    return dataclasses.replace(configs.reduced(configs.get_arch(arch_id)),
                               **TP_CHANGES[arch_id])


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


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _tree(d: dict, prefix: str) -> dict:
    """Nested dict of tensors from flat ``prefix/a/b`` numpy keys."""
    out: dict = {}
    for key, v in d.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, last = key[len(prefix) + 1:].split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return out


def _flat(tree, prefix: str, out: dict) -> dict:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}/{k}", out)
    else:
        out[prefix] = to_numpy(tree)
    return out


def _whole(tree, mesh, specs):
    """The full tensors of a tree of this rank's shards."""
    return sh._zip_specs(lambda x, s: sh.unlocal(x, mesh, s), tree, specs)


def _batch_spec(axes) -> sh.P:
    entry = None if not axes else (axes[0] if len(axes) == 1 else
                                   tuple(axes))
    return sh.P(entry, None)


def _rank_batch(batch: dict, mesh, axes) -> dict:
    spec = _batch_spec(axes)
    return sh.local(batch, mesh, {k: spec for k in batch})[0]


# ---------------------------------------------------------------------------
# prefill and decode on (data, model)
# ---------------------------------------------------------------------------

def serve_world(rank: int, mesh_shape: tuple, inputs: dict) -> dict:
    """Every TP arch's prefill (REFERENCE and FLASH: the plain kernel on
    the CPU) and ``DECODE_STEPS`` greedy steps on a (data, model) mesh."""
    mesh = make_test_mesh(mesh_shape, ("data", "model"))
    pshape, dshape, _ = shapes(tc)
    out = {}
    for arch_id in TP_ARCHS:
        arch = tp_arch(tc, arch_id)
        full = _tree(inputs, f"{arch_id}/params")
        pspecs = sh.param_partition_specs(tree_map(_t, full), arch, mesh,
                                          tc.ParallelConfig(fsdp=False))
        params = params_to_rank(arch, full, mesh, pspecs, device="cpu")
        tokens = _rank_batch({"tokens": _t(inputs[f"{arch_id}/tokens"])},
                             mesh, ("data",))
        cspecs = serve.session_cache_specs(arch, mesh, PREFILL_BATCH)
        for impl in (tc.AttnImpl.REFERENCE, tc.AttnImpl.FLASH):
            step = serve.make_prefill_step(arch, pshape, impl=impl,
                                           device="cpu", compute_dtype=F32,
                                           mesh=mesh)
            logits, cache = step(params, tokens)
            whole = _whole(cache, mesh, cspecs)
            if rank == 0:
                out[f"{arch_id}/prefill/{impl.value}/logits"] = \
                    logits.numpy()
                _flat(whole, f"{arch_id}/prefill/{impl.value}/cache", out)

        cache_full = tree_map(_t, _tree(inputs, f"{arch_id}/dcache"))
        dspecs = serve.session_cache_specs(arch, mesh, DECODE_BATCH)
        cache = sh.local(cache_full, mesh, dspecs)[0]
        token = _rank_batch({"t": _t(inputs[f"{arch_id}/dtoken"])}, mesh,
                            ("data",))["t"]
        step = serve.make_decode_step(arch, device="cpu", compute_dtype=F32,
                                      mesh=mesh)
        toks = []
        for _ in range(DECODE_STEPS):
            token, cache = step(params, cache, token)
            toks.append(sh.unlocal(token, mesh, sh.P("data", None)))
        whole = _whole(cache, mesh, dspecs)
        if rank == 0:
            out[f"{arch_id}/decode/tokens"] = torch.stack(toks).numpy()
            _flat(whole, f"{arch_id}/decode/cache", out)
    if mesh_shape == (2, 2):
        out.update(reductions(rank, mesh, inputs))
    return out


def reductions(rank: int, mesh, inputs: dict) -> dict:
    """The six sharded reductions on a (data 2, model 2) mesh, each held
    against the unsharded form on the same numbers (rank 0 reports; each
    check is a number a naive port gets wrong)."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import cross_entropy_loss
    from repro_torch.optim.adamw import global_norm
    from repro_torch.optim.compression import int8_compress
    out = {}
    m, d = col.axis_index(mesh, "model"), col.axis_index(mesh, "data")
    arch = tp_arch(tc, "internlm2-1.8b")
    table = _t(inputs["red/embed"])                      # (V, D)
    tokens = _t(inputs["red/tokens"]).long()             # (B, S)
    v_l = table.shape[0] // 2
    x = transformer._embed(arch, {"embed": table[m * v_l:(m + 1) * v_l]},
                           tokens, F32, mesh)
    x0 = transformer._embed(arch, {"embed": table}, tokens, F32)
    out["embed/err"] = float((x - x0).abs().max())

    logits = _t(inputs["red/logits"])                    # (B, S, V)
    labels, mask = _t(inputs["red/labels"]), _t(inputs["red/mask"])
    b_l = logits.shape[0] // 2
    rows = slice(d * b_l, (d + 1) * b_l)
    mine = logits[rows, :, m * v_l:(m + 1) * v_l]
    ce = cross_entropy_loss(mine, labels[rows], mask[rows], mesh=mesh,
                            vocab_axis="model", batch_axes=("data",))
    out["ce/got"] = float(ce)
    out["ce/want"] = float(cross_entropy_loss(logits, labels, mask))
    out["ce/mean_of_means"] = float(sum(
        cross_entropy_loss(logits[i * b_l:(i + 1) * b_l],
                           labels[i * b_l:(i + 1) * b_l],
                           mask[i * b_l:(i + 1) * b_l]) for i in range(2)) / 2)

    # the norm: w sharded on model (cols), b replicated, e on data and model
    w, b, e = (_t(inputs[f"red/{k}"]) for k in ("w", "b", "e"))
    tree = {"w": w, "b": b, "e": e}
    specs = {"w": sh.P(None, "model"), "b": sh.P(None), "e":
             sh.P("data", "model")}
    shards, axes = sh.local(tree, mesh, specs)
    out["norm/got"] = float(global_norm(shards, mesh,
                                        [axes[k] for k in sorted(axes)]))
    out["norm/want"] = float(global_norm(tree))
    q = int8_compress(shards["e"], mesh, axes["e"])
    q0 = int8_compress(e)
    out["int8/scale"], out["int8/scale_whole"] = float(q.scale), \
        float(q0.scale)
    out["int8/q_equal"] = bool(torch.equal(
        q.q, sh.local(q0.q, mesh, sh.P("data", "model"))[0]))

    tie = _t(inputs["red/tie"])                          # (B, V)
    tok = serve.greedy_sharded(tie[:, m * v_l:(m + 1) * v_l], mesh)
    out["argmax/got"] = tok[:, 0].numpy()

    from repro_torch.data import rank_batch, synthetic_batch
    tshape = shapes(tc)[2]
    got = rank_batch(arch, tshape, 3, 1, mesh, device="cpu")
    want = synthetic_batch(arch, tshape, 3, 1, shard=d, num_shards=2,
                           device="cpu")
    flags = {"embed/err": out["embed/err"], "rank_batch/equal": all(
        torch.equal(got[k], want[k]) for k in want)}
    return {**out, **flags} if rank == 0 else flags


# ---------------------------------------------------------------------------
# training on (data 2, model 2): ZeRO-1 and FSDP
# ---------------------------------------------------------------------------

def _train_parts(arch_id: str, fsdp: bool, remat: str):
    arch = tp_arch(tc, arch_id)
    par = tc.ParallelConfig(fsdp=fsdp, zero1=True, remat=remat,
                            optimizer="adamw")
    return arch, shapes(tc)[2], par, tc.TrainConfig(**TRAIN_CFG)


def _init_state(inputs: dict, prefix: str) -> dict:
    return {"params": _tree(inputs, f"{prefix}/params"),
            "opt": _tree(inputs, f"{prefix}/opt"),
            "step": inputs[f"{prefix}/step"]}


def _steps(report, mesh, arch, shape, par, cfg, enoki, init, batches, prefix,
           n_steps):
    """``n_steps`` of ``make_train_step`` on ``mesh`` from ``init`` (full
    numpy): every step's metrics and, where ``report``, the gradients at
    the first step and the whole state after the last."""
    step, _ = train.make_train_step(arch, shape, parallel=par, enoki=enoki,
                                    cfg=cfg, device="cpu", compute_dtype=F32,
                                    mesh=mesh)
    state = train_state_to_rank(arch, init, mesh, step.specs, device="cpu")
    out = {}
    for i in range(n_steps):
        batch = _rank_batch({k: _t(v) for k, v in batches[i].items()}, mesh,
                            step.batch_axes)
        if i == 0:
            grads = step.grads(state["params"], batch)
            whole = _whole(grads, mesh, step.specs["params"])
            if report:
                _flat(whole, f"{prefix}/grads", out)
        state, m = step(state, batch)
        out[f"{prefix}/metrics/{i}"] = {k: float(v) for k, v in m.items()}
    whole = _whole(state, mesh, step.specs)
    if report:
        _flat(whole, f"{prefix}/state", out)
    return out, state, step


def train_world(rank: int, inputs: dict) -> dict:
    mesh = make_test_mesh((2, 2), ("data", "model"))
    out = {}
    for arch_id in TP_ARCHS:
        for name, fsdp, remat in TRAIN_MODES:
            arch, shape, par, cfg = _train_parts(arch_id, fsdp, remat)
            batches = [{k: inputs[f"{arch_id}/batch/{i}/{k}"] for k in
                        ("tokens", "labels", "loss_mask")}
                       for i in range(TRAIN_STEPS)]
            got, _, _ = _steps(rank == 0, mesh, arch, shape, par, cfg,
                               tc.EnokiConfig(),
                               _init_state(inputs, f"{arch_id}/init"),
                               batches, f"{arch_id}/{name}", TRAIN_STEPS)
            out.update(got)
    return out


# ---------------------------------------------------------------------------
# (pod 2, data 2, model 2): the policies, replication, sessions
# ---------------------------------------------------------------------------

def pods_world(rank: int, inputs: dict) -> dict:
    from repro_torch.optim import diloco_init
    mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
    pod = col.axis_index(mesh, "pod")
    arch, shape, par, cfg = _train_parts("internlm2-1.8b", False, "none")
    R = tc.ReplicationPolicy
    init = _init_state(inputs, "pods/init")
    out = {}

    def batches(policy):
        keys = ("tokens", "labels", "loss_mask")
        if policy == R.REPLICATED:      # the pod's own batch (P, b, ...)
            return [{k: inputs[f"pods/batch/{i}/{k}"][pod] for k in keys}
                    for i in range(TRAIN_STEPS)]
        return [{k: inputs[f"pods/batch/{i}/{k}"].reshape(
            (-1,) + inputs[f"pods/batch/{i}/{k}"].shape[2:]) for k in keys}
            for i in range(TRAIN_STEPS)]

    # each pod's first rank (ranks 0 and 4) reports its pod's state
    report = rank in (0, 4)
    got, state, step = _steps(report, mesh, arch, shape, par, cfg,
                              tc.EnokiConfig(policy=R.REPLICATED), init,
                              batches(R.REPLICATED), f"pods/replicated{pod}",
                              TRAIN_STEPS)
    out.update(got)
    out.update(_remesh(rank, mesh, state, step.specs))
    # the anti-entropy round on the same pod states in both packages
    pspecs = step.specs["params"]
    ospecs = {"outer_params": pspecs, "momentum": pspecs, "round": sh.P()}
    mine = tree_map(lambda a: _t(a)[pod], _tree(inputs, "pods/rstate"))
    for c in (0, 1):
        enoki = tc.EnokiConfig(policy=R.REPLICATED, compress_deltas=bool(c))
        rstep, _ = train.make_replicate_step(arch, 2, par, enoki,
                                             device="cpu", mesh=mesh)
        s2 = {"params": sh.local(mine, mesh, pspecs)[0]}
        outer = sh.local(diloco_init(tree_map(_t, init["params"])), mesh,
                         ospecs)[0]
        s2, o2 = rstep(s2, outer)
        p_whole = _whole(s2["params"], mesh, pspecs)
        o_whole = _whole(o2, mesh, ospecs)
        if report:
            _flat(p_whole, f"pods/replicate{c}/params{pod}", out)
            _flat(o_whole, f"pods/replicate{c}/outer{pod}", out)

    for name, policy in (("central", R.CLOUD_CENTRAL),
                         ("peer", R.PEER_FETCH)):
        got, _, _ = _steps(rank == 0, mesh, arch, shape, par, cfg,
                           tc.EnokiConfig(policy=policy), init,
                           batches(policy), f"pods/{name}", TRAIN_STEPS)
        if rank == 0:
            out.update(got)

    # sessions on (pod, data, model): decode, replicate, migrate
    sarch = arch
    full = _tree(inputs, "pods/sess/params")
    sspecs = sh.param_partition_specs(tree_map(_t, full), sarch, mesh,
                                      tc.ParallelConfig(fsdp=False))
    params = params_to_rank(sarch, full, mesh, sspecs, device="cpu")
    cspecs = serve.session_cache_specs(sarch, mesh, 2)
    cache_full = tree_map(lambda a: _t(a)[pod], _tree(inputs,
                                                      "pods/sess/cache"))
    cache = sh.local(cache_full, mesh, cspecs)[0]
    token = _rank_batch({"t": _t(inputs["pods/sess/token"])[pod]}, mesh,
                        ("data",))["t"]
    dstep = serve.make_decode_step(sarch, device="cpu", compute_dtype=F32,
                                   mesh=mesh)
    toks = []
    for _ in range(DECODE_STEPS):
        token, cache = dstep(params, cache, token)
        toks.append(sh.unlocal(token, mesh, sh.P("data", None)))
    backup = serve.make_replicate_sessions_step(device="cpu", mesh=mesh)(cache)
    restored = serve.make_migrate_sessions_step(device="cpu", mesh=mesh)(
        cache, backup, torch.tensor([True, False]))
    for name, tree in (("cache", cache), ("backup", backup),
                       ("restored", restored)):
        whole = _whole(tree, mesh, cspecs)
        if report:
            _flat(whole, f"pods/sess/{name}{pod}", out)
    if report:
        out[f"pods/sess/tokens{pod}"] = torch.stack(toks).numpy()
    out.update(pod_replication_twin(rank, mesh, inputs))
    return out


def _remesh(rank: int, mesh, state: dict, specs: dict) -> dict:
    """Pod 1 lost: pod 0's tensor-parallel ZeRO-1 state (plain shards)
    re-meshed onto (data 2, model 2) over pod 0's ranks equals pod 0's
    whole state cut there; pod 1's ranks get None leaves."""
    from repro_torch.runtime.elastic import (degraded_mesh_config, make_mesh,
                                             remesh)
    full_cfg = tc.MeshConfig(shape=(2, 2, 2), axes=("pod", "data", "model"))
    degraded = degraded_mesh_config(full_cfg, alive_pods=1)
    new_mesh = make_mesh(degraded, parent=mesh)
    whole = _whole(state, mesh, specs)
    moved = remesh(state, specs, new_mesh, old_mesh=mesh)
    out = {"remesh/degraded": (degraded.shape, degraded.axes)}
    if new_mesh.get_coordinate() is None:
        out["remesh/outside_none"] = all(
            x is None for x in tree_flatten(moved)[0])
        return out
    want = sh.local(whole, new_mesh, specs)[0]
    out["remesh/equal"] = all(torch.equal(a, b) for a, b in zip(
        tree_flatten(moved)[0], tree_flatten(want)[0]))
    return out


def pod_replication_twin(rank: int, mesh, inputs: dict) -> dict:
    """``tests/test_pod_replication.py``'s SCRIPT on the port's (pod 2,
    data 2, model 2) ranks: pods diverge, converge after a round, the loss
    trends down over rounds every 2 steps, sessions fail over."""
    from repro_torch.optim import diloco_init
    arch = tc.reduced(tc.get_arch("internlm2-1.8b"))
    shape = tc.reduced_shape(tc.SHAPES_BY_NAME["train_4k"])
    R = tc.ReplicationPolicy
    enoki = tc.EnokiConfig(policy=R.REPLICATED, replication_period=2)
    par = tc.ParallelConfig(fsdp=False, remat="none", optimizer="adamw")
    step, _ = train.make_train_step(arch, shape, parallel=par, enoki=enoki,
                                    cfg=tc.TrainConfig(lr=1e-3),
                                    device="cpu", compute_dtype=F32,
                                    mesh=mesh)
    pod = col.axis_index(mesh, "pod")
    single = train.init_state(arch, 0, par, device="cpu")
    state = sh.local(single, mesh, step.specs)[0]
    rstep, _ = train.make_replicate_step(arch, 2, par, enoki, device="cpu",
                                         mesh=mesh)
    pspecs = step.specs["params"]
    outer = diloco_init(single["params"])
    outer = sh.local(outer, mesh, {"outer_params": pspecs,
                                   "momentum": pspecs, "round": sh.P()})[0]
    from repro_torch.data import synthetic_batch

    def batch(i):      # pod p's batch is shard p of 2 (batch_override=4)
        b = synthetic_batch(arch, shape, 0, i, shard=pod, num_shards=2,
                            batch_override=4, device="cpu")
        return _rank_batch(b, mesh, step.batch_axes)
    first = tree_flatten(state["params"])[0][0]
    for i in range(2):
        state, _ = step(state, batch(i))
    both = col.all_gather(first, mesh, "pod")
    out = {"twin/divergence": float((both[0] - both[1]).abs().max())}
    state, outer = rstep(state, outer)
    both = col.all_gather(first, mesh, "pod")
    out["twin/convergence"] = float((both[0] - both[1]).abs().max())
    losses = []
    for i in range(2, POD_STEPS):
        state, m = step(state, batch(i))
        losses.append(float(m["loss"]))
        if i % 2:
            state, outer = rstep(state, outer)
    out["twin/losses"] = losses
    return out if rank == 0 else {}


# ---------------------------------------------------------------------------
# on the card (tests/test_torch_cuda.py, two ranks sharing it)
# ---------------------------------------------------------------------------

CARD_LAYERS, CARD_SEQ, CARD_BATCH = 2, 256, 2
CARD_TOL = 5e-2               # the reference's prefill/decode bound (bf16)


def card_tp_forms(rank: int) -> dict:
    """internlm2-1.8b at full width, depth 2, bf16: the FLASH prefill on
    (data 1, model 2) (the CUDA kernel on each rank's 8 query and 4 KV
    heads) against the unsharded prefill on the card; one ZeRO-1 step
    (f32 params, bf16 compute) on (data 2, model 1) against the unsharded
    step on the card."""
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.mesh import make_mesh_compat, world_device
    dev = world_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    arch = dataclasses.replace(tc.get_arch("internlm2-1.8b"),
                               num_layers=CARD_LAYERS)
    out = {}
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
    out["flash_launches"] = fk.flash_attention_bhsd.launches - n0
    out["give_ups"] = fk.check_give_ups()
    cspecs = serve.session_cache_specs(arch, mesh, CARD_BATCH)
    whole = _whole(cache, mesh, cspecs)
    plain = serve.make_prefill_step(arch, shape, impl=tc.AttnImpl.FLASH,
                                    device=dev)
    logits0, cache0 = plain(full, {"tokens": tokens})
    rel = lambda a, b: float((a.float() - b.float()).abs().max()
                             / b.float().abs().max())
    out["prefill_rel"] = rel(logits, logits0)
    out["cache_rel"] = max(rel(whole[k], cache0[k]) for k in ("k", "v"))
    del full, params, cache, whole, cache0

    mesh = make_mesh_compat((2, 1), ("data", "model"))
    tshape = tc.ShapeConfig("card", CARD_SEQ, CARD_BATCH, tc.StepKind.TRAIN)
    par = tc.ParallelConfig(zero1=True, fsdp=False, remat="block")
    cfg = tc.TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    tstep, _ = train.make_train_step(arch, tshape, parallel=par, cfg=cfg,
                                     device=dev, mesh=mesh)
    state0 = train.init_state(arch, 0, par, device=dev)
    state = sh.local(state0, mesh, tstep.specs)[0]
    parts = [synthetic_batch(arch, tshape, 0, 0, shard=s, num_shards=2,
                             device=dev) for s in range(2)]
    state, m = tstep(state, parts[rank])
    got = _whole(state["params"], mesh, tstep.specs["params"])
    ustep, _ = train.make_train_step(arch, tshape, parallel=par, cfg=cfg,
                                     device=dev)
    batch = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    state0, m0 = ustep(state0, batch)
    out["loss_rel"] = abs(float(m["loss"]) - float(m0["loss"])) / \
        abs(float(m0["loss"]))
    out["params_diff"] = max(float((a - b).abs().max()) for a, b in zip(
        tree_flatten(got)[0], tree_flatten(state0["params"])[0]))
    out["lr"] = cfg.lr
    return out
