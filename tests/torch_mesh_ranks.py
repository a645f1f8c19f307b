"""Rank bodies of ``tests/test_torch_mesh.py``: what each rank of a gloo
world on the CPU runs.  Spawned children import this module by name, so
it imports neither jax nor the reference (nor pytest); inputs arrive as
numpy arrays and results leave as numpy arrays.

Each body runs after ``launch.mesh.init_world(..., device="cpu")`` (see
``launch.mesh.spawn_world``) and returns a dict of numpy arrays and
Python values.  Where a rank form is held against the port's stacked or
unsharded form bit for bit, the twin runs in the same rank process (the
same single thread), so the comparison never depends on how many threads
a CPU product used.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import configs as tc
from repro_torch.core import replication as rep
from repro_torch.core.carry import to_numpy, train_state_from_numpy
from repro_torch.core.keygroup import TensorKeygroup
from repro_torch.core.store import Store
from repro_torch.core.tree import tree_map
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.parallel import collectives as col
from repro_torch.parallel import sharding as sh

ARENA = ("keys", "values", "lengths", "versions", "vv")
FD_LENGTHS = (5, 17)         # S=32 over model=2: shard 1 wholly masked at 5
EP_CAPS = (128, 1)           # cap_multiple: no drops, then drops


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


# ---------------------------------------------------------------------------
# flash-decode and expert-parallel MoE on a (data 2, model 2) mesh
# ---------------------------------------------------------------------------

def decode_and_ep(rank: int, inputs: dict) -> dict:
    mesh = make_test_mesh((2, 2), ("data", "model"))
    c = col.axis_index(mesh, "model")
    out = {}
    arch = tc.reduced(tc.get_arch("qwen1.5-110b"))
    ap = tree_map(_t, _tree(inputs, "fd/params"))
    x1 = _t(inputs["fd/x1"])
    for n in FD_LENGTHS:
        length = torch.tensor(n, dtype=torch.int32)
        ck, cv = _t(inputs["fd/ck"]), _t(inputs["fd/cv"])
        s_local = ck.shape[1] // 2
        ck_l = ck[:, c * s_local:(c + 1) * s_local].clone()
        cv_l = cv[:, c * s_local:(c + 1) * s_local].clone()
        y, ck_l, cv_l = attn.decode_self_attention_sharded(
            ap, x1, ck_l, cv_l, length, arch, mesh)
        y0, k0, v0 = attn.decode_self_attention(ap, x1, ck.clone(),
                                                cv.clone(), length, arch)
        gathered = [torch.cat(col.all_gather(t, mesh, "model").unbind(0), 1)
                    for t in (ck_l, cv_l)]
        out[f"fd/{n}/y"] = y.numpy()
        out[f"fd/{n}/y_plain"] = y0.numpy()
        out[f"fd/{n}/caches_equal"] = bool(torch.equal(gathered[0], k0)
                                           and torch.equal(gathered[1], v0))

    karch = tc.reduced(tc.get_arch("kimi-k2-1t-a32b"))
    full = tree_map(_t, _tree(inputs, "ep/params"))
    e_local = karch.moe.num_experts // 2
    lo = c * e_local
    x = _t(inputs["ep/x"])
    for cap in EP_CAPS:
        params = {k: (v[lo:lo + e_local].clone() if k in
                      ("w_gate", "w_up", "w_down") else v)
                  for k, v in full.items()}
        if cap == EP_CAPS[0]:
            params = tree_map(lambda p: p.detach().requires_grad_(), params)
        y, aux = moe_mod.moe_apply_ep(params, x, karch, mesh,
                                      cap_multiple=cap)
        out[f"ep/{cap}/y"] = y.detach().numpy()
        out[f"ep/{cap}/aux"] = float(aux)
        if cap == EP_CAPS[0]:
            y.sum().backward()
            _flat(tree_map(lambda p: p.grad, params), "ep/grad", out)
            out["ep/lo"] = lo
    out.update(_model_paths(rank, mesh, c))
    return out


def _model_paths(rank: int, mesh, c: int) -> dict:
    """``forward_seq(mesh, moe_impl="ep")`` on the rank's shards of
    reduced kimi-k2 (the reference's specs; 2 KV heads, which model = 2
    splits) against the unsharded "auto" run, and against "auto" on the
    same mesh (the fallback when the tokens do not divide over ``data``);
    and the flash-decode ``make_decode_step`` against the plain one,
    f32."""
    import dataclasses

    from repro_torch.models import model_zoo as zoo
    out = {}
    f32 = torch.float32
    karch = dataclasses.replace(tc.reduced(tc.get_arch("kimi-k2-1t-a32b")),
                                num_kv_heads=2)
    params = zoo.init_params(karch, seed=4, device="cpu")
    specs = sh.param_partition_specs(params, karch, mesh,
                                     tc.ParallelConfig(fsdp=False))
    local = sh.local(params, mesh, specs)[0]
    v_local = karch.vocab_size // 2
    gen = torch.Generator().manual_seed(5)
    for B, S in ((2, 8), (1, 7)):           # 7 tokens: no split over data
        tokens = torch.randint(0, karch.vocab_size, (B, S), generator=gen)
        want, aux0, _ = zoo.forward_seq(karch, params, tokens,
                                        compute_dtype=f32)
        got, aux, _ = zoo.forward_seq(karch, local, tokens, mesh=mesh,
                                      moe_impl="ep", compute_dtype=f32)
        auto, _, _ = zoo.forward_seq(karch, local, tokens, mesh=mesh,
                                     compute_dtype=f32)
        want = want[..., c * v_local:(c + 1) * v_local]
        out[f"fwd/{B}x{S}/err"] = float((got - want).abs().max())
        out[f"fwd/{B}x{S}/aux_diff"] = abs(float(aux) - float(aux0))
        out[f"fwd/{B}x{S}/equal"] = bool(torch.equal(got, auto))

    qarch = tc.reduced(tc.get_arch("qwen1.5-110b"))
    qparams = zoo.init_params(qarch, seed=6, device="cpu")
    B, S = 2, 32
    full = zoo.init_cache(qarch, B, S, dtype=f32, device="cpu")
    for name in ("k", "v"):
        full[name].normal_(generator=gen)
    full["length"].fill_(13)
    half = slice(c * S // 2, (c + 1) * S // 2)
    mine = {"k": full["k"][:, :, half].clone(),
            "v": full["v"][:, :, half].clone(),
            "length": full["length"].clone()}
    token = torch.randint(0, qarch.vocab_size, (B, 1), generator=gen,
                          dtype=torch.int32)
    plain = serve.make_decode_step(qarch, 1, device="cpu", compute_dtype=f32)
    sharded = serve.make_decode_step(qarch, device="cpu", compute_dtype=f32,
                                     mesh=mesh, flash_decode=True)
    stacked = {k: v[None] for k, v in full.items()}
    t1, t2 = token, token[None]
    same = True
    for _ in range(3):                      # positions 13..15, in shard 0
        t1, mine = sharded(qparams, mine, t1)
        t2, stacked = plain(qparams, stacked, t2)
        same &= bool(torch.equal(t1, t2[0]))
    # layer 0's new rows are the same arithmetic on the same input; later
    # layers see the partial softmax's last bits in their input
    same &= all(torch.equal(mine[k][0], stacked[k][0][0][:, half])
                for k in ("k", "v"))
    same &= int(mine["length"]) == int(stacked["length"][0]) == 16
    out["fd_step/equal"] = same
    out["fd_step/cache_err"] = max(
        float((mine[k] - stacked[k][0][:, :, half]).abs().max())
        for k in ("k", "v"))
    return out


# ---------------------------------------------------------------------------
# replicate_pod_axis, pods one a rank (P = 4 on the world, P = 2 on ranks
# 0 and 1)
# ---------------------------------------------------------------------------

def _replica(kind: str, stacked: dict, i: int):
    if kind in ("aligned", "unaligned"):
        return Store(*(_t(stacked[f][i]) for f in ARENA))
    return TensorKeygroup({"w": _t(stacked["w"][i]), "b": _t(stacked["b"][i])},
                          _t(stacked["version"][i]), kind)


def _stack_port(kind: str, stacked: dict):
    if kind in ("aligned", "unaligned"):
        return Store(*(_t(stacked[f]) for f in ARENA))
    return TensorKeygroup({"w": _t(stacked["w"]), "b": _t(stacked["b"])},
                          _t(stacked["version"]), kind)


def _replica_np(kind: str, x) -> dict:
    if kind in ("aligned", "unaligned"):
        return {f: t.numpy() for f, t in zip(ARENA, x)}
    return {"w": x.tree["w"].numpy(), "b": x.tree["b"].numpy(),
            "version": x.version.numpy()}


MERGES = {"aligned": rep.merge_arena_aligned, "unaligned": rep.merge_arena,
          "lww": rep.merge_tensor, "mean": rep.merge_tensor,
          "max": rep.merge_tensor}


def pod_replicate(rank: int, cases: dict) -> dict:
    """``cases``: {"kind:topology:pods": stacked numpy replicas}.  Each
    rank returns its replica after one round, and (rank 0) the stacked
    form's round on the same replicas."""
    from torch.distributed.device_mesh import DeviceMesh
    meshes = {4: make_test_mesh((4,), ("pod",)),
              2: DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("pod",))}
    out = {}
    for case, stacked in cases.items():
        kind, topology, pods = case.split(":")
        pods = int(pods)
        mesh = meshes[pods]
        if mesh.get_coordinate() is None:
            continue
        mine = _replica(kind, stacked, rank)
        step = rep.make_pod_replicate_step(MERGES[kind], pods, topology,
                                           device="cpu", mesh=mesh)
        got = step(mine)
        out[case] = {"got": _replica_np(kind, got),
                     "input_kept": _replica_np(kind, mine)}
        if rank == 0:
            whole = rep.replicate_pod_axis(_stack_port(kind, stacked),
                                           MERGES[kind], pods, topology)
            out[case]["stacked"] = _replica_np(kind, whole)
    return out


# ---------------------------------------------------------------------------
# remesh: (pod 2, data 2, model 2) -> one pod
# ---------------------------------------------------------------------------

def remesh_world(rank: int, state: dict, spec_entries: dict,
                 params: dict) -> dict:
    from repro_torch.runtime.elastic import (degraded_mesh_config, make_mesh,
                                             remesh)
    full_cfg = tc.MeshConfig(shape=(2, 2, 2), axes=("pod", "data", "model"))
    mesh = make_mesh(full_cfg)
    specs = {k: sh.P(*v) for k, v in spec_entries.items()}
    tensors = {k: _t(v) for k, v in state.items()}
    placed = sh.place(tensors, mesh, specs)
    arch = tc.reduced(tc.get_arch("internlm2-1.8b"))
    ptree = tree_map(_t, params)
    pspecs = sh.param_partition_specs(ptree, arch, mesh,
                                      tc.ParallelConfig(fsdp=True))
    pplaced = sh.place(ptree, mesh, pspecs)

    degraded = degraded_mesh_config(full_cfg, alive_pods=1)
    new_mesh = make_mesh(degraded, parent=mesh)
    moved = remesh(placed, specs, new_mesh)
    pmoved = remesh(pplaced, pspecs, new_mesh)
    out = {"degraded": (degraded.shape, degraded.axes),
           "in_new_mesh": new_mesh.get_coordinate() is not None,
           "local_w": placed["w"].to_local().numpy()}
    if out["in_new_mesh"]:
        out["moved"] = {k: sh.gather(v).numpy() for k, v in moved.items()}
        out["moved_placements"] = {k: str(v.placements)
                                   for k, v in moved.items()}
        same = tree_map(lambda a, b: bool(torch.equal(sh.gather(a), b)),
                        pmoved, ptree)
        out["params_equal"] = all(_leaves_of(same))
    else:
        out["moved"] = moved
    return out


def _leaves_of(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves_of(v)]
    return [tree]


# ---------------------------------------------------------------------------
# the pod-mesh train, replicate and session steps, one pod a rank
# ---------------------------------------------------------------------------

TRAIN_ARCH = "internlm2-1.8b"


def _train_parts():
    arch = tc.reduced(tc.get_arch(TRAIN_ARCH))
    shape = tc.reduced_shape(tc.SHAPES_BY_NAME["train_4k"])
    par = tc.ParallelConfig(fsdp=False, remat="none", optimizer="adamw")
    return arch, shape, par, tc.TrainConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=10)


def _batch(batches: dict, name: str, i: int, pod=None) -> dict:
    keys = ("tokens", "labels", "loss_mask")
    b = {k: _t(batches[f"{name}/{i}/{k}"]) for k in keys}
    return b if pod is None else {k: v[pod] for k, v in b.items()}


def pods_train_and_sessions(rank: int, init: dict, batches: dict,
                            sess: dict) -> dict:
    from repro_torch.optim import diloco_init
    mesh = make_test_mesh((2,), ("pod",))
    arch, shape, par, cfg = _train_parts()
    f32 = torch.float32
    R = tc.ReplicationPolicy
    out = {}

    def fresh():
        tree = {k: v for k, v in init.items()}
        return train_state_from_numpy(arch, tree, device="cpu")

    # REPLICATED: each rank its pod, 2 steps, then one round (int8 off/on)
    step, _ = train.make_train_step(arch, shape, parallel=par,
                                    enoki=tc.EnokiConfig(policy=R.REPLICATED),
                                    cfg=cfg, device="cpu", compute_dtype=f32,
                                    mesh=mesh)
    state = fresh()
    for i in range(2):
        state, m = step(state, _batch(batches, "pods", i, rank))
        out[f"pods/metrics/{i}"] = {k: float(v) for k, v in m.items()}
    _flat(state, "pods/state", out)
    outer0 = diloco_init(fresh()["params"])
    for c in (0, 1):
        enoki = tc.EnokiConfig(policy=R.REPLICATED, compress_deltas=bool(c))
        rstep, _ = train.make_replicate_step(arch, 2, par, enoki,
                                             device="cpu", mesh=mesh)
        s2 = {"params": tree_map(torch.clone, state["params"])}
        s2, o2 = rstep(s2, tree_map(torch.clone, outer0))
        _flat(s2["params"], f"replicate{c}/params", out)
        _flat(o2, f"replicate{c}/outer", out)

    # CLOUD_CENTRAL over the pod mesh: gradients averaged over pod
    cstep, _ = train.make_train_step(
        arch, shape, parallel=par, enoki=tc.EnokiConfig(policy=R.CLOUD_CENTRAL),
        cfg=cfg, device="cpu", compute_dtype=f32, mesh=mesh)
    cstate = fresh()
    for i in range(2):
        cstate, m = cstep(cstate, _batch(batches, "pods", i, rank))
        out[f"central/metrics/{i}"] = {k: float(v) for k, v in m.items()}
    _flat(cstate, "central/state", out)

    # sessions: f32 decode, one pod a rank, then replicate and migrate
    params = tree_map(_t, _tree(sess, "params"))
    cache = tree_map(lambda a: _t(a)[rank], _tree(sess, "cache"))
    token = _t(sess["token"])[rank]
    dstep = serve.make_decode_step(arch, device="cpu", compute_dtype=f32,
                                   mesh=mesh)
    toks = []
    for _ in range(3):
        token, cache = dstep(params, cache, token)
        toks.append(token.numpy())
    backup = serve.make_replicate_sessions_step(device="cpu", mesh=mesh)(cache)
    dead = torch.tensor([True, False])
    restored = serve.make_migrate_sessions_step(device="cpu", mesh=mesh)(
        cache, backup, dead)
    out["sess/tokens"] = np.stack(toks)
    _flat(cache, "sess/cache", out)
    _flat(backup, "sess/backup", out)
    _flat(restored, "sess/restored", out)

    if rank == 0:           # the stacked forms, in this same process
        out["stacked"] = _stacked_twin(init, batches, sess, arch, shape, par,
                                       cfg)
    return out


def _stacked_twin(init, batches, sess, arch, shape, par, cfg) -> dict:
    from repro_torch.optim import diloco_init
    f32 = torch.float32
    R = tc.ReplicationPolicy
    out = {}
    single = train_state_from_numpy(arch, dict(init), device="cpu")
    state = tree_map(lambda l: torch.stack([l, l]), single)
    step, _ = train.make_train_step(arch, shape, 2, par,
                                    tc.EnokiConfig(policy=R.REPLICATED), cfg,
                                    device="cpu", compute_dtype=f32)
    for i in range(2):
        state, _ = step(state, _batch(batches, "pods", i))
    _flat(state, "pods/state", out)
    for c in (0, 1):
        enoki = tc.EnokiConfig(policy=R.REPLICATED, compress_deltas=bool(c))
        rstep, _ = train.make_replicate_step(arch, 2, par, enoki,
                                             device="cpu")
        s2 = {"params": tree_map(torch.clone, state["params"])}
        s2, o2 = rstep(s2, diloco_init(single["params"]))
        _flat(s2["params"], f"replicate{c}/params", out)
        _flat(o2, f"replicate{c}/outer", out)
    params = tree_map(_t, _tree(sess, "params"))
    cache = tree_map(_t, _tree(sess, "cache"))
    token = _t(sess["token"])
    dstep = serve.make_decode_step(arch, 2, device="cpu", compute_dtype=f32)
    toks = []
    for _ in range(3):
        token, cache = dstep(params, cache, token)
        toks.append(token.numpy())
    backup = serve.make_replicate_sessions_step(device="cpu")(cache)
    restored = serve.make_migrate_sessions_step(device="cpu")(
        cache, backup, torch.tensor([True, False]))
    out["sess/tokens"] = np.stack(toks)
    _flat(cache, "sess/cache", out)
    _flat(backup, "sess/backup", out)
    _flat(restored, "sess/restored", out)
    return out


# ---------------------------------------------------------------------------
# what a world refuses
# ---------------------------------------------------------------------------

def wrong_size(rank: int):
    """A (3,) mesh on a world of 2: the ``ValueError``'s text."""
    try:
        make_test_mesh((3,), ("pod",))
    except ValueError as e:
        return str(e)
    return None


def fail_on_one(rank: int):
    if rank == 1:
        raise ValueError("rank body failed")
    return rank


# ---------------------------------------------------------------------------
# the rank forms on the card (tests/test_torch_cuda.py, two ranks sharing
# it)
# ---------------------------------------------------------------------------

S_ARENA, V_ARENA, N_VV = 8, 6, 4


def pod_replicas(kind: str, pods: int, seed: int) -> dict:
    """``pods`` replicas of one kind stacked as numpy arrays: arenas
    (keys from one layout when aligned, drawn slots otherwise) or tensor
    keygroups; versions in 0..3, so ties are common."""
    rng = np.random.default_rng(seed)
    reps = []
    layout = (1000 + np.arange(S_ARENA)).astype(np.int32)
    layout[rng.integers(0, S_ARENA)] = 0
    pool = (2000 + np.arange(3 * S_ARENA)).astype(np.int32)
    for _ in range(pods):
        if kind in ("aligned", "unaligned"):
            if kind == "aligned":
                keys = layout.copy()
            else:
                keys = np.zeros(S_ARENA, np.int32)
                live = rng.choice(S_ARENA, size=S_ARENA - 2, replace=False)
                keys[live] = rng.choice(pool, size=S_ARENA - 2, replace=False)
            reps.append({
                "keys": keys,
                "values": rng.normal(size=(S_ARENA, V_ARENA)).astype(
                    np.float32),
                "lengths": rng.integers(-1, V_ARENA, S_ARENA).astype(np.int32),
                "versions": rng.integers(0, 4, S_ARENA).astype(np.int32),
                "vv": rng.integers(0, 50, N_VV).astype(np.int32)})
        else:
            reps.append({"w": rng.normal(size=(3, 4)).astype(np.float32),
                         "b": rng.normal(size=(5,)).astype(np.float32),
                         "version": np.int32(rng.integers(0, 4))})
    return {f: np.stack([r[f] for r in reps]) for f in reps[0]}


def card_rank_forms(rank: int) -> dict:
    """On the card: pod replication (aligned arenas, the merge kernel)
    against the plain stacked form on the CPU; flash decode and
    expert-parallel MoE (f32, reduced) against the unsharded forms on the
    card; the pod-mesh decode step against the stacked one on the card."""
    from repro_torch.kernels.enoki_merge.kernel import enoki_merge_rows
    from repro_torch.launch.mesh import make_mesh_compat, world_device
    from repro_torch.models import model_zoo as zoo
    dev = world_device()
    pod = make_mesh_compat((2,), ("pod",))
    dm = make_mesh_compat((1, 2), ("data", "model"))
    out = {}
    stacked = pod_replicas("aligned", 2, seed=5)
    for topo in rep.TOPOLOGIES:
        mine = Store(*(_t(stacked[f][rank]).to(dev) for f in ARENA))
        n0 = enoki_merge_rows.launches
        got = rep.make_pod_replicate_step(rep.merge_arena_aligned, 2, topo,
                                          device=dev, mesh=pod)(mine)
        torch.cuda.synchronize()
        out[f"pod/{topo}/launches"] = enoki_merge_rows.launches - n0
        want = rep.replicate_pod_axis(_stack_port("aligned", stacked),
                                      rep.merge_arena_aligned, 2, topo)
        out[f"pod/{topo}/equal"] = all(torch.equal(g.cpu(), w[rank])
                                       for g, w in zip(got, want))

    gen = torch.Generator(device=dev).manual_seed(7)
    arch = tc.reduced(tc.get_arch("qwen1.5-110b"))
    ap = attn.attn_init(gen, arch)
    B, S, KV, D = 2, 64, arch.num_kv_heads, arch.resolved_head_dim
    x1 = torch.randn((B, 1, arch.d_model), generator=gen, device=dev)
    ck = torch.randn((B, S, KV, D), generator=gen, device=dev)
    cv = torch.randn((B, S, KV, D), generator=gen, device=dev)
    for n in (20, 40):                     # shard 1 wholly masked at 20
        length = torch.tensor(n, dtype=torch.int32, device=dev)
        half = slice(rank * S // 2, (rank + 1) * S // 2)
        y, k_l, v_l = attn.decode_self_attention_sharded(
            ap, x1, ck[:, half].clone(), cv[:, half].clone(), length, arch,
            dm)
        y0, k0, v0 = attn.decode_self_attention(ap, x1, ck.clone(),
                                                cv.clone(), length, arch)
        out[f"fd/{n}/err"] = float((y - y0).abs().max())
        out[f"fd/{n}/caches_equal"] = bool(torch.equal(k_l, k0[:, half])
                                           and torch.equal(v_l, v0[:, half]))

    karch = tc.reduced(tc.get_arch("kimi-k2-1t-a32b"))
    full = moe_mod.moe_init(gen, karch)
    e_local = karch.moe.num_experts // 2
    mine = {k: (v[rank * e_local:(rank + 1) * e_local] if k in
                ("w_gate", "w_up", "w_down") else v) for k, v in full.items()}
    x = torch.randn((4, 16, karch.d_model), generator=gen, device=dev) * 0.5
    y, aux = moe_mod.moe_apply_ep(mine, x, karch, dm)
    y0, aux0 = moe_mod.moe_apply(full, x, karch)
    out["ep/err"] = float((y - y0).abs().max())
    out["ep/aux_diff"] = abs(float(aux) - float(aux0))

    darch = tc.reduced(tc.get_arch("internlm2-1.8b"))
    params = zoo.init_params(darch, seed=0, dtype=torch.bfloat16, device=dev)
    caches = [zoo.init_cache(darch, 2, 32, device=dev) for _ in range(2)]
    tokens = [torch.full((2, 1), 3 + p, dtype=torch.int32, device=dev)
              for p in range(2)]
    both = {k: torch.stack([c[k] for c in caches]) for k in caches[0]}
    tok2 = torch.stack(tokens)
    cache, token = caches[rank], tokens[rank]
    step = serve.make_decode_step(darch, device=dev, mesh=pod)
    step2 = serve.make_decode_step(darch, 2, device=dev)
    same = True
    for _ in range(3):
        token, cache = step(params, cache, token)
        tok2, both = step2(params, both, tok2)
        same &= bool(torch.equal(token, tok2[rank]))
    backup = serve.make_replicate_sessions_step(device=dev, mesh=pod)(cache)
    backup2 = serve.make_replicate_sessions_step(device=dev)(both)
    same &= all(torch.equal(backup[k], backup2[k][rank]) for k in cache)
    same &= all(torch.equal(cache[k], both[k][rank]) for k in cache)
    out["sess/equal"] = same
    return out
