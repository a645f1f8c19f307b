"""The port's tensor-parallel steps of the moe (grok-1, kimi-k2) and vlm
(phi-3-vision) families on gloo worlds of CPU ranks, against the
reference's jitted steps on the same meshes of forced host devices.

ONE reference subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=8``)
runs, in f32 compute, the family configs of the reduced archs
(``torch_tp_family_ranks.FAMILY_CHANGES``: head counts that model = 4
divides; grok-1 with 6 experts, so model = 4 takes them column/row on
d_expert while model = 2 takes them by expert; kimi-k2's shared expert on
its layer dim) through ``make_prefill_step`` under ``moe_impl`` "auto" and
"ep" and ``make_decode_step`` on (data 2, model 2) (every arch) and (data
1, model 4) (grok-1, whose experts go column/row there), ``make_train_step``
on (data 2, model 2) with Adafactor FSDP (remat "full": grok-1, and
kimi-k2 at 3 layers, whose shared expert then goes column/row) and AdamW
ZeRO-1 (remat "block": phi-3-vision), and kimi-k2's Adafactor REPLICATED,
CLOUD_CENTRAL and PEER_FETCH steps, the int8 anti-entropy round and the
session steps on (pod 2, data 2, model 2); also the moe layer alone under
"auto" and "ep" where a bucket overflows.  It starts first and runs while
the port's worlds run (rank bodies in ``tests/torch_tp_family_ranks.py``),
on the same numpy inputs: its serving and training on disjoint halves of
its 8 devices at once (two threads), then the pods on all 8; one world of
4 ranks takes both serving meshes and the training, one of 8 the pods.
Bounds, as for the dense family
(``tests/test_torch_tensor_parallel.py``):

* prefill logits within 1e-4 of the reference's largest (REFERENCE under
  both forms, FLASH under "auto": the kernel's plain version on the CPU);
  caches within 1e-5; decode: greedy tokens equal, caches within 1e-5;
* train: loss and ce within 1e-5 relative at each step, ``grad_norm``
  within 1e-5 relative, the first step's gradients within 1e-4 of each
  leaf's max-abs; the state after 2 steps: AdamW's within the dense
  family's bounds; Adafactor's factors within 1e-4 of the leaf's max-abs,
  its params within twice the reference's whole move of the leaf and,
  where the first gradient is above 1e-3 of its leaf's max-abs, within
  1e-4 of the leaf's max-abs (Adafactor's update divides by its factored
  second moment, so a near-zero gradient's rounding moves as far as a
  large one's);
* the layer: output within 1e-4 of the max, aux within 1e-6; "auto"
  drops data shard 1's overflow (the global order), "ep" keeps it (its
  own capacity), the aux is not the mean of the data shards' auxes, and a
  batch every data rank holds gives the same; the vlm's patch columns
  are gathered whole.

The moe routes are the two packages' own: each world reports the smallest
top-k margin of every route it took, which the tests print beside a
failure (no seed is picked to hide a flipped route).
"""
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import torch_tp_family_ranks as ranks
from repro import configs as rc
from repro.launch import train as ref_train
from repro.parallel import sharding as ref_sh
from repro_torch import configs as tc
from repro_torch.core.carry import train_state_to_numpy
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import train
from repro_torch.models import model_zoo as zoo
from repro_torch.models import transformer
from repro_torch.parallel import sharding as sh
from test_torch_tensor_parallel import (CACHE_TOL, LOGIT_TOL, NORM_TOL,
                                        _assert_close_tree, _assert_metrics,
                                        _assert_state, _flat, _np, _rel,
                                        _spec_paths, _sub, _train_batch)
from test_torch_train import GRAD_TOL, LOSS_TOL
from torch_parity import port_lockdep  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")

REPO = pathlib.Path(__file__).resolve().parents[1]
AUX_TOL = 1e-6
WORLD_TIMEOUT_S = 300.0
SERVE_MESHES = ((2, 2), (1, 4))
MESH_IDS = ["data2xmodel2", "data1xmodel4"]

SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, functools
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from repro import configs as rc
    from repro.configs import (AttnImpl, EnokiConfig, ParallelConfig,
                               ReplicationPolicy, TrainConfig)
    from repro.launch import serve as S
    from repro.launch import train as T
    from repro.models import model_zoo as zoo
    from repro.models import moe as M
    from repro.optim import diloco_init
    from repro.parallel.sharding import named

    cfg = json.loads(sys.argv[3])
    f32 = jnp.float32
    zoo.lm_loss = functools.partial(zoo.lm_loss, compute_dtype=f32)
    zoo.decode_step = functools.partial(zoo.decode_step, compute_dtype=f32)
    zoo.forward_seq = functools.partial(zoo.forward_seq, compute_dtype=f32)
    data = dict(np.load(sys.argv[1]))
    out = {}

    def tree(prefix):
        t = {}
        for key, v in data.items():
            if key.startswith(prefix + "/"):
                *path, last = key[len(prefix) + 1:].split("/")
                node = t
                for p in path:
                    node = node.setdefault(p, {})
                node[last] = np.asarray(v)
        return t

    def put(prefix, t):
        for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]:
            key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                           for p in path)
            out[f"{prefix}/{key}" if key else prefix] = np.asarray(leaf)

    def arch_of(arch_id, train=False):
        arch = rc.reduced(rc.get_arch(arch_id))
        ch = dict(cfg["changes"][arch_id])
        if "moe" in ch:
            ch["moe"] = dataclasses.replace(arch.moe, **ch["moe"])
        if train and arch_id in cfg["train_layers"]:
            ch["num_layers"] = cfg["train_layers"][arch_id]
        return dataclasses.replace(arch, **ch)

    def shape_of(name, seq, batch):
        return dataclasses.replace(rc.reduced_shape(rc.SHAPES_BY_NAME[name]),
                                   seq_len=seq, global_batch=batch)

    pshape = shape_of("prefill_32k", *cfg["prefill"])
    dshape = shape_of("decode_32k", *cfg["decode"])
    tshape = shape_of("train_4k", *cfg["train"])
    tcfg = TrainConfig(**cfg["train_cfg"])
    devs = jax.devices()

    def prompt(arch_id):
        return {k: np.asarray(data[f"{arch_id}/prompt/{k}"])
                for k in ("tokens", "patch_embeds")
                if f"{arch_id}/prompt/{k}" in data}

    keys = ("tokens", "labels", "loss_mask", "patch_embeds")

    def batches(prefix, n, keys, merge_pods=False):
        bs = []
        for i in range(n):
            b = {k: np.asarray(data[f"{prefix}/{i}/{k}"]) for k in keys
                 if f"{prefix}/{i}/{k}" in data}
            if merge_pods:
                b = {k: v.reshape((-1,) + v.shape[2:]) for k, v in b.items()}
            bs.append(b)
        return bs

    def run_steps(step, sspecs, mesh, init, bs, prefix):
        st = jax.tree.map(jax.device_put, init, named(mesh, sspecs))
        for i, b in enumerate(bs):
            st, m = step(st, b)
            put(f"{prefix}/metrics/{i}", m)
        put(f"{prefix}/state", st)

    @functools.lru_cache(maxsize=None)
    def grad_fn(arch):
        return jax.jit(jax.grad(lambda p, b: zoo.lm_loss(arch, p, b)[0]))

    def grads(arch, params, batch):
        return grad_fn(arch)(params, batch)

    def init_of(prefix):
        st = tree(prefix)
        st["step"] = st["step"].astype(jnp.int32)
        st["opt"]["count"] = st["opt"]["count"].astype(jnp.int32)
        return st

    def serve_part():
        # -- prefill and decode on (data, model)
        for ms in cfg["serve_meshes"]:
            mesh = Mesh(np.array(devs[:4]).reshape(ms), ("data", "model"))
            tag = "x".join(map(str, ms))
            for arch_id in cfg["serve_archs"][tag]:
                arch = arch_of(arch_id)
                params = tree(f"{arch_id}/params")
                impls = ("auto", "ep") if arch.family == "moe" else ("auto",)
                for moe_impl in impls:
                    step, _, _ = S.make_prefill_step(
                        arch, pshape, mesh, ParallelConfig(
                            remat="none", fsdp=False, moe_impl=moe_impl),
                        impl=AttnImpl.REFERENCE)
                    logits, cache = step(params, prompt(arch_id))
                    out[f"{tag}/{arch_id}/prefill/{moe_impl}/logits"] = \\
                        np.asarray(logits)
                    put(f"{tag}/{arch_id}/prefill/{moe_impl}/cache", cache)
                dstep, _, _ = S.make_decode_step(arch, dshape, mesh,
                                                 donate=False)
                cache = tree(f"{arch_id}/dcache")
                token = np.asarray(data[f"{arch_id}/dtoken"])
                toks = []
                for _ in range(cfg["decode_steps"]):
                    token, cache = dstep(params, cache, token)
                    toks.append(np.asarray(token))
                out[f"{tag}/{arch_id}/decode/tokens"] = np.stack(toks)
                put(f"{tag}/{arch_id}/decode/cache", cache)

        # -- the moe layer alone on (data 2, model 2)
        mesh = Mesh(np.array(devs[:4]).reshape(2, 2), ("data", "model"))
        karch = arch_of("kimi-k2-1t-a32b")
        lp, x = tree("layer/params"), np.asarray(data["layer/x"])
        y, aux = jax.jit(lambda p, x: M.moe_apply(p, x, karch))(lp, x)
        out["layer/auto/y"], out["layer/auto/aux"] = np.asarray(y), np.asarray(aux)
        y, aux = jax.jit(lambda p, x: M.moe_apply_ep(p, x, karch, mesh))(lp, x)
        out["layer/ep/y"], out["layer/ep/aux"] = np.asarray(y), np.asarray(aux)


    def train_part():
        mesh = Mesh(np.array(devs[4:]).reshape(2, 2), ("data", "model"))
        # -- training on (data 2, model 2), devices 4-7
        for arch_id in cfg["archs"]:
            arch = arch_of(arch_id, train=True)
            bs = batches(f"{arch_id}/batch", cfg["train_steps"], keys)
            for name in cfg["train_cases"][arch_id]:
                opt, fsdp, remat = cfg["train_modes"][name]
                par = ParallelConfig(fsdp=fsdp, zero1=True, remat=remat,
                                     optimizer=opt)
                step, _, (sspecs, _) = T.make_train_step(
                    arch, tshape, mesh, par, EnokiConfig(), tcfg, donate=False)
                init = init_of(f"{arch_id}/init/{opt}")
                run_steps(step, sspecs, mesh, init, bs, f"{arch_id}/{name}")
            put(f"{arch_id}/grads", grads(arch, init["params"], bs[0]))


    # the inputs stay numpy until a step takes them (a jnp array on one
    # device would be resliced to every sharding by a compiled program)

    # serve and train on disjoint halves of the 8 devices, at once (XLA
    # compiles and runs them in parallel), then the pods on all 8
    import threading
    errors = []

    def run(part):
        try:
            part()
        except BaseException:
            import traceback
            errors.append(traceback.format_exc())
    threads = [threading.Thread(target=run, args=(f,))
               for f in (serve_part, train_part)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[0]

    # -- (pod 2, data 2, model 2): kimi-k2 with Adafactor
    mesh = Mesh(np.array(devs).reshape(2, 2, 2), ("pod", "data", "model"))
    arch = arch_of(cfg["pod_arch"])
    par = ParallelConfig(fsdp=False, zero1=True, remat="none",
                         optimizer="adafactor")
    R = ReplicationPolicy
    init = init_of("pods/init")
    tkeys = keys[:3]
    step, sshape, (sspecs, _) = T.make_train_step(
        arch, tshape, mesh, par, EnokiConfig(policy=R.REPLICATED), tcfg,
        donate=False)
    st = jax.tree.map(lambda l: np.stack([l, l]), init)
    st = jax.tree.map(jax.device_put, st, named(mesh, sspecs))
    pbs = batches("pods/batch", cfg["train_steps"], tkeys)
    for i, b in enumerate(pbs):
        st, m = step(st, b)
        put(f"pods/replicated/metrics/{i}", m)
    put("pods/replicated/state", st)
    put("pods/replicated/grads", jax.tree.map(lambda *g: jnp.stack(g), *[
        grads(arch, init["params"], {k: v[p] for k, v in pbs[0].items()})
        for p in range(2)]))
    st = dict(st, params=jax.tree.map(jax.device_put, tree("pods/rstate"),
                                      named(mesh, sspecs["params"])))
    enoki = EnokiConfig(policy=R.REPLICATED, compress_deltas=True)
    rstep, _, _ = T.make_replicate_step(arch, mesh, par, enoki, sshape)
    s2, o2 = rstep(st, diloco_init(init["params"]))
    put("pods/replicate/params", s2["params"])
    put("pods/replicate/outer", o2)
    for name, policy in (("central", R.CLOUD_CENTRAL),
                         ("peer", R.PEER_FETCH)):
        step, _, (sspecs, _) = T.make_train_step(
            arch, tshape, mesh, par, EnokiConfig(policy=policy), tcfg,
            donate=False)
        mbs = batches("pods/batch", cfg["train_steps"], tkeys, True)
        run_steps(step, sspecs, mesh, init, mbs, f"pods/{name}")
        put(f"pods/{name}/grads", grads(arch, init["params"], mbs[0]))
    sshape2 = dataclasses.replace(dshape, global_batch=2 * cfg["pod_sessions"])
    dstep, _, _ = S.make_decode_step(arch, sshape2, mesh, donate=False)
    params = tree("pods/sess/params")
    sparams = jax.tree.map(lambda l: np.stack([l, l]), params)
    cache = tree("pods/sess/cache")
    token = np.asarray(data["pods/sess/token"])
    toks = []
    for _ in range(cfg["decode_steps"]):
        token, cache = dstep(sparams, cache, token)
        toks.append(np.asarray(token))
    out["pods/sess/tokens"] = np.stack(toks)
    put("pods/sess/cache", cache)
    rsess, _, _ = S.make_replicate_sessions_step(arch, sshape2, mesh)
    put("pods/sess/backup", rsess(cache))
    np.savez(sys.argv[2], **out)
    print("TP_FAMILY_REFERENCE_OK", len(out))
""")


# ---------------------------------------------------------------------------
# seeded inputs (numpy), the same for both packages
# ---------------------------------------------------------------------------

def _patches(rng, arch, b) -> np.ndarray:
    return (0.02 * rng.standard_normal((b, arch.num_patches, arch.d_model))
            ).astype(np.float32)


def _layer_inputs(rng, inp):
    """The moe layer's weights (kimi-k2's config, one layer) and 4 x 64
    tokens whose second half (data shard 1) leans on expert 0 through the
    router's first column: 128 of its tokens route there, past the
    global capacity of 128 once shard 0's share comes first."""
    from repro_torch.models import moe as moe_mod
    arch = ranks.family_arch(tc, "kimi-k2-1t-a32b")
    p = moe_mod.moe_init(torch.Generator().manual_seed(40), arch)
    p["router"][:, 0] += 0.5
    _flat(_np(p), "layer/params", inp)
    x = rng.standard_normal((ranks.LAYER_B, ranks.LAYER_S, arch.d_model))
    x[ranks.LAYER_B // 2:] += 1.0
    inp["layer/x"] = x.astype(np.float32)


def _inputs() -> dict:
    rng = np.random.default_rng(25)
    f32 = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(
        np.float32)
    inp = {}
    for j, arch_id in enumerate(ranks.FAMILY_ARCHS):
        arch = ranks.family_arch(tc, arch_id)
        params = zoo.init_params(arch, seed=10 + j, device="cpu")
        _flat(_np(params), f"{arch_id}/params", inp)
        inp[f"{arch_id}/prompt/tokens"] = rng.integers(
            0, arch.vocab_size, (ranks.PREFILL_BATCH, ranks.PREFILL_SEQ)
        ).astype(np.int32)
        if arch.frontend_stub == "clip_patches":
            inp[f"{arch_id}/prompt/patch_embeds"] = _patches(
                rng, arch, ranks.PREFILL_BATCH)
        L, B, S = arch.num_layers, ranks.DECODE_BATCH, ranks.DECODE_SEQ
        for name in ("k", "v"):
            inp[f"{arch_id}/dcache/{name}"] = f32(
                L, B, S, arch.num_kv_heads, arch.resolved_head_dim, scale=0.5)
        inp[f"{arch_id}/dcache/length"] = np.array(ranks.DECODE_LENGTH,
                                                   np.int32)
        inp[f"{arch_id}/dtoken"] = rng.integers(
            0, arch.vocab_size, (B, 1)).astype(np.int32)
        tarch = ranks.family_arch(tc, arch_id, train_config=True)
        for opt in {ranks.TRAIN_MODES[m][0] for m in ranks.TRAIN_CASES[arch_id]}:
            par = tc.ParallelConfig(optimizer=opt)
            _flat(train_state_to_numpy(train.init_state(
                tarch, 20 + j, par, device="cpu")), f"{arch_id}/init/{opt}",
                inp)
        for i in range(ranks.TRAIN_STEPS):
            batch = _train_batch(rng, tarch, ranks.TRAIN_BATCH,
                                 ranks.TRAIN_SEQ)
            if tarch.frontend_stub == "clip_patches":
                batch["patch_embeds"] = _patches(rng, tarch,
                                                 ranks.TRAIN_BATCH)
                batch["loss_mask"][:, :tarch.num_patches] = 0.0
            for k, v in batch.items():
                inp[f"{arch_id}/batch/{i}/{k}"] = v
    _layer_inputs(rng, inp)

    arch = ranks.family_arch(tc, ranks.POD_ARCH)
    _flat(train_state_to_numpy(train.init_state(
        arch, 30, tc.ParallelConfig(optimizer="adafactor"), device="cpu")),
        "pods/init", inp)
    for i in range(ranks.TRAIN_STEPS):
        pods = [_train_batch(rng, arch, 2, ranks.TRAIN_SEQ) for _ in range(2)]
        for k in pods[0]:
            inp[f"pods/batch/{i}/{k}"] = np.stack([p[k] for p in pods])
    init_keys = [k for k in inp if k.startswith("pods/init/params/")]
    for key in init_keys:                    # two pods' params apart
        leaf = inp[key]
        inp["pods/rstate/" + key[len("pods/init/params/"):]] = np.stack([
            leaf + f32(*leaf.shape, scale=0.01) for _ in range(2)])
    _flat(_np(zoo.init_params(arch, seed=31, device="cpu")),
          "pods/sess/params", inp)
    L, S, n = arch.num_layers, ranks.DECODE_SEQ, ranks.POD_SESSIONS
    for name in ("k", "v"):
        inp[f"pods/sess/cache/{name}"] = f32(
            2, L, n, S, arch.num_kv_heads, arch.resolved_head_dim, scale=0.5)
    inp["pods/sess/cache/length"] = np.array([5, 9], np.int32)
    inp["pods/sess/token"] = rng.integers(0, arch.vocab_size,
                                          (2, n, 1)).astype(np.int32)
    return inp


@functools.lru_cache(maxsize=None)
def _cached_inputs():
    return _inputs()


def _ref_cfg() -> dict:
    return {"changes": ranks.FAMILY_CHANGES, "archs": list(ranks.FAMILY_ARCHS),
            "train_layers": ranks.TRAIN_LAYERS,
            "prefill": [ranks.PREFILL_SEQ, ranks.PREFILL_BATCH],
            "decode": [ranks.DECODE_SEQ, ranks.DECODE_BATCH],
            "train": [ranks.TRAIN_SEQ, ranks.TRAIN_BATCH],
            "train_cfg": ranks.TRAIN_CFG, "train_steps": ranks.TRAIN_STEPS,
            "train_modes": ranks.TRAIN_MODES,
            "train_cases": ranks.TRAIN_CASES,
            "serve_meshes": [list(m) for m in SERVE_MESHES],
            "serve_archs": {"x".join(map(str, m)): list(a)
                            for m, a in ranks.SERVE_ARCHS.items()},
            "decode_steps": ranks.DECODE_STEPS, "pod_arch": ranks.POD_ARCH,
            "pod_sessions": ranks.POD_SESSIONS}


# ---------------------------------------------------------------------------
# the reference (one subprocess, started first) and the port's worlds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("tp_families")


@pytest.fixture(scope="module")
def reference_proc(workdir):
    np.savez(workdir / "in.npz", **_cached_inputs())
    (workdir / "ref.py").write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, str(workdir / "ref.py"), str(workdir / "in.npz"),
         str(workdir / "out.npz"), json.dumps(_ref_cfg())], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference(reference_proc, workdir):
    try:
        stdout, stderr = reference_proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        reference_proc.kill()
        raise
    assert reference_proc.returncode == 0, \
        f"STDOUT:\n{stdout}\nSTDERR:\n{stderr[-4000:]}"
    assert "TP_FAMILY_REFERENCE_OK" in stdout
    out = np.load(workdir / "out.npz")
    return {k: out[k] for k in out.files}


def _world(workdir, name, fn, n, *args):
    store = workdir / f"{name}.store"
    return port_mesh.spawn_world(fn, n, f"file://{store}", args=args,
                                 device="cpu", timeout_s=WORLD_TIMEOUT_S,
                                 threads=1)


@pytest.fixture(scope="module")
def four_ranks(reference_proc, workdir):
    return _world(workdir, "four", ranks.four_ranks, 4, SERVE_MESHES,
                  _cached_inputs())


@pytest.fixture(scope="module")
def serve_worlds(four_ranks):
    return {ms: [r["serve"][ms] for r in four_ranks] for ms in SERVE_MESHES}


@pytest.fixture(scope="module")
def trained(four_ranks):
    return [r["train"] for r in four_ranks]


@pytest.fixture(scope="module")
def pods(reference_proc, workdir):
    return _world(workdir, "pods", ranks.pods_world, 8, _cached_inputs())


def _margin(world) -> str:
    return f"smallest top-k route margin {world[0]['route/min_margin']:.3g}"


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

PREFILL_CASES = [(ms, a, impl, m) for ms in SERVE_MESHES
                 for a in ranks.SERVE_ARCHS[ms]
                 for impl, m in (("reference", "auto"), ("reference", "ep"),
                                 ("flash", "auto"))
                 if m == "auto" or a != "phi-3-vision-4.2b"]
DECODE_CASES = [(ms, a) for ms in SERVE_MESHES for a in ranks.SERVE_ARCHS[ms]]


def _ids(cases):
    return ["-".join((MESH_IDS[SERVE_MESHES.index(c[0])],) + tuple(c[1:]))
            for c in cases]


@pytest.mark.parametrize("ms,arch_id,impl,moe_impl", PREFILL_CASES,
                         ids=_ids(PREFILL_CASES))
def test_prefill_matches_reference(serve_worlds, reference, ms, arch_id,
                                   impl, moe_impl):
    """The last logits, gathered to every rank, within 1e-4 of the
    reference's largest under the same ``moe_impl``; the rank's caches (by
    KV heads) gathered within 1e-5 of the reference's."""
    got = serve_worlds[ms][0]
    tag = "x".join(map(str, ms))
    logits = got[f"{arch_id}/prefill/{impl}/{moe_impl}/logits"]
    want = reference[f"{tag}/{arch_id}/prefill/{moe_impl}/logits"]
    assert _rel(logits, want) <= LOGIT_TOL, _margin(serve_worlds[ms])
    cache = _sub(got, f"{arch_id}/prefill/{impl}/{moe_impl}/cache")
    wcache = _sub(reference, f"{tag}/{arch_id}/prefill/{moe_impl}/cache")
    for k in ("k", "v"):
        assert _rel(cache[k], wcache[k]) <= CACHE_TOL, k
    assert int(cache["length"]) == int(wcache["length"]) == \
        ranks.PREFILL_SEQ


@pytest.mark.parametrize("ms,arch_id", DECODE_CASES, ids=_ids(DECODE_CASES))
def test_decode_matches_reference(serve_worlds, reference, ms, arch_id):
    """3 greedy steps (the moe layers' buckets of 8 over the global
    batch's tokens): tokens equal, the gathered caches within 1e-5."""
    got = serve_worlds[ms][0]
    tag = "x".join(map(str, ms))
    np.testing.assert_array_equal(got[f"{arch_id}/decode/tokens"],
                                  reference[f"{tag}/{arch_id}/decode/tokens"],
                                  err_msg=_margin(serve_worlds[ms]))
    cache = _sub(got, f"{arch_id}/decode/cache")
    want = _sub(reference, f"{tag}/{arch_id}/decode/cache")
    for k in ("k", "v"):
        assert _rel(cache[k], want[k]) <= CACHE_TOL, k
    assert int(cache["length"]) == int(want["length"])


# ---------------------------------------------------------------------------
# the moe layer: global dispatch order, per-shard capacity, the global aux
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moe_impl", ranks.MOE_IMPLS)
def test_overflowing_bucket_matches_reference(serve_worlds, reference,
                                              moe_impl):
    """Data shard 1's tokens lean on expert 0.  "auto" ranks them after
    shard 0's in the global order and drops those past the global
    capacity; "ep" ranks each data shard on its own against its own
    capacity and keeps them.  Both within 1e-4 of the reference's."""
    got = serve_worlds[(2, 2)][0]
    assert _rel(got[f"layer/{moe_impl}/y"],
                reference[f"layer/{moe_impl}/y"]) <= LOGIT_TOL
    assert abs(got[f"layer/{moe_impl}/aux"] -
               float(reference[f"layer/{moe_impl}/aux"])) <= AUX_TOL


@pytest.mark.parametrize("moe_impl", ranks.MOE_IMPLS)
def test_layer_on_a_batch_every_data_rank_holds(serve_worlds, reference,
                                                moe_impl):
    """The whole batch on every data rank (``batch_axes=()``: a batch that
    ``data`` does not divide): "auto" dispatches it as one group, "ep"
    cuts its tokens over ``data`` as the reference's ``moe_apply_ep``
    does and gathers them back; both within 1e-4 of the reference's."""
    got = serve_worlds[(2, 2)][0]
    assert _rel(got[f"layer/{moe_impl}/replicated_y"],
                reference[f"layer/{moe_impl}/y"]) <= LOGIT_TOL
    assert abs(got[f"layer/{moe_impl}/replicated_aux"] -
               float(reference[f"layer/{moe_impl}/aux"])) <= AUX_TOL


def test_auto_and_ep_drop_different_tokens(serve_worlds, reference):
    """The two forms agree on data shard 0's tokens and part on shard 1's
    (the reference's too): the case shows the global order."""
    half = ranks.LAYER_B // 2
    for src in (serve_worlds[(2, 2)][0], reference):
        auto, ep = src["layer/auto/y"], src["layer/ep/y"]
        assert _rel(auto[:half], ep[:half]) <= LOGIT_TOL
        assert _rel(auto[half:], ep[half:]) > 1e-2


def test_aux_is_the_global_batch_not_a_mean_of_ranks(serve_worlds,
                                                     reference):
    """The aux is E x sum(fraction x mean_prob) over all tokens; the mean
    of the data shards' own auxes (a product of means averaged) is not."""
    got = serve_worlds[(2, 2)][0]
    want = float(reference["layer/auto/aux"])
    assert abs(got["layer/auto/aux"] - want) <= AUX_TOL
    assert abs(got["layer/mean_of_auxes"] - want) > 10 * AUX_TOL


def test_vlm_patch_columns_are_gathered(serve_worlds):
    """``patch_proj`` is column-parallel: a model rank's product holds only
    its d / model columns (model rank 1's differ from the first columns),
    and ``all_gather_dim`` over ``model`` gives the whole projection that
    goes in front of the text."""
    got = serve_worlds[(2, 2)]
    assert got[0]["patches/err"] <= 1e-6
    assert got[1]["patches/rank_cols_err"] > 1e-3


def test_vlm_rank_batch_cuts_the_patches(serve_worlds):
    """``data.rank_batch`` of the vlm is ``synthetic_batch`` of the rank's
    ``data`` index, ``patch_embeds`` included."""
    for r in serve_worlds[(2, 2)]:
        assert r["rank_batch/equal"]
    assert "patch_embeds" in serve_worlds[(2, 2)][0]["rank_batch/keys"]


# ---------------------------------------------------------------------------
# training: AdamW ZeRO-1 and Adafactor FSDP on (data 2, model 2)
# ---------------------------------------------------------------------------

def _assert_adafactor_state(got: dict, want: dict, init: dict, grads: dict,
                            what: str, factor_tol: float = GRAD_TOL):
    """Adafactor's state after ``TRAIN_STEPS`` (the module docstring):
    the counters exactly; each factor within ``factor_tol`` of its max-abs;
    each param within twice the reference's whole move of the leaf, and
    within ``GRAD_TOL`` of the leaf's max-abs where the first gradient is
    live."""
    gf, wf = _flat(got, "", {}), _flat(want, "", {})
    assert sorted(gf) == sorted(wf), what
    for k in gf:
        g, w = np.asarray(gf[k], np.float64), np.asarray(wf[k], np.float64)
        assert g.shape == w.shape, (what, k)
        if k in ("/step", "/opt/count"):
            np.testing.assert_array_equal(g, w, err_msg=what + k)
            continue
        err = np.abs(g - w)
        peak = np.abs(w).max() + 1e-30
        if k.startswith("/opt/v/"):
            assert err.max() <= factor_tol * peak, (what, k, err.max() / peak)
            continue
        leaf = k.split("/", 2)[2]
        moved = np.abs(w - np.asarray(init["/" + leaf], np.float64)).max()
        assert err.max() <= 2 * moved + 1e-7, (what, k, err.max(), moved)
        gr = np.abs(np.asarray(grads["/" + leaf], np.float64))
        live = gr > 1e-3 * gr.max()
        assert (err[live] <= GRAD_TOL * peak).all(), \
            (what, k, (err[live] / peak).max())


def _assert_train(got, reference, prefix, grads, init, opt):
    """Metrics and the state after the steps: ``grads`` and ``init`` (the
    params before them) flat, keyed as ``_flat`` keys a params tree."""
    _assert_metrics(got, reference, prefix, prefix)
    if opt == "adamw":
        _assert_state(_sub(got, f"{prefix}/state"),
                      _sub(reference, f"{prefix}/state"), grads, prefix)
    else:
        _assert_adafactor_state(_sub(got, f"{prefix}/state"),
                                _sub(reference, f"{prefix}/state"), init,
                                grads, prefix)


TRAIN_IDS = [(a, m) for a in ranks.FAMILY_ARCHS for m in ranks.TRAIN_CASES[a]]


@pytest.mark.parametrize("arch_id,mode", TRAIN_IDS,
                         ids=["-".join(c) for c in TRAIN_IDS])
def test_train_matches_reference(trained, reference, arch_id, mode):
    """2 steps: loss, ce and grad_norm at each (the moe aux the global
    batch's); the first step's gradients within 1e-4 of each leaf's
    max-abs; the whole state after the second (module docstring)."""
    got = trained[0]
    prefix = f"{arch_id}/{mode}"
    opt = ranks.TRAIN_MODES[mode][0]
    want = _sub(reference, f"{arch_id}/grads")
    _assert_close_tree(_sub(got, f"{prefix}/grads"), want, GRAD_TOL, prefix)
    init = _sub(_cached_inputs(), f"{arch_id}/init/{opt}")["params"]
    _assert_train(got, reference, prefix, _flat(want, "", {}),
                  _flat(init, "", {}), opt)


def test_adafactor_factors_of_an_expert_leaf_sharded_over_model(trained,
                                                                reference):
    """kimi-k2's ``w_gate`` (L, E, d, f) is sharded by expert over model:
    its factors ``row`` (L, E, d) and ``col`` (L, E, f) are means over the
    whole leaf's dims, each rank's expert slice gathered into the
    replicated factor, as the reference's specs hold them (``P()``)."""
    prefix = "kimi-k2-1t-a32b/adafactor_fsdp/state/opt/v/blocks/moe/w_gate"
    for name in ("row", "col"):
        got = trained[0][f"{prefix}/{name}"]
        want = reference[f"{prefix}/{name}"]
        assert got.shape == want.shape
        assert _rel(got, want) <= GRAD_TOL, name
    arch = ranks.family_arch(tc, "kimi-k2-1t-a32b", train_config=True)
    par = tc.ParallelConfig(fsdp=True, optimizer="adafactor")
    specs = train.state_specs(train.state_shapes(arch, par), arch,
                              _DataModel, par)
    assert tuple(specs["params"]["blocks"]["moe"]["w_gate"]) == \
        (None, "model", "data", None)
    assert tuple(specs["opt"]["v"]["blocks"]["moe"]["w_gate"]["row"]) == ()


# ---------------------------------------------------------------------------
# (pod 2, data 2, model 2): kimi-k2 with Adafactor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["central", "peer"])
def test_pod_policies_match_reference(pods, reference, name):
    """CLOUD_CENTRAL (the batch and the moe dispatch over ("pod",
    "data")) and PEER_FETCH (every leaf, and every factor, also over
    ``pod``) against the reference's jitted steps."""
    got = pods[0]
    grads = _sub(reference, f"pods/{name}/grads")
    _assert_close_tree(_sub(got, f"pods/{name}/grads"), grads, GRAD_TOL,
                       name)
    init = _sub(_cached_inputs(), "pods/init")["params"]
    _assert_train(got, reference, f"pods/{name}", _flat(grads, "", {}),
                  _flat(init, "", {}), "adafactor")


def test_replicated_pods_match_reference(pods, reference):
    """REPLICATED: each pod (4 ranks) steps on its own batch; pod p's state
    is the reference's stacked slice p."""
    want = _sub(reference, "pods/replicated/state")
    grads = _sub(reference, "pods/replicated/grads")
    init = _flat(_sub(_cached_inputs(), "pods/init")["params"], "", {})
    for p, r in ((0, 0), (1, 4)):
        pick = lambda t: jax.tree.map(lambda x: x[p], t)
        _assert_close_tree(_sub(pods[r], f"pods/replicated{p}/grads"),
                           pick(grads), GRAD_TOL, f"pod {p}")
        _assert_adafactor_state(_sub(pods[r], f"pods/replicated{p}/state"),
                                pick(want), init, _flat(pick(grads), "", {}),
                                f"pod {p}")
        for i in range(ranks.TRAIN_STEPS):
            m = pods[r][f"pods/replicated{p}/metrics/{i}"]
            w = reference[f"pods/replicated/metrics/{i}/loss"][p]
            assert abs(m["loss"] - float(w)) <= LOSS_TOL * abs(float(w))


def test_replicate_step_per_shard_matches_reference(pods, reference):
    """The int8 anti-entropy round on kimi-k2's shards (each scale the
    whole leaf's, the shared expert sharded on its layer dim): both pods
    equal bit for bit after it, and within 1e-5 of the reference's."""
    a = _sub(pods[0], "pods/replicate/params0")
    b = _sub(pods[4], "pods/replicate/params1")
    for (k, x), (_, y) in zip(sorted(_flat(a, "", {}).items()),
                              sorted(_flat(b, "", {}).items())):
        np.testing.assert_array_equal(x, y, err_msg=k)
    want = _sub(reference, "pods/replicate/params")
    _assert_close_tree(a, jax.tree.map(lambda x: x[0], want), 1e-5, "params")
    outer = _sub(pods[0], "pods/replicate/outer0")
    wouter = _sub(reference, "pods/replicate/outer")
    _assert_close_tree({k: outer[k] for k in ("outer_params", "momentum")},
                       {k: wouter[k] for k in ("outer_params", "momentum")},
                       1e-5, "outer")


def test_sessions_on_a_pod_tensor_parallel_mesh(pods, reference):
    """kimi-k2's decode on (pod, data, model), each pod's 2 sessions on its
    4 ranks: tokens equal to the reference's, the caches within 1e-5; the
    backup ring per shard (pod 1's backup is pod 0's cache)."""
    for p, r in ((0, 0), (1, 4)):
        got = pods[r]
        np.testing.assert_array_equal(got[f"pods/sess/tokens{p}"],
                                      reference["pods/sess/tokens"][:, p])
        for k in ("k", "v"):
            assert _rel(got[f"pods/sess/cache{p}/{k}"],
                        reference[f"pods/sess/cache/{k}"][p]) <= CACHE_TOL
            assert _rel(got[f"pods/sess/backup{p}/{k}"],
                        reference[f"pods/sess/backup/{k}"][p]) <= CACHE_TOL
    np.testing.assert_array_equal(pods[4]["pods/sess/backup1/k"],
                                  pods[0]["pods/sess/cache0/k"])


def test_remesh_of_a_moe_state(pods):
    """``remesh(old_mesh=)`` of kimi-k2's Adafactor state (experts by
    column, the shared expert by layer, the factors replicated) from
    (pod 2, data 2, model 2) onto pod 0's (data 2, model 2) equals pod 0's
    whole state cut there; pod 1's ranks get None leaves."""
    for r, got in enumerate(pods):
        assert tuple(got["remesh/degraded"][0]) == (2, 2)
        assert got["remesh/equal" if r < 4 else "remesh/outside_none"], r


# ---------------------------------------------------------------------------
# specs and splits (no world)
# ---------------------------------------------------------------------------

class _DataModel:
    shape = {"data": 2, "model": 2}
    mesh_dim_names = None


def _mesh(**sizes):
    return type("M", (), {"shape": sizes, "mesh_dim_names": None})


@pytest.mark.parametrize("arch_id,model,layers,want", [
    ("kimi-k2-1t-a32b", 2, None, ("model", None, None)),
    ("kimi-k2-1t-a32b", 4, None, ("model", None, None)),
    ("kimi-k2-1t-a32b", 4, 61, (None, None, "model")),
], ids=["reduced-model2", "reduced-model4", "full-depth-model4"])
def test_shared_expert_layouts_match_reference(arch_id, model, layers, want):
    """The reference's 3-D test for expert weights also takes kimi-k2's
    layer-stacked shared expert (L, d, f): its LAYER dim goes over model
    when model divides L (reduced kimi-k2, L = 4), else the column rule
    (61 layers); ``moe.expert_layout`` names the same, and the port's
    specs equal the reference's leaf for leaf."""
    from repro_torch.models import moe as moe_mod
    changes = {} if layers is None else {"num_layers": layers}
    arch_p = dataclasses.replace(tc.reduced(tc.get_arch(arch_id)), **changes)
    arch_r = dataclasses.replace(rc.reduced(rc.get_arch(arch_id)), **changes)
    mesh = _mesh(data=1, model=model)
    got = sh.param_partition_specs(zoo.init_params(arch_p, device="meta"),
                                   arch_p, mesh, tc.ParallelConfig())
    want_all = ref_sh.param_partition_specs(
        jax.eval_shape(lambda: rc_zoo().init_params(arch_r,
                                                     jax.random.PRNGKey(0))),
        arch_r, mesh, rc.ParallelConfig())
    assert _spec_paths(got) == _spec_paths(want_all)
    assert tuple(got["blocks"]["moe"]["shared"]["w_gate"]) == want
    lay = moe_mod.expert_layout(arch_p, model)["shared"]
    assert lay == ("layer" if want[0] == "model" else "tp")


def rc_zoo():
    from repro.models import model_zoo
    return model_zoo


def test_grok_experts_fall_back_to_columns_when_model_does_not_divide():
    """grok-1's 8 experts over model 16 (its mesh): the experts go
    column/row on d_expert in both packages, and the port's layout says
    "tp"; the reduced test config (6 experts) does so at model 4."""
    from repro_torch.models import moe as moe_mod
    for arch_p, arch_r, model in (
            (tc.get_arch("grok-1-314b"), rc.get_arch("grok-1-314b"), 16),
            (ranks.family_arch(tc, "grok-1-314b"),
             ranks.family_arch(rc, "grok-1-314b"), 4)):
        arch_p = dataclasses.replace(arch_p, num_layers=2)
        arch_r = dataclasses.replace(arch_r, num_layers=2)
        mesh = _mesh(data=1, model=model)
        got = sh.param_partition_specs(zoo.init_params(arch_p,
                                                       device="meta"),
                                       arch_p, mesh, tc.ParallelConfig())
        want = ref_sh.param_partition_specs(
            jax.eval_shape(lambda: rc_zoo().init_params(
                arch_r, jax.random.PRNGKey(0))), arch_r, mesh,
            rc.ParallelConfig())
        assert _spec_paths(got) == _spec_paths(want)
        moe = got["blocks"]["moe"]
        assert tuple(moe["w_gate"]) == (None, None, None, "model")
        assert tuple(moe["w_down"]) == (None, None, "model", None)
        assert moe_mod.expert_layout(arch_p, model)["experts"] == "tp"


@pytest.mark.parametrize("policy", ["replicated", "peer_fetch"])
def test_adafactor_state_specs_match_reference(policy):
    """``state_specs`` of an Adafactor state (kimi-k2, FSDP): the factors
    replicated, or over ``pod`` under PEER_FETCH, leaf for leaf as the
    reference's."""
    arch_p = ranks.family_arch(tc, "kimi-k2-1t-a32b")
    arch_r = ranks.family_arch(rc, "kimi-k2-1t-a32b")
    mesh = _mesh(pod=2, data=2, model=2)
    peer = policy == "peer_fetch"
    par_p = tc.ParallelConfig(fsdp=True, optimizer="adafactor")
    par_r = rc.ParallelConfig(fsdp=True, optimizer="adafactor")
    got = train.state_specs(train.state_shapes(arch_p, par_p), arch_p, mesh,
                            par_p, peer_fetch_pod=peer)
    want = ref_train.state_specs(ref_train.state_shapes(arch_r, par_r),
                                 arch_r, mesh, par_r, peer_fetch_pod=peer)
    assert _spec_paths(got) == _spec_paths(want)


def test_splits_the_moe_family_checks():
    """``check_tp_split``: the moe family is held to its heads, KV heads
    and vocabulary, and to d_expert only where the specs cut it."""
    arch = ranks.family_arch(tc, "grok-1-314b")
    transformer.check_tp_split(arch, 4)         # 6 experts: d_expert 128
    bad = dataclasses.replace(arch, moe=dataclasses.replace(arch.moe,
                                                            d_expert=130))
    transformer.check_tp_split(bad, 2)          # by expert: not cut
    with pytest.raises(ValueError, match="d_expert"):
        transformer.check_tp_split(bad, 4)      # column/row: cut
    vlm = ranks.family_arch(tc, "phi-3-vision-4.2b")
    with pytest.raises(ValueError, match="d_model"):
        transformer.check_tp_split(dataclasses.replace(vlm, d_model=130), 4)
