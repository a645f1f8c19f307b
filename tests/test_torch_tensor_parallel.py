"""The port's tensor-parallel, ZeRO-1 and FSDP steps of the dense family on
gloo worlds of CPU ranks, against the reference's jitted steps on the same
meshes of forced host devices.

ONE reference subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=8``)
runs, in f32 compute, the TP configs of reduced internlm2, gemma-7b and
qwen1.5-110b (``torch_tp_ranks.TP_CHANGES``: head counts that model = 4
divides) through ``make_prefill_step`` and ``make_decode_step`` on (data 2,
model 2) and (data 1, model 4), ``make_train_step`` with ZeRO-1 (remat
"block") and FSDP (remat "full") on (data 2, model 2), and the REPLICATED,
CLOUD_CENTRAL and PEER_FETCH steps, ``make_replicate_step`` (int8 off and
on) and the session steps on (pod 2, data 2, model 2).  It starts first
and runs while the port's worlds run: one world a mesh shape, spawned by
``launch.mesh.spawn_world`` (one thread a rank; the rank bodies are in
``tests/torch_tp_ranks.py``), on the same numpy inputs carried across by
``core.carry``.  Bounds:

* prefill logits within 1e-4 of the reference's largest (REFERENCE and
  FLASH, the kernel's plain version on the CPU); caches within 1e-5;
* decode: greedy tokens equal, caches within 1e-5;
* train: loss and ce within 1e-5 relative at every step, ``grad_norm``
  within 1e-5 relative, the first step's gradients within 1e-4 of each
  leaf's max-abs, and the state after 2 steps within
  ``tests/test_torch_train.py``'s state bounds (moments 1e-4 of the
  leaf's max-abs; params within 2 x lr x steps and all but 1e-3 of the
  elements within 1e-4 of the leaf's max-abs: AdamW's normalised update
  turns a near-zero gradient's rounding into a full step);
* the six sharded reductions, each on numbers that a naive port gets
  wrong: the vocab-parallel embedding, the cross-entropy over vocabulary
  shards, the masked mean over the global batch (data shards holding
  unequal mask counts), the gradient norm with a leaf replicated over
  ``model``, the int8 scale of a sharded leaf, and the argmax with a tie
  across two vocabulary shards;
* ``tests/test_pod_replication.py``'s scenario on the port's 8 ranks.
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

import torch_tp_ranks as ranks
from repro import configs as rc
from repro.launch import train as ref_train
from repro_torch import configs as tc
from repro_torch.core.carry import train_state_to_numpy
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import train
from repro_torch.models import model_zoo as zoo
from test_torch_train import GRAD_TOL, LOSS_TOL
from torch_parity import port_lockdep  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")

REPO = pathlib.Path(__file__).resolve().parents[1]
LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
NORM_TOL = 1e-5
WORLD_TIMEOUT_S = 300.0
SERVE_MESHES = ((2, 2), (1, 4))

SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, functools
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro import configs as rc
    from repro.configs import (AttnImpl, EnokiConfig, ParallelConfig,
                               ReplicationPolicy, TrainConfig)
    from repro.launch import serve as S
    from repro.launch import train as T
    from repro.models import model_zoo as zoo
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
                node[last] = jnp.asarray(v)
        return t

    def put(prefix, t):
        for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]:
            key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                           for p in path)
            out[f"{prefix}/{key}" if key else prefix] = np.asarray(leaf)

    def arch_of(arch_id):
        return dataclasses.replace(rc.reduced(rc.get_arch(arch_id)),
                                   **cfg["changes"][arch_id])

    def shape_of(name, seq, batch):
        return dataclasses.replace(rc.reduced_shape(rc.SHAPES_BY_NAME[name]),
                                   seq_len=seq, global_batch=batch)

    pshape = shape_of("prefill_32k", *cfg["prefill"])
    dshape = shape_of("decode_32k", *cfg["decode"])
    tshape = shape_of("train_4k", *cfg["train"])
    tcfg = TrainConfig(**cfg["train_cfg"])
    devs = jax.devices()

    # -- prefill and decode on (data, model)
    for ms in cfg["serve_meshes"]:
        mesh = Mesh(np.array(devs[:4]).reshape(ms), ("data", "model"))
        tag = "x".join(map(str, ms))
        for arch_id in cfg["archs"]:
            arch = arch_of(arch_id)
            params = tree(f"{arch_id}/params")
            step, _, _ = S.make_prefill_step(
                arch, pshape, mesh, ParallelConfig(remat="none", fsdp=False),
                impl=AttnImpl.REFERENCE)
            logits, cache = step(params, {"tokens": jnp.asarray(
                data[f"{arch_id}/tokens"])})
            out[f"{tag}/{arch_id}/prefill/logits"] = np.asarray(logits)
            put(f"{tag}/{arch_id}/prefill/cache", cache)
            dstep, _, _ = S.make_decode_step(arch, dshape, mesh,
                                             donate=False)
            cache = tree(f"{arch_id}/dcache")
            token = jnp.asarray(data[f"{arch_id}/dtoken"])
            toks = []
            for _ in range(cfg["decode_steps"]):
                token, cache = dstep(params, cache, token)
                toks.append(np.asarray(token))
            out[f"{tag}/{arch_id}/decode/tokens"] = np.stack(toks)
            put(f"{tag}/{arch_id}/decode/cache", cache)

    def batches(prefix, n, merge_pods=False):
        bs = []
        for i in range(n):
            b = {k: jnp.asarray(data[f"{prefix}/{i}/{k}"])
                 for k in ("tokens", "labels", "loss_mask")}
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

    def grads(arch, params, batch, remat):
        return jax.jit(jax.grad(lambda p: zoo.lm_loss(
            arch, p, batch, remat=remat)[0]))(params)

    def init_of(prefix):
        st = tree(prefix)
        st["step"] = st["step"].astype(jnp.int32)
        st["opt"]["count"] = st["opt"]["count"].astype(jnp.int32)
        return st

    # -- training on (data 2, model 2): ZeRO-1 and FSDP
    mesh = Mesh(np.array(devs[:4]).reshape(2, 2), ("data", "model"))
    for arch_id in cfg["archs"]:
        arch = arch_of(arch_id)
        bs = batches(f"{arch_id}/batch", cfg["train_steps"])
        for name, fsdp, remat in cfg["train_modes"]:
            par = ParallelConfig(fsdp=fsdp, zero1=True, remat=remat,
                                 optimizer="adamw")
            step, _, (sspecs, _) = T.make_train_step(
                arch, tshape, mesh, par, EnokiConfig(), tcfg, donate=False)
            init = init_of(f"{arch_id}/init")
            run_steps(step, sspecs, mesh, init, bs, f"{arch_id}/{name}")
            put(f"{arch_id}/{name}/grads",
                grads(arch, init["params"], bs[0], remat))

    # -- (pod 2, data 2, model 2)
    mesh = Mesh(np.array(devs).reshape(2, 2, 2), ("pod", "data", "model"))
    arch = arch_of("internlm2-1.8b")
    par = ParallelConfig(fsdp=False, remat="none", optimizer="adamw")
    R = ReplicationPolicy
    init = init_of("pods/init")
    step, sshape, (sspecs, _) = T.make_train_step(
        arch, tshape, mesh, par, EnokiConfig(policy=R.REPLICATED), tcfg,
        donate=False)
    st = jax.tree.map(lambda l: jnp.stack([l, l]), init)
    st = jax.tree.map(jax.device_put, st, named(mesh, sspecs))
    pbs = batches("pods/batch", cfg["train_steps"])
    for i, b in enumerate(pbs):
        st, m = step(st, b)
        put(f"pods/replicated/metrics/{i}", m)
    put("pods/replicated/state", st)
    put("pods/replicated/grads", jax.tree.map(lambda *g: jnp.stack(g), *[
        grads(arch, init["params"], {k: v[p] for k, v in pbs[0].items()},
              "none") for p in range(2)]))
    st = dict(st, params=jax.tree.map(jax.device_put, tree("pods/rstate"),
                                      named(mesh, sspecs["params"])))
    for c in (0, 1):
        enoki = EnokiConfig(policy=R.REPLICATED, compress_deltas=bool(c))
        rstep, _, _ = T.make_replicate_step(arch, mesh, par, enoki, sshape)
        s2, o2 = rstep(st, diloco_init(init["params"]))
        put(f"pods/replicate{c}/params", s2["params"])
        put(f"pods/replicate{c}/outer", o2)
    for name, policy in (("central", R.CLOUD_CENTRAL),
                         ("peer", R.PEER_FETCH)):
        step, _, (sspecs, _) = T.make_train_step(
            arch, tshape, mesh, par, EnokiConfig(policy=policy), tcfg,
            donate=False)
        mbs = batches("pods/batch", cfg["train_steps"], True)
        run_steps(step, sspecs, mesh, init, mbs, f"pods/{name}")
        put(f"pods/{name}/grads", grads(arch, init["params"], mbs[0], "none"))
    sshape2 = dataclasses.replace(dshape, global_batch=4)
    dstep, _, _ = S.make_decode_step(arch, sshape2, mesh, donate=False)
    params = tree("pods/sess/params")
    sparams = jax.tree.map(lambda l: jnp.stack([l, l]), params)
    cache = tree("pods/sess/cache")
    token = jnp.asarray(data["pods/sess/token"])
    toks = []
    for _ in range(cfg["decode_steps"]):
        token, cache = dstep(sparams, cache, token)
        toks.append(np.asarray(token))
    out["pods/sess/tokens"] = np.stack(toks)
    put("pods/sess/cache", cache)
    rsess, _, _ = S.make_replicate_sessions_step(arch, sshape2, mesh)
    backup = rsess(cache)
    put("pods/sess/backup", backup)
    mstep, _, _ = S.make_migrate_sessions_step(arch, sshape2, mesh)
    put("pods/sess/restored", mstep(cache, backup, jnp.asarray([True, False])))
    np.savez(sys.argv[2], **out)
    print("TP_REFERENCE_OK", len(out))
""")


# ---------------------------------------------------------------------------
# seeded inputs (numpy), the same for both packages
# ---------------------------------------------------------------------------

def _flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}/{k}", out)
    else:
        out[prefix] = np.asarray(tree)
    return out


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _train_batch(rng, arch, b, s):
    """tokens, labels and a loss mask whose data shards (the batch's first
    and second halves) hold unequal counts."""
    tok = rng.integers(0, arch.vocab_size, (b, s + 1)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[b // 2:, : s // 2] = 0.0
    mask[-1, :] = 0.0
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:], "loss_mask": mask}


def _inputs() -> dict:
    rng = np.random.default_rng(24)
    f32 = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(
        np.float32)
    inp = {}
    for j, arch_id in enumerate(ranks.TP_ARCHS):
        arch = ranks.tp_arch(tc, arch_id)
        params = zoo.init_params(arch, seed=10 + j, device="cpu")
        if arch.qkv_bias:       # the init's zero biases would hide a slice
            for name in ("bq", "bk", "bv"):
                params["blocks"]["attn"][name].normal_(
                    generator=torch.Generator().manual_seed(j)).mul_(0.1)
        _flat(_np(params), f"{arch_id}/params", inp)
        inp[f"{arch_id}/tokens"] = rng.integers(
            0, arch.vocab_size, (ranks.PREFILL_BATCH, ranks.PREFILL_SEQ)
        ).astype(np.int32)
        L, B, S = arch.num_layers, ranks.DECODE_BATCH, ranks.DECODE_SEQ
        for name in ("k", "v"):
            inp[f"{arch_id}/dcache/{name}"] = f32(
                L, B, S, arch.num_kv_heads, arch.resolved_head_dim, scale=0.5)
        inp[f"{arch_id}/dcache/length"] = np.array(ranks.DECODE_LENGTH,
                                                   np.int32)
        inp[f"{arch_id}/dtoken"] = rng.integers(
            0, arch.vocab_size, (B, 1)).astype(np.int32)
        par = tc.ParallelConfig(optimizer="adamw")
        _flat(train_state_to_numpy(train.init_state(arch, 20 + j, par,
                                                    device="cpu")),
              f"{arch_id}/init", inp)
        for i in range(ranks.TRAIN_STEPS):
            for k, v in _train_batch(rng, arch, ranks.TRAIN_BATCH,
                                     ranks.TRAIN_SEQ).items():
                inp[f"{arch_id}/batch/{i}/{k}"] = v

    arch = ranks.tp_arch(tc, "internlm2-1.8b")
    _flat(train_state_to_numpy(train.init_state(
        arch, 30, tc.ParallelConfig(optimizer="adamw"), device="cpu")),
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
    L, S = arch.num_layers, ranks.DECODE_SEQ
    for name in ("k", "v"):
        inp[f"pods/sess/cache/{name}"] = f32(
            2, L, 2, S, arch.num_kv_heads, arch.resolved_head_dim, scale=0.5)
    inp["pods/sess/cache/length"] = np.array([5, 9], np.int32)
    inp["pods/sess/token"] = rng.integers(0, arch.vocab_size,
                                          (2, 2, 1)).astype(np.int32)

    V, D = 64, 16
    inp["red/embed"] = f32(V, D)
    inp["red/tokens"] = rng.integers(0, V, (4, 8)).astype(np.int32)
    inp["red/logits"] = f32(4, 8, V, scale=3.0)
    inp["red/labels"] = rng.integers(0, V, (4, 8)).astype(np.int32)
    mask = np.ones((4, 8), np.float32)
    mask[2:, 3:] = 0.0                      # data shard 1: 6 of 16
    inp["red/mask"] = mask
    inp["red/w"], inp["red/b"], inp["red/e"] = f32(6, 8), f32(8), \
        f32(4, 6, scale=2.0)
    inp["red/e"][3, 5] = 9.0                # the peak on one shard only
    tie = f32(3, V)
    tie[:, 5] = tie[:, V // 2 + 2] = 50.0   # row 0/1: ties across shards
    tie[1, V // 2 + 1] = 50.0
    tie[2, V // 2 + 7] = 60.0               # row 2: shard 1 wins alone
    inp["red/tie"] = tie
    return inp


@functools.lru_cache(maxsize=None)
def _cached_inputs():
    return _inputs()


def _ref_cfg() -> dict:
    return {"changes": ranks.TP_CHANGES, "archs": list(ranks.TP_ARCHS),
            "prefill": [ranks.PREFILL_SEQ, ranks.PREFILL_BATCH],
            "decode": [ranks.DECODE_SEQ, ranks.DECODE_BATCH],
            "train": [ranks.TRAIN_SEQ, ranks.TRAIN_BATCH],
            "train_cfg": ranks.TRAIN_CFG, "train_steps": ranks.TRAIN_STEPS,
            "train_modes": [list(m) for m in ranks.TRAIN_MODES],
            "serve_meshes": [list(m) for m in SERVE_MESHES],
            "decode_steps": ranks.DECODE_STEPS}


# ---------------------------------------------------------------------------
# the reference (one subprocess, started first) and the port's worlds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("tp")


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
    assert "TP_REFERENCE_OK" in stdout
    out = np.load(workdir / "out.npz")
    return {k: out[k] for k in out.files}


def _world(workdir, name, fn, n, *args):
    store = workdir / f"{name}.store"
    return port_mesh.spawn_world(fn, n, f"file://{store}", args=args,
                                 device="cpu", timeout_s=WORLD_TIMEOUT_S,
                                 threads=1)


@pytest.fixture(scope="module")
def serve_worlds(reference_proc, workdir):
    inp = _cached_inputs()
    return {ms: _world(workdir, f"serve{ms[0]}{ms[1]}", ranks.serve_world, 4,
                       ms, inp) for ms in SERVE_MESHES}


@pytest.fixture(scope="module")
def trained(reference_proc, workdir):
    return _world(workdir, "train", ranks.train_world, 4, _cached_inputs())


@pytest.fixture(scope="module")
def pods(reference_proc, workdir):
    return _world(workdir, "pods", ranks.pods_world, 8, _cached_inputs())


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _sub(flat: dict, prefix: str) -> dict:
    return ranks._tree(flat, prefix)


def _assert_close_tree(got: dict, want: dict, tol: float, what: str):
    gf, wf = _flat(got, "", {}), _flat(want, "", {})
    assert sorted(gf) == sorted(wf), what
    for k in gf:
        assert _rel(gf[k], wf[k]) <= tol, f"{what}{k}: {_rel(gf[k], wf[k])}"


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("arch_id", ranks.TP_ARCHS)
@pytest.mark.parametrize("ms", SERVE_MESHES, ids=["data2xmodel2",
                                                  "data1xmodel4"])
def test_prefill_matches_reference(serve_worlds, reference, ms, arch_id,
                                   impl):
    """The last logits, gathered to every rank, within 1e-4 of the
    reference's largest; the rank's caches (by KV heads) gathered within
    1e-5 of the reference's (its cache on the head dim)."""
    got = serve_worlds[ms][0]
    tag = "x".join(map(str, ms))
    logits = got[f"{arch_id}/prefill/{impl}/logits"]
    assert _rel(logits, reference[f"{tag}/{arch_id}/prefill/logits"]) <= \
        LOGIT_TOL
    cache = _sub(got, f"{arch_id}/prefill/{impl}/cache")
    want = _sub(reference, f"{tag}/{arch_id}/prefill/cache")
    for k in ("k", "v"):
        assert _rel(cache[k], want[k]) <= CACHE_TOL, k
    assert int(cache["length"]) == int(want["length"]) == ranks.PREFILL_SEQ


@pytest.mark.parametrize("arch_id", ranks.TP_ARCHS)
@pytest.mark.parametrize("ms", SERVE_MESHES, ids=["data2xmodel2",
                                                  "data1xmodel4"])
def test_decode_matches_reference(serve_worlds, reference, ms, arch_id):
    """3 greedy steps: tokens equal, the gathered caches within 1e-5."""
    got = serve_worlds[ms][0]
    tag = "x".join(map(str, ms))
    np.testing.assert_array_equal(got[f"{arch_id}/decode/tokens"],
                                  reference[f"{tag}/{arch_id}/decode/tokens"])
    cache = _sub(got, f"{arch_id}/decode/cache")
    want = _sub(reference, f"{tag}/{arch_id}/decode/cache")
    for k in ("k", "v"):
        assert _rel(cache[k], want[k]) <= CACHE_TOL, k
    assert int(cache["length"]) == int(want["length"])


# ---------------------------------------------------------------------------
# the six sharded reductions
# ---------------------------------------------------------------------------

def test_vocab_parallel_embedding(serve_worlds):
    """Each rank looks up only the tokens it owns: the sum over ``model``
    equals the unsharded lookup exactly, on every rank."""
    assert all(r["embed/err"] == 0.0 for r in serve_worlds[(2, 2)])


def test_vocab_parallel_cross_entropy(serve_worlds):
    """pmax/psum logsumexp and the owner's gold logit over two vocabulary
    shards equal the unsharded loss (a rank's own logsumexp is far off)."""
    got = serve_worlds[(2, 2)][0]
    inp = _cached_inputs()
    logits = inp["red/logits"].astype(np.float64)
    m = logits.max(-1, keepdims=True)
    logz = (m + np.log(np.exp(logits - m).sum(-1, keepdims=True)))[..., 0]
    gold = np.take_along_axis(logits, inp["red/labels"][..., None].astype(
        np.int64), -1)[..., 0]
    nll, mask = logz - gold, inp["red/mask"]
    want = float((nll * mask).sum() / mask.sum())
    assert abs(got["ce/got"] - want) <= 1e-5 * abs(want)
    assert abs(got["ce/want"] - want) <= 1e-5 * abs(want)


def test_masked_mean_over_the_global_batch(serve_worlds):
    """The data shards hold 16 and 6 unmasked tokens: the loss is the
    global masked mean, not the mean of the shards' means."""
    got = serve_worlds[(2, 2)][0]
    assert abs(got["ce/got"] - got["ce/want"]) <= 1e-6 * abs(got["ce/want"])
    assert abs(got["ce/mean_of_means"] - got["ce/want"]) > \
        1e-3 * abs(got["ce/want"])


def test_gradient_norm_counts_every_element_once(serve_worlds):
    """A leaf replicated over ``model`` (and one over ``data``) is not
    summed over the axis it is replicated on."""
    got = serve_worlds[(2, 2)][0]
    inp = _cached_inputs()
    want = np.sqrt(sum(float((inp[f"red/{k}"].astype(np.float64) ** 2).sum())
                       for k in ("w", "b", "e")))
    assert abs(got["norm/got"] - want) <= NORM_TOL * want
    assert abs(got["norm/want"] - want) <= NORM_TOL * want


def test_int8_scale_of_a_sharded_leaf(serve_worlds):
    """The scale is the whole leaf's (its peak lies on one shard), and
    every shard quantises with it."""
    got = serve_worlds[(2, 2)][0]
    assert got["int8/scale"] == got["int8/scale_whole"] == \
        np.float32(9.0) / np.float32(127.0)
    assert got["int8/q_equal"]


def test_argmax_ties_go_to_the_lowest_global_id(serve_worlds):
    """Rows 0 and 1 tie across the two vocabulary shards (shard 1's copy
    at a smaller local id); row 2's maximum is shard 1's alone."""
    got = serve_worlds[(2, 2)][0]
    tie = _cached_inputs()["red/tie"]
    want = np.argmax(tie, axis=-1)
    np.testing.assert_array_equal(got["argmax/got"], want)
    np.testing.assert_array_equal(want, [5, 5, 32 + 7])


# ---------------------------------------------------------------------------
# training: ZeRO-1 and FSDP on (data 2, model 2)
# ---------------------------------------------------------------------------

def _assert_state(got: dict, want: dict, grads: dict, what: str):
    """A train state after ``TRAIN_STEPS`` against the reference's: the
    step and counters exactly; the moments within ``GRAD_TOL`` (m) and
    2 x ``GRAD_TOL`` (v) of the leaf's max-abs; the params within
    2 x lr x steps everywhere (AdamW's largest move) and within
    ``GRAD_TOL`` of the leaf's max-abs wherever the first step's gradient
    is above 1e-3 of its leaf's max-abs.  Below that AdamW's normalised
    update m / (sqrt(v) + eps) turns the gradients' last bits into
    different steps of up to lr (qwen1.5's ``bk`` gradient is ~1e-9: a
    key bias shifts every score of a query by nearly the same amount)."""
    lr_steps = ranks.TRAIN_CFG["lr"] * ranks.TRAIN_STEPS
    gf, wf = _flat(got, "", {}), _flat(want, "", {})
    assert sorted(gf) == sorted(wf), what
    for k in gf:
        g, w = np.asarray(gf[k], np.float64), np.asarray(wf[k], np.float64)
        assert g.shape == w.shape, (what, k)
        if np.issubdtype(np.asarray(wf[k]).dtype, np.integer) or \
                k in ("/step", "/opt/count"):
            np.testing.assert_array_equal(g, w, err_msg=what + k)
            continue
        err = np.abs(g - w)
        peak = np.abs(w).max() + 1e-30
        if k.startswith("/opt/m/"):
            assert err.max() <= GRAD_TOL * peak, (what, k, err.max() / peak)
        elif k.startswith("/opt/v/"):
            assert err.max() <= 2 * GRAD_TOL * peak, (what, k)
        else:
            assert err.max() <= 2 * lr_steps, (what, k, err.max())
            gr = np.abs(np.asarray(grads["/" + k.split("/", 2)[2]], np.float64))
            live = gr > 1e-3 * gr.max()
            assert (err[live] <= GRAD_TOL * peak).all(), \
                (what, k, (err[live] / peak).max())


def _assert_metrics(got: dict, want: dict, prefix: str, wprefix: str):
    for i in range(ranks.TRAIN_STEPS):
        g, w = got[f"{prefix}/metrics/{i}"], _sub(want,
                                                   f"{wprefix}/metrics/{i}")
        for k in ("loss", "ce"):
            assert abs(g[k] - float(w[k])) <= LOSS_TOL * abs(float(w[k])), \
                (i, k, g[k], float(w[k]))
        assert abs(g["grad_norm"] - float(w["grad_norm"])) <= \
            NORM_TOL * float(w["grad_norm"]), (i, g["grad_norm"])
        assert g["lr"] == pytest.approx(float(w["lr"]), rel=1e-6)


@pytest.mark.parametrize("mode", [m[0] for m in ranks.TRAIN_MODES])
@pytest.mark.parametrize("arch_id", ranks.TP_ARCHS)
def test_train_matches_reference(trained, reference, arch_id, mode):
    """2 steps: loss, ce and grad_norm at each; the first step's
    gradients; the whole state after the second (module docstring)."""
    got = trained[0]
    prefix = f"{arch_id}/{mode}"
    _assert_metrics(got, reference, prefix, prefix)
    grads = _sub(got, f"{prefix}/grads")
    want = _sub(reference, f"{prefix}/grads")
    _assert_close_tree(grads, want, GRAD_TOL, prefix)
    _assert_state(_sub(got, f"{prefix}/state"),
                  _sub(reference, f"{prefix}/state"), _flat(want, "", {}),
                  prefix)


# ---------------------------------------------------------------------------
# (pod 2, data 2, model 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["central", "peer"])
def test_pod_policies_match_reference(pods, reference, name):
    """CLOUD_CENTRAL (the batch over ("pod", "data")) and PEER_FETCH (every
    leaf also sharded over ``pod``, gathered at use) against the
    reference's jitted steps."""
    got = pods[0]
    _assert_metrics(got, reference, f"pods/{name}", f"pods/{name}")
    _assert_close_tree(_sub(got, f"pods/{name}/grads"),
                       _sub(reference, f"pods/{name}/grads"), GRAD_TOL, name)
    _assert_state(_sub(got, f"pods/{name}/state"),
                  _sub(reference, f"pods/{name}/state"),
                  _flat(_sub(reference, f"pods/{name}/grads"), "", {}), name)


def test_replicated_pods_match_reference(pods, reference):
    """REPLICATED: each pod (4 ranks) steps on its own batch with no pod
    collective; pod p's state is the reference's stacked slice p."""
    want = _sub(reference, "pods/replicated/state")
    grads = _sub(reference, "pods/replicated/grads")
    for p, r in ((0, 0), (1, 4)):
        got = _sub(pods[r], f"pods/replicated{p}/state")
        pick = lambda t: jax.tree.map(lambda x: x[p], t)
        _assert_close_tree(_sub(pods[r], f"pods/replicated{p}/grads"),
                           pick(grads), GRAD_TOL, f"pod {p}")
        _assert_state(got, pick(want), _flat(pick(grads), "", {}),
                      f"pod {p}")
        for i in range(ranks.TRAIN_STEPS):
            m = pods[r][f"pods/replicated{p}/metrics/{i}"]
            w = reference[f"pods/replicated/metrics/{i}/loss"][p]
            assert abs(m["loss"] - float(w)) <= LOSS_TOL * abs(float(w))


@pytest.mark.parametrize("compress", [0, 1], ids=["f32", "int8"])
def test_replicate_step_per_shard_matches_reference(pods, reference,
                                                    compress):
    """The anti-entropy round shard by shard (int8: each scale the whole
    leaf's): both pods' params equal bit for bit after it, and within
    1e-5 of the reference's; the outer state too."""
    a = _sub(pods[0], f"pods/replicate{compress}/params0")
    b = _sub(pods[4], f"pods/replicate{compress}/params1")
    for (k, x), (_, y) in zip(sorted(_flat(a, "", {}).items()),
                              sorted(_flat(b, "", {}).items())):
        np.testing.assert_array_equal(x, y, err_msg=k)
    want = _sub(reference, f"pods/replicate{compress}/params")
    _assert_close_tree(a, jax.tree.map(lambda x: x[0], want), 1e-5, "params")
    outer = _sub(pods[0], f"pods/replicate{compress}/outer0")
    wouter = _sub(reference, f"pods/replicate{compress}/outer")
    _assert_close_tree({k: outer[k] for k in ("outer_params", "momentum")},
                       {k: wouter[k] for k in ("outer_params", "momentum")},
                       1e-5, "outer")


def test_sessions_on_a_pod_tensor_parallel_mesh(pods, reference):
    """Decode on (pod, data, model) with each pod's sessions on its 4
    ranks: tokens equal to the reference's; the backup ring per shard
    (pod 1's backup is pod 0's cache) and failover."""
    for p, r in ((0, 0), (1, 4)):
        got = pods[r]
        np.testing.assert_array_equal(got[f"pods/sess/tokens{p}"],
                                      reference["pods/sess/tokens"][:, p])
        for k in ("k", "v"):
            assert _rel(got[f"pods/sess/cache{p}/{k}"],
                        reference[f"pods/sess/cache/{k}"][p]) <= CACHE_TOL
    np.testing.assert_array_equal(pods[4]["pods/sess/backup1/k"],
                                  pods[0]["pods/sess/cache0/k"])
    np.testing.assert_array_equal(pods[0]["pods/sess/backup0/k"],
                                  pods[4]["pods/sess/cache1/k"])
    np.testing.assert_array_equal(pods[0]["pods/sess/restored0/k"],
                                  pods[0]["pods/sess/backup0/k"])
    np.testing.assert_array_equal(pods[4]["pods/sess/restored1/k"],
                                  pods[4]["pods/sess/cache1/k"])


def test_remesh_of_a_tensor_parallel_state(pods):
    """``degraded_mesh_config`` keeps the inner axes; ``remesh(old_mesh=)``
    gathers each shard on (pod 2, data 2, model 2) and cuts it on pod 0's
    (data 2, model 2): equal to pod 0's whole state cut there."""
    for r, got in enumerate(pods):
        assert tuple(got["remesh/degraded"][0]) == (2, 2)
        assert tuple(got["remesh/degraded"][1]) == ("data", "model")
        assert got["remesh/equal" if r < 4 else "remesh/outside_none"], r


def test_rank_batch_is_the_data_shard(serve_worlds):
    """``data.rank_batch`` is ``synthetic_batch`` of the rank's ``data``
    index."""
    assert all(r["rank_batch/equal"] for r in serve_worlds[(2, 2)])


def test_pod_replication_scenario_on_port_ranks(pods):
    """``tests/test_pod_replication.py`` on the port's 8 ranks: the pods
    diverge, one round makes them equal, the loss trends down."""
    got = pods[0]
    assert got["twin/divergence"] > 0
    assert got["twin/convergence"] == 0.0
    losses = got["twin/losses"]
    assert sum(losses[-5:]) / 5 < sum(losses[:5]) / 5, losses


# ---------------------------------------------------------------------------
# specs (no world)
# ---------------------------------------------------------------------------

class _PodMesh:
    """A shape-only stand-in of a (pod 2, data 2, model 2) mesh: both
    packages' spec rules read its axis sizes only."""
    shape = {"pod": 2, "data": 2, "model": 2}
    mesh_dim_names = None


def _spec_paths(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_spec_paths(tree[k], f"{pre}/{k}"))
        return out
    return {pre: tuple(tree)}


def test_peer_fetch_specs_match_reference():
    """``add_pod_axis_spec`` over a whole train state equals the
    reference's ``state_specs(peer_fetch_pod=True)``, leaf for leaf."""
    arch_p = ranks.tp_arch(tc, "internlm2-1.8b")
    arch_r = ranks.tp_arch(rc, "internlm2-1.8b")
    got = train.state_specs(
        train.state_shapes(arch_p, tc.ParallelConfig(optimizer="adamw")),
        arch_p, _PodMesh, tc.ParallelConfig(optimizer="adamw"),
        peer_fetch_pod=True)
    want = ref_train.state_specs(
        ref_train.state_shapes(arch_r, rc.ParallelConfig(optimizer="adamw")),
        arch_r, _PodMesh, rc.ParallelConfig(optimizer="adamw"),
        peer_fetch_pod=True)
    assert _spec_paths(got) == _spec_paths(want)


def test_session_cache_layout_is_by_kv_heads():
    """The tensor-parallel steps hold internlm2-1.8b's (L, B, S, 8, 128)
    cache by KV heads over ``model``; the reference's rule (the port's
    ``cache_partition_specs``, unchanged) puts it on the head dim."""
    from repro_torch.launch import serve
    from repro_torch.parallel import sharding as sh

    class Mesh:
        shape = (2, 2)
        mesh_dim_names = ("data", "model")
    arch = tc.get_arch("internlm2-1.8b")
    cache = zoo.init_cache(arch, 4, 64, device="meta")
    mine = serve.session_cache_specs(arch, Mesh, 4)
    theirs = sh.cache_partition_specs(cache, arch, Mesh, 4)
    assert tuple(mine["k"]) == (None, "data", None, "model", None)
    assert tuple(theirs["k"]) == (None, "data", None, None, "model")
    assert tuple(mine["length"]) == tuple(theirs["length"]) == ()
