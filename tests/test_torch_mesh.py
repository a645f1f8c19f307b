"""The port's mesh path on gloo worlds of CPU ranks, against the reference
under its forced host devices.

ONE reference subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=8``)
runs the reference's mesh cases on seeded numpy inputs and writes an
``.npz``; it starts first and runs while the port's worlds run.  Each
world is started by ``launch.mesh.spawn_world`` (spawned processes, one a
rank, gloo over a ``file://`` store under ``tmp_path``, one thread a rank,
a time limit on every wait); the rank bodies are in
``tests/torch_mesh_ranks.py``.  Bounds:

* flash-decode (reduced qwen1.5-110b, (data 2, model 2), S = 32 sharded on
  the sequence, ``length`` 5, where model shard 1 is wholly masked, and
  17): output within 1e-4 of the reference's and of the port's unsharded
  step (the reference test's own bound), the gathered caches equal to the
  unsharded step's bit for bit;
* ``moe_apply_ep`` (reduced kimi-k2, (2, 2)): output within 1e-4 and
  ``aux`` within 1e-6 of the reference's, without and with dropped
  assignments; every gradient leaf within 1e-4 of the leaf's max-abs of
  the reference's ``jax.grad`` (each rank holds its column's experts);
* ``replicate_pod_axis`` with pods one a rank (P = 4, and P = 2 on a
  sub-mesh of ranks 0 and 1; every replica kind; full and ring): bit for
  bit against the reference under ``shard_map`` and the port's stacked
  form;
* ``remesh`` from (2, 2, 2) to one pod: bit for bit;
* the pod-mesh train, replicate and session steps one pod a rank: equal
  to the port's stacked form bit for bit at P = 2, and to the reference's
  jitted steps on its (2, 2, 2) mesh within ``tests/test_torch_train.py``'s
  bounds (both packages in f32), greedy tokens equal.
"""
import dataclasses
import functools
import os
import pathlib
import subprocess
import sys
import textwrap
import zlib

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro import configs as rc
from repro.data import synthetic_batch as ref_batch
from repro.parallel import sharding as ref_sharding
from repro_torch import configs as tc
from repro_torch.core.carry import train_state_to_numpy
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import serve, train
from repro_torch.models import moe as moe_mod
from repro_torch.models import model_zoo as zoo
from repro_torch.parallel import sharding as sh
from repro_torch.runtime.elastic import degraded_mesh_config
from test_torch_train import GRAD_TOL, LOSS_TOL, _assert_state_close
from torch_parity import port_lockdep  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")

REPO = pathlib.Path(__file__).resolve().parents[1]
FD_TOL = 1e-4
EP_TOL = 1e-4
AUX_TOL = 1e-6
WORLD_TIMEOUT_S = 240.0
POD_KINDS = ("aligned", "unaligned", "lww", "mean", "max")
POD_CASES = [f"{k}:{t}:{p}" for k in POD_KINDS for t in ("full", "ring")
             for p in (2, 4)]

SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import functools
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.configs import (EnokiConfig, MeshConfig, ParallelConfig,
                               ReplicationPolicy, SHAPES_BY_NAME, TrainConfig,
                               get_arch, reduced, reduced_shape)
    from repro.core import replication as rep
    from repro.core.keygroup import TensorKeygroup
    from repro.core.store import Store
    from repro.launch import serve as S
    from repro.launch import train as T
    from repro.models import attention as A
    from repro.models import model_zoo as zoo
    from repro.models import moe as M
    from repro.optim import diloco_init
    from repro.parallel.sharding import named
    from repro.runtime.elastic import degraded_mesh_config, make_mesh, remesh

    # the reference's trainer and decode compute in bf16: hold both in f32
    zoo.lm_loss = functools.partial(zoo.lm_loss, compute_dtype=jnp.float32)
    zoo.decode_step = functools.partial(zoo.decode_step,
                                        compute_dtype=jnp.float32)
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

    devs = jax.devices()
    mesh22 = Mesh(np.array(devs[:4]).reshape(2, 2), ("data", "model"))

    # -- flash decode (reduced qwen1.5-110b)
    arch = reduced(get_arch("qwen1.5-110b"))
    ap, x1 = tree("fd/params"), jnp.asarray(data["fd/x1"])
    ck, cv = jnp.asarray(data["fd/ck"]), jnp.asarray(data["fd/cv"])
    for n in (5, 17):
        ln = jnp.asarray(n, jnp.int32)
        y, k, v = jax.jit(lambda ln: A.decode_self_attention_sharded(
            ap, x1, ck, cv, ln, arch, mesh22))(ln)
        out[f"fd/{n}/y"] = np.asarray(y)
        out[f"fd/{n}/k"] = np.asarray(k)

    # -- expert-parallel MoE (reduced kimi-k2)
    karch = reduced(get_arch("kimi-k2-1t-a32b"))
    mp, x = tree("ep/params"), jnp.asarray(data["ep/x"])
    for cap in (128, 1):
        f = jax.jit(lambda p, x: M.moe_apply_ep(p, x, karch, mesh22,
                                                cap_multiple=cap),
                    in_shardings=(None, NamedSharding(mesh22,
                                                      P("data", None, None))))
        y, aux = f(mp, x)
        out[f"ep/{cap}/y"], out[f"ep/{cap}/aux"] = np.asarray(y), float(aux)
    g = jax.grad(lambda p: M.moe_apply_ep(p, x, karch, mesh22)[0].sum())(mp)
    put("ep/grad", g)

    # -- replicate_pod_axis under shard_map, one pod a device
    ARENA = ("keys", "values", "lengths", "versions", "vv")
    for case in sorted({k.split("/")[1] for k in data if k.startswith("pod/")}):
        kind, topology, pods = case.split(":")
        pods = int(pods)
        leaf = lambda f: jnp.asarray(data[f"pod/{case}/{f}"])
        if kind in ("aligned", "unaligned"):
            state = Store(*(leaf(f) for f in ARENA))
            merge = (rep.merge_arena_aligned if kind == "aligned"
                     else rep.merge_arena)
        else:
            state = TensorKeygroup({"w": leaf("w"), "b": leaf("b")},
                                   leaf("version"), kind)
            merge = rep.merge_tensor
        mesh = Mesh(np.array(devs[:pods]), ("pod",))

        def body(s, merge=merge, pods=pods, topology=topology):
            mine = jax.tree.map(lambda x: x[0], s)
            new = rep.replicate_pod_axis(mine, merge, axis_name="pod",
                                         num_pods=pods, topology=topology)
            return jax.tree.map(lambda x: x[None], new)

        got = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("pod"),),
                                out_specs=P("pod"), check_rep=False))(state)
        if kind in ("aligned", "unaligned"):
            for f, x in zip(ARENA, got):
                out[f"pod/{case}/{f}"] = np.asarray(x)
        else:
            out[f"pod/{case}/w"] = np.asarray(got.tree["w"])
            out[f"pod/{case}/b"] = np.asarray(got.tree["b"])
            out[f"pod/{case}/version"] = np.asarray(got.version)

    # -- remesh (2, 2, 2) -> one pod
    full_cfg = MeshConfig(shape=(2, 2, 2), axes=("pod", "data", "model"))
    mesh = make_mesh(full_cfg)
    state = {"w": jnp.asarray(data["remesh/w"]),
             "stacked": jnp.asarray(data["remesh/stacked"])}
    specs = {"w": P(None, "model"), "stacked": P("pod", "data", None)}
    placed = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                          state, specs, is_leaf=lambda x: isinstance(x, P))
    moved = remesh(placed, specs, make_mesh(degraded_mesh_config(full_cfg, 1)))
    put("remesh/moved", moved)

    # -- the pod-mesh train and replicate steps (tests/test_pod_replication.py)
    mesh = Mesh(np.array(devs).reshape(2, 2, 2), ("pod", "data", "model"))
    tarch = reduced(get_arch("internlm2-1.8b"))
    shape = reduced_shape(SHAPES_BY_NAME["train_4k"])
    par = ParallelConfig(fsdp=False, remat="none", optimizer="adamw")
    cfg = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    single = tree("init")
    single["step"] = single["step"].astype(jnp.int32)
    policy = ReplicationPolicy.REPLICATED
    step, sshape, (sspecs, _) = T.make_train_step(
        tarch, shape, mesh, par, EnokiConfig(policy=policy), cfg, donate=False)
    st = jax.tree.map(lambda l: jnp.stack([l, l]), single)
    st = jax.tree.map(jax.device_put, st, named(mesh, sspecs))
    batch = lambda i: {k: jnp.asarray(data[f"pods/{i}/{k}"])
                       for k in ("tokens", "labels", "loss_mask")}
    for i in range(2):
        st, m = step(st, batch(i))
        put(f"pods/metrics/{i}", m)
    put("pods/state", st)
    for c in (0, 1):
        enoki = EnokiConfig(policy=policy, compress_deltas=bool(c))
        rstep, _, _ = T.make_replicate_step(tarch, mesh, par, enoki, sshape)
        s2, o2 = rstep(st, diloco_init(single["params"]))
        put(f"replicate{c}/params", s2["params"])
        put(f"replicate{c}/outer", o2)
    cstep, _, (cspecs, _) = T.make_train_step(
        tarch, shape, mesh, par,
        EnokiConfig(policy=ReplicationPolicy.CLOUD_CENTRAL), cfg, donate=False)
    cst = jax.tree.map(jax.device_put, single, named(mesh, cspecs))
    for i in range(2):
        b = {k: v.reshape((-1,) + v.shape[2:]) for k, v in batch(i).items()}
        cst, m = cstep(cst, b)
        put(f"central/metrics/{i}", m)
    put("central/state", cst)

    # -- sessions: decode, replicate, migrate on the pod axis
    import dataclasses
    dshape = dataclasses.replace(reduced_shape(SHAPES_BY_NAME["decode_32k"]),
                                 seq_len=32, global_batch=4)
    dstep, _, _ = S.make_decode_step(tarch, dshape, mesh, donate=False)
    params = tree("sess/params")
    sparams = jax.tree.map(lambda l: jnp.stack([l, l]), params)
    cache = tree("sess/cache")
    token = jnp.asarray(data["sess/token"])
    toks = []
    for _ in range(3):
        token, cache = dstep(sparams, cache, token)
        toks.append(np.asarray(token))
    out["sess/tokens"] = np.stack(toks)
    put("sess/cache", cache)
    rsess, _, _ = S.make_replicate_sessions_step(tarch, dshape, mesh)
    backup = rsess(cache)
    put("sess/backup", backup)
    mstep, _, _ = S.make_migrate_sessions_step(tarch, dshape, mesh)
    put("sess/restored", mstep(cache, backup, jnp.asarray([True, False])))
    np.savez(sys.argv[2], **out)
    print("MESH_REFERENCE_OK", len(out))
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


def _nest(flat: dict, prefix: str) -> dict:
    return ranks._tree(flat, prefix)


def _pod_replicas(kind, pods):
    return ranks.pod_replicas(kind, pods,
                              zlib.crc32(f"mesh{kind}{pods}".encode()))


def _inputs() -> dict:
    rng = np.random.default_rng(23)
    f32 = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(
        np.float32)
    inp = {}
    qa = tc.reduced(tc.get_arch("qwen1.5-110b"))
    d, H, KV, dh = qa.d_model, qa.num_heads, qa.num_kv_heads, \
        qa.resolved_head_dim
    sc = d ** -0.5
    for name, shape in (("wq", (d, H * dh)), ("wk", (d, KV * dh)),
                        ("wv", (d, KV * dh)), ("wo", (H * dh, d))):
        inp[f"fd/params/{name}"] = f32(*shape, scale=sc)
    for name, w in (("bq", H), ("bk", KV), ("bv", KV)):
        inp[f"fd/params/{name}"] = f32(w * dh, scale=0.1)
    inp["fd/x1"] = f32(2, 1, d, scale=0.1)
    inp["fd/ck"] = f32(2, 32, KV, dh, scale=0.5)
    inp["fd/cv"] = f32(2, 32, KV, dh, scale=0.5)

    ka = tc.reduced(tc.get_arch("kimi-k2-1t-a32b"))
    _flat(tree_np(moe_mod.moe_init(torch.Generator().manual_seed(0), ka)),
          "ep/params", inp)
    inp["ep/x"] = f32(4, 16, ka.d_model, scale=0.5)

    for case in POD_CASES:
        kind, _, pods = case.split(":")
        for f, x in _pod_replicas(kind, int(pods)).items():
            inp[f"pod/{case}/{f}"] = x

    inp["remesh/w"] = np.arange(64, dtype=np.float32).reshape(8, 8)
    inp["remesh/stacked"] = np.arange(32, dtype=np.float32).reshape(2, 4, 4)

    arch_t, _, par, _ = ranks._train_parts()
    _flat(train_state_to_numpy(train.init_state(arch_t, 0, par,
                                                device="cpu")), "init", inp)
    arch_r = rc.reduced(rc.get_arch(ranks.TRAIN_ARCH))
    shape_r = rc.reduced_shape(rc.SHAPES_BY_NAME["train_4k"])
    for i in range(2):
        pods = [jax.device_get(ref_batch(arch_r, shape_r, 0, i, shard=p,
                                         num_shards=2, batch_override=4))
                for p in range(2)]
        for k in pods[0]:
            inp[f"pods/{i}/{k}"] = np.stack([np.asarray(b[k]) for b in pods])

    _flat(tree_np(zoo.init_params(arch_t, seed=1, device="cpu")),
          "sess/params", inp)
    L, B, S = arch_t.num_layers, 2, 32
    for name in ("k", "v"):
        inp[f"sess/cache/{name}"] = f32(2, L, B, S, arch_t.num_kv_heads,
                                        arch_t.resolved_head_dim, scale=0.5)
    inp["sess/cache/length"] = np.array([5, 9], np.int32)
    inp["sess/token"] = rng.integers(0, arch_t.vocab_size,
                                     (2, B, 1)).astype(np.int32)
    return inp


def tree_np(tree):
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    return tree.detach().numpy()


@functools.lru_cache(maxsize=None)
def _cached_inputs():
    return _inputs()


# ---------------------------------------------------------------------------
# the reference (one subprocess, started first) and the port's worlds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh")


@pytest.fixture(scope="module")
def reference_proc(workdir):
    np.savez(workdir / "in.npz", **_cached_inputs())
    (workdir / "ref.py").write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, str(workdir / "ref.py"), str(workdir / "in.npz"),
         str(workdir / "out.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
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
    assert "MESH_REFERENCE_OK" in stdout
    out = np.load(workdir / "out.npz")
    return {k: out[k] for k in out.files}


def _world(workdir, name, fn, n, *args):
    store = workdir / f"{name}.store"
    return port_mesh.spawn_world(fn, n, f"file://{store}", args=args,
                                 device="cpu", timeout_s=WORLD_TIMEOUT_S,
                                 threads=1)


@pytest.fixture(scope="module")
def decode_ep(reference_proc, workdir):
    inp = _cached_inputs()
    sub = {k: v for k, v in inp.items() if k.startswith(("fd/", "ep/"))}
    return _world(workdir, "decode_ep", ranks.decode_and_ep, 4, sub)


@pytest.fixture(scope="module")
def pods(reference_proc, workdir):
    inp = _cached_inputs()
    cases = {c: {k.split("/")[2]: v for k, v in inp.items()
                 if k.startswith(f"pod/{c}/")} for c in POD_CASES}
    return _world(workdir, "pods", ranks.pod_replicate, 4, cases)


@pytest.fixture(scope="module")
def remeshed(reference_proc, workdir):
    inp = _cached_inputs()
    state = {"w": inp["remesh/w"], "stacked": inp["remesh/stacked"]}
    specs = {"w": (None, "model"), "stacked": ("pod", "data", None)}
    params = tree_np(zoo.init_params(tc.reduced(tc.get_arch(ranks.TRAIN_ARCH)),
                                     seed=2, device="cpu"))
    return _world(workdir, "remesh", ranks.remesh_world, 8, state, specs,
                  params), params


@pytest.fixture(scope="module")
def pod_steps(reference_proc, workdir):
    inp = _cached_inputs()
    init = _nest(inp, "init")
    batches = {k: v for k, v in inp.items() if k.startswith("pods/")}
    sess = {k[len("sess/"):]: v for k, v in inp.items()
            if k.startswith("sess/")}
    return _world(workdir, "pod_steps", ranks.pods_train_and_sessions, 2,
                  init, batches, sess)


# ---------------------------------------------------------------------------
# flash decode
# ---------------------------------------------------------------------------

def _max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) -
                        np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("length", ranks.FD_LENGTHS)
def test_flash_decode_matches_reference(decode_ep, reference, length):
    """Every rank's output within 1e-4 of the reference's flash decode and
    of the port's unsharded step, and the caches gathered over ``model``
    equal to the unsharded step's bit for bit.  At length 5 model shard 1
    holds no valid position: its partial softmax must vanish."""
    for r, out in enumerate(decode_ep):
        y = out[f"fd/{length}/y"]
        assert _max_err(y, reference[f"fd/{length}/y"]) < FD_TOL, r
        assert _max_err(y, out[f"fd/{length}/y_plain"]) < FD_TOL, r
        assert out[f"fd/{length}/caches_equal"], r
    assert np.array_equal(decode_ep[0][f"fd/{length}/y"],
                          decode_ep[3][f"fd/{length}/y"])


# ---------------------------------------------------------------------------
# expert-parallel MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", ranks.EP_CAPS)
def test_ep_moe_matches_reference(decode_ep, reference, cap):
    """Output within 1e-4 and aux within 1e-6 of the reference's
    ``moe_apply_ep`` on every rank; at ``cap_multiple=1`` (capacity 10 a
    data shard) assignments are dropped on both sides."""
    for r, out in enumerate(decode_ep):
        assert _max_err(out[f"ep/{cap}/y"], reference[f"ep/{cap}/y"]) < \
            EP_TOL, r
        assert abs(out[f"ep/{cap}/aux"] - float(reference[f"ep/{cap}/aux"])) \
            < AUX_TOL, r
    if cap == 1:    # drops change the output against the no-drop run
        assert _max_err(reference["ep/1/y"], reference["ep/128/y"]) > 1e-3


def test_ep_moe_matches_unsharded_without_drops(decode_ep):
    inp = _cached_inputs()
    arch = tc.reduced(tc.get_arch("kimi-k2-1t-a32b"))
    params = {k: torch.from_numpy(v) if not isinstance(v, dict) else
              {kk: torch.from_numpy(vv) for kk, vv in v.items()}
              for k, v in _nest(inp, "ep/params").items()}
    y, aux = moe_mod.moe_apply(params, torch.from_numpy(inp["ep/x"]), arch)
    for out in decode_ep:
        assert _max_err(out["ep/128/y"], y.numpy()) < EP_TOL
        assert abs(out["ep/128/aux"] - float(aux)) < AUX_TOL


@pytest.mark.parametrize("geometry", ["2x8", "1x7"])
def test_forward_seq_expert_parallel_on_a_mesh(decode_ep, geometry):
    """``forward_seq(mesh=..., moe_impl="ep")`` on each rank's shards
    runs each moe layer expert-parallel (the rank's vocabulary shard of the
    logits within 1e-4 and aux within 1e-6 of the unsharded "auto" run);
    with 7 tokens, which do not split over data 2, it falls back to the
    global dispatch and equals "auto" on the same mesh bit for bit (the
    reference's rule)."""
    for out in decode_ep:
        assert out[f"fwd/{geometry}/err"] < EP_TOL
        assert out[f"fwd/{geometry}/aux_diff"] < AUX_TOL
        if geometry == "1x7":
            assert out[f"fwd/{geometry}/equal"]


def test_flash_decode_step_equals_the_plain_step(decode_ep):
    """``make_decode_step(mesh=..., flash_decode=True)`` on the rank's
    sequence shard of the cache, f32, 3 steps: tokens, ``length`` and
    layer 0's cache equal the plain step's bit for bit, every layer's
    cache within 1e-4 (later layers' inputs carry the partial softmax's
    rounding)."""
    for out in decode_ep:
        assert out["fd_step/equal"]
        assert out["fd_step/cache_err"] < FD_TOL


def test_ep_moe_gradients_match_reference(decode_ep, reference):
    """Each rank's gradients (the router and shared expert whole, its
    column's experts) within 1e-4 of the leaf's max-abs of the reference's
    ``jax.grad`` of ``moe_apply_ep``: psum passes the cotangent through,
    the replicated inputs sum theirs (``parallel.collectives``)."""
    want = _nest(reference, "ep/grad")
    arch = tc.reduced(tc.get_arch("kimi-k2-1t-a32b"))
    e_local = arch.moe.num_experts // 2
    for r, out in enumerate(decode_ep):
        got = _nest(out, "ep/grad")
        lo = out["ep/lo"]
        for key in ("router", "w_gate", "w_up", "w_down"):
            w = want[key]
            if key != "router":
                w = w[lo:lo + e_local]
            scale = np.abs(want[key]).max()
            assert _max_err(got[key], w) <= GRAD_TOL * scale, (r, key)
        for key, w in want["shared"].items():
            assert _max_err(got["shared"][key], w) <= \
                GRAD_TOL * np.abs(w).max(), (r, key)


# ---------------------------------------------------------------------------
# pods one a rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", POD_CASES)
def test_pod_replicate_ranks_match_reference_and_stacked(pods, reference,
                                                         case):
    kind, topology, n = case.split(":")
    n = int(n)
    inp = _cached_inputs()
    got = [pods[r][case] for r in range(n)]
    for r in range(n):
        for f, x in got[r]["got"].items():
            want = reference[f"pod/{case}/{f}"][r]
            if kind == "mean" and f in ("w", "b"):
                np.testing.assert_allclose(x, want, rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(x, want, err_msg=f"{r} {f}")
            np.testing.assert_array_equal(x, got[0]["stacked"][f][r],
                                          err_msg=f"{r} {f} stacked")
            np.testing.assert_array_equal(got[r]["input_kept"][f],
                                          inp[f"pod/{case}/{f}"][r])
    if topology == "full":
        for r in range(1, n):
            for f in got[0]["got"]:
                np.testing.assert_array_equal(got[r]["got"][f],
                                              got[0]["got"][f])
    assert all(case not in pods[r] for r in range(n, 4))


# ---------------------------------------------------------------------------
# remesh
# ---------------------------------------------------------------------------

def test_remesh_keeps_every_leaf(remeshed, reference):
    """(pod 2, data 2, model 2) -> (data 2, model 2): the survivors' (pod
    0's) gathered leaves equal the state bit for bit, as the reference's
    moved arrays do; internlm2's params placed by ``param_partition_specs``
    (fsdp) come back equal; the lost pod's ranks get None."""
    results, _ = remeshed
    inp = _cached_inputs()
    for r, out in enumerate(results):
        assert out["degraded"] == ((2, 2), ("data", "model"))
        assert out["in_new_mesh"] == (r < 4)
        if r < 4:
            for k in ("w", "stacked"):
                np.testing.assert_array_equal(out["moved"][k],
                                              inp[f"remesh/{k}"])
                np.testing.assert_array_equal(out["moved"][k],
                                              reference[f"remesh/moved/{k}"])
            assert out["params_equal"]
            # ("pod", "data", None) loses "pod": dim 1 over data
            assert out["moved_placements"]["stacked"] == \
                "(Shard(dim=1), Replicate())"
        else:
            assert out["moved"] == {"w": None, "stacked": None}
    # w = P(None, "model"): rank 1 (model 1) holds columns 4..7
    np.testing.assert_array_equal(results[1]["local_w"],
                                  inp["remesh/w"][:, 4:])


def test_degraded_mesh_config_matches_reference():
    from repro.runtime.elastic import degraded_mesh_config as ref_degraded
    for cfg, alive in ((tc.MULTI_POD_MESH, 1), (tc.MULTI_POD_MESH, 2),
                       (tc.SINGLE_POD_MESH, 1)):
        got = degraded_mesh_config(cfg, alive)
        want = ref_degraded(rc.MeshConfig(cfg.shape, cfg.axes), alive)
        assert (got.shape, got.axes) == (want.shape, want.axes)
    with pytest.raises(ValueError, match="no pods left"):
        degraded_mesh_config(tc.MULTI_POD_MESH, 0)


# ---------------------------------------------------------------------------
# train, replicate and session steps, one pod a rank
# ---------------------------------------------------------------------------

def _equal_flat(a: dict, b: dict, prefix: str, what: str):
    keys = sorted(k for k in a if k.startswith(prefix + "/"))
    assert keys and keys == sorted(k for k in b if k.startswith(prefix + "/"))
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def _pod_slice(flat: dict, prefix: str, p: int) -> dict:
    return {k: v[p] for k, v in flat.items() if k.startswith(prefix + "/")}


def test_rank_train_steps_equal_stacked_bit_for_bit(pod_steps):
    stacked = pod_steps[0]["stacked"]
    for r, out in enumerate(pod_steps):
        _equal_flat(_pod_slice(stacked, "pods/state", r), out, "pods/state",
                    f"pod {r}")
    w0 = pod_steps[0]["pods/state/params/blocks/attn/wq"]
    assert np.abs(w0 - pod_steps[1]["pods/state/params/blocks/attn/wq"]
                  ).max() > 0, "pods must diverge between rounds"


@pytest.mark.parametrize("compress", [0, 1])
def test_rank_replicate_step_equals_stacked_and_converges(pod_steps,
                                                          compress):
    stacked = pod_steps[0]["stacked"]
    a, b = pod_steps
    _equal_flat(a, b, f"replicate{compress}/params", "pods after the round")
    _equal_flat(a, b, f"replicate{compress}/outer", "outer")
    _equal_flat(_pod_slice(stacked, f"replicate{compress}/params", 0), a,
                f"replicate{compress}/params", "against stacked")
    _equal_flat(stacked, a, f"replicate{compress}/outer", "outer stacked")


def test_rank_train_steps_match_reference(pod_steps, reference):
    arch_t = tc.reduced(tc.get_arch(ranks.TRAIN_ARCH))
    from repro_torch.core.carry import train_state_from_numpy
    for r, out in enumerate(pod_steps):
        for i in range(2):
            want = _nest(reference, f"pods/metrics/{i}")
            for k in ("loss", "ce", "lr", "grad_norm"):
                w = float(want[k][r])
                assert abs(out[f"pods/metrics/{i}"][k] - w) <= \
                    LOSS_TOL * abs(w), (r, i, k)
        got = _nest({k: v for k, v in out.items()
                     if k.startswith("pods/state/")}, "pods/state")
        ref = _nest(_pod_slice(reference, "pods/state", r), "pods/state")
        ref["step"] = ref["step"].astype(np.int32)
        got["step"] = np.asarray(got["step"], np.int32)
        _assert_state_close(train_state_from_numpy(arch_t, got, device="cpu"),
                            ref, 1e-3 * 2, f"pod {r}")


@pytest.mark.parametrize("compress", [0, 1])
def test_rank_replicate_step_matches_reference(pod_steps, reference,
                                               compress):
    """The round from each package's own pods: within the train bounds
    (the pods differ by the steps' tolerance before it)."""
    for r, out in enumerate(pod_steps):
        for k, v in out.items():
            if k.startswith(f"replicate{compress}/params/"):
                w = reference[k][r]
                assert _max_err(v, w) <= 2 * 1e-3 * 3, k
            elif k.startswith(f"replicate{compress}/outer/"):
                w = reference[k]
                assert _max_err(v, w) <= 2 * 1e-3 * 3, k


def test_cloud_central_over_pods_matches_reference(pod_steps, reference):
    """CLOUD_CENTRAL on a pod mesh averages the gradients over ``pod``: both
    ranks end equal, and equal to the reference's step over the pods'
    concatenated batch within the train bounds."""
    arch_t = tc.reduced(tc.get_arch(ranks.TRAIN_ARCH))
    from repro_torch.core.carry import train_state_from_numpy
    a, b = pod_steps
    _equal_flat(a, b, "central/state", "ranks")
    for i in range(2):
        want = _nest(reference, f"central/metrics/{i}")
        for k in ("loss", "ce", "lr", "grad_norm"):
            w = float(want[k])
            assert abs(a[f"central/metrics/{i}"][k] - w) <= LOSS_TOL * abs(w), \
                (i, k)
    got = _nest({k: v for k, v in a.items() if k.startswith("central/state/")},
                "central/state")
    ref = _nest(reference, "central/state")
    ref["step"] = ref["step"].astype(np.int32)
    got["step"] = np.asarray(got["step"], np.int32)
    _assert_state_close(train_state_from_numpy(arch_t, got, device="cpu"), ref,
                        1e-3 * 2, "central")


def test_sessions_ranks_equal_stacked_and_reference(pod_steps, reference):
    """Decode 3 steps, replicate (pod i's backup holds pod i - 1's
    sessions), pod 0 dead, migrate: every rank equals its pod of the
    stacked form bit for bit; tokens equal the reference's (f32 greedy),
    caches within 1e-5 of it."""
    stacked = pod_steps[0]["stacked"]
    for r, out in enumerate(pod_steps):
        np.testing.assert_array_equal(out["sess/tokens"],
                                      stacked["sess/tokens"][:, r])
        np.testing.assert_array_equal(out["sess/tokens"],
                                      reference["sess/tokens"][:, r])
        for part in ("cache", "backup", "restored"):
            _equal_flat(_pod_slice(stacked, f"sess/{part}", r), out,
                        f"sess/{part}", f"pod {r} {part}")
            for k, v in out.items():
                if k.startswith(f"sess/{part}/"):
                    assert _max_err(v, reference[k][r]) <= 1e-5, k
    a, b = pod_steps
    np.testing.assert_array_equal(b["sess/backup/k"], a["sess/cache/k"])
    np.testing.assert_array_equal(a["sess/restored/k"], a["sess/backup/k"])
    np.testing.assert_array_equal(b["sess/restored/k"], b["sess/cache/k"])


# ---------------------------------------------------------------------------
# what the mesh forms refuse
# ---------------------------------------------------------------------------

class _Inner:
    """Shape-only stand-in of a (pod 2, data 2, model 2) mesh (the
    factories read its axis sizes only)."""
    shape = (2, 2, 2)
    mesh_dim_names = ("pod", "data", "model")


class _DataModel:
    """Shape-only stand-in of a (data 2, model 2) mesh."""
    shape = (2, 2)
    mesh_dim_names = ("data", "model")


#: case -> (arch id, ParallelConfig changes): every family, ``seq_shard``
#: and Adafactor build
INNER_CASES = {"dense": ("internlm2-1.8b", {}),
               "moe": ("kimi-k2-1t-a32b", {}),
               "vlm": ("phi-3-vision-4.2b", {}),
               "hybrid": ("zamba2-7b", {}),
               "ssm": ("xlstm-350m", {}),
               "audio": ("whisper-tiny", {}),
               "seq_shard": ("internlm2-1.8b", {"seq_shard": True}),
               "adafactor": ("internlm2-1.8b", {"optimizer": "adafactor"})}
#: case -> reduced-arch changes: the reduced kimi-k2 keeps one KV head
#: (its 8:1 ratio at 4 heads), which model = 2 cannot split
INNER_ARCH_CHANGES = {"moe": {"num_kv_heads": 2}}


@pytest.mark.parametrize("case", sorted(INNER_CASES))
def test_inner_axes_build_every_family(case):
    """On a mesh whose ``data``/``model`` axes are > 1 every family's
    factories build their tensor-parallel steps, Adafactor's too, and
    ``seq_shard=True``: its prefill (``make_prefill_step(parallel=)``), and
    a train step whose specs and batch axes are those without it, leaf by
    leaf (the flag cuts only a prefill's sequence;
    ``tests/test_torch_seq_shard.py`` steps both on ranks)."""
    arch_id, changes = INNER_CASES[case]
    arch = dataclasses.replace(tc.reduced(tc.get_arch(arch_id)),
                               **INNER_ARCH_CHANGES.get(case, {}))
    shape = tc.reduced_shape(tc.SHAPES_BY_NAME["train_4k"])
    pshape = tc.reduced_shape(tc.SHAPES_BY_NAME["prefill_32k"])
    par = tc.ParallelConfig(**changes)
    calls = [lambda: train.make_train_step(arch, shape, parallel=par,
                                           device="cpu", mesh=_Inner)]
    if case == "seq_shard":
        calls.append(lambda: serve.make_prefill_step(
            arch, pshape, device="cpu", mesh=_DataModel, parallel=par))
    elif case != "adafactor":
        calls += [
            lambda: train.make_replicate_step(arch, 2, par, tc.EnokiConfig(),
                                              device="cpu", mesh=_Inner),
            lambda: serve.make_decode_step(arch, device="cpu", mesh=_Inner),
            lambda: serve.make_prefill_step(arch, pshape, device="cpu",
                                            mesh=_DataModel)]
    for call in calls:
        got = call()
        assert callable(got[0] if isinstance(got, tuple) else got)
    if case == "seq_shard":
        on, _ = calls[0]()
        off, _ = train.make_train_step(
            arch, shape, parallel=dataclasses.replace(par, seq_shard=False),
            device="cpu", mesh=_Inner)
        assert on.batch_axes == off.batch_axes
        assert _spec_paths(on.specs) == _spec_paths(off.specs)


def _spec_paths(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _spec_paths(tree[key], f"{path}/{key}").items()}
    return {path: tuple(tree)}


def test_world_needs_the_card_unless_told_and_mesh_needs_a_world(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mesh.init_world(0, 1, "file:///nonexistent/store")
    with pytest.raises(RuntimeError, match="no world"):
        port_mesh.make_mesh_compat((1,), ("pod",))


def test_mesh_of_the_wrong_size_raises(workdir):
    got = _world(workdir, "wrong", ranks.wrong_size, 2)
    assert all("needs 3 ranks" in g for g in got)


def test_a_failing_rank_fails_the_world(workdir):
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        _world(workdir, "fails", ranks.fail_on_one, 2)


def test_specs_map_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    class M:
        mesh_dim_names = ("pod", "data", "model")
    spec = sh.P(("pod", "data"), None, "model")
    assert sh.placements(M, spec) == [Shard(0), Shard(0), Shard(2)]
    assert sh.placements(M, sh.P()) == [Replicate()] * 3
    assert sh.named(M, {"a": spec, "b": {"c": sh.P(None, "data")}}) == {
        "a": [Shard(0), Shard(0), Shard(2)],
        "b": {"c": [Replicate(), Shard(1), Replicate()]}}
    assert sh.strip_axes(spec, {"data", "model"}) == sh.P("data", None,
                                                          "model")
    assert tuple(ref_sharding.P(("pod", "data"), None, "model")) == \
        tuple(spec)


def test_transport_is_picked_from_backend_and_device(monkeypatch):
    """A CUDA tensor crosses a gloo group through a host buffer; a CPU
    tensor, or NCCL, moves as it is: chosen from the group's backend and
    the tensor's device, never by catching an error."""
    from repro_torch.parallel import collectives as col

    class Card:
        is_cuda = True

    class Host:
        is_cuda = False

    for cfg, card_staged in (("cpu:gloo,cuda:gloo", True), ("gloo", True),
                             ("cpu:gloo,cuda:nccl", False), ("nccl", False)):
        monkeypatch.setattr(col.dist, "get_backend_config",
                            lambda group, cfg=cfg: cfg)
        assert col.staged(None, Card()) is card_staged, cfg
        assert col.staged(None, Host()) is False, cfg
