"""The port's tensor-parallel steps of the hybrid family (zamba2) on gloo
worlds of CPU ranks, against the reference's jitted steps on the same
meshes of forced host devices.

ONE reference subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=8``)
runs, in f32 compute, the reduced zamba2 (5 layers: 2 groups of 2 Mamba-2
layers with the shared attention and MLP block, then a tail layer; d 128,
8 SSM heads of 32, 4 attention heads) through ``make_prefill_step`` and 3
steps of ``make_decode_step`` from its cache on (data 2, model 2) and
(data 1, model 4) (4 and 2 SSM heads a rank), ``make_train_step`` on
(data 2, model 2) with AdamW ZeRO-1 (remat "block"), AdamW FSDP (remat
"full") and Adafactor, and on (pod 2, data 2, model 2) two REPLICATED
steps and one anti-entropy round.  Its serving and training take disjoint
halves of its devices at once (two threads; programs that share a device
could wait on each other's collectives), then the pods all 8.  It
starts first and runs while the port's worlds run (rank bodies in
``tests/torch_tp_recurrent_ranks.py``) on the same numpy inputs: one world
of 4 ranks for both serving meshes and the training and one of 8 for the
pods, started at once.  The norm scales, A, D, the dt bias and the gate biases are
perturbed from their constant init, so a head or a column cut in the
wrong place shows.  Bounds, as for the dense family
(``tests/test_torch_tensor_parallel.py``):

* prefill logits within 1e-4 of the reference's largest (REFERENCE, and
  FLASH: the kernels' plain versions on the CPU); every cache leaf
  gathered within 1e-5 of its largest; decode: greedy tokens equal, the
  caches within 1e-5;
* train: loss and ce within 1e-5 relative at each step, ``grad_norm``
  within 1e-5 relative, every leaf of the first step's gradients within
  1e-4 of its max-abs, and the state after 2 steps (AdamW's bounds of
  the dense family; Adafactor's of the moe family, its factors held to
  ``FACTOR_TOL``);
* pods: each pod's steps as the reference's slice; the round, from two
  pods' params moved apart by the same numbers in both packages, leaves
  the pods' params equal bit for bit and within 1e-5 of the reference's.

Two mutants show the checks can see the traps of the Mamba-2 layer on
ranks: a gated norm whose mean square is the rank's own d_inner columns'
(the prefill's logits), and B and C fed to the rank's heads without
``vary`` (``w_B``, ``w_C``, ``conv_B`` and ``conv_C`` then get the rank's
heads' share of their gradient).
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import threading

import jax
import numpy as np
import pytest

import torch_tp_recurrent_ranks as ranks
from repro_torch import configs as tc
from repro_torch.core.carry import train_state_to_numpy
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import train
from repro_torch.models import model_zoo as zoo
from repro_torch.models import transformer
from test_torch_tensor_parallel import (CACHE_TOL, LOGIT_TOL,
                                        _assert_close_tree, _assert_metrics,
                                        _assert_state, _flat, _np, _rel,
                                        _sub, _train_batch)
from test_torch_tensor_parallel_families import _assert_adafactor_state
from test_torch_train import GRAD_TOL, LOSS_TOL
from torch_parity import port_lockdep  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD_TIMEOUT_S = 300.0
FAMILY = "hybrid"
#: Adafactor's factors after 2 steps, of each leaf's max-abs: means of
#: squared gradients, so twice the gradients' bound (as AdamW's second
#: moments are held); xlstm 1e-3: its sLSTM leaves' second gradients read
#: the first Adafactor update through 32 steps of the exponential input
#: gate (the sLSTM ``r`` factor read 2.2e-4 against a 2e-4 bound, where
#: every first-step gradient held 1e-4)
FACTOR_TOL = {"hybrid": 2 * GRAD_TOL, "ssm": 10 * GRAD_TOL}

SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, functools, threading
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

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
                node[last] = np.asarray(v)
        return t

    def put(prefix, t):
        for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]:
            key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                           for p in path)
            out[f"{prefix}/{key}" if key else prefix] = np.asarray(leaf)

    def shape_of(name, seq, batch):
        return dataclasses.replace(rc.reduced_shape(rc.SHAPES_BY_NAME[name]),
                                   seq_len=seq, global_batch=batch)

    arch = rc.reduced(rc.get_arch(cfg["arch"]))
    pshape = shape_of("prefill_32k", *cfg["prefill"])
    dshape = shape_of("decode_32k", *cfg["prefill"])
    tshape = shape_of("train_4k", *cfg["train"])
    tcfg = TrainConfig(**cfg["train_cfg"])
    devs = jax.devices()
    keys = ("tokens", "labels", "loss_mask")

    def batches(prefix):
        return [{k: data[f"{prefix}/{i}/{k}"] for k in keys}
                for i in range(cfg["train_steps"])]

    def init_of(prefix):
        st = tree(prefix)
        st["step"] = st["step"].astype(np.int32)
        st["opt"]["count"] = st["opt"]["count"].astype(np.int32)
        return st

    def serve_part():
        params = tree("params")
        for ms in cfg["serve_meshes"]:
            mesh = Mesh(np.array(devs[:4]).reshape(ms), ("data", "model"))
            tag = "x".join(map(str, ms))
            step, _, _ = S.make_prefill_step(
                arch, pshape, mesh, ParallelConfig(remat="none", fsdp=False),
                impl=AttnImpl.REFERENCE)
            logits, cache = step(params, {"tokens": data["prompt"]})
            out[f"{tag}/prefill/logits"] = np.asarray(logits)
            put(f"{tag}/prefill/cache", cache)
            dstep, _, _ = S.make_decode_step(arch, dshape, mesh,
                                             donate=False)
            token, toks = data["dtoken"], []
            for _ in range(cfg["decode_steps"]):
                token, cache = dstep(params, cache, token)
                toks.append(np.asarray(token))
            out[f"{tag}/decode/tokens"] = np.stack(toks)
            put(f"{tag}/decode/cache", cache)

    def train_part():
        mesh = Mesh(np.array(devs[4:8]).reshape(2, 2), ("data", "model"))
        bs = batches("batch")
        for name, (opt, fsdp, remat) in cfg["train_modes"].items():
            par = ParallelConfig(fsdp=fsdp, zero1=True, remat=remat,
                                 optimizer=opt)
            step, _, (sspecs, _) = T.make_train_step(
                arch, tshape, mesh, par, EnokiConfig(), tcfg, donate=False)
            st = jax.tree.map(jax.device_put, init_of(f"init/{opt}"),
                              named(mesh, sspecs))
            for i, b in enumerate(bs):
                st, m = step(st, b)
                put(f"{name}/metrics/{i}", m)
            put(f"{name}/state", st)
        grad = jax.jit(jax.grad(lambda p, b: zoo.lm_loss(arch, p, b)[0]))
        put("grads", grad(tree("init/adamw/params"), bs[0]))

    def pods_part():
        mesh = Mesh(np.array(devs).reshape(2, 2, 2),
                    ("pod", "data", "model"))
        par = ParallelConfig(fsdp=False, zero1=True, remat="none",
                             optimizer="adamw")
        enoki = EnokiConfig(policy=ReplicationPolicy.REPLICATED)
        step, sshape, (sspecs, _) = T.make_train_step(
            arch, tshape, mesh, par, enoki, tcfg, donate=False)
        init = init_of("init/adamw")
        st = jax.tree.map(lambda l: np.stack([l, l]), init)
        st = jax.tree.map(jax.device_put, st, named(mesh, sspecs))
        for i, b in enumerate(batches("pods/batch")):
            st, m = step(st, b)
            put(f"pods/replicated/metrics/{i}", m)
        put("pods/replicated/state", st)
        st = dict(st, params=jax.tree.map(jax.device_put, tree("pods/rstate"),
                                          named(mesh, sspecs["params"])))
        rstep, _, _ = T.make_replicate_step(arch, mesh, par, enoki, sshape)
        s2, o2 = rstep(st, diloco_init(init["params"]))
        put("pods/replicate/params", s2["params"])
        put("pods/replicate/outer", o2)

    # the inputs stay numpy until a step takes them
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
    pods_part()
    np.savez(sys.argv[2], **out)
    print("TP_RECURRENT_REFERENCE_OK", len(out))
""")


# ---------------------------------------------------------------------------
# seeded inputs (numpy), the same for both packages
# ---------------------------------------------------------------------------

_INPUTS: dict = {}


def family_inputs(family: str) -> dict:
    """The serving params, prompts and decode tokens, the AdamW and
    Adafactor train states (one params tree), the train batches and each
    pod's batches, made once a process."""
    if family in _INPUTS:
        return _INPUTS[family]
    rng = np.random.default_rng({"hybrid": 26, "ssm": 27}[family])
    arch = ranks.family_arch(tc, family)
    inp = {}
    _flat(ranks.perturb(_np(zoo.init_params(arch, seed=10, device="cpu")),
                        rng), "params", inp)
    inp["prompt"] = rng.integers(0, arch.vocab_size, (
        ranks.PREFILL_BATCH, ranks.PREFILL_SEQ)).astype(np.int32)
    inp["dtoken"] = rng.integers(0, arch.vocab_size,
                                 (ranks.PREFILL_BATCH, 1)).astype(np.int32)
    tparams = ranks.perturb(_np(zoo.init_params(arch, seed=20,
                                                device="cpu")), rng)
    for opt in ("adamw", "adafactor"):
        st = train_state_to_numpy(train.init_state(
            arch, 20, tc.ParallelConfig(optimizer=opt), device="cpu"))
        st["params"] = tparams
        _flat(st, f"init/{opt}", inp)
    for i in range(ranks.TRAIN_STEPS):
        for k, v in _train_batch(rng, arch, ranks.TRAIN_BATCH,
                                 ranks.TRAIN_SEQ).items():
            inp[f"batch/{i}/{k}"] = v
        pods = [_train_batch(rng, arch, 2, ranks.TRAIN_SEQ) for _ in range(2)]
        for k in pods[0]:
            inp[f"pods/batch/{i}/{k}"] = np.stack([p[k] for p in pods])
    for key in [k for k in inp if k.startswith("init/adamw/params/")]:
        leaf = inp[key]                     # two pods' params apart
        inp["pods/rstate/" + key[len("init/adamw/params/"):]] = np.stack([
            leaf + 0.01 * rng.standard_normal(leaf.shape).astype(np.float32)
            for _ in range(2)])
    _INPUTS[family] = inp
    return inp


def ref_cfg(family: str) -> dict:
    return {"arch": ranks.ARCHS[family],
            "serve_meshes": [list(m) for m in ranks.SERVE_MESHES[family]],
            "prefill": [ranks.PREFILL_SEQ, ranks.PREFILL_BATCH],
            "train": [ranks.TRAIN_SEQ, ranks.TRAIN_BATCH],
            "train_cfg": ranks.TRAIN_CFG, "train_steps": ranks.TRAIN_STEPS,
            "train_modes": ranks.TRAIN_MODES,
            "decode_steps": ranks.DECODE_STEPS}


def start_reference(workdir, family: str):
    np.savez(workdir / "in.npz", **family_inputs(family))
    (workdir / "ref.py").write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, str(workdir / "ref.py"), str(workdir / "in.npz"),
         str(workdir / "out.npz"), json.dumps(ref_cfg(family))], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def stop_reference(proc):
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def reference_out(proc, workdir) -> dict:
    try:
        stdout, stderr = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, \
        f"STDOUT:\n{stdout}\nSTDERR:\n{stderr[-4000:]}"
    assert "TP_RECURRENT_REFERENCE_OK" in stdout
    out = np.load(workdir / "out.npz")
    return {k: out[k] for k in out.files}


def world(workdir, name, fn, n, *args):
    store = workdir / f"{name}.store"
    return port_mesh.spawn_world(fn, n, f"file://{store}", args=args,
                                 device="cpu", timeout_s=WORLD_TIMEOUT_S,
                                 threads=1)


def run_worlds(workdir, family: str) -> dict:
    """``{"four": rank 0's four_ranks, "pods": every rank's pods_world}``:
    the 4-rank and the 8-rank worlds started at once (a thread waits on
    the second), both beside the reference subprocess, so their process
    starts overlap."""
    inp, out, errors = family_inputs(family), {}, []

    def pods():
        try:
            out["pods"] = world(workdir, "pods", ranks.pods_world, 8, family,
                                inp)
        except BaseException as e:          # re-raised below
            errors.append(e)
    t = threading.Thread(target=pods)
    t.start()
    try:
        out["four"] = world(workdir, "four", ranks.four_ranks, 4, family,
                            inp)[0]
    finally:
        t.join()
    if errors:
        raise errors[0]
    return out


# ---------------------------------------------------------------------------
# the checks, shared with tests/test_torch_tensor_parallel_ssm.py
# ---------------------------------------------------------------------------

def _assert_cache(got: dict, want: dict, what: str):
    """Every leaf of a gathered cache: integers (positions, length)
    exactly, the rest within ``CACHE_TOL`` of the leaf's max-abs."""
    gf, wf = _flat(got, "", {}), _flat(want, "", {})
    assert sorted(gf) == sorted(wf), what
    for k in gf:
        if np.issubdtype(wf[k].dtype, np.integer):
            np.testing.assert_array_equal(gf[k], wf[k], err_msg=what + k)
        else:
            assert _rel(gf[k], wf[k]) <= CACHE_TOL, (what, k,
                                                     _rel(gf[k], wf[k]))


def check_prefill(got: dict, reference: dict, ms, impl: str):
    tag = "x".join(map(str, ms))
    assert _rel(got[f"prefill/{impl}/logits"],
                reference[f"{tag}/prefill/logits"]) <= LOGIT_TOL
    _assert_cache(_sub(got, f"prefill/{impl}/cache"),
                  _sub(reference, f"{tag}/prefill/cache"), f"{tag} {impl}")
    assert int(got[f"prefill/{impl}/cache/length"]) == ranks.PREFILL_SEQ


def check_decode(got: dict, reference: dict, ms):
    tag = "x".join(map(str, ms))
    np.testing.assert_array_equal(got["decode/tokens"],
                                  reference[f"{tag}/decode/tokens"])
    _assert_cache(_sub(got, "decode/cache"),
                  _sub(reference, f"{tag}/decode/cache"), f"{tag} decode")


def check_train(got: dict, reference: dict, family: str, mode: str):
    """Metrics, the first step's gradients (every leaf), the state after
    the steps."""
    _assert_metrics(got, reference, mode, mode)
    grads = _sub(reference, "grads")
    _assert_close_tree(_sub(got, f"{mode}/grads"), grads, GRAD_TOL, mode)
    gflat = _flat(grads, "", {})
    opt = ranks.TRAIN_MODES[mode][0]
    if opt == "adamw":
        _assert_state(_sub(got, f"{mode}/state"),
                      _sub(reference, f"{mode}/state"), gflat, mode)
    else:
        init = _sub(family_inputs(family), f"init/{opt}")["params"]
        _assert_adafactor_state(_sub(got, f"{mode}/state"),
                                _sub(reference, f"{mode}/state"),
                                _flat(init, "", {}), gflat, mode,
                                factor_tol=FACTOR_TOL[family])


def check_pods(pods: list, reference: dict):
    """Each pod's REPLICATED steps as the reference's slice p (metrics and
    state, the port's first-step gradients marking the live elements);
    after the round (from ``pods/rstate``) the two pods' params equal bit
    for bit, and within 1e-5 of the reference's, the outer state too."""
    grads = None
    for p, r in ((0, 0), (1, 4)):
        got = pods[r]
        pick = lambda t: jax.tree.map(lambda x: x[p], t)
        for i in range(ranks.TRAIN_STEPS):
            m = got[f"pods/replicated{p}/metrics/{i}"]
            w = reference[f"pods/replicated/metrics/{i}/loss"][p]
            assert abs(m["loss"] - float(w)) <= LOSS_TOL * abs(float(w))
        state = _sub(got, f"pods/replicated{p}/state")
        want = pick(_sub(reference, "pods/replicated/state"))
        grads = _flat(_sub(got, f"pods/replicated{p}/grads"), "", {})
        _assert_state(state, want, grads, f"pod {p}")
    a = _flat(_sub(pods[0], "pods/replicate/params0"), "", {})
    b = _flat(_sub(pods[4], "pods/replicate/params1"), "", {})
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    want = _sub(reference, "pods/replicate/params")
    _assert_close_tree(_sub(pods[0], "pods/replicate/params0"),
                       jax.tree.map(lambda x: x[0], want), 1e-5, "params")
    outer = _sub(pods[0], "pods/replicate/outer0")
    wouter = _sub(reference, "pods/replicate/outer")
    _assert_close_tree({k: outer[k] for k in ("outer_params", "momentum")},
                       {k: wouter[k] for k in ("outer_params", "momentum")},
                       1e-5, "outer")


# ---------------------------------------------------------------------------
# the reference (one subprocess, started first) and the port's worlds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("tp_hybrid")


@pytest.fixture(scope="module")
def reference_proc(workdir):
    proc = start_reference(workdir, FAMILY)
    yield proc
    stop_reference(proc)


@pytest.fixture(scope="module")
def reference(reference_proc, workdir):
    return reference_out(reference_proc, workdir)


@pytest.fixture(scope="module")
def worlds(reference_proc, workdir):
    return run_worlds(workdir, FAMILY)


@pytest.fixture(scope="module")
def four(worlds):
    return worlds["four"]


@pytest.fixture(scope="module")
def pods(worlds):
    return worlds["pods"]


MESHES = ranks.SERVE_MESHES[FAMILY]
MESH_IDS = ["x".join(map(str, m)) for m in MESHES]


@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("ms", MESHES, ids=MESH_IDS)
def test_prefill_matches_reference(four, reference, ms, impl):
    """The last logits, gathered to every rank, within 1e-4 of the
    reference's largest; every cache leaf gathered (the Mamba-2 windows
    and states by d_inner and SSM heads, the shared block's ring by KV
    heads) within 1e-5 of the reference's."""
    check_prefill(four["serve"][ms], reference, ms, impl)


@pytest.mark.parametrize("ms", MESHES, ids=MESH_IDS)
def test_decode_matches_reference(four, reference, ms):
    """3 greedy steps from the prefill's cache: tokens equal, the gathered
    caches within 1e-5."""
    check_decode(four["serve"][ms], reference, ms)


@pytest.mark.parametrize("mode", sorted(ranks.TRAIN_MODES))
def test_train_matches_reference(four, reference, mode):
    """2 steps on (data 2, model 2): loss, ce and grad_norm at each, the
    first step's gradients (every leaf ``tp_view`` cuts among them), the
    state after (module docstring)."""
    check_train(four["train"], reference, FAMILY, mode)


def test_replicated_round_matches_reference(pods, reference):
    """(pod 2, data 2, model 2): each pod's REPLICATED steps, then one
    anti-entropy round (module docstring)."""
    check_pods(pods, reference)


def test_rank_local_gated_norm_is_seen(four, reference):
    """A gated norm over the rank's own d_inner columns moves the logits
    far past the bound the real one keeps."""
    got = four["serve"][(2, 2)]["mutant/local_norm/logits"]
    assert _rel(got, reference["2x2/prefill/logits"]) > 100 * LOGIT_TOL


def test_b_and_c_without_vary_are_seen(four, reference):
    """B and C fed to the rank's heads without ``vary``: the gradients of
    ``w_B``, ``w_C``, ``conv_B`` and ``conv_C`` (blocks and tail) miss the
    other rank's heads' share, far past the bound the real step keeps."""
    got = _sub(four["train"], "mutant/no_vary/grads")
    want = _sub(reference, "grads")
    for stack in ("blocks", "tail"):
        for name in ranks.SHARED_FOR_HEADS:
            err = _rel(got[stack]["mamba"][name], want[stack]["mamba"][name])
            assert err > 100 * GRAD_TOL, (stack, name, err)


def test_splits_the_hybrid_and_ssm_families_check():
    """``check_tp_split``: zamba2-7b and xlstm-350m split at model 2 and 4;
    the reduced xlstm's sLSTM feed-forward (170) does not split by 4, and
    SSM heads that model does not divide raise."""
    for arch_id in ("zamba2-7b", "xlstm-350m"):
        for model in (2, 4):
            transformer.check_tp_split(tc.get_arch(arch_id), model)
    xl = ranks.family_arch(tc, "ssm")
    transformer.check_tp_split(xl, 2)
    with pytest.raises(ValueError, match="sLSTM d_ff"):
        transformer.check_tp_split(xl, 4)
    import dataclasses
    z = ranks.family_arch(tc, "hybrid")
    odd = dataclasses.replace(z, ssm=dataclasses.replace(z.ssm, head_dim=64,
                                                         expand=3))
    with pytest.raises(ValueError, match="SSM heads"):
        transformer.check_tp_split(odd, 4)


def test_init_cache_holds_the_rank_part(four):
    """``init_cache(mesh=)`` gives the shapes of the rank's prefill cache
    (``session_cache_specs``' cut) on both meshes."""
    for ms in MESHES:
        assert four["serve"][ms]["init_cache/same_shapes"], ms
