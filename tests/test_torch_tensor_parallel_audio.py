"""The port's tensor-parallel steps of the audio family (whisper-tiny) on
gloo worlds of CPU ranks, against the reference's jitted steps on the same
meshes of forced host devices, each at a vocabulary that ``model``
divides (512) and at one it does not (515: every rank then holds the whole
embedding and head, the reference's divisibility guard, as for
whisper-tiny's 51,865); and the dense family at that odd vocabulary.

ONE reference subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=16``)
runs, in f32 compute, the reduced whisper-tiny (2 encoder and 2 decoder
layers, d 128, 4 heads of 32, 8 frames) through ``make_prefill_step`` and
3 steps of ``make_decode_step`` from its cache on (data 2, model 2) and
(data 1, model 4), ``make_train_step`` on (data 2, model 2) with AdamW
ZeRO-1 (remat "block"), AdamW FSDP (remat "full") and Adafactor, and on
(pod 2, data 2, model 2) two REPLICATED steps and one anti-entropy round;
and internlm2's TP config at vocabulary 515 (prefill, decode and ZeRO-1 on
(2, 2)).  Its serving and training of the first vocabulary and of the
rest take four disjoint quarters of its devices at once (four threads),
then each vocabulary's pods half of them.  It starts first and runs while
the port's worlds run (rank bodies in ``tests/torch_tp_audio_ranks.py``)
on the same numpy inputs: one world of 4 ranks for both serving meshes and
the training and one of 8 for the pods, started at once.  The norm scales
are perturbed from their zero init.  Bounds, as for the dense family
(``tests/test_torch_tensor_parallel.py``): prefill logits 1e-4 of the
reference's largest (REFERENCE, and FLASH: the kernel's plain version on
the CPU), every cache leaf gathered 1e-5; decode tokens equal; train loss,
ce and ``grad_norm`` 1e-5 relative, the first step's gradients 1e-4 of
each leaf's max-abs, the state after 2 steps (AdamW's bounds of the dense
family, Adafactor's of the moe family); pods bit-identical after the
round and within 1e-5 of the reference's.

A mutant shows the checks see a rank-local cross-attention: ``wo`` of the
cross-attention without its ``psum`` over ``model``.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest

import torch_tp_audio_ranks as ranks
from repro_torch import configs as tc
from repro_torch.core.carry import train_state_to_numpy
from repro_torch.launch import train
from repro_torch.models import model_zoo as zoo
from repro_torch.models import transformer
from test_torch_tensor_parallel import (LOGIT_TOL, _assert_close_tree,
                                        _assert_metrics, _assert_state, _flat,
                                        _np, _rel, _sub, _train_batch)
from test_torch_tensor_parallel_families import _assert_adafactor_state
from test_torch_tensor_parallel_hybrid import (_assert_cache, stop_reference,
                                               world)
from test_torch_train import GRAD_TOL, LOSS_TOL
from torch_parity import port_lockdep  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")

REPO = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = """
import os, sys, json
# LLVM's cheaper passes: compiling, not running, is this script's time
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=16 "
                           "--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true")
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


def arch_of(case):
    if case == "dense":
        d = cfg["dense"]
        return dataclasses.replace(rc.reduced(rc.get_arch(d["arch"])),
                                   vocab_size=d["vocab"], **d["changes"])
    return dataclasses.replace(rc.reduced(rc.get_arch(cfg["arch"])),
                               vocab_size=int(case))


pshape = shape_of("prefill_32k", *cfg["prefill"])
dshape = shape_of("decode_32k", *cfg["prefill"])
tshape = shape_of("train_4k", *cfg["train"])
tcfg = TrainConfig(**cfg["train_cfg"])
devs = jax.devices()


def batches(prefix):
    keys = [k for k in ("tokens", "labels", "loss_mask", "frame_embeds")
            if f"{prefix}/0/{k}" in data]
    return [{k: data[f"{prefix}/{i}/{k}"] for k in keys}
            for i in range(cfg["train_steps"])]


def init_of(prefix):
    st = tree(prefix)
    st["step"] = st["step"].astype(np.int32)
    st["opt"]["count"] = st["opt"]["count"].astype(np.int32)
    return st


def serve_part(cases, devs):
    for case in cases:
        arch = arch_of(case)
        params = tree(f"{case}/params")
        prompt = {k: data[f"{case}/prompt/{k}"]
                  for k in ("tokens", "frame_embeds")
                  if f"{case}/prompt/{k}" in data}
        for ms in cfg["serve_meshes"]:
            if case == "dense" and ms != [2, 2]:
                continue
            mesh = Mesh(np.array(devs).reshape(ms), ("data", "model"))
            tag = "x".join(map(str, ms))
            step, _, _ = S.make_prefill_step(
                arch, pshape, mesh, ParallelConfig(remat="none", fsdp=False),
                impl=AttnImpl.REFERENCE)
            logits, cache = step(params, prompt)
            out[f"{tag}/{case}/prefill/logits"] = np.asarray(logits)
            put(f"{tag}/{case}/prefill/cache", cache)
            dstep, _, _ = S.make_decode_step(arch, dshape, mesh,
                                             donate=False)
            token, toks = data[f"{case}/dtoken"], []
            for _ in range(cfg["decode_steps"]):
                token, cache = dstep(params, cache, token)
                toks.append(np.asarray(token))
            out[f"{tag}/{case}/decode/tokens"] = np.stack(toks)
            put(f"{tag}/{case}/decode/cache", cache)


def train_part(cases, devs):
    mesh = Mesh(np.array(devs).reshape(2, 2), ("data", "model"))
    for case in cases:
        arch = arch_of(case)
        bs = batches(f"{case}/batch")
        modes = ["adamw_zero1"] if case == "dense" else cfg["train_modes"]
        for name in modes:
            opt, fsdp, remat = cfg["train_modes"][name]
            par = ParallelConfig(fsdp=fsdp, zero1=True, remat=remat,
                                 optimizer=opt)
            step, _, (sspecs, _) = T.make_train_step(
                arch, tshape, mesh, par, EnokiConfig(), tcfg, donate=False)
            st = jax.tree.map(jax.device_put, init_of(f"{case}/init/{opt}"),
                              named(mesh, sspecs))
            for i, b in enumerate(bs):
                st, m = step(st, b)
                put(f"{case}/{name}/metrics/{i}", m)
            put(f"{case}/{name}/state", st)
        grad = jax.jit(jax.grad(lambda p, b: zoo.lm_loss(arch, p, b)[0]))
        put(f"{case}/grads", grad(tree(f"{case}/init/adamw/params"), bs[0]))


def pods_part(cases, devs):
    mesh = Mesh(np.array(devs).reshape(2, 2, 2), ("pod", "data", "model"))
    par = ParallelConfig(fsdp=False, zero1=True, remat="none",
                         optimizer="adamw")
    enoki = EnokiConfig(policy=ReplicationPolicy.REPLICATED)
    for case in cases:
        arch = arch_of(case)
        step, sshape, (sspecs, _) = T.make_train_step(
            arch, tshape, mesh, par, enoki, tcfg, donate=False)
        init = init_of(f"{case}/init/adamw")
        st = jax.tree.map(lambda l: np.stack([l, l]), init)
        st = jax.tree.map(jax.device_put, st, named(mesh, sspecs))
        for i, b in enumerate(batches(f"{case}/pods/batch")):
            st, m = step(st, b)
            put(f"{case}/pods/replicated/metrics/{i}", m)
        put(f"{case}/pods/replicated/state", st)
        st = dict(st, params=jax.tree.map(
            jax.device_put, tree(f"{case}/pods/rstate"),
            named(mesh, sspecs["params"])))
        rstep, _, _ = T.make_replicate_step(arch, mesh, par, enoki, sshape)
        s2, o2 = rstep(st, diloco_init(init["params"]))
        put(f"{case}/pods/replicate/params", s2["params"])
        put(f"{case}/pods/replicate/outer", o2)


errors = []


def run(part, cases, devs):
    try:
        part(cases, devs)
    except BaseException:
        import traceback
        errors.append(traceback.format_exc())


def in_parallel(jobs):
    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[0]


# serving and training, the first case and the rest, on four disjoint
# quarters of the 16 devices at once; then each case's pods on a half
first, rest = cfg["cases"][:1], cfg["cases"][1:]
in_parallel([(serve_part, first, devs[0:4]), (serve_part, rest, devs[4:8]),
             (train_part, first, devs[8:12]),
             (train_part, rest, devs[12:16])])
in_parallel([(pods_part, [case], devs[8 * i:8 * i + 8])
             for i, case in enumerate(cfg["pod_cases"])])
np.savez(sys.argv[2], **out)
print("TP_AUDIO_REFERENCE_OK", len(out))
"""


# ---------------------------------------------------------------------------
# seeded inputs (numpy), the same for both packages
# ---------------------------------------------------------------------------

_INPUTS: dict = {}


def _frames(rng, arch, b) -> np.ndarray:
    return (0.02 * rng.standard_normal((b, arch.num_patches, arch.d_model))
            ).astype(np.float32)


def inputs() -> dict:
    """Every case's serving params, prompts (with frames) and decode
    tokens, its AdamW and Adafactor train states (one params tree), its
    train batches and, for whisper, each pod's batches and the pods'
    params moved apart; made once a process."""
    if _INPUTS:
        return _INPUTS
    rng = np.random.default_rng(27)
    inp = {}
    for j, case in enumerate(ranks.CASES):
        arch = ranks.arch_of(tc, case)
        audio = case != "dense"
        _flat(ranks.perturb(_np(zoo.init_params(arch, seed=10 + j,
                                                device="cpu")), rng),
              f"{case}/params", inp)
        inp[f"{case}/prompt/tokens"] = rng.integers(0, arch.vocab_size, (
            ranks.PREFILL_BATCH, ranks.PREFILL_SEQ)).astype(np.int32)
        if audio:
            inp[f"{case}/prompt/frame_embeds"] = _frames(
                rng, arch, ranks.PREFILL_BATCH)
        inp[f"{case}/dtoken"] = rng.integers(
            0, arch.vocab_size, (ranks.PREFILL_BATCH, 1)).astype(np.int32)
        tparams = ranks.perturb(_np(zoo.init_params(arch, seed=20 + j,
                                                    device="cpu")), rng)
        for opt in ("adamw", "adafactor"):
            st = train_state_to_numpy(train.init_state(
                arch, 20, tc.ParallelConfig(optimizer=opt), device="cpu"))
            st["params"] = tparams
            _flat(st, f"{case}/init/{opt}", inp)
        for i in range(ranks.TRAIN_STEPS):
            b = _train_batch(rng, arch, ranks.TRAIN_BATCH, ranks.TRAIN_SEQ)
            if audio:
                b["frame_embeds"] = _frames(rng, arch, ranks.TRAIN_BATCH)
            for k, v in b.items():
                inp[f"{case}/batch/{i}/{k}"] = v
            if not audio:
                continue
            pods = [_train_batch(rng, arch, 2, ranks.TRAIN_SEQ)
                    for _ in range(2)]
            for p in pods:
                p["frame_embeds"] = _frames(rng, arch, 2)
            for k in pods[0]:
                inp[f"{case}/pods/batch/{i}/{k}"] = np.stack([p[k]
                                                              for p in pods])
        if audio:
            pre = f"{case}/init/adamw/params/"
            for key in [k for k in inp if k.startswith(pre)]:
                leaf = inp[key]             # two pods' params apart
                inp[f"{case}/pods/rstate/" + key[len(pre):]] = np.stack([
                    leaf + 0.01 * rng.standard_normal(leaf.shape).astype(
                        np.float32) for _ in range(2)])
    _INPUTS.update(inp)
    return _INPUTS


def ref_cfg() -> dict:
    return {"arch": ranks.ARCH, "cases": list(ranks.CASES),
            "pod_cases": list(ranks.CASES[:len(ranks.VOCABS)]),
            "dense": {"arch": ranks.DENSE_ARCH, "vocab": ranks.DENSE_VOCAB,
                      "changes": ranks.TP_CHANGES[ranks.DENSE_ARCH]},
            "serve_meshes": [list(m) for m in ranks.SERVE_MESHES],
            "prefill": [ranks.PREFILL_SEQ, ranks.PREFILL_BATCH],
            "train": [ranks.TRAIN_SEQ, ranks.TRAIN_BATCH],
            "train_cfg": ranks.TRAIN_CFG, "train_steps": ranks.TRAIN_STEPS,
            "train_modes": ranks.TRAIN_MODES,
            "decode_steps": ranks.DECODE_STEPS}


# ---------------------------------------------------------------------------
# the reference (one subprocess, started first) and the port's worlds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("tp_audio")


@pytest.fixture(scope="module")
def reference_proc(workdir):
    np.savez(workdir / "in.npz", **inputs())
    (workdir / "ref.py").write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, str(workdir / "ref.py"), str(workdir / "in.npz"),
         str(workdir / "out.npz"), json.dumps(ref_cfg())], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    stop_reference(proc)


@pytest.fixture(scope="module")
def reference(reference_proc, workdir):
    try:
        stdout, stderr = reference_proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        reference_proc.kill()
        raise
    assert reference_proc.returncode == 0, \
        f"STDOUT:\n{stdout}\nSTDERR:\n{stderr[-4000:]}"
    assert "TP_AUDIO_REFERENCE_OK" in stdout
    out = np.load(workdir / "out.npz")
    return {k: out[k] for k in out.files}


@pytest.fixture(scope="module")
def worlds(reference_proc, workdir):
    """``{"four": rank 0's four_ranks, "pods": every rank's pods_world}``,
    the two worlds started at once."""
    out, errors = {}, []

    path = str(workdir / "in.npz")          # the reference's inputs

    def pods():
        try:
            out["pods"] = world(workdir, "pods", ranks.pods_world, 8, path)
        except BaseException as e:          # re-raised below
            errors.append(e)
    t = threading.Thread(target=pods)
    t.start()
    try:
        out["four"] = world(workdir, "four", ranks.four_ranks, 4, path)[0]
    finally:
        t.join()
    if errors:
        raise errors[0]
    return out


@pytest.fixture(scope="module")
def four(worlds):
    return worlds["four"]


VOCAB_IDS = [f"vocab{v}" for v in ranks.VOCABS]
AUDIO = [str(v) for v in ranks.VOCABS]
MESH_IDS = ["x".join(map(str, m)) for m in ranks.SERVE_MESHES]


def check_prefill(got: dict, reference: dict, ms, case: str, impl: str):
    tag = "x".join(map(str, ms))
    assert _rel(got[f"{case}/prefill/{impl}/logits"],
                reference[f"{tag}/{case}/prefill/logits"]) <= LOGIT_TOL
    _assert_cache(_sub(got, f"{case}/prefill/{impl}/cache"),
                  _sub(reference, f"{tag}/{case}/prefill/cache"),
                  f"{tag} {case} {impl}")


def check_decode(got: dict, reference: dict, ms, case: str):
    tag = "x".join(map(str, ms))
    np.testing.assert_array_equal(got[f"{case}/decode/tokens"],
                                  reference[f"{tag}/{case}/decode/tokens"])
    _assert_cache(_sub(got, f"{case}/decode/cache"),
                  _sub(reference, f"{tag}/{case}/decode/cache"),
                  f"{tag} {case} decode")


def check_train(got: dict, reference: dict, case: str, mode: str):
    """Metrics, the first step's gradients (every leaf), the state after
    the steps."""
    prefix = f"{case}/{mode}"
    _assert_metrics(got, reference, prefix, prefix)
    grads = _sub(reference, f"{case}/grads")
    _assert_close_tree(_sub(got, f"{prefix}/grads"), grads, GRAD_TOL, prefix)
    gflat = _flat(grads, "", {})
    opt = ranks.TRAIN_MODES[mode][0]
    if opt == "adamw":
        _assert_state(_sub(got, f"{prefix}/state"),
                      _sub(reference, f"{prefix}/state"), gflat, prefix)
    else:
        init = _sub(inputs(), f"{case}/init/{opt}")["params"]
        _assert_adafactor_state(_sub(got, f"{prefix}/state"),
                                _sub(reference, f"{prefix}/state"),
                                _flat(init, "", {}), gflat, prefix)


@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("case", AUDIO, ids=VOCAB_IDS)
@pytest.mark.parametrize("ms", ranks.SERVE_MESHES, ids=MESH_IDS)
def test_prefill_matches_reference(four, reference, ms, case, impl):
    """The last logits, gathered to every rank (whole on every rank at
    the odd vocabulary), within 1e-4 of the reference's largest; every
    cache leaf gathered (the decoder's and the encoder output's K/V by KV
    heads) within 1e-5 of the reference's."""
    check_prefill(four["serve"][ms], reference, ms, case, impl)


@pytest.mark.parametrize("case", AUDIO, ids=VOCAB_IDS)
@pytest.mark.parametrize("ms", ranks.SERVE_MESHES, ids=MESH_IDS)
def test_decode_matches_reference(four, reference, ms, case):
    """3 greedy steps from the prefill's cache (``greedy_sharded`` over
    the vocabulary shards, the plain argmax of whole logits at the odd
    vocabulary): tokens equal, the gathered caches within 1e-5."""
    check_decode(four["serve"][ms], reference, ms, case)


@pytest.mark.parametrize("mode", sorted(ranks.TRAIN_MODES))
@pytest.mark.parametrize("case", AUDIO, ids=VOCAB_IDS)
def test_train_matches_reference(four, reference, case, mode):
    """2 steps on (data 2, model 2) with the batch's frames split over
    ``data``: loss, ce and grad_norm at each, the first step's gradients
    (every leaf), the state after (module docstring)."""
    check_train(four["train"], reference, case, mode)


@pytest.mark.parametrize("case", AUDIO, ids=VOCAB_IDS)
def test_replicated_round_matches_reference(worlds, reference, case):
    """(pod 2, data 2, model 2): each pod's REPLICATED steps as the
    reference's slice, then one anti-entropy round: the pods' params bit
    for bit equal, and within 1e-5 of the reference's, the outer state
    too."""
    pods = worlds["pods"]
    for p, r in ((0, 0), (1, 4)):
        got = pods[r]
        pick = lambda t: jax.tree.map(lambda x: x[p], t)
        for i in range(ranks.TRAIN_STEPS):
            m = got[f"{case}/pods/replicated{p}/metrics/{i}"]
            w = reference[f"{case}/pods/replicated/metrics/{i}/loss"][p]
            assert abs(m["loss"] - float(w)) <= LOSS_TOL * abs(float(w))
        grads = _flat(_sub(got, f"{case}/pods/replicated{p}/grads"), "", {})
        _assert_state(_sub(got, f"{case}/pods/replicated{p}/state"),
                      pick(_sub(reference, f"{case}/pods/replicated/state")),
                      grads, f"pod {p}")
    a = _flat(_sub(pods[0], f"{case}/pods/replicate/params0"), "", {})
    b = _flat(_sub(pods[4], f"{case}/pods/replicate/params1"), "", {})
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    want = _sub(reference, f"{case}/pods/replicate/params")
    _assert_close_tree(_sub(pods[0], f"{case}/pods/replicate/params0"),
                       jax.tree.map(lambda x: x[0], want), 1e-5, "params")
    outer = _sub(pods[0], f"{case}/pods/replicate/outer0")
    wouter = _sub(reference, f"{case}/pods/replicate/outer")
    _assert_close_tree({k: outer[k] for k in ("outer_params", "momentum")},
                       {k: wouter[k] for k in ("outer_params", "momentum")},
                       1e-5, "outer")


@pytest.mark.parametrize("part", ["prefill", "decode", "train"])
def test_dense_family_at_an_odd_vocabulary(four, reference, part):
    """internlm2's TP config at vocabulary 515 on (data 2, model 2): the
    embedding and head whole on every rank, the loss's cross-entropy over
    whole logits; prefill (REFERENCE and FLASH), decode and ZeRO-1 steps
    as the reference's."""
    got, ms = four["serve"][(2, 2)], (2, 2)
    if part == "prefill":
        for impl in ("reference", "flash"):
            check_prefill(got, reference, ms, "dense", impl)
    elif part == "decode":
        check_decode(got, reference, ms, "dense")
    else:
        check_train(four["train"], reference, "dense", "adamw_zero1")


def test_cross_attention_without_psum_is_seen(four, reference):
    """Cross-attention's ``wo`` left without its ``psum``: each rank keeps
    its heads' part, and the logits move far past the bound the real step
    keeps."""
    case = ranks.CASES[0]
    got = four["serve"][(2, 2)][f"mutant/{case}/cross_psum/logits"]
    assert _rel(got, reference[f"2x2/{case}/prefill/logits"]) > \
        100 * LOGIT_TOL


def test_init_cache_holds_the_rank_part(four):
    """``init_cache(mesh=)`` gives the shapes of the rank's whisper cache
    (``session_cache_specs``' cut: the four K/V leaves by KV heads) on
    both meshes."""
    for ms in ranks.SERVE_MESHES:
        for case in AUDIO:
            assert four["serve"][ms][f"{case}/init_cache/same_shapes"], \
                (ms, case)


def test_whisper_splits_and_its_vocabulary_stays_whole():
    """``check_tp_split``: whisper-tiny splits at model 2 with its 51,865
    (odd) vocabulary whole on every rank; its 6 heads over model 4 raise
    ``ValueError`` naming the query heads."""
    arch = tc.get_arch(ranks.ARCH)
    transformer.check_tp_split(arch, 2)

    class Model2:
        shape = (2,)
        mesh_dim_names = ("model",)

        def size(self, i):
            return 2
    assert not transformer.vocab_split(arch, Model2())
    assert transformer.vocab_split(dataclasses.replace(arch,
                                                       vocab_size=51864),
                                   Model2())
    with pytest.raises(ValueError, match="query heads"):
        transformer.check_tp_split(arch, 4)
