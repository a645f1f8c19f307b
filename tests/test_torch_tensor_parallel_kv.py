"""The port's tensor parallelism where ``model`` exceeds the KV heads
(Megatron's replicated KV heads: each group of ``rep = model / KV``
consecutive ranks of ``model`` holds one KV head whole, gathered from the
specs' column shards over the group) on gloo worlds of CPU ranks, against
the reference's jitted steps on the same meshes of forced host devices,
where GSPMD splits a head's columns and reshards them.

ONE reference subprocess (32 forced host devices, four threads on
disjoint devices) runs, in f32 compute, each case of
``torch_tp_kv_ranks.CASES`` at model = 4: the reduced internlm2 (KV 2:
rep 2), qwen1.5-110b (KV 1: rep 4, with qkv biases) and grok-1 (moe, KV
1) as they are, and phi-3-vision (KV 2), zamba2 (its shared block, KV 1)
and whisper-tiny (self- and cross-attention, KV 2) with their KV heads
lowered: ``make_prefill_step`` and 3 steps of ``make_decode_step`` from
its cache on (data 1, model 4) and (data 2, model 4), and
``make_train_step`` on (data 2, model 4) with AdamW ZeRO-1 (remat
"block") and FSDP (remat "full") for the dense cases and one of them a
family elsewhere.  The port's worlds (rank bodies in
``tests/torch_tp_kv_ranks.py``: 4 ranks for (1, 4); 8 for (2, 4) and the
training) run beside it on the same numpy inputs, the norm scales and
biases perturbed.  Bounds, the tensor-parallel tests' own:

* prefill logits within 1e-4 of the reference's largest (REFERENCE, and
  FLASH: the kernel's plain version on the CPU), and the prefill under
  ``seq_shard`` on (2, 4) against the reference's prefill on that mesh
  (its program computes what it computes without the flag,
  ``tests/test_torch_seq_shard.py``); every cache leaf, gathered from the
  groups' leaders, within 1e-5 of its max-abs (integers exactly);
* every group's copies of a cache leaf bit for bit equal;
* decode: greedy tokens equal, caches as above;
* train: loss, ce and ``grad_norm`` within 1e-5 relative at each of 2
  steps, the first step's gradients within 1e-4 of each leaf's max-abs,
  and the state after (``tests/test_torch_tensor_parallel.py``'s bounds).

A mutant shows the train check sees the group gather's transpose: its
cotangent sliced to the rank's columns instead of reduce-scattered over
the group (each ``wk``/``wv`` shard then gets one rank's share).
"""
import json
import os
import pathlib
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest

import torch_tp_kv_ranks as ranks
from repro_torch import configs as tc
from repro_torch.core.carry import train_state_to_numpy
from repro_torch.launch import train
from repro_torch.models import model_zoo as zoo
from repro_torch.models import transformer
from repro_torch.parallel import sharding as sh
from test_torch_tensor_parallel import (LOGIT_TOL, _assert_close_tree,
                                        _assert_metrics,
                                        _assert_state, _flat, _np, _rel,
                                        _sub, _train_batch)
from test_torch_tensor_parallel_hybrid import (_assert_cache, stop_reference,
                                               world)
from test_torch_train import GRAD_TOL
from torch_parity import port_lockdep  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")

REPO = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = """
import os, sys, json
# LLVM's cheaper passes: compiling, not running, is this script's time
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=32 "
                           "--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true")
import dataclasses, functools, threading
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from repro import configs as rc
from repro.configs import AttnImpl, EnokiConfig, ParallelConfig, TrainConfig
from repro.launch import serve as S
from repro.launch import train as T
from repro.models import model_zoo as zoo
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
    arch_id, changes = cfg["cases"][case]
    return dataclasses.replace(rc.reduced(rc.get_arch(arch_id)), **changes)


pshape = shape_of("prefill_32k", *cfg["prefill"])
dshape = shape_of("decode_32k", *cfg["prefill"])
tshape = shape_of("train_4k", *cfg["train"])
tcfg = TrainConfig(**cfg["train_cfg"])
devs = jax.devices()


def serve_part(ms, devs):
    mesh = Mesh(np.array(devs).reshape(ms), ("data", "model"))
    tag = "x".join(map(str, ms))
    for case in cfg["cases"]:
        arch = arch_of(case)
        params = tree(f"{case}/params")
        step, _, _ = S.make_prefill_step(
            arch, pshape, mesh, ParallelConfig(remat="none", fsdp=False),
            impl=AttnImpl.REFERENCE)
        logits, cache = step(params, tree(f"{case}/prompt"))
        out[f"{tag}/{case}/prefill/logits"] = np.asarray(logits)
        put(f"{tag}/{case}/prefill/cache", cache)
        dstep, _, _ = S.make_decode_step(arch, dshape, mesh, donate=False)
        token, toks = data[f"{case}/dtoken"], []
        for _ in range(cfg["decode_steps"]):
            token, cache = dstep(params, cache, token)
            toks.append(np.asarray(token))
        out[f"{tag}/{case}/decode/tokens"] = np.stack(toks)
        put(f"{tag}/{case}/decode/cache", cache)


def train_part(cases, devs):
    mesh = Mesh(np.array(devs).reshape(2, cfg["model"]), ("data", "model"))
    for case in cases:
        arch = arch_of(case)
        bs = [tree(f"{case}/batch/{i}") for i in range(cfg["train_steps"])]
        for name in cfg["train_cases"][case]:
            fsdp, remat = cfg["train_modes"][name]
            par = ParallelConfig(fsdp=fsdp, zero1=True, remat=remat,
                                 optimizer="adamw")
            step, _, (sspecs, _) = T.make_train_step(
                arch, tshape, mesh, par, EnokiConfig(), tcfg, donate=False)
            st = tree(f"{case}/init")
            st["step"] = st["step"].astype(np.int32)
            st["opt"]["count"] = st["opt"]["count"].astype(np.int32)
            st = jax.tree.map(jax.device_put, st, named(mesh, sspecs))
            for i, b in enumerate(bs):
                st, m = step(st, b)
                put(f"{case}/{name}/metrics/{i}", m)
            put(f"{case}/{name}/state", st)
        grad = jax.jit(jax.grad(lambda p, b: zoo.lm_loss(arch, p, b)[0]))
        put(f"{case}/grads", grad(tree(f"{case}/init/params"), bs[0]))


errors = []


def run(part, *args):
    try:
        part(*args)
    except BaseException:
        import traceback
        errors.append(traceback.format_exc())


model = cfg["model"]
cases = list(cfg["train_cases"])
jobs = [(serve_part, [1, model], devs[0:model]),
        (serve_part, [2, model], devs[model:3 * model]),
        (train_part, cases[:len(cases) // 2], devs[16:16 + 2 * model]),
        (train_part, cases[len(cases) // 2:], devs[24:24 + 2 * model])]
threads = [threading.Thread(target=run, args=job) for job in jobs]
for t in threads:
    t.start()
for t in threads:
    t.join()
assert not errors, errors[0]
np.savez(sys.argv[2], **out)
print("TP_KV_REFERENCE_OK", len(out))
"""


# ---------------------------------------------------------------------------
# seeded inputs (numpy), the same for both packages
# ---------------------------------------------------------------------------

_INPUTS: dict = {}
STUBS = {"clip_patches": "patch_embeds", "audio_frames": "frame_embeds"}


def _stub(rng, arch, b) -> dict:
    """The vlm's patch or whisper's frame embeddings of ``b`` rows."""
    name = STUBS.get(arch.frontend_stub)
    if name is None:
        return {}
    return {name: (0.02 * rng.standard_normal(
        (b, arch.num_patches, arch.d_model))).astype(np.float32)}


def inputs() -> dict:
    """Every case's serving params, prompt and decode tokens, its AdamW
    train state and batches; made once a process."""
    if _INPUTS:
        return _INPUTS
    rng = np.random.default_rng(29)
    inp = {}
    B, S = ranks.PREFILL_BATCH, ranks.PREFILL_SEQ
    for j, case in enumerate(ranks.CASES):
        arch = ranks.case_arch(tc, case)
        _flat(ranks.perturb(_np(zoo.init_params(arch, seed=10 + j,
                                                device="cpu")), rng),
              f"{case}/params", inp)
        prompt = {"tokens": rng.integers(0, arch.vocab_size, (B, S)).astype(
            np.int32), **_stub(rng, arch, B)}
        _flat(prompt, f"{case}/prompt", inp)
        inp[f"{case}/dtoken"] = rng.integers(0, arch.vocab_size,
                                             (B, 1)).astype(np.int32)
        st = train_state_to_numpy(train.init_state(
            arch, 20 + j, tc.ParallelConfig(optimizer="adamw"),
            device="cpu"))
        st["params"] = ranks.perturb(st["params"], rng)
        _flat(st, f"{case}/init", inp)
        for i in range(ranks.TRAIN_STEPS):
            b = _train_batch(rng, arch, ranks.TRAIN_BATCH, ranks.TRAIN_SEQ)
            _flat({**b, **_stub(rng, arch, ranks.TRAIN_BATCH)},
                  f"{case}/batch/{i}", inp)
    _INPUTS.update(inp)
    return _INPUTS


def ref_cfg() -> dict:
    return {"cases": {c: list(v) for c, v in ranks.CASES.items()},
            "model": ranks.MODEL,
            "prefill": [ranks.PREFILL_SEQ, ranks.PREFILL_BATCH],
            "train": [ranks.TRAIN_SEQ, ranks.TRAIN_BATCH],
            "train_cfg": ranks.TRAIN_CFG, "train_steps": ranks.TRAIN_STEPS,
            "train_modes": ranks.TRAIN_MODES,
            "train_cases": ranks.TRAIN_CASES,
            "decode_steps": ranks.DECODE_STEPS}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("tp_kv")


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
    assert "TP_KV_REFERENCE_OK" in stdout
    out = np.load(workdir / "out.npz")
    return {k: out[k] for k in out.files}


@pytest.fixture(scope="module")
def worlds(reference_proc, workdir):
    """``{(1, 4): rank 0's serve_world, (2, 4): rank 0's data_world}``:
    both worlds started at once (a thread waits on the second) beside the
    reference subprocess."""
    path, out, errors = str(workdir / "in.npz"), {}, []

    def data():
        try:
            out[(2, 4)] = world(workdir, "data", ranks.data_world, 8,
                                path)[0]
        except BaseException as e:          # re-raised below
            errors.append(e)
    t = threading.Thread(target=data)
    t.start()
    try:
        out[(1, 4)] = world(workdir, "serve", ranks.serve_world, 4, path)[0]
    finally:
        t.join()
    if errors:
        raise errors[0]
    return out


MESH_IDS = ["data1xmodel4", "data2xmodel4"]


# ---------------------------------------------------------------------------
# prefill, seq_shard and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("case", list(ranks.CASES))
@pytest.mark.parametrize("ms", ranks.SERVE_MESHES, ids=MESH_IDS)
def test_prefill_matches_reference(worlds, reference, ms, case, impl):
    """The last logits, whole on every rank, within 1e-4 of the
    reference's largest; every cache leaf gathered from the groups'
    leaders (the rank's one KV head) within 1e-5 of the reference's
    (GSPMD's, cut on the head dim)."""
    got, tag = worlds[ms], "x".join(map(str, ms))
    assert got[f"{case}/rep"] == {"dense_rep2": 2, "vlm": 2,
                                  "audio": 2}.get(case, 4)
    assert _rel(got[f"{case}/{impl}/logits"],
                reference[f"{tag}/{case}/prefill/logits"]) <= LOGIT_TOL
    _assert_cache(_sub(got, f"{case}/{impl}/cache"),
                  _sub(reference, f"{tag}/{case}/prefill/cache"),
                  f"{tag} {case} {impl}")


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_seq_shard_prefill_matches_reference(worlds, reference, case):
    """The prefill under ``seq_shard`` on (data 2, model 4): each rank's
    tokens its (B / 2, S / 4) block, the logits and cache those of the
    reference's prefill on that mesh."""
    got = worlds[(2, 4)]
    assert _rel(got[f"{case}/seq_shard/logits"],
                reference[f"2x4/{case}/prefill/logits"]) <= LOGIT_TOL
    _assert_cache(_sub(got, f"{case}/seq_shard/cache"),
                  _sub(reference, f"2x4/{case}/prefill/cache"),
                  f"{case} seq_shard")


@pytest.mark.parametrize("case", list(ranks.CASES))
@pytest.mark.parametrize("ms", ranks.SERVE_MESHES, ids=MESH_IDS)
def test_decode_matches_reference(worlds, reference, ms, case):
    """3 greedy steps from the prefill's cache: tokens equal, the gathered
    caches within 1e-5."""
    got, tag = worlds[ms], "x".join(map(str, ms))
    np.testing.assert_array_equal(got[f"{case}/decode/tokens"],
                                  reference[f"{tag}/{case}/decode/tokens"])
    _assert_cache(_sub(got, f"{case}/decode/cache"),
                  _sub(reference, f"{tag}/{case}/decode/cache"),
                  f"{tag} {case} decode")


@pytest.mark.parametrize("case", list(ranks.CASES))
@pytest.mark.parametrize("ms", ranks.SERVE_MESHES, ids=MESH_IDS)
def test_group_copies_are_identical(worlds, ms, case):
    """The ``rep`` ranks of a KV group hold its head's cache bit for bit
    alike after every prefill form and after decode."""
    got = worlds[ms]
    forms = ["reference", "flash", "decode"] + \
        (["seq_shard"] if ms[0] > 1 else [])
    assert all(got[f"{case}/{f}/copies_identical"] for f in forms), \
        {f: got[f"{case}/{f}/copies_identical"] for f in forms}


# ---------------------------------------------------------------------------
# training on (data 2, model 4), and the mutant
# ---------------------------------------------------------------------------

TRAIN_IDS = [(c, m) for c, modes in ranks.TRAIN_CASES.items()
             for m in modes]


@pytest.mark.parametrize("case,mode", TRAIN_IDS,
                         ids=[f"{c}-{m}" for c, m in TRAIN_IDS])
def test_train_matches_reference(worlds, reference, case, mode):
    """2 AdamW steps: loss, ce and ``grad_norm`` at each; the first
    step's gradients against the reference's (each ``wk``/``wv`` shard's
    the sum over every rank of its KV group); the state after."""
    got, prefix = worlds[(2, 4)], f"{case}/{mode}"
    _assert_metrics(got, reference, prefix, prefix)
    want = _sub(reference, f"{case}/grads")
    _assert_close_tree(_sub(got, f"{prefix}/grads"), want, GRAD_TOL, prefix)
    _assert_state(_sub(got, f"{prefix}/state"),
                  _sub(reference, f"{prefix}/state"), _flat(want, "", {}),
                  prefix)


def test_sliced_group_gather_is_seen(worlds, reference):
    """The group gather's cotangent sliced instead of reduce-scattered:
    ``wk`` and ``wv`` lose the other rank's share of their gradient, far
    past the bound the real step keeps; the other leaves keep it."""
    got = _sub(worlds[(2, 4)], "mutant/grads")
    want = _sub(reference, f"{ranks.MUTANT_CASE}/grads")
    for name in ("wk", "wv"):
        err = _rel(got["blocks"]["attn"][name], want["blocks"]["attn"][name])
        assert err > 100 * GRAD_TOL, (name, err)
    assert _rel(got["blocks"]["attn"]["wq"],
                want["blocks"]["attn"]["wq"]) <= GRAD_TOL


# ---------------------------------------------------------------------------
# the rule (no world)
# ---------------------------------------------------------------------------

def test_check_tp_split_takes_multiples_of_the_kv_heads():
    """``model`` a multiple of the KV heads splits (the four models of the
    production meshes' refused cells: 8 KV heads at model 16); a KV count
    that neither divides ``model`` nor is divided by it still raises, and
    so does a query-side width."""
    for arch_id in ("internlm2-1.8b", "grok-1-314b", "kimi-k2-1t-a32b",
                    "qwen1.5-110b"):
        arch = tc.get_arch(arch_id)
        transformer.check_tp_split(arch, 16)
        assert transformer.kv_split(arch, 16) == (1, 2)
        assert transformer.kv_split(arch, 4) == (2, 1)
    whisper = tc.get_arch("whisper-tiny")                # 6 heads
    with pytest.raises(ValueError, match="key/value heads"):
        transformer.check_tp_split(whisper, 4)
    with pytest.raises(ValueError, match="query heads"):
        transformer.check_tp_split(tc.get_arch("qwen1.5-32b"), 16)


def test_cache_specs_group_the_kv_heads():
    """Where ``model`` exceeds the KV heads each KV dim of a session cache
    is ``Grouped`` over ``model`` (the rank's group's head; it pickles
    as itself), and stays plain ``model`` where it divides them; the
    parameter specs do not change."""
    import pickle

    from repro_torch.launch import serve

    class Mesh:
        def __init__(self, model):
            self.shape = (2, model)
        mesh_dim_names = ("data", "model")
    arch = tc.get_arch("internlm2-1.8b")
    k = serve.session_cache_specs(arch, Mesh(16), 4)["k"]
    assert tuple(k) == (None, "data", None, "model", None)
    assert isinstance(k[3], sh.Grouped) and k[3].parts == 8
    again = pickle.loads(pickle.dumps(k[3]))
    assert isinstance(again, sh.Grouped) and again.parts == 8
    assert not isinstance(serve.session_cache_specs(arch, Mesh(4), 4)["k"][3],
                          sh.Grouped)
    z = serve.session_cache_specs(tc.get_arch("zamba2-7b"), Mesh(64), 4)
    assert isinstance(z["shared_k"][3], sh.Grouped)
    assert not any(isinstance(e, sh.Grouped) for e in z["mamba"]["state"])

