"""The port's prefill under ``ParallelConfig(seq_shard=True)`` for every
family, on a gloo world of 4 CPU ranks on (data 2, model 2), against the
reference's jitted prefill with the same config on 4 forced host devices.

``seq_shard`` holds the prompt's tokens (B / data, S / model) on each rank
(``sharding.batch_specs``).  The reference's program computes what it
computes without the flag; the port runs Megatron's sequence parallelism
(``forward_seq(seq_shard=True)``): the residual stream between layers is
the rank's slice of the sequence, each layer gathers its normed input and
reduce-scatters its row-parallel output, and attention, the scans and the
moe layer run on the rank's heads over the whole sequence.  ONE reference
subprocess runs each family's reduced config (internlm2 and grok-1 at
their tensor-parallel test configs, phi-3-vision, zamba2, xlstm and
whisper-tiny) under REFERENCE while the port's world runs them (rank
bodies in ``tests/torch_seq_shard_ranks.py``) on the same numpy inputs,
the norm scales and the recurrent layers' constant leaves perturbed.
Bounds, as for the tensor-parallel prefills: the last logits within 1e-4
of the reference's largest, every cache leaf gathered within 1e-5 (the
dense case under FLASH too: the kernel's plain version on the CPU).

Two mutants show the checks see the traps of a sequence-sharded prefill:
attention over the rank's own slice of the keys only, and positions local
to the rank's slice.  A length that ``model`` does not divide raises
``ValueError``, and a train step ignores the flag, as the reference's
does.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

import torch_seq_shard_ranks as ranks
from repro_torch import configs as tc
from repro_torch.core.carry import train_state_to_numpy
from repro_torch.launch import serve, train
from repro_torch.models import model_zoo as zoo
from test_torch_tensor_parallel import (LOGIT_TOL, _flat, _np, _rel, _sub,
                                        _train_batch)
from test_torch_tensor_parallel_hybrid import (_assert_cache, stop_reference,
                                               world)
from torch_parity import port_lockdep  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")

REPO = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, functools
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from repro import configs as rc
from repro.configs import AttnImpl, ParallelConfig
from repro.launch import serve as S
from repro.models import model_zoo as zoo

cfg = json.loads(sys.argv[3])
zoo.forward_seq = functools.partial(zoo.forward_seq,
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
            node[last] = np.asarray(v)
    return t


def put(prefix, t):
    for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[f"{prefix}/{key}" if key else prefix] = np.asarray(leaf)


mesh = Mesh(np.array(jax.devices()).reshape(cfg["mesh"]), ("data", "model"))
shape = dataclasses.replace(rc.reduced_shape(rc.SHAPES_BY_NAME["prefill_32k"]),
                            seq_len=cfg["seq"], global_batch=cfg["batch"])
for case, (arch_id, changes, moe_impl) in cfg["cases"].items():
    arch = rc.reduced(rc.get_arch(arch_id))
    changes = dict(changes)
    if "moe" in changes:
        changes["moe"] = dataclasses.replace(arch.moe, **changes["moe"])
    arch = dataclasses.replace(arch, **changes)
    par = ParallelConfig(remat="none", fsdp=False, seq_shard=True,
                         moe_impl=moe_impl)
    step, _, (_, bspecs, _) = S.make_prefill_step(arch, shape, mesh, par,
                                                  impl=AttnImpl.REFERENCE)
    assert tuple(bspecs["tokens"]) == ("data", "model"), bspecs
    logits, cache = step(tree(f"{case}/params"), tree(f"{case}/prompt"))
    out[f"{case}/logits"] = np.asarray(logits)
    put(f"{case}/cache", cache)
np.savez(sys.argv[2], **out)
print("SEQ_SHARD_REFERENCE_OK", len(out))
"""


# ---------------------------------------------------------------------------
# seeded inputs (numpy), the same for both packages
# ---------------------------------------------------------------------------

_INPUTS: dict = {}


def inputs() -> dict:
    """Every case's params and prompt (with the vlm's patches and
    whisper's frames), and the dense case's train state and batch."""
    if _INPUTS:
        return _INPUTS
    rng = np.random.default_rng(28)
    inp = {}
    B, S = ranks.PREFILL_BATCH, ranks.PREFILL_SEQ
    for j, case in enumerate(ranks.CASES):
        arch = ranks.case_arch(tc, case)
        _flat(ranks.perturb(_np(zoo.init_params(arch, seed=10 + j,
                                                device="cpu")), rng),
              f"{case}/params", inp)
        inp[f"{case}/prompt/tokens"] = rng.integers(
            0, arch.vocab_size, (B, S)).astype(np.int32)
        stub = {"clip_patches": "patch_embeds",
                "audio_frames": "frame_embeds"}.get(arch.frontend_stub)
        if stub:
            inp[f"{case}/prompt/{stub}"] = (0.02 * rng.standard_normal(
                (B, arch.num_patches, arch.d_model))).astype(np.float32)
    arch = ranks.case_arch(tc, "dense")
    st = train_state_to_numpy(train.init_state(
        arch, 20, tc.ParallelConfig(), device="cpu"))
    _flat(st, "train/init", inp)
    for k, v in _train_batch(rng, arch, ranks.TRAIN_BATCH,
                             ranks.TRAIN_SEQ).items():
        inp[f"train/batch/{k}"] = v
    _INPUTS.update(inp)
    return _INPUTS


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("seq_shard")


@pytest.fixture(scope="module")
def reference_proc(workdir):
    np.savez(workdir / "in.npz", **inputs())
    (workdir / "ref.py").write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    cfg = {"cases": {c: list(v) for c, v in ranks.CASES.items()},
           "mesh": list(ranks.MESH), "seq": ranks.PREFILL_SEQ,
           "batch": ranks.PREFILL_BATCH}
    proc = subprocess.Popen(
        [sys.executable, str(workdir / "ref.py"), str(workdir / "in.npz"),
         str(workdir / "out.npz"), json.dumps(cfg)], env=env,
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
    assert "SEQ_SHARD_REFERENCE_OK" in stdout
    out = np.load(workdir / "out.npz")
    return {k: out[k] for k in out.files}


@pytest.fixture(scope="module")
def got(reference_proc, workdir):
    return world(workdir, "seq", ranks.seq_shard_world, 4,
                 str(workdir / "in.npz"))[0]


PREFILL_CASES = [(c, "reference") for c in ranks.CASES] + \
    [("dense", "flash")]


@pytest.mark.parametrize("case,impl", PREFILL_CASES,
                         ids=[f"{c}-{i}" for c, i in PREFILL_CASES])
def test_seq_shard_prefill_matches_reference(got, reference, case, impl):
    """The last logits, whole on every rank, within 1e-4 of the
    reference's largest; every cache leaf gathered (laid out by
    ``session_cache_specs``, as without ``seq_shard``) within 1e-5."""
    assert _rel(got[f"{case}/{impl}/logits"],
                reference[f"{case}/logits"]) <= LOGIT_TOL
    _assert_cache(_sub(got, f"{case}/{impl}/cache"),
                  _sub(reference, f"{case}/cache"), f"{case} {impl}")
    assert int(got[f"{case}/{impl}/cache/length"]) == ranks.PREFILL_SEQ


def test_each_rank_holds_its_slice_of_the_prompt(got):
    """The rank's tokens are (B / data, S / model)."""
    assert got["dense/rank_tokens_shape"] == (
        ranks.PREFILL_BATCH // ranks.MESH[0],
        ranks.PREFILL_SEQ // ranks.MESH[1])


@pytest.mark.parametrize("mutant", ["slice_only", "local_positions"])
def test_mutants_are_seen(got, reference, mutant):
    """Attention over the rank's own slice of the keys, or positions
    local to the slice (each rank's restarting at 0), move the logits far
    past the bound the real prefill keeps."""
    assert _rel(got[f"mutant/{mutant}/logits"],
                reference["dense/logits"]) > 100 * LOGIT_TOL


def test_train_step_ignores_seq_shard(got):
    """``make_train_step(seq_shard=True)`` takes the same batch axes and
    gives the same step as without it: every leaf of the state after one
    ZeRO-1 step, and the metrics, bit for bit."""
    assert got["train/True/batch_axes"] == got["train/False/batch_axes"]
    assert got["train/True/metrics"] == got["train/False/metrics"]
    a, b = got["train/True/leaves"], got["train/False/leaves"]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


class _DataModel:
    """Shape-only stand-in of a (data 2, model 2) mesh."""
    shape = (2, 2)
    mesh_dim_names = ("data", "model")


@pytest.mark.parametrize("case", sorted(ranks.CASES))
def test_length_model_does_not_divide_raises(case):
    """A prompt of 33 positions over model 2 raises ``ValueError`` when the
    step is built (for the vlm the length counts its patches: they take
    the prompt's first positions)."""
    arch = ranks.case_arch(tc, case)
    with pytest.raises(ValueError, match="does not divide"):
        serve.make_prefill_step(arch, ranks.prefill_shape(tc, 33),
                                device="cpu", mesh=_DataModel,
                                parallel=tc.ParallelConfig(seq_shard=True))
    serve.make_prefill_step(arch, ranks.prefill_shape(tc, 34), device="cpu",
                            mesh=_DataModel,
                            parallel=tc.ParallelConfig(seq_shard=True))
