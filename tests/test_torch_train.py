"""The port's training stack (``models.transformer.lm_loss``, ``_remat``,
``launch/train.py``, ``core.carry.train_state_*``) against the reference,
on the CPU, from the same seeded state and batches.

* ``lm_loss`` and its gradients for every model of the registry at
  ``reduced()``, f32 compute, against ``jax.value_and_grad`` of the
  reference's (the twin of ``tests/test_arch_smoke.py``'s loss and gradient
  cases, with values compared): loss within 1e-5 relative, each gradient
  leaf within 1e-4 of the leaf's max-abs (the same f32 arithmetic through a
  few layers in other summation orders).  xlstm's groupnorm scales are
  drawn around 1 for both packages (the reference initialises them to 0,
  which would hide the cells).  The moe families are held in f32 only
  (ROADMAP queue 3).
* remat "none", "block" and "full" give the same loss and gradients (a
  mode changes memory, not results: the recomputation repeats the same
  arithmetic, so they are equal bit for bit).
* ``make_step_fn`` for 3 steps against the reference's, AdamW with f32
  params and Adafactor with bf16 params; ``make_train_step`` (REPLICATED
  with 2 pods stacked, and CLOUD_CENTRAL over the pods' concatenated
  batch) and ``make_replicate_step`` (compression off and on) against the
  reference's jitted ones on a (pod=2) mesh of forced host devices, in ONE
  subprocess (so ``XLA_FLAGS`` does not reach the rest of the suite).  The
  reference's trainer computes in bf16; both packages are held in f32 here
  (the subprocess and the in-process step wrap the reference's
  ``lm_loss`` with ``compute_dtype=float32``).  Metrics within 1e-5
  relative; the moments, made of gradients, within the gradients' 1e-4 of
  the leaf's max-abs (second moments, their squares, 2e-4); the params
  within 2 x lr x steps everywhere and all but 1e-3 of their elements
  within 1e-4 (bf16 params: one bf16 ulp, 2^-8, of the leaf's max-abs, as
  one rounding of the f32 update may flip), because Adam's update
  m/sqrt(v) is ~lr x sign(g) and amplifies the last bits of a gradient
  that is near 0 or that cancels across steps; the replicate step alone
  (from the same pods) within 1e-5.  Step counters and rounds exactly;
  pods bit-identical after an anti-entropy round.
* ``tests/test_pod_replication.py``'s markers on the port: pods diverge
  between rounds, replicas converge to 0.0, the loss trends down.
* The repairs: the three kernel wrappers and ``lm_loss(impl=FLASH)``
  refuse autograd on the CPU too (nothing launched, counters unchanged);
  ``slstm_scan`` under autograd runs the eager loop (the sLSTM gradients
  equal ``slstm_loop``'s, and ``SLSTM_STEPS`` is never called).
* ``examples/torch_train_local_sgd.py`` for 6 steps on the CPU with a crash
  and a restore from its checkpoint.
"""
import collections
import functools
import os
import pathlib
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as rc
from repro.data import synthetic_batch as ref_batch
from repro.launch import train as ref_train
from repro.models import model_zoo as ref_zoo
from repro_torch import configs as tc
from repro_torch.core.carry import (params_from_numpy, train_state_from_numpy,
                                    train_state_to_numpy)
from repro_torch.core.tree import tree_map
from repro_torch.data import synthetic_batch as port_batch
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.mlstm_chunk import kernel as mk
from repro_torch.kernels.ssd_chunk import kernel as sk
from repro_torch.launch import train
from repro_torch.models import model_zoo as zoo
from repro_torch.models import xlstm
from torch_parity import port_lockdep, to_np  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")

REPO = pathlib.Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STATE_TOL = 1e-5
BF16_ULP = 2.0 ** -8
ARCH = "internlm2-1.8b"


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k],
                                                         f"{pre}/{k}")]
    return [(pre, tree)]


def _err(got, want) -> float:
    g = to_np(got).astype(np.float32)
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape
    return float(np.abs(g - w).max() / (np.abs(w).max() + 1e-30))


def _assert_tree_close(got, want, tol, what):
    gp, wp = _paths(got), _paths(want)
    assert [p for p, _ in gp] == [p for p, _ in wp], what
    for (path, g), (_, w) in zip(gp, wp):
        assert _err(g, w) <= tol, f"{what}{path}: {_err(g, w):.3e} > {tol}"


def _assert_state_close(got, want, lr_steps, what):
    """Counters exactly; first moments within GRAD_TOL of the leaf's
    max-abs and second moments (squares of gradients) within 2 x GRAD_TOL;
    params and AdamW's master within 2 x lr x steps everywhere and all but
    1e-3 of the elements within GRAD_TOL (bf16 params: one bf16 ulp of the
    leaf's max-abs; module docstring)."""
    for (path, g), (_, w) in zip(_paths(got), _paths(want)):
        if np.issubdtype(np.asarray(w).dtype, np.integer):
            np.testing.assert_array_equal(to_np(g), np.asarray(w),
                                          err_msg=what + path)
        elif path.startswith("/opt/m/"):
            assert _err(g, w) <= GRAD_TOL, f"{what}{path}: {_err(g, w):.3e}"
        elif path.startswith("/opt/v/"):
            assert _err(g, w) <= 2 * GRAD_TOL, \
                f"{what}{path}: {_err(g, w):.3e}"
        else:
            tol = BF16_ULP if g.dtype == torch.bfloat16 else GRAD_TOL
            g = to_np(g).astype(np.float32)
            w = np.asarray(jnp.asarray(w, jnp.float32))
            diff = np.abs(g - w)
            assert diff.max() <= 2 * lr_steps, f"{what}{path}: {diff.max()}"
            far = float(np.mean(diff > tol * np.abs(w).max()))
            assert far <= 1e-3, f"{what}{path}: {far:.2e} of elements"


def _unit_norms(params, seed=3):
    """xlstm: the groupnorm scales drawn around 1 (numpy, both packages)."""
    rng = np.random.default_rng(seed)
    for group in ("mlstm", "slstm"):
        cell = params["blocks"][group]["cell"]
        cell["norm"] = (1.0 + 0.1 * rng.standard_normal(
            cell["norm"].shape)).astype(np.float32)
    return params


@functools.lru_cache(maxsize=None)
def _model(arch_id):
    """Reduced configs of both packages, f32 params and a train batch as
    numpy, drawn by the port (both packages then compute on the same
    numbers; the reference's own init is what the step tests start
    from)."""
    arch_r = rc.reduced(rc.get_arch(arch_id))
    arch_t = tc.reduced(tc.get_arch(arch_id))
    params = train_state_to_numpy(zoo.init_params(arch_t, seed=0,
                                                  device="cpu"))
    if arch_r.family == "ssm":
        params = _unit_norms(params)
    shape = tc.reduced_shape(tc.SHAPES_BY_NAME["train_4k"])
    batch = train_state_to_numpy(port_batch(arch_t, shape, 0, 1,
                                            device="cpu"))
    return arch_r, arch_t, params, batch


def _port_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _ref_value_and_grad(arch_r, params, batch):
    f = jax.jit(jax.value_and_grad(lambda p, b: ref_zoo.lm_loss(
        arch_r, p, b, compute_dtype=jnp.float32)[0]))
    return f(jax.tree.map(jnp.asarray, params),
             jax.tree.map(jnp.asarray, batch))


def _port_value_and_grad(arch_t, params, batch, remat="none", impl=None):
    par = tc.ParallelConfig(remat=remat)
    loss_fn = train.make_loss_fn(arch_t, par, impl or tc.AttnImpl.REFERENCE,
                                 compute_dtype=torch.float32)
    loss, _, grads = train.value_and_grad(
        loss_fn, params_from_numpy(arch_t, params, device="cpu"),
        _port_batch(batch))
    return loss, grads


# ---------------------------------------------------------------------------
# lm_loss and gradients, every family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", rc.ARCH_IDS)
def test_lm_loss_and_gradients_match_reference(arch_id):
    arch_r, arch_t, params, batch = _model(arch_id)
    want_loss, want_grads = _ref_value_and_grad(arch_r, params, batch)
    loss, grads = _port_value_and_grad(arch_t, params, batch)
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL * abs(
        float(want_loss))
    _assert_tree_close(grads, jax.device_get(want_grads), GRAD_TOL, arch_id)
    if arch_r.family == "ssm":      # the sLSTM cells are reached
        for leaf in ("w_in", "r", "b"):
            assert grads["blocks"]["slstm"]["cell"][leaf].abs().max() > 0


@pytest.mark.parametrize("arch_id", ["internlm2-1.8b", "grok-1-314b",
                                     "xlstm-350m", "zamba2-7b",
                                     "whisper-tiny"])
def test_remat_modes_change_memory_not_results(arch_id):
    _, arch_t, params, batch = _model(arch_id)
    want_loss, want = _port_value_and_grad(arch_t, params, batch, "none")
    for mode in ("block", "full"):
        loss, grads = _port_value_and_grad(arch_t, params, batch, mode)
        assert torch.equal(loss, want_loss), mode
        for (path, g), (_, w) in zip(_paths(grads), _paths(want)):
            assert torch.equal(g, w), f"{mode}{path}"
    with pytest.raises(ValueError, match="remat mode"):
        _port_value_and_grad(arch_t, params, batch, "sometimes")


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


def test_block_remat_saves_the_products_and_recomputes_the_rest():
    """What the backward pass runs again: under "block" the attention's
    batched products and the elementwise ops but no ``aten.mm`` (its
    outputs are saved); under "full" the ``aten.mm`` products too; under
    "none" nothing."""
    _, arch_t, params, batch = _model(ARCH)
    tp = tree_map(lambda p: p.detach().requires_grad_(),
                  params_from_numpy(arch_t, params, device="cpu"))
    backward = {}
    for mode in ("none", "block", "full"):
        loss, _ = zoo.lm_loss(arch_t, tp, _port_batch(batch), remat=mode,
                              compute_dtype=torch.float32)
        with _OpCount() as count:
            loss.backward()
        backward[mode] = count.ops
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert backward["none"][mm] == backward["block"][mm] < \
        backward["full"][mm]
    assert backward["none"][bmm] < backward["block"][bmm] == \
        backward["full"][bmm]
    exp = torch.ops.aten.exp.default
    assert backward["none"][exp] < backward["block"][exp]


# ---------------------------------------------------------------------------
# make_step_fn against the reference's, 3 steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_step_fn_matches_reference(optimizer, monkeypatch):
    bf16 = optimizer == "adafactor"
    arch_r = rc.reduced(rc.get_arch(ARCH))
    arch_t = tc.reduced(tc.get_arch(ARCH))
    cfg = dict(lr=1e-3, warmup_steps=2, total_steps=6)
    dtype = jnp.bfloat16 if bf16 else None
    par_r = rc.ParallelConfig(remat="block", optimizer=optimizer)
    par_t = tc.ParallelConfig(remat="block", optimizer=optimizer)
    state = jax.device_get(ref_train.init_state(
        arch_r, jax.random.PRNGKey(0), par_r, dtype=dtype))
    port_state = train_state_from_numpy(arch_t, state, device="cpu")
    assert sorted(port_state["opt"]) == sorted(state["opt"])
    # the reference's trainer computes in bf16: hold both in f32
    f32_loss = functools.partial(ref_zoo.lm_loss, compute_dtype=jnp.float32)
    monkeypatch.setattr(ref_train, "zoo", types.SimpleNamespace(
        lm_loss=f32_loss))
    ref_step = jax.jit(ref_train.make_step_fn(arch_r, par_r,
                                              rc.TrainConfig(**cfg)))
    port_step = train.make_step_fn(arch_t, par_t, tc.TrainConfig(**cfg),
                                   compute_dtype=torch.float32)
    state = jax.tree.map(jnp.asarray, state)
    shape = rc.reduced_shape(rc.SHAPES_BY_NAME["train_4k"])
    for i in range(3):
        b = jax.device_get(ref_batch(arch_r, shape, 0, i))
        state, want = ref_step(state, jax.tree.map(jnp.asarray, b))
        port_state, got = port_step(port_state, _port_batch(b))
        for k in ("loss", "ce", "lr", "grad_norm"):
            assert _err(got[k], want[k]) <= LOSS_TOL, (i, k)
    assert int(port_state["step"]) == 3
    _assert_state_close(port_state, jax.device_get(state), cfg["lr"] * 3,
                        optimizer)
    if bf16:
        assert port_state["params"]["embed"].dtype == torch.bfloat16


def test_train_state_round_trips_through_numpy():
    arch_t = tc.reduced(tc.get_arch(ARCH))
    for opt, dtype in (("adamw", torch.bfloat16), ("adafactor", None)):
        par = tc.ParallelConfig(optimizer=opt)
        state = train.init_state(arch_t, 0, par, dtype=dtype, device="cpu")
        back = train_state_from_numpy(arch_t, train_state_to_numpy(state),
                                      device="cpu", param_dtype=dtype)
        for (p, a), (q, b) in zip(_paths(state), _paths(back)):
            assert p == q and a.dtype == b.dtype and torch.equal(a, b), p
    assert "master" in train.init_state(arch_t, 0, tc.ParallelConfig(),
                                        dtype=torch.bfloat16,
                                        device="cpu")["opt"]


def test_state_shapes_allocate_nothing_and_match_init():
    arch_t = tc.reduced(tc.get_arch(ARCH))
    par = tc.ParallelConfig()
    shapes = train.state_shapes(arch_t, par)
    state = train.init_state(arch_t, 0, par, device="cpu")
    for (p, s), (q, x) in zip(_paths(shapes), _paths(state)):
        assert p == q and s.is_meta and s.shape == x.shape and \
            s.dtype == x.dtype
    full = tc.get_arch(ARCH)
    assert train.param_dtype_for(full) == torch.float32
    assert train.param_dtype_for(tc.get_arch("kimi-k2-1t-a32b")) == \
        torch.bfloat16
    dp = train.default_parallel(full, tc.SHAPES_BY_NAME["train_4k"])
    assert (dp.remat, dp.optimizer) == ("block", "adamw") == (
        ref_train.default_parallel(rc.get_arch(ARCH),
                                   rc.SHAPES_BY_NAME["train_4k"]).remat,
        "adamw")


def test_card_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arch_t = tc.reduced(tc.get_arch(ARCH))
    shape = tc.reduced_shape(tc.SHAPES_BY_NAME["train_4k"])
    par = tc.ParallelConfig()
    for call in (lambda: train.make_train_step(arch_t, shape),
                 lambda: train.make_replicate_step(arch_t, 2, par,
                                                   tc.EnokiConfig()),
                 lambda: train.init_state(arch_t, 0, par)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_step_refuses_state_on_another_device():
    arch_t = tc.reduced(tc.get_arch(ARCH))
    shape = tc.reduced_shape(tc.SHAPES_BY_NAME["train_4k"])
    step, _ = train.make_train_step(arch_t, shape, device="meta")
    state = train.init_state(arch_t, 0, tc.ParallelConfig(), device="cpu")
    with pytest.raises(ValueError, match="this step runs on meta"):
        step(state, {})


# ---------------------------------------------------------------------------
# make_train_step / make_replicate_step against the reference's jitted ones
# ---------------------------------------------------------------------------

SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import functools
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.configs import (EnokiConfig, ParallelConfig, ReplicationPolicy,
                               SHAPES_BY_NAME, TrainConfig, get_arch, reduced,
                               reduced_shape)
    from repro.launch import train as T
    from repro.launch.mesh import make_test_mesh
    from repro.models import model_zoo as zoo
    from repro.optim import diloco_init
    from repro.parallel.sharding import named

    # the reference's trainer computes in bf16: hold both packages in f32
    zoo.lm_loss = functools.partial(zoo.lm_loss, compute_dtype=jnp.float32)
    data = dict(np.load(sys.argv[1]))
    arch = reduced(get_arch("internlm2-1.8b"))
    shape = reduced_shape(SHAPES_BY_NAME["train_4k"])
    par = ParallelConfig(fsdp=False, remat="block", optimizer="adamw")
    cfg = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    mesh = make_test_mesh((2, 1, 1), ("pod", "data", "model"))
    out = {}

    def put(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                           for p in path)
            out[f"{prefix}/{key}"] = np.asarray(jnp.asarray(leaf,
                                                            jnp.float32)
                                                if leaf.dtype == jnp.bfloat16
                                                else leaf)

    def batch(name, i):
        keys = ("tokens", "labels", "loss_mask")
        return {k: jnp.asarray(data[f"{name}/{i}/{k}"]) for k in keys}

    single = T.init_state(arch, jax.random.PRNGKey(0), par)
    put("init", single)
    policy = ReplicationPolicy.REPLICATED
    step, sshape, (sspecs, _) = T.make_train_step(
        arch, shape, mesh, par, EnokiConfig(policy=policy), cfg,
        donate=False)
    state = jax.tree.map(lambda l: jnp.stack([l, l]), single)
    state = jax.tree.map(jax.device_put, state, named(mesh, sspecs))
    for i in range(2):
        state, m = step(state, batch("pods", i))
        put(f"pods/metrics/{i}", m)
    put("pods/state", state)
    for c in (0, 1):
        enoki = EnokiConfig(policy=policy, compress_deltas=bool(c))
        rstep, _, _ = T.make_replicate_step(arch, mesh, par, enoki, sshape)
        s2, o2 = rstep(state, diloco_init(single["params"]))
        put(f"replicate{c}/params", s2["params"])
        put(f"replicate{c}/outer", o2)
    cstep, _, (cspecs, _) = T.make_train_step(
        arch, shape, mesh, par,
        EnokiConfig(policy=ReplicationPolicy.CLOUD_CENTRAL), cfg,
        donate=False)
    cstate = jax.tree.map(jax.device_put, single, named(mesh, cspecs))
    for i in range(2):
        cstate, m = cstep(cstate, batch("central", i))
        put(f"central/metrics/{i}", m)
    put("central/state", cstate)
    np.savez(sys.argv[2], **out)
""")


def _nest(flat: dict, prefix: str) -> dict:
    out: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, last = key[len(prefix) + 1:].split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return out


@pytest.fixture(scope="module")
def reference_steps(tmp_path_factory):
    """The reference's jitted REPLICATED (2 pods) and CLOUD_CENTRAL steps
    and its replicate step, compression off and on, in one subprocess."""
    arch_r = rc.reduced(rc.get_arch(ARCH))
    shape = rc.reduced_shape(rc.SHAPES_BY_NAME["train_4k"])
    batches = {}
    for i in range(2):
        pods = [jax.device_get(ref_batch(arch_r, shape, 0, i, shard=p,
                                         num_shards=2, batch_override=4))
                for p in range(2)]
        for k in pods[0]:
            batches[f"pods/{i}/{k}"] = np.stack([b[k] for b in pods])
            batches[f"central/{i}/{k}"] = np.concatenate([b[k]
                                                          for b in pods])
    d = tmp_path_factory.mktemp("ref_train")
    np.savez(d / "in.npz", **batches)
    (d / "ref.py").write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, str(d / "ref.py"),
                          str(d / "in.npz"), str(d / "out.npz")],
                         capture_output=True, text=True, timeout=600,
                         env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    return batches, dict(np.load(d / "out.npz"))


def _ref_state(out, prefix, arch_t):
    tree = _nest(out, prefix)
    tree["step"] = tree["step"].astype(np.int32)
    return train_state_from_numpy(arch_t, tree, device="cpu")


def _pod_steps(arch_t, par, enoki, out, batches, n_pods):
    shape = tc.reduced_shape(tc.SHAPES_BY_NAME["train_4k"])
    cfg = tc.TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step, sshape = train.make_train_step(arch_t, shape, n_pods, par, enoki,
                                         cfg, device="cpu",
                                         compute_dtype=torch.float32)
    single = _ref_state(out, "init", arch_t)
    state = single if n_pods == 1 else tree_map(
        lambda l: torch.stack([l] * n_pods), single)
    for (p, s), (q, x) in zip(_paths(sshape), _paths(state)):
        assert p == q and s.shape == x.shape and s.dtype == x.dtype, p
    name = "pods" if n_pods > 1 else "central"
    metrics = []
    for i in range(2):
        b = {k: torch.from_numpy(batches[f"{name}/{i}/{k}"])
             for k in ("tokens", "labels", "loss_mask")}
        state, m = step(state, b)
        metrics.append(m)
    return state, metrics


@pytest.mark.parametrize("policy", ["replicated", "cloud_central"])
def test_train_step_matches_reference_jitted(reference_steps, policy):
    batches, out = reference_steps
    arch_t = tc.reduced(tc.get_arch(ARCH))
    par = tc.ParallelConfig(remat="block")
    n_pods = 2 if policy == "replicated" else 1
    name = "pods" if n_pods > 1 else "central"
    state, metrics = _pod_steps(arch_t, par,
                                tc.EnokiConfig(policy=tc.ReplicationPolicy(
                                    policy)), out, batches, n_pods)
    for i, m in enumerate(metrics):
        want = _nest(out, f"{name}/metrics/{i}")
        for k in ("loss", "ce", "lr", "grad_norm"):
            assert tuple(m[k].shape) == want[k].shape
            assert _err(m[k], want[k]) <= LOSS_TOL, (i, k)
    want = _nest(out, f"{name}/state")
    want["step"] = want["step"].astype(np.int32)
    _assert_state_close(state, want, 1e-3 * 2, policy)
    if n_pods > 1:   # different data: the pods diverged
        w = state["params"]["blocks"]["attn"]["wq"]
        assert (w[0] - w[1]).abs().max() > 0


@pytest.mark.parametrize("compress", [False, True])
def test_replicate_step_matches_reference_jitted(reference_steps, compress):
    batches, out = reference_steps
    arch_t = tc.reduced(tc.get_arch(ARCH))
    par = tc.ParallelConfig(remat="block")
    enoki = tc.EnokiConfig(compress_deltas=compress)
    # start from the reference's pods after 2 steps, so the round alone is
    # compared
    want = _nest(out, "pods/state")
    want["step"] = want["step"].astype(np.int32)
    state = train_state_from_numpy(arch_t, want, device="cpu")
    replicate, outer_shape = train.make_replicate_step(arch_t, 2, par, enoki,
                                                       device="cpu")
    from repro_torch.optim import diloco_init
    outer = diloco_init(_ref_state(out, "init", arch_t)["params"])
    for (p, s), (q, x) in zip(_paths(outer_shape), _paths(outer)):
        assert p == q and s.shape == x.shape and s.is_meta, p
    state, outer = replicate(state, outer)
    c = int(compress)
    _assert_tree_close(state["params"], _nest(out, f"replicate{c}/params"),
                       STATE_TOL, "params")
    want_outer = _nest(out, f"replicate{c}/outer")
    assert int(outer["round"]) == int(want_outer["round"]) == 1
    _assert_tree_close({k: outer[k] for k in ("outer_params", "momentum")},
                       {k: want_outer[k] for k in ("outer_params",
                                                   "momentum")},
                       STATE_TOL, "outer")
    for _, leaf in _paths(state["params"]):
        assert torch.equal(leaf[0], leaf[1])


# ---------------------------------------------------------------------------
# tests/test_pod_replication.py's markers on the port
# ---------------------------------------------------------------------------

def test_pods_diverge_converge_and_the_loss_falls():
    arch_t = tc.reduced(tc.get_arch(ARCH))
    shape = tc.reduced_shape(tc.SHAPES_BY_NAME["train_4k"])
    enoki = tc.EnokiConfig(policy=tc.ReplicationPolicy.REPLICATED,
                           replication_period=2)
    par = tc.ParallelConfig(fsdp=False, remat="none", optimizer="adamw")
    step, _ = train.make_train_step(arch_t, shape, 2, par, enoki,
                                    tc.TrainConfig(lr=1e-3), device="cpu")
    single = train.init_state(arch_t, 0, par, device="cpu")
    state = tree_map(lambda l: torch.stack([l, l]), single)
    from repro_torch.optim import diloco_init

    def stacked_batch(i):
        bs = [port_batch(arch_t, shape, 0, i, shard=p, num_shards=2,
                              batch_override=4, device="cpu")
              for p in range(2)]
        return tree_map(lambda a, b: torch.stack([a, b]), *bs)

    # 1. hot path: pods diverge (different data, no cross-pod sync)
    for i in range(2):
        state, metrics = step(state, stacked_batch(i))
    w = state["params"]["embed"]
    assert float((w[0] - w[1]).abs().max()) > 0
    # 2. anti-entropy converges the pods (staleness -> 0)
    rstep, _ = train.make_replicate_step(arch_t, 2, par, enoki,
                                         device="cpu")
    outer = diloco_init(single["params"])
    state, outer = rstep(state, outer)
    for _, leaf in _paths(state["params"]):
        assert float((leaf[0] - leaf[1]).abs().max()) == 0.0
    # 3. the loss trends down across rounds
    losses = []
    for i in range(2, 20):
        state, metrics = step(state, stacked_batch(i))
        losses.append(float(metrics["loss"][0]))
        if i % 2:
            state, outer = rstep(state, outer)
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    assert last < first, f"loss must trend down: {first} -> {last}"
    assert int(outer["round"]) == 10


# ---------------------------------------------------------------------------
# the repairs
# ---------------------------------------------------------------------------

def _counts():
    return (fk.flash_attention_bhsd.launches, sk.ssd_chunk_bhcp.launches,
            mk.mlstm_chunk_bhsd.launches)


def test_kernel_wrappers_refuse_autograd_on_every_device():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)
    q, k, v = r(1, 2, 64, 32), r(1, 2, 64, 32), r(1, 2, 64, 32)
    before = _counts()
    calls = {
        "flash_attention_bhsd": lambda t: fk.flash_attention_bhsd(t, k, v),
        "ssd_chunk_bhcp": lambda t: sk.ssd_chunk_bhcp(
            t, r(1, 2, 64), r(1, 1, 64, 16), r(1, 1, 64, 16), chunk=32),
        "mlstm_chunk_bhsd": lambda t: mk.mlstm_chunk_bhsd(
            t, k, v, r(1, 2, 64), r(1, 2, 64), chunk=32),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}.*no backward.*"
                           "REFERENCE"):
            call(q.clone().requires_grad_())
        with torch.no_grad():        # inference still runs
            call(q.clone().requires_grad_())
        call(q)
    assert _counts() == before


def test_lm_loss_under_flash_refuses_autograd():
    _, arch_t, params, batch = _model(ARCH)
    with pytest.raises(RuntimeError, match="flash_attention_bhsd"):
        _port_value_and_grad(arch_t, params, batch, impl=tc.AttnImpl.FLASH)
    loss, _ = zoo.lm_loss(arch_t, params_from_numpy(arch_t, params,
                                                    device="cpu"),
                          _port_batch(batch), impl=tc.AttnImpl.FLASH,
                          compute_dtype=torch.float32)
    assert torch.isfinite(loss)


class _Spy:
    def __init__(self, cache):
        self.cache, self.calls = cache, 0

    def __call__(self, **kw):
        self.calls += 1
        return self.cache(**kw)


def test_slstm_scan_under_autograd_runs_the_loop(monkeypatch):
    spy = _Spy(xlstm.SLSTM_STEPS)
    monkeypatch.setattr(xlstm, "SLSTM_STEPS", spy)
    arch = tc.reduced(tc.get_arch("xlstm-350m"))
    p = xlstm.slstm_init(torch.Generator().manual_seed(0), arch)
    B, S, d, h = 2, 100, arch.d_model, arch.xlstm.num_heads
    wx = torch.randn((B, S, 4 * d), generator=torch.Generator().manual_seed(1))
    init = xlstm.slstm_cache_init(arch, B, torch.float32, device="cpu")
    carry = (init["c"], init["n"], init["m"], init["h"])
    grads = []
    for fn in (xlstm.slstm_scan, xlstm.slstm_loop):
        leaves = [t.clone().requires_grad_() for t in (wx, p["r"], p["b"])]
        hs, c = fn(*leaves, carry, h)
        (hs.square().sum() + c[0].sum()).backward()
        grads.append([t.grad for t in leaves])
    assert spy.calls == 0
    for got, want in zip(*grads):
        assert torch.equal(got, want)
    with torch.no_grad():     # inference keeps the step cache
        xlstm.slstm_scan(wx, p["r"], p["b"], carry, h)
    assert spy.calls == len(xlstm.slstm_blocks(S))


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------

def test_example_trains_crashes_and_restores(tmp_path):
    sys.path.insert(0, str(REPO / "examples"))
    try:
        import torch_train_local_sgd as example
    finally:
        sys.path.remove(str(REPO / "examples"))
    out = example.main(["--device", "cpu", "--steps", "6", "--crash-at",
                        "5", "--replication-period", "2", "--ckpt-every",
                        "2", "--ckpt-dir", str(tmp_path)])
    # the crash at step 5 lost step 4's update: the restored state holds 4
    # steps (the checkpoint after step 3), then step 5 makes 5
    assert out["state"]["step"].tolist() == [5, 5]
    assert out["checkpoints"] == [3, 5]
    assert out["cursors"] == [6, 6]      # the data cursors never rewind
    assert int(out["outer"]["round"]) == 3      # after steps 1, 3 and 5
    for _, leaf in _paths(out["state"]["params"]):   # the last round synced
        assert torch.equal(leaf[0], leaf[1])
    assert all(np.isfinite(l).all() for l in out["losses"])
