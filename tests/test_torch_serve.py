"""The session-serving slice as a whole, against the reference.

internlm2-1.8b reduced (4 layers, d 128, 4 heads with kv 2, head dim 32,
vocab 512).  The reference's parameters are made with ``jax.random`` and
carried across with ``carry.params_from_numpy``; prompts come from numpy.
Tolerances, as relative max errors over the compared tensor:

* float32 compute: 1e-4, the same f32 arithmetic through 4 layers in
  another summation order (the reference's FLASH path is its Pallas kernel
  in interpret mode, the port's is the plain version);
* bfloat16 compute: 5e-2, the reference's own prefill/decode bound
  (``tests/test_arch_smoke.py``): both round activations to bf16 at the
  same points, but a rounding flip propagates through the layers.

The reference serves pods on a mesh; its pod semantics are the ones of
``tests/test_pod_replication.py`` and ``examples/serve_sessions.py``
(``jnp.roll`` over the pod dim for replication, ``jnp.where`` on the dead
mask for migration, ``jax.vmap`` of ``decode_step`` over pod-stacked
identical weights), which the port is held to here on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rc
from repro.models import model_zoo as ref_zoo
from repro_torch import configs as tc
from repro_torch.core.carry import (cache_from_numpy, cache_to_numpy,
                                    params_from_numpy)
from repro_torch.core.tree import tree_map
from repro_torch.launch import serve
from repro_torch.models import model_zoo as zoo
from torch_parity import port_lockdep, to_np  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")

ARCH = "internlm2-1.8b"
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


@pytest.fixture(scope="module")
def model():
    arch_r = rc.reduced(rc.get_arch(ARCH))
    arch_t = tc.reduced(tc.get_arch(ARCH))
    params_r = ref_zoo.init_params(arch_r, jax.random.PRNGKey(0))
    params_t = params_from_numpy(arch_t, jax.device_get(params_r),
                                 device="cpu")
    return arch_r, arch_t, params_r, params_t


def _rel(got, want) -> float:
    got, want = to_np(got).astype(np.float32), to_np(want).astype(np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


def _prompt(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_forward_seq_logits_and_cache_match(model, impl, dtype):
    arch_r, arch_t, params_r, params_t = model
    jdt, tdt, tol = DTYPES[dtype]
    tokens = _prompt(1, 2, 64, arch_r.vocab_size)
    want, _, wcache = ref_zoo.forward_seq(
        arch_r, params_r, jnp.asarray(tokens), impl=rc.AttnImpl(impl),
        return_cache=True, compute_dtype=jdt)
    got, aux, gcache = zoo.forward_seq(
        arch_t, params_t, torch.from_numpy(tokens), impl=tc.AttnImpl(impl),
        return_cache=True, compute_dtype=tdt)
    assert got.dtype == tdt and float(aux) == 0.0
    assert _rel(got, want) < tol
    for key in ("k", "v"):
        assert gcache[key].shape == wcache[key].shape
        assert _rel(gcache[key], wcache[key]) < tol, key


def _ref_greedy(arch, params, tokens, steps, cache_len):
    """Reference prefill, then greedy decode: (tokens, last logits)."""
    B, S = tokens.shape
    logits, _, cache = ref_zoo.forward_seq(arch, params, jnp.asarray(tokens),
                                           return_cache=True,
                                           compute_dtype=jnp.float32)
    full = ref_zoo.init_cache(arch, B, cache_len, dtype=jnp.float32)
    pad = [(0, 0), (0, 0), (0, cache_len - S), (0, 0), (0, 0)]
    cache = {"k": jnp.pad(cache["k"], pad), "v": jnp.pad(cache["v"], pad),
             "length": jnp.asarray(S, jnp.int32)}
    assert cache["k"].shape == full["k"].shape
    tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
    out = [np.asarray(tok)]
    for _ in range(steps):
        logits, cache = ref_zoo.decode_step(arch, params, cache, tok,
                                            compute_dtype=jnp.float32)
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(
            jnp.int32)
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1), logits


@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_prefill_then_decode_continuation(model, impl):
    """Prefill S tokens through the port's prefill step, pad the cache as
    ``tests/test_arch_smoke.py`` pads it, decode greedily: the tokens equal
    the reference's, and the last step's logits agree with the reference's
    and with one full-sequence forward over the same tokens."""
    arch_r, arch_t, params_r, params_t = model
    B, S, steps, cache_len = 2, 16, 6, 24
    tokens = _prompt(2, B, S, arch_r.vocab_size)
    want_tokens, want_logits = _ref_greedy(arch_r, params_r, tokens, steps,
                                           cache_len)
    pshape = tc.ShapeConfig("p", S, B, tc.StepKind.PREFILL)
    prefill = serve.make_prefill_step(arch_t, pshape, impl=tc.AttnImpl(impl),
                                      device="cpu",
                                      compute_dtype=torch.float32)
    step = serve.make_decode_step(arch_t, device="cpu",
                                  compute_dtype=torch.float32)
    logits, pc = prefill(params_t, {"tokens": torch.from_numpy(tokens)})
    assert logits.shape == (B, 1, arch_t.vocab_size)
    assert int(pc["length"]) == S
    # one pod: init_cache's leaves stacked on a leading pod dim of 1
    cache = {k: v[None] for k, v in zoo.init_cache(
        arch_t, B, cache_len, dtype=torch.float32, device="cpu").items()}
    cache["k"][0, :, :, :S] = pc["k"]
    cache["v"][0, :, :, :S] = pc["v"]
    cache["length"][0] = pc["length"]
    k_buf = cache["k"]
    tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
    got = [tok.numpy()]
    for _ in range(steps):
        tok, cache = step(params_t, cache, tok[None])
        tok = tok[0]
        got.append(tok.numpy())
    assert cache["k"] is k_buf, "decode writes the cache it is handed"
    assert int(cache["length"]) == S + steps
    cache = {k: v[0] for k, v in cache.items()}
    np.testing.assert_array_equal(np.concatenate(got, axis=1), want_tokens)
    # the continuation's logits, against the reference step's and against
    # one forward over prompt + generated tokens
    seq = np.concatenate([tokens, np.concatenate(got, axis=1)[:, :-1]], 1)
    full, _, _ = zoo.forward_seq(arch_t, params_t, torch.from_numpy(seq),
                                 compute_dtype=torch.float32)
    last, _ = zoo.decode_step(arch_t, params_t, {
        **cache, "length": cache["length"] - 1}, torch.from_numpy(seq[:, -1:]),
        compute_dtype=torch.float32)
    assert _rel(last[:, 0], want_logits[:, 0]) < 1e-4
    assert _rel(last[:, 0], full[:, -1]) < 1e-4


def _stacked_cache(arch, seed, n_pods=2, B=2, S=16):
    rng = np.random.default_rng(seed)
    L, KV, D = arch.num_layers, arch.num_kv_heads, arch.resolved_head_dim
    return {"k": rng.standard_normal((n_pods, L, B, S, KV, D))
            .astype(np.float32),
            "v": rng.standard_normal((n_pods, L, B, S, KV, D))
            .astype(np.float32),
            "length": np.array([7, 9, 11][:n_pods], np.int32)}


def test_replicate_and_migrate_match_reference_semantics(model):
    _, arch_t, _, _ = model
    live_np = _stacked_cache(arch_t, 3)
    replicate = serve.make_replicate_sessions_step(device="cpu")
    migrate = serve.make_migrate_sessions_step(device="cpu")
    live = cache_from_numpy(live_np, device="cpu")
    backup = replicate(live)
    # the reference's replicate step: jnp.roll over the pod dim
    ref_live = {k: jnp.asarray(v) for k, v in live_np.items()}
    ref_backup = jax.tree.map(lambda c: jnp.roll(c, 1, axis=0), ref_live)
    got = cache_to_numpy(backup)
    for key in ref_live:
        np.testing.assert_array_equal(got[key], np.asarray(ref_backup[key]))
    # tests/test_pod_replication.py: pod1's backup slot holds pod0's sessions
    np.testing.assert_array_equal(got["k"][1], live_np["k"][0])
    np.testing.assert_array_equal(got["length"], [9, 7])
    dead = np.array([True, False])
    restored = migrate(live, backup, torch.from_numpy(dead))
    ref_restored = jax.tree.map(
        lambda l, b: jnp.where(jnp.asarray(dead).reshape(
            (2,) + (1,) * (l.ndim - 1)), b, l), ref_live, ref_backup)
    got = cache_to_numpy(restored)
    for key in ref_live:
        np.testing.assert_array_equal(got[key],
                                      np.asarray(ref_restored[key]))
    # pod0 flagged dead -> its slot now carries the backup contents, which
    # with 2 pods is its ring neighbour's copy
    np.testing.assert_array_equal(got["k"][0], to_np(backup["k"][0]))
    np.testing.assert_array_equal(got["k"][1], live_np["k"][1])
    np.testing.assert_array_equal(got["length"], [9, 9])


def test_shared_weights_decode_like_stacked_copies(model):
    """The port's pods share one weight tree; the reference vmaps
    ``decode_step`` over pod-stacked identical copies.  Greedy tokens equal
    and caches agree, each pod at its own length."""
    arch_r, arch_t, params_r, params_t = model
    n_pods, B, S, steps = 2, 2, 16, 5
    live_np = _stacked_cache(arch_t, 4, n_pods, B, S)
    for key in ("k", "v"):      # positions past each pod's length are empty
        for pod, n in enumerate(live_np["length"]):
            live_np[key][pod, :, :, n:] = 0.0
    tok_np = np.random.default_rng(5).integers(
        0, arch_r.vocab_size, (n_pods, B, 1)).astype(np.int32)

    sparams = jax.tree.map(lambda l: jnp.stack([l] * n_pods), params_r)
    ref_step = jax.vmap(lambda p, c, t: ref_zoo.decode_step(
        arch_r, p, c, t, compute_dtype=jnp.float32))
    ref_cache = {k: jnp.asarray(v) for k, v in live_np.items()}
    ref_tok, want = jnp.asarray(tok_np), []
    for _ in range(steps):
        logits, ref_cache = ref_step(sparams, ref_cache, ref_tok)
        ref_tok = jnp.argmax(logits[..., -1, :], axis=-1)[..., None].astype(
            jnp.int32)
        want.append(np.asarray(ref_tok))

    step = serve.make_decode_step(arch_t, n_pods=n_pods, device="cpu",
                                  compute_dtype=torch.float32)
    cache = cache_from_numpy(live_np, device="cpu")
    tok, got = torch.from_numpy(tok_np), []
    for _ in range(steps):
        tok, cache = step(params_t, cache, tok)
        got.append(tok.numpy().copy())
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    np.testing.assert_array_equal(to_np(cache["length"]),
                                  live_np["length"] + steps)
    for key in ("k", "v"):
        assert _rel(cache[key], ref_cache[key]) < 1e-4, key


def test_pod_stacked_step_checks_its_state(model):
    arch_t, params_t = model[1], model[3]
    step = serve.make_decode_step(arch_t, n_pods=2, device="cpu")
    cache = cache_from_numpy(_stacked_cache(arch_t, 6, n_pods=3),
                             device="cpu")
    with pytest.raises(ValueError, match="2 pods"):
        step(params_t, cache, torch.ones((3, 2, 1), dtype=torch.int32))


def test_steps_run_on_their_device_only(model, monkeypatch):
    """``device=None`` means the card and raises without one; a step made
    for the card refuses CPU tensors rather than computing on the CPU."""
    arch_t, params_t = model[1], model[3]
    shape = tc.ShapeConfig("p", 16, 2, tc.StepKind.PREFILL)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: serve.make_prefill_step(arch_t, shape),
                 lambda: serve.make_decode_step(arch_t),
                 serve.make_replicate_sessions_step,
                 serve.make_migrate_sessions_step):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zoo.init_cache(arch_t, 2, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zoo.init_params(arch_t)
    prefill = serve.make_prefill_step(arch_t, shape, device="cuda:0")
    with pytest.raises(ValueError, match="runs on cuda:0"):
        prefill(params_t, {"tokens": torch.zeros((2, 16), dtype=torch.int32)})
    replicate = serve.make_replicate_sessions_step(device="cuda:0")
    with pytest.raises(ValueError, match="runs on cuda:0"):
        replicate(cache_from_numpy(_stacked_cache(arch_t, 7), device="cpu"))


# ---------------------------------------------------------------------------
# zamba2 (hybrid): Mamba-2 states, the shared block's ring cache
# ---------------------------------------------------------------------------
#
# zamba2-7b reduced: 5 layers as 2 groups of 2 Mamba-2 layers + the shared
# attention block, then a tail of 1; d 128, 4 heads (kv 4) of 32, sliding
# window 64.  Prompts of S=128 > 64 tokens, so the prefill cache keeps the
# last 64 positions and decode wraps the 64-slot ring.

ZAMBA = "zamba2-7b"
Z_B, Z_S, Z_STEPS = 2, 128, 20


@pytest.fixture(scope="module")
def zamba():
    arch_r = rc.reduced(rc.get_arch(ZAMBA))
    arch_t = tc.reduced(tc.get_arch(ZAMBA))
    params_r = ref_zoo.init_params(arch_r, jax.random.PRNGKey(1))
    params_t = params_from_numpy(arch_t, jax.device_get(params_r),
                                 device="cpu")
    return arch_r, arch_t, params_r, params_t


def _tree_rel(got, want, tol, path=""):
    """Every leaf of two nested trees: same keys and shapes, rel <= tol
    (integer leaves equal)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _tree_rel(got[k], want[k], tol, f"{path}/{k}")
        return
    g, w = to_np(got), to_np(want)
    assert g.shape == w.shape, (path, g.shape, w.shape)
    if np.issubdtype(w.dtype, np.integer):
        np.testing.assert_array_equal(g, w, err_msg=path)
    else:
        assert _rel(got, want) <= tol, path


@pytest.fixture(scope="module")
def zamba_reference_run(zamba):
    """The reference's prefill (f32) of two pods' prompts and Z_STEPS
    greedy decode steps (a jitted step): per pod (tokens, final cache)."""
    import functools
    arch_r, _, params_r, _ = zamba
    step = jax.jit(functools.partial(ref_zoo.decode_step, arch_r,
                                     compute_dtype=jnp.float32))
    out = []
    for pod in range(2):
        tokens = _prompt(10 + pod, Z_B, Z_S, arch_r.vocab_size)
        logits, _, cache = ref_zoo.forward_seq(
            arch_r, params_r, jnp.asarray(tokens), return_cache=True,
            compute_dtype=jnp.float32)
        cache = {**cache, "length": jnp.asarray(Z_S, jnp.int32)}
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
        got = [np.asarray(tok)]
        for _ in range(Z_STEPS):
            logits, cache = step(params_r, cache, tok)
            tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(
                jnp.int32)
            got.append(np.asarray(tok))
        out.append((np.concatenate(got, axis=1), jax.device_get(cache)))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_zamba_forward_seq_logits_and_cache_match(zamba, impl, dtype):
    """Logits and the whole prefill cache tree (Mamba-2 conv windows and
    states per group and in the tail, the shared block's last-64 K/V and
    their positions) against the reference's, FLASH being the SSD and
    attention kernels' plain versions here and the Pallas attention kernel
    in interpret mode there."""
    arch_r, arch_t, params_r, params_t = zamba
    jdt, tdt, tol = DTYPES[dtype]
    tokens = _prompt(1, Z_B, Z_S, arch_r.vocab_size)
    want, _, wcache = ref_zoo.forward_seq(
        arch_r, params_r, jnp.asarray(tokens), impl=rc.AttnImpl(impl),
        return_cache=True, compute_dtype=jdt)
    got, aux, gcache = zoo.forward_seq(
        arch_t, params_t, torch.from_numpy(tokens), impl=tc.AttnImpl(impl),
        return_cache=True, compute_dtype=tdt)
    assert got.dtype == tdt and float(aux) == 0.0
    assert _rel(got, want) < tol
    assert gcache["shared_k"].shape[2] == 64
    _tree_rel(gcache, wcache, tol)


@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_zamba_greedy_decode_wraps_the_ring(zamba, zamba_reference_run,
                                            impl):
    """Two pods, each prefilled through the port's prefill step and decoded
    Z_STEPS greedy steps in one pod-stacked cache (positions 128..147 go to
    ring slots 0..19): the tokens equal the reference's in f32 and every
    cache leaf agrees; decode writes the tree it is handed."""
    arch_r, arch_t, params_r, params_t = zamba
    pshape = tc.ShapeConfig("p", Z_S, Z_B, tc.StepKind.PREFILL)
    prefill = serve.make_prefill_step(arch_t, pshape, impl=tc.AttnImpl(impl),
                                      device="cpu",
                                      compute_dtype=torch.float32)
    step = serve.make_decode_step(arch_t, n_pods=2, device="cpu",
                                  compute_dtype=torch.float32)
    caches, first = [], []
    for pod in range(2):
        tokens = _prompt(10 + pod, Z_B, Z_S, arch_r.vocab_size)
        logits, pc = prefill(params_t, {"tokens": torch.from_numpy(tokens)})
        assert int(pc["length"]) == Z_S
        caches.append(pc)
        first.append(torch.argmax(logits[:, -1, :], dim=-1)[:, None])
    cache = tree_map(lambda *v: torch.stack(v), *caches)
    state_buf, ring_buf = cache["mamba"]["state"], cache["shared_k"]
    tok = torch.stack(first).to(torch.int32)
    got = [tok.numpy()]
    for _ in range(Z_STEPS):
        tok, cache = step(params_t, cache, tok)
        got.append(tok.numpy())
    assert cache["mamba"]["state"] is state_buf and \
        cache["shared_k"] is ring_buf, "decode writes the cache in place"
    got = np.concatenate(got, axis=2)
    for pod, (want_tokens, want_cache) in enumerate(zamba_reference_run):
        np.testing.assert_array_equal(got[pod], want_tokens)
        _tree_rel(tree_map(lambda v: v[pod], cache), want_cache, 1e-4)
    assert to_np(cache["shared_pos"]).max() == Z_S + Z_STEPS - 1


def test_zamba_prefill_then_decode_continuation(zamba):
    """``tests/test_arch_smoke.py``'s check on the port: prefill S tokens,
    decode one more; the step's logits match one forward over S+1 tokens
    (f32), so the emitted prefill cache is the decode state."""
    arch_r, arch_t, params_r, params_t = zamba
    tokens = torch.from_numpy(_prompt(3, 1, Z_S + 1, arch_r.vocab_size))
    full, _, _ = zoo.forward_seq(arch_t, params_t, tokens,
                                 compute_dtype=torch.float32)
    _, _, cache = zoo.forward_seq(arch_t, params_t, tokens[:, :Z_S],
                                  return_cache=True,
                                  compute_dtype=torch.float32)
    cache["length"] = torch.tensor(Z_S, dtype=torch.int32)
    want = zoo.init_cache(arch_t, 1, Z_S + 1, dtype=torch.float32,
                          device="cpu")
    assert tree_map(lambda v: v.shape, cache) == \
        tree_map(lambda v: v.shape, want)
    step, _ = zoo.decode_step(arch_t, params_t, cache, tokens[:, Z_S:],
                              compute_dtype=torch.float32)
    assert _rel(step[:, 0], full[:, -1]) < 1e-4


def test_zamba_init_cache_matches_reference(zamba):
    """The decode cache's tree, shapes and dtypes: a ring of
    ``sliding_window`` slots when that is shorter than max_len, else
    max_len slots; empty slots at position -1; f32 SSM states."""
    arch_r, arch_t, _, _ = zamba
    for max_len in (200, 40):
        want = jax.device_get(ref_zoo.init_cache(arch_r, 2, max_len))
        got = zoo.init_cache(arch_t, 2, max_len, device="cpu")
        assert tree_map(lambda t: (tuple(t.shape), str(t.dtype)),
                               got) == jax.tree.map(
            lambda a: (a.shape, "torch." + a.dtype.name), want)
        _tree_rel(got, want, 0.0)


def test_zamba_replicate_and_migrate_nested(zamba):
    """``replicate``/``migrate`` map over every leaf of the nested
    pod-stacked tree: ``jnp.roll``/``jnp.where`` on each leaf of the
    reference's tree, bit for bit."""
    _, arch_t, _, _ = zamba
    rng = np.random.default_rng(8)
    empty = zoo.init_cache(arch_t, 2, 200, device="cpu")
    live_np = tree_map(lambda v: rng.standard_normal(
        (3,) + tuple(v.shape)).astype(np.float32), empty)
    live_np["shared_pos"] = rng.integers(
        -1, 99, (3,) + tuple(empty["shared_pos"].shape)).astype(np.int32)
    live_np["length"] = np.array([7, 9, 11], np.int32)
    live = cache_from_numpy(live_np, device="cpu")
    backup = serve.make_replicate_sessions_step(device="cpu")(live)
    ref_live = jax.tree.map(jnp.asarray, live_np)
    ref_backup = jax.tree.map(lambda c: jnp.roll(c, 1, axis=0), ref_live)
    _tree_rel(backup, ref_backup, 0.0)
    np.testing.assert_array_equal(to_np(backup["mamba"]["state"][1]),
                                  live_np["mamba"]["state"][0])
    dead = np.array([True, False, False])
    restored = serve.make_migrate_sessions_step(device="cpu")(
        live, backup, torch.from_numpy(dead))
    ref_restored = jax.tree.map(
        lambda l, b: jnp.where(jnp.asarray(dead).reshape(
            (3,) + (1,) * (l.ndim - 1)), b, l), ref_live, ref_backup)
    _tree_rel(restored, ref_restored, 0.0)
    np.testing.assert_array_equal(to_np(restored["length"]), [11, 9, 11])


def test_zamba_cache_carries_across(zamba):
    """A reference prefill cache round-trips through ``cache_from_numpy``
    and ``cache_to_numpy``; ``dtype`` casts the K/V and conv windows only,
    the SSM states stay f32 and the positions and length int32."""
    arch_r, _, params_r, _ = zamba
    tokens = _prompt(4, Z_B, Z_S, arch_r.vocab_size)
    _, _, wcache = ref_zoo.forward_seq(arch_r, params_r, jnp.asarray(tokens),
                                       return_cache=True)
    wcache = jax.device_get({**wcache, "length": jnp.asarray(Z_S, jnp.int32)})
    for dtype in (None, torch.bfloat16):
        cache = cache_from_numpy(wcache, device="cpu", dtype=dtype)
        kv = dtype or torch.bfloat16      # the reference's bf16 compute dtype
        assert cache["shared_k"].dtype == cache["mamba"]["conv_x"].dtype \
            == cache["tail"]["conv_B"].dtype == kv
        assert cache["mamba"]["state"].dtype == torch.float32
        assert cache["tail"]["state"].dtype == torch.float32
        assert cache["shared_pos"].dtype == cache["length"].dtype \
            == torch.int32
        _tree_rel(cache_to_numpy(cache), wcache, 0.0)


# ---------------------------------------------------------------------------
# xlstm (ssm): recurrent session state, mLSTM matrix memories, sLSTM cells
# ---------------------------------------------------------------------------
#
# xlstm-350m reduced: 8 layers as 1 group of 7 mLSTM layers + 1 sLSTM layer;
# d 128, mLSTM 2 heads of 128 (chunk 16), sLSTM 2 heads of 64; vocab 512.
# The reference initialises the groupnorm scales to 0, which multiply the
# normalised cell output, so every block would add 0: the scales are drawn
# by numpy around 1 for both packages.  Prompts of 64 tokens (4 chunks).

XLSTM = "xlstm-350m"
X_B, X_S, X_STEPS = 2, 64, 12


def _xlstm_norms(params_np, seed):
    """``params_np`` with every groupnorm scale drawn around 1."""
    rng = np.random.default_rng(seed)
    blocks = params_np["blocks"]
    for cell in (blocks["mlstm"]["cell"], blocks["slstm"]["cell"]):
        cell["norm"] = (1.0 + 0.1 * rng.standard_normal(cell["norm"].shape)
                        ).astype(np.float32)
    return params_np


@pytest.fixture(scope="module")
def xlstm_model():
    arch_r = rc.reduced(rc.get_arch(XLSTM))
    arch_t = tc.reduced(tc.get_arch(XLSTM))
    params_np = _xlstm_norms(jax.device_get(ref_zoo.init_params(
        arch_r, jax.random.PRNGKey(2))), 5)
    params_r = jax.tree.map(jnp.asarray, params_np)
    params_t = params_from_numpy(arch_t, params_np, device="cpu")
    return arch_r, arch_t, params_r, params_t


@pytest.fixture(scope="module")
def xlstm_reference_run(xlstm_model):
    """The reference's prefill (f32) of two pods' prompts and X_STEPS
    greedy decode steps (a jitted step): per pod (tokens, final cache)."""
    import functools
    arch_r, _, params_r, _ = xlstm_model
    step = jax.jit(functools.partial(ref_zoo.decode_step, arch_r,
                                     compute_dtype=jnp.float32))
    out = []
    for pod in range(2):
        tokens = _prompt(20 + pod, X_B, X_S, arch_r.vocab_size)
        logits, _, cache = ref_zoo.forward_seq(
            arch_r, params_r, jnp.asarray(tokens), return_cache=True,
            compute_dtype=jnp.float32)
        cache = {**cache, "length": jnp.asarray(X_S, jnp.int32)}
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
        got = [np.asarray(tok)]
        for _ in range(X_STEPS):
            logits, cache = step(params_r, cache, tok)
            tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(
                jnp.int32)
            got.append(np.asarray(tok))
        out.append((np.concatenate(got, axis=1), jax.device_get(cache)))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_xlstm_forward_seq_logits_and_cache_match(xlstm_model, impl, dtype):
    """Logits and the whole prefill cache tree (per mLSTM layer the conv
    window and the f32 C, n, m; per sLSTM layer c, n, m and h) against the
    reference's, FLASH being the mLSTM kernel's plain version here and the
    reference's own jnp cell there (its model calls no kernel)."""
    arch_r, arch_t, params_r, params_t = xlstm_model
    jdt, tdt, tol = DTYPES[dtype]
    tokens = _prompt(1, X_B, X_S, arch_r.vocab_size)
    want, _, wcache = ref_zoo.forward_seq(
        arch_r, params_r, jnp.asarray(tokens), impl=rc.AttnImpl(impl),
        return_cache=True, compute_dtype=jdt)
    got, aux, gcache = zoo.forward_seq(
        arch_t, params_t, torch.from_numpy(tokens), impl=tc.AttnImpl(impl),
        return_cache=True, compute_dtype=tdt)
    assert got.dtype == tdt and float(aux) == 0.0
    assert _rel(got, want) < tol
    assert gcache["mlstm"]["C"].shape == (1, 7, X_B, 2, 128, 128)
    _tree_rel(gcache, wcache, tol)


@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_xlstm_greedy_decode_matches(xlstm_model, xlstm_reference_run,
                                     impl):
    """Two pods, each prefilled through the port's prefill step and decoded
    X_STEPS greedy steps in one pod-stacked cache: the tokens equal the
    reference's in f32 and every cache leaf agrees; decode writes the tree
    it is handed."""
    arch_r, arch_t, params_r, params_t = xlstm_model
    pshape = tc.ShapeConfig("p", X_S, X_B, tc.StepKind.PREFILL)
    prefill = serve.make_prefill_step(arch_t, pshape, impl=tc.AttnImpl(impl),
                                      device="cpu",
                                      compute_dtype=torch.float32)
    step = serve.make_decode_step(arch_t, n_pods=2, device="cpu",
                                  compute_dtype=torch.float32)
    caches, first = [], []
    for pod in range(2):
        tokens = _prompt(20 + pod, X_B, X_S, arch_r.vocab_size)
        logits, pc = prefill(params_t, {"tokens": torch.from_numpy(tokens)})
        assert int(pc["length"]) == X_S
        caches.append(pc)
        first.append(torch.argmax(logits[:, -1, :], dim=-1)[:, None])
    cache = tree_map(lambda *v: torch.stack(v), *caches)
    bufs = [x for _, x in sorted(_flat(cache).items())]
    tok = torch.stack(first).to(torch.int32)
    got = [tok.numpy()]
    for _ in range(X_STEPS):
        tok, cache = step(params_t, cache, tok)
        got.append(tok.numpy())
    assert all(a is b for a, b in zip(
        [x for _, x in sorted(_flat(cache).items())], bufs)), \
        "decode writes the cache in place"
    got = np.concatenate(got, axis=2)
    for pod, (want_tokens, want_cache) in enumerate(xlstm_reference_run):
        np.testing.assert_array_equal(got[pod], want_tokens)
        _tree_rel(tree_map(lambda v: v[pod], cache), want_cache, 1e-4)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: tree}


def test_xlstm_prefill_then_decode_continuation(xlstm_model):
    """``tests/test_arch_smoke.py``'s check on the port: prefill S tokens,
    decode one more; the step's logits match one forward over S+1 tokens
    (f32), so the emitted prefill cache is the decode state."""
    arch_r, arch_t, params_r, params_t = xlstm_model
    tokens = torch.from_numpy(_prompt(3, 1, X_S + 1, arch_r.vocab_size))
    full, _, _ = zoo.forward_seq(arch_t, params_t, tokens,
                                 compute_dtype=torch.float32)
    _, _, cache = zoo.forward_seq(arch_t, params_t, tokens[:, :X_S],
                                  impl=tc.AttnImpl.FLASH, return_cache=True,
                                  compute_dtype=torch.float32)
    cache["length"] = torch.tensor(X_S, dtype=torch.int32)
    want = zoo.init_cache(arch_t, 1, X_S + 1, dtype=torch.float32,
                          device="cpu")
    assert tree_map(lambda v: (v.shape, v.dtype), cache) == \
        tree_map(lambda v: (v.shape, v.dtype), want)
    step, _ = zoo.decode_step(arch_t, params_t, cache, tokens[:, X_S:],
                              compute_dtype=torch.float32)
    assert _rel(step[:, 0], full[:, -1]) < 1e-4


def test_xlstm_init_cache_matches_reference(xlstm_model):
    """The decode cache's tree, shapes and dtypes: (G, 7, ...) mLSTM and
    (G, ...) sLSTM states, conv windows and the sLSTM h in the cache dtype,
    C, n, m and c f32, all zero; no leaf depends on max_len."""
    arch_r, arch_t, _, _ = xlstm_model
    for max_len in (200, 40):
        want = jax.device_get(ref_zoo.init_cache(arch_r, 2, max_len))
        got = zoo.init_cache(arch_t, 2, max_len, device="cpu")
        assert tree_map(lambda t: (tuple(t.shape), str(t.dtype)),
                        got) == jax.tree.map(
            lambda a: (a.shape, "torch." + a.dtype.name), want)
        _tree_rel(got, want, 0.0)


def test_xlstm_replicate_and_migrate_nested(xlstm_model):
    """``replicate``/``migrate`` map over every leaf of the nested
    pod-stacked recurrent tree: ``jnp.roll``/``jnp.where`` on each leaf of
    the reference's tree, bit for bit."""
    _, arch_t, _, _ = xlstm_model
    rng = np.random.default_rng(9)
    empty = zoo.init_cache(arch_t, 2, 64, device="cpu")
    live_np = tree_map(lambda v: rng.standard_normal(
        (3,) + tuple(v.shape)).astype(np.float32), empty)
    live_np["length"] = np.array([7, 9, 11], np.int32)
    live = cache_from_numpy(live_np, device="cpu")
    backup = serve.make_replicate_sessions_step(device="cpu")(live)
    ref_live = jax.tree.map(jnp.asarray, live_np)
    ref_backup = jax.tree.map(lambda c: jnp.roll(c, 1, axis=0), ref_live)
    _tree_rel(backup, ref_backup, 0.0)
    np.testing.assert_array_equal(to_np(backup["mlstm"]["C"][1]),
                                  live_np["mlstm"]["C"][0])
    dead = np.array([False, True, False])
    restored = serve.make_migrate_sessions_step(device="cpu")(
        live, backup, torch.from_numpy(dead))
    ref_restored = jax.tree.map(
        lambda l, b: jnp.where(jnp.asarray(dead).reshape(
            (3,) + (1,) * (l.ndim - 1)), b, l), ref_live, ref_backup)
    _tree_rel(restored, ref_restored, 0.0)
    np.testing.assert_array_equal(to_np(restored["slstm"]["h"][1]),
                                  live_np["slstm"]["h"][0])
    np.testing.assert_array_equal(to_np(restored["length"]), [7, 7, 11])


def test_xlstm_cache_carries_across(xlstm_model):
    """A reference prefill cache round-trips through ``cache_from_numpy``
    and ``cache_to_numpy``; ``dtype`` casts the conv windows and the sLSTM
    h only, the mLSTM C, n, m and the sLSTM c, n, m stay f32 and the length
    int32."""
    arch_r, _, params_r, _ = xlstm_model
    tokens = _prompt(4, X_B, X_S, arch_r.vocab_size)
    _, _, wcache = ref_zoo.forward_seq(arch_r, params_r, jnp.asarray(tokens),
                                       return_cache=True)
    wcache = jax.device_get({**wcache, "length": jnp.asarray(X_S, jnp.int32)})
    for dtype in (None, torch.bfloat16):
        cache = cache_from_numpy(wcache, device="cpu", dtype=dtype)
        cast = dtype or torch.bfloat16    # the reference's bf16 compute dtype
        assert cache["mlstm"]["conv"].dtype == cache["slstm"]["h"].dtype \
            == cast
        for key in ("C", "n", "m"):
            assert cache["mlstm"][key].dtype == torch.float32, key
        for key in ("c", "n", "m"):
            assert cache["slstm"][key].dtype == torch.float32, key
        assert cache["length"].dtype == torch.int32
        _tree_rel(cache_to_numpy(cache), wcache, 0.0)


# ---------------------------------------------------------------------------
# moe (grok-1, kimi-k2), vlm (phi-3-vision) and audio (whisper-tiny)
# ---------------------------------------------------------------------------
#
# Reduced: grok-1 and kimi-k2 4 layers of attention (4 heads, kv 1 and 2)
# and 8 experts of 128, top-2 (kimi-k2 with a shared expert); phi-3-vision 4
# dense layers behind 8 patch positions; whisper-tiny 2 encoder layers over
# 8 frames and 2 decoder layers.  The stubs' embeddings come from numpy.
# Prompts of 32 tokens (phi-3-vision: 8 patches + 24 text tokens), 6 greedy
# steps in a cache of 48 positions.  The moe families are compared in f32
# only: in bf16 the two packages round the expert FFN at other points
# (torch's silu rounds once), which flips near-tied routes.

FAMILIES = ["grok-1-314b", "kimi-k2-1t-a32b", "phi-3-vision-4.2b",
            "whisper-tiny"]
F_B, F_S, F_STEPS, F_LEN = 2, 32, 6, 48
_STUB = {"clip_patches": "patch_embeds", "audio_frames": "frame_embeds"}


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    arch_r = rc.reduced(rc.get_arch(request.param))
    arch_t = tc.reduced(tc.get_arch(request.param))
    params_r = ref_zoo.init_params(arch_r, jax.random.PRNGKey(3))
    params_t = params_from_numpy(arch_t, jax.device_get(params_r),
                                 device="cpu")
    return arch_r, arch_t, params_r, params_t


def _family_batch(arch, seed, B=F_B, S=F_S):
    """(numpy batch): tokens and the front-end stub's embeddings (scale
    0.02, as ``example_batch`` draws them)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": _prompt(seed, B, S, arch.vocab_size)}
    if arch.frontend_stub in _STUB:
        batch[_STUB[arch.frontend_stub]] = (0.02 * rng.standard_normal(
            (B, arch.num_patches, arch.d_model))).astype(np.float32)
    return batch


def _ref_run(arch, params, batch, steps, cache_len):
    """The reference's prefill (f32) and ``steps`` greedy decode steps (a
    jitted step) in a cache of ``cache_len``: (tokens, final cache)."""
    import functools
    logits, _, cache = ref_zoo.forward_seq(
        arch, params, jnp.asarray(batch["tokens"]),
        extra={k: jnp.asarray(v) for k, v in batch.items()},
        return_cache=True, compute_dtype=jnp.float32)
    full = ref_zoo.init_cache(arch, batch["tokens"].shape[0], cache_len,
                              dtype=jnp.float32)
    cache = {k: jax.lax.dynamic_update_slice(full[k], v, (0,) * v.ndim)
             for k, v in cache.items()}
    cache["length"] = jnp.asarray(batch["tokens"].shape[1], jnp.int32)
    step = jax.jit(functools.partial(ref_zoo.decode_step, arch,
                                     compute_dtype=jnp.float32))
    tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
    got = [np.asarray(tok)]
    for _ in range(steps):
        logits, cache = step(params, cache, tok)
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
        got.append(np.asarray(tok))
    return np.concatenate(got, axis=1), jax.device_get(cache)


@pytest.fixture(scope="module")
def family_reference_run(family):
    """Two pods' prompts through the reference: per pod (tokens, cache)."""
    arch_r, _, params_r, _ = family
    return [_ref_run(arch_r, params_r, _family_batch(arch_r, 30 + pod),
                     F_STEPS, F_LEN) for pod in range(2)]


def _forward_matches(arch_r, arch_t, params_r, params_t, impl, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    batch = _family_batch(arch_r, 1)
    want, waux, wcache = ref_zoo.forward_seq(
        arch_r, params_r, jnp.asarray(batch["tokens"]),
        extra={k: jnp.asarray(v) for k, v in batch.items()},
        impl=rc.AttnImpl(impl), return_cache=True, compute_dtype=jdt)
    got, gaux, gcache = zoo.forward_seq(
        arch_t, params_t, torch.from_numpy(batch["tokens"]),
        extra={k: torch.from_numpy(v) for k, v in batch.items()},
        impl=tc.AttnImpl(impl), return_cache=True, compute_dtype=tdt)
    assert got.dtype == tdt and gaux.dtype == torch.float32
    assert _rel(got, want) < tol
    np.testing.assert_allclose(float(gaux), float(waux), rtol=tol, atol=1e-7)
    assert (float(gaux) > 0) == (arch_t.family == "moe")
    _tree_rel(gcache, wcache, tol)


@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_family_forward_seq_logits_aux_and_cache_match(family, impl):
    """Logits, the moe aux loss and the whole prefill cache (moe k/v;
    whisper's self and cross K/V) against the reference's in f32, FLASH
    being the flash kernel's plain version here and the Pallas kernel in
    interpret mode there."""
    _forward_matches(*family, impl, "float32")


@pytest.mark.parametrize("impl", ["flash", "reference"])
@pytest.mark.parametrize("arch_id", ["phi-3-vision-4.2b", "whisper-tiny"])
def test_stub_families_forward_seq_in_bf16(arch_id, impl):
    """The same in bf16 (5e-2) for the vlm and whisper (the moe families
    are held in f32 only: above)."""
    arch_r = rc.reduced(rc.get_arch(arch_id))
    arch_t = tc.reduced(tc.get_arch(arch_id))
    params_r = ref_zoo.init_params(arch_r, jax.random.PRNGKey(3))
    params_t = params_from_numpy(arch_t, jax.device_get(params_r),
                                 device="cpu")
    _forward_matches(arch_r, arch_t, params_r, params_t, impl, "bfloat16")


@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_family_greedy_decode_matches(family, family_reference_run, impl):
    """Two pods prefilled through the port's prefill step (the batch as
    ``extra``), each cache put in the leading corner of a pod-stacked
    decode cache of F_LEN positions, F_STEPS greedy steps of the pod-step:
    the tokens equal the reference's in f32 and every cache leaf agrees
    (1e-4); decode writes the tree it is handed."""
    arch_r, arch_t, params_r, params_t = family
    pshape = tc.ShapeConfig("p", F_S, F_B, tc.StepKind.PREFILL)
    prefill = serve.make_prefill_step(arch_t, pshape, impl=tc.AttnImpl(impl),
                                      device="cpu",
                                      compute_dtype=torch.float32)
    step = serve.make_decode_step(arch_t, n_pods=2, device="cpu",
                                  compute_dtype=torch.float32)
    live = tree_map(lambda v: torch.stack([v] * 2), zoo.init_cache(
        arch_t, F_B, F_LEN, dtype=torch.float32, device="cpu"))
    first = []
    for pod in range(2):
        batch = {k: torch.from_numpy(v) for k, v in
                 _family_batch(arch_r, 30 + pod).items()}
        logits, pc = prefill(params_t, batch)
        assert int(pc["length"]) == F_S
        tree_map(lambda dst, src: dst[pod][tuple(
            slice(0, n) for n in src.shape)].copy_(src), live, pc)
        first.append(torch.argmax(logits[:, -1, :], dim=-1)[:, None])
    bufs = [x for _, x in sorted(_flat(live).items())]
    tok = torch.stack(first).to(torch.int32)
    got = [tok.numpy()]
    for _ in range(F_STEPS):
        tok, live = step(params_t, live, tok)
        got.append(tok.numpy())
    assert all(a is b for a, b in zip(
        [x for _, x in sorted(_flat(live).items())], bufs))
    got = np.concatenate(got, axis=2)
    for pod, (want_tokens, want_cache) in enumerate(family_reference_run):
        np.testing.assert_array_equal(got[pod], want_tokens)
        _tree_rel(tree_map(lambda v: v[pod], live), want_cache, 1e-4)


def test_family_prefill_then_decode_continuation(family):
    """``tests/test_arch_smoke.py``'s check on the port: prefill S tokens,
    decode the next one; the step's logits match one forward over S+1
    tokens (f32), so the prefill cache is the decode state.  The vlm's
    forward over S+1 keeps its patches in front, so its next text token is
    the one at S - num_patches."""
    arch_r, arch_t, _, params_t = family
    batch = {k: torch.from_numpy(v) for k, v in
             _family_batch(arch_r, 4, S=F_S + 1).items()}
    tokens = batch["tokens"]
    full, _, none = zoo.forward_seq(arch_t, params_t, tokens, extra=batch,
                                    compute_dtype=torch.float32)
    assert none is None            # no cache asked for (whisper included)
    _, _, pc = zoo.forward_seq(arch_t, params_t, tokens[:, :F_S],
                               extra=batch, impl=tc.AttnImpl.FLASH,
                               return_cache=True, compute_dtype=torch.float32)
    cache = zoo.init_cache(arch_t, F_B, F_S + 1, dtype=torch.float32,
                           device="cpu")
    tree_map(lambda dst, src: dst[tuple(
        slice(0, n) for n in src.shape)].copy_(src),
        {k: cache[k] for k in pc}, pc)
    cache["length"].fill_(F_S)
    nxt = F_S - (arch_t.num_patches if arch_t.frontend_stub ==
                 "clip_patches" else 0)
    step, _ = zoo.decode_step(arch_t, params_t, cache,
                              tokens[:, nxt:nxt + 1],
                              compute_dtype=torch.float32)
    assert _rel(step[:, 0], full[:, -1]) < 1e-4


def test_family_init_cache_matches_reference(family):
    """The decode cache's tree, shapes and dtypes (moe k/v; whisper's
    self K/V of max_len and cross K/V of the encoder's frames), all
    zero."""
    arch_r, arch_t, _, _ = family
    for max_len in (200, 40):
        want = jax.device_get(ref_zoo.init_cache(arch_r, 2, max_len))
        got = zoo.init_cache(arch_t, 2, max_len, device="cpu")
        assert tree_map(lambda t: (tuple(t.shape), str(t.dtype)),
                        got) == jax.tree.map(
            lambda a: (a.shape, "torch." + a.dtype.name), want)
        _tree_rel(got, want, 0.0)


def test_family_replicate_migrate_and_carry(family):
    """``replicate``/``migrate`` over the family's pod-stacked tree, bit
    for bit against ``jnp.roll``/``jnp.where`` on the reference's; and a
    reference prefill cache through ``cache_from_numpy`` and back (``dtype``
    casts the K/V leaves, ``length`` stays int32)."""
    arch_r, arch_t, params_r, _ = family
    rng = np.random.default_rng(11)
    empty = zoo.init_cache(arch_t, 2, 40, device="cpu")
    live_np = tree_map(lambda v: rng.standard_normal(
        (3,) + tuple(v.shape)).astype(np.float32), empty)
    live_np["length"] = np.array([7, 9, 11], np.int32)
    live = cache_from_numpy(live_np, device="cpu")
    backup = serve.make_replicate_sessions_step(device="cpu")(live)
    ref_live = jax.tree.map(jnp.asarray, live_np)
    _tree_rel(backup, jax.tree.map(lambda c: jnp.roll(c, 1, axis=0),
                                   ref_live), 0.0)
    dead = np.array([True, False, False])
    restored = serve.make_migrate_sessions_step(device="cpu")(
        live, backup, torch.from_numpy(dead))
    key = "self_k" if arch_t.family == "audio" else "k"
    np.testing.assert_array_equal(to_np(restored[key][0]),
                                  live_np[key][2])
    np.testing.assert_array_equal(to_np(restored["length"]), [11, 9, 11])

    batch = _family_batch(arch_r, 5)
    _, _, wcache = ref_zoo.forward_seq(
        arch_r, params_r, jnp.asarray(batch["tokens"]),
        extra={k: jnp.asarray(v) for k, v in batch.items()},
        return_cache=True)
    wcache = jax.device_get({**wcache, "length": jnp.asarray(F_S,
                                                             jnp.int32)})
    for dtype in (None, torch.float32):
        cache = cache_from_numpy(wcache, device="cpu", dtype=dtype)
        want = dtype or torch.bfloat16    # the reference's bf16 compute dtype
        assert all(v.dtype == want for k, v in cache.items() if k != "length")
        assert cache["length"].dtype == torch.int32
        _tree_rel(cache_to_numpy(cache), wcache, 0.0)


def test_family_params_carry_reference_dtypes(family):
    """``params_from_numpy`` of the reference's bf16 serving tree keeps
    each leaf's dtype: the moe router f32, every other weight bf16."""
    arch_r, arch_t, _, _ = family
    tree = jax.device_get(ref_zoo.init_params(arch_r, jax.random.PRNGKey(0),
                                              dtype=jnp.bfloat16))
    params = params_from_numpy(arch_t, tree, device="cpu")
    got = {k: str(v.dtype).removeprefix("torch.")
           for k, v in _flat(params).items()}
    want = {k: v.dtype.name for k, v in _flat(tree).items()}
    assert got == want
    if arch_t.family == "moe":
        assert got["/blocks/moe/router"] == "float32"
    with pytest.raises(ValueError, match="parameter tree"):
        params_from_numpy(arch_t, {"embed": tree["embed"]}, device="cpu")


@pytest.mark.parametrize("arch_id", ["gemma-7b", "qwen1.5-32b",
                                     "qwen1.5-110b"])
def test_every_registry_config_prefill_and_decode_match(arch_id):
    """The registry's dense configs that the tests above do not drive
    (gemma-7b: GeGLU and tied embeddings; qwen1.5: qkv biases), reduced,
    through both packages on the same weights, f32: ``forward_seq``'s
    logits under REFERENCE and FLASH (1e-4), then the prefill cache put in
    the corner of a decode cache and 3 greedy ``decode_step``s, tokens
    equal and the last logits within 1e-4.  With the internlm2, zamba2,
    xlstm and family tests above, every one of the 10 reduced configs is
    held to the reference's prefill and decode."""
    arch_r = rc.reduced(rc.get_arch(arch_id))
    arch_t = tc.reduced(tc.get_arch(arch_id))
    params_np = jax.device_get(ref_zoo.init_params(arch_r,
                                                   jax.random.PRNGKey(4)))
    if arch_r.family == "ssm":
        params_np = _xlstm_norms(jax.tree.map(np.array, params_np), 6)
    params_r = jax.tree.map(jnp.asarray, params_np)
    params_t = params_from_numpy(arch_t, params_np, device="cpu")
    B, S, steps = 1, 16, 3
    batch = _family_batch(arch_r, 7, B=B, S=S)
    jextra = {k: jnp.asarray(v) for k, v in batch.items()}
    textra = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = {}
    for impl in ("reference", "flash"):
        want, _, wcache = ref_zoo.forward_seq(
            arch_r, params_r, jextra["tokens"], extra=jextra,
            impl=rc.AttnImpl(impl), return_cache=True,
            compute_dtype=jnp.float32)
        got, _, gcache = zoo.forward_seq(
            arch_t, params_t, textra["tokens"], extra=textra,
            impl=tc.AttnImpl(impl), return_cache=True,
            compute_dtype=torch.float32)
        assert _rel(got, want) < 1e-4, impl
        logits[impl] = (want, wcache, got, gcache)
    want, wcache, got, gcache = logits["reference"]
    wfull = ref_zoo.init_cache(arch_r, B, S + steps, dtype=jnp.float32)
    wcache = jax.tree.map(lambda f, c: jax.lax.dynamic_update_slice(
        f, c.astype(f.dtype), (0,) * c.ndim),
        {k: wfull[k] for k in wcache}, wcache)
    wcache["length"] = jnp.asarray(S, jnp.int32)
    tcache = zoo.init_cache(arch_t, B, S + steps, dtype=torch.float32,
                            device="cpu")
    tree_map(lambda d, s: d[tuple(slice(0, n) for n in s.shape)].copy_(s),
             {k: tcache[k] for k in gcache}, gcache)
    tcache["length"].fill_(S)
    wtok = jnp.argmax(want[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
    ttok = torch.argmax(got[:, -1, :], dim=-1)[:, None].to(torch.int32)
    for _ in range(steps):
        np.testing.assert_array_equal(to_np(ttok), np.asarray(wtok))
        wl, wcache = ref_zoo.decode_step(arch_r, params_r, wcache, wtok,
                                         compute_dtype=jnp.float32)
        tl, tcache = zoo.decode_step(arch_t, params_t, tcache, ttok,
                                     compute_dtype=torch.float32)
        wtok = jnp.argmax(wl[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
        ttok = torch.argmax(tl[:, -1, :], dim=-1)[:, None].to(torch.int32)
    np.testing.assert_array_equal(to_np(ttok), np.asarray(wtok))
    assert _rel(tl, wl) < 1e-4
