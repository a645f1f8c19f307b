"""The port's MoE layer against the reference's, function by function.

Reduced grok-1 (top-2 of 8 experts) and reduced kimi-k2 (top-2 of 8 with a
shared expert), d 128, experts of 128.  Router weights, expert weights and
activations are made by numpy from a seed and handed to both packages
(normal draws; the tie cases draw whole-number logits and all-zero
tokens, where equal probabilities go lowest expert first in both, as
``lax.top_k`` breaks ties).  Routes and bucket slots are
compared exactly; the routing weights and the aux loss in float32 at 1e-6
(the same f32 arithmetic up to summation order).  The layer's output is
held to 1e-5 of its largest magnitude: the reference draws expert weights
with a fan-in of the expert count (8, the stacked tensors' leading dim), so
the expert FFN's hidden values reach the hundreds and its f32 sums, taken
in another order by each package's matmul, differ by up to ~2e-6 of the
output's scale.  Drops are forced with a small ``cap_multiple`` and a
router skewed toward expert 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rc
from repro.models import moe as ref_moe
from repro_torch import configs as tc
from repro_torch.models import moe
from torch_parity import port_lockdep, to_np  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")

ARCHS = ["grok-1-314b", "kimi-k2-1t-a32b"]
T = 64                                  # tokens (B=2 x S=32)


def _archs(arch_id):
    return rc.reduced(rc.get_arch(arch_id)), tc.reduced(tc.get_arch(arch_id))


def _params(arch_r, seed, skew=0.0):
    """The reference's init (numpy on the host) with the router's column 0
    raised by ``skew``: both packages' parameter dicts."""
    p = jax.device_get(ref_moe.moe_init(jax.random.PRNGKey(seed), arch_r))
    p = jax.tree.map(np.array, p)
    p["router"][:, 0] += skew
    ref = jax.tree.map(jnp.asarray, p)
    port = jax.tree.map(torch.from_numpy, p)
    return ref, port


def _close(got, want, tol=1e-5):
    got, want = to_np(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < tol, err


def _x(seed, d, shape=(2, 32)):
    x = np.random.default_rng(seed).standard_normal(shape + (d,))
    return x.astype(np.float32)


@pytest.mark.parametrize("arch_id", ARCHS)
@pytest.mark.parametrize("skew", [0.0, 2.0])
def test_route_matches(arch_id, skew):
    arch_r, arch_t = _archs(arch_id)
    pr, pt = _params(arch_r, 0, skew)
    x = _x(1, arch_r.d_model).reshape(T, -1)
    we, ww, wa = ref_moe.route(pr["router"], jnp.asarray(x), arch_r.moe)
    ge, gw, ga = moe.route(pt["router"], torch.from_numpy(x), arch_t.moe)
    np.testing.assert_array_equal(to_np(ge), np.asarray(we))
    assert gw.dtype == torch.float32
    np.testing.assert_allclose(to_np(gw), to_np(ww), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(ga), float(wa), rtol=1e-6)


def test_route_upcasts_a_bf16_router():
    """The model casts the router to the compute dtype; the reference's
    f32 @ bf16 product promotes to f32, and the port upcasts both operands:
    the same f32 logits, the weights in x's dtype."""
    arch_r, arch_t = _archs("grok-1-314b")
    pr, pt = _params(arch_r, 2)
    x = _x(3, arch_r.d_model).reshape(T, -1)
    w16 = pr["router"].astype(jnp.bfloat16)
    we, ww, _ = ref_moe.route(w16, jnp.asarray(x).astype(jnp.bfloat16),
                              arch_r.moe)
    ge, gw, _ = moe.route(pt["router"].to(torch.bfloat16),
                          torch.from_numpy(x).to(torch.bfloat16), arch_t.moe)
    np.testing.assert_array_equal(to_np(ge), np.asarray(we))
    assert gw.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(gw), to_np(ww), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("num_experts,cap,skewed", [
    (8, 128, False), (8, 20, False), (8, 4, True), (9, 3, True)])
def test_dispatch_indices_bit_exact(num_experts, cap, skewed):
    """Slots and ``kept`` equal the reference's, with no drop (cap 128),
    a few (cap 20), and most (a skewed assignment, cap 4; 9 experts: the
    trash bucket of ``moe_apply_ep``)."""
    rng = np.random.default_rng(num_experts + cap)
    if skewed:
        idx = np.where(rng.random((T, 2)) < 0.7, 0,
                       rng.integers(0, num_experts, (T, 2)))
    else:
        idx = rng.integers(0, num_experts, (T, 2))
    idx = idx.astype(np.int32)
    ws, wk = ref_moe.dispatch_indices(jnp.asarray(idx), num_experts, cap)
    gs, gk = moe.dispatch_indices(torch.from_numpy(idx), num_experts, cap)
    np.testing.assert_array_equal(to_np(gs), np.asarray(ws))
    np.testing.assert_array_equal(to_np(gk), np.asarray(wk))
    assert (not bool(gk.all())) == (cap < 128 and (skewed or cap == 20))


@pytest.mark.parametrize("tokens,multiple", [(64, 128), (64, 8), (4, 8),
                                             (16384, 128), (3, 1)])
def test_capacity_matches(tokens, multiple):
    for arch_id in ARCHS:
        full_r, full_t = rc.get_arch(arch_id), tc.get_arch(arch_id)
        for a_r, a_t in ((full_r, full_t), _archs(arch_id)):
            assert moe.capacity(tokens, a_t.moe, multiple) == \
                ref_moe.capacity(tokens, a_r.moe, multiple)


@pytest.mark.parametrize("arch_id", ARCHS)
@pytest.mark.parametrize("drops", [False, True])
def test_moe_apply_matches(arch_id, drops):
    """The layer's output (1e-5 of its scale) and aux loss (1e-6) in f32:
    at ``cap_multiple``
    128 nothing drops; at 4 with a router skewed toward expert 0 most of
    expert 0's assignments drop, in both packages alike."""
    arch_r, arch_t = _archs(arch_id)
    skew, mult = (3.0, 4) if drops else (0.0, 128)
    pr, pt = _params(arch_r, 4, skew)
    x = _x(5, arch_r.d_model)
    want, waux = ref_moe.moe_apply(pr, jnp.asarray(x), arch_r,
                                   cap_multiple=mult)
    got, gaux = moe.moe_apply(pt, torch.from_numpy(x), arch_t,
                              cap_multiple=mult)
    idx, _, _ = moe.route(pt["router"], torch.from_numpy(x).reshape(T, -1),
                          arch_t.moe)
    cap = moe.capacity(T, arch_t.moe, mult)
    _, kept = moe.dispatch_indices(idx, arch_t.moe.num_experts, cap)
    assert bool(kept.all()) != drops
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-6)


def test_moe_apply_decode_buckets():
    """Decode's shape: one token a sequence, buckets of ``cap_multiple=8``
    (the reference's decode step)."""
    arch_r, arch_t = _archs("kimi-k2-1t-a32b")
    pr, pt = _params(arch_r, 6)
    x = _x(7, arch_r.d_model, (4, 1))
    want, _ = ref_moe.moe_apply(pr, jnp.asarray(x), arch_r, cap_multiple=8)
    got, _ = moe.moe_apply(pt, torch.from_numpy(x), arch_t, cap_multiple=8)
    _close(got, want)


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        else:
            out[f"{pre}{k}"] = v
    return out


def test_moe_init_tree_matches():
    """Keys, shapes and dtypes of the layer's parameters: the router f32
    in a bf16 tree; kimi-k2's shared expert."""
    for arch_id in ARCHS:
        arch_r, arch_t = _archs(arch_id)
        ref = jax.eval_shape(lambda: ref_moe.moe_init(
            jax.random.PRNGKey(0), arch_r, dtype=jnp.bfloat16))
        port = moe.moe_init(torch.Generator().manual_seed(0), arch_t,
                            dtype=torch.bfloat16)
        want = {k: (tuple(v.shape), v.dtype.name) for k, v in
                _flat(ref).items()}
        got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
               for k, v in _flat(port).items()}
        assert got == want
        assert got["router"][1] == "float32"


@pytest.mark.parametrize("shards,want", [(1, "ep"), (2, "ep"), (16, "tp"),
                                         (3, "tp")])
def test_expert_sharding_strategy_matches(shards, want):
    for arch_id in ARCHS:
        cfg_r, cfg_t = rc.get_arch(arch_id).moe, tc.get_arch(arch_id).moe
        got = moe.expert_sharding_strategy(cfg_t, shards)
        assert got == ref_moe.expert_sharding_strategy(cfg_r, shards)
    assert moe.expert_sharding_strategy(tc.get_arch("grok-1-314b").moe,
                                        shards) == want


TIE_CASES = [(8, 1), (8, 2), (16, 2), (16, 4)]


def _tied(arch_r, arch_t, num_experts, top_k, seed):
    """Both packages' archs at ``num_experts`` and ``top_k``, a router of
    whole numbers in [-2, 2] and (T, d) tokens of 0s and 1s whose first
    quarter is all zero: every logit a small integer, exact in f32, so
    equal logits give equal probabilities and ties at the k-th place are
    common (every expert ties on a zero token)."""
    import dataclasses
    arch_r = dataclasses.replace(arch_r, moe=dataclasses.replace(
        arch_r.moe, num_experts=num_experts, top_k=top_k))
    arch_t = dataclasses.replace(arch_t, moe=dataclasses.replace(
        arch_t.moe, num_experts=num_experts, top_k=top_k))
    p = jax.device_get(ref_moe.moe_init(jax.random.PRNGKey(seed), arch_r))
    p = jax.tree.map(np.array, p)
    rng = np.random.default_rng(seed)
    p["router"] = rng.integers(-2, 3, p["router"].shape).astype(np.float32)
    x = (rng.random((T, arch_r.d_model)) < 0.02).astype(np.float32)
    x[:T // 4] = 0.0
    return (arch_r, arch_t, jax.tree.map(jnp.asarray, p),
            jax.tree.map(torch.from_numpy, p), x)


@pytest.mark.parametrize("num_experts,top_k", TIE_CASES,
                         ids=[f"E{e}k{k}" for e, k in TIE_CASES])
def test_route_breaks_ties_as_the_reference(num_experts, top_k):
    """Tied probabilities go lowest expert first, as ``lax.top_k`` picks
    them: routes and bucket slots exactly, weights and aux at 1e-6; the
    inputs hold ties at the k-th place (all-zero tokens tie every
    expert)."""
    arch_r, arch_t, pr, pt, x = _tied(*_archs("grok-1-314b"), num_experts,
                                      top_k, 11)
    we, ww, wa = ref_moe.route(pr["router"], jnp.asarray(x), arch_r.moe)
    ge, gw, ga = moe.route(pt["router"], torch.from_numpy(x), arch_t.moe)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ pr["router"], -1))
    kth = np.sort(probs, -1)[:, ::-1]
    if top_k < num_experts:
        assert (kth[:, top_k - 1] == kth[:, top_k]).sum() >= T // 4
    np.testing.assert_array_equal(to_np(ge), np.asarray(we))
    np.testing.assert_array_equal(to_np(ge[0]), np.arange(top_k))
    np.testing.assert_allclose(to_np(gw), to_np(ww), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(ga), float(wa), rtol=1e-6)
    cap = moe.capacity(T, arch_t.moe, 8)
    ws, wk = ref_moe.dispatch_indices(we, num_experts, cap)
    gs, gk = moe.dispatch_indices(ge, num_experts, cap)
    np.testing.assert_array_equal(to_np(gs), np.asarray(ws))
    np.testing.assert_array_equal(to_np(gk), np.asarray(wk))


@pytest.mark.parametrize("num_experts,top_k", TIE_CASES,
                         ids=[f"E{e}k{k}" for e, k in TIE_CASES])
@pytest.mark.parametrize("mult", [128, 4])
def test_moe_apply_on_tied_routes(num_experts, top_k, mult):
    """The layer on the tied inputs (kimi-k2: with its shared expert),
    without drops and with most of the low experts' buckets overflowing
    (``cap_multiple`` 4: which tokens drop follows the tie order): output
    within 1e-5 of its scale, aux within 1e-6."""
    arch_r, arch_t, pr, pt, x = _tied(*_archs("kimi-k2-1t-a32b"),
                                      num_experts, top_k, 12)
    x = x.reshape(2, T // 2, -1)
    want, waux = ref_moe.moe_apply(pr, jnp.asarray(x), arch_r,
                                   cap_multiple=mult)
    got, gaux = moe.moe_apply(pt, torch.from_numpy(x), arch_t,
                              cap_multiple=mult)
    _close(got, want)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-6)
