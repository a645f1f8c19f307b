"""The port's CUDA kernels on the card: ``enoki_merge_rows``,
``flash_attention_bhsd`` (wgmma, TMA), ``ssd_chunk_bhcp`` (three kernels a
call) and ``mlstm_chunk_bhsd`` against their plain versions on the same card
inputs, at the main paths' full geometries too, the served merge path
launching the merge once per fused merge, and a prefill launching the
attention kernel once per attention layer, the SSD kernel once per Mamba-2
layer and the mLSTM kernel once per mLSTM layer.  The warm paths run as
captured CUDA graphs (``core/graphs.py``): the batched fold, the decode
pod-step and the sLSTM scan are each held bit for bit against their eager
bodies, warm serving captures nothing, and one batched dispatch keeps the
reference's 2.5x floor over sequential invokes (``-k "graph or warm"``).

Every test here is marked ``cuda`` and skips, with its reason, on a host
without a card (a kernel has no CPU mode).  The file imports no jax, so
it runs where the card is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import Cluster, enoki_function, get_function
from repro_torch.core.store import (Store, arena_clone, kv_set_fold,
                                    merge_snapshots_fused, stores_equal)
from repro_torch.kernels.enoki_merge.kernel import (enoki_merge_rows,
                                                    enoki_merge_rows_plain)

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32, "uint8": torch.uint8}


@pytest.fixture(autouse=True)
def port_lockdep():
    from repro_torch.analysis import lockdep
    lockdep.enable()
    problems = None
    try:
        yield
        problems = lockdep.verify()
    finally:
        lockdep.disable()
    assert not problems, "lockdep:\n  " + "\n  ".join(problems)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    yield torch.device("cuda")
    # no flash wait of the test gave up (the D=256 kernel counts a give-up
    # in a device word instead of trapping; this raises if it is set)
    from repro_torch.kernels.flash_attention import kernel as fk
    fk.check_give_ups()


def _arena(rng, R, V, dtype, device):
    if dtype in ("int32", "uint8"):
        values = rng.integers(0, 100, (R, V)).astype(dtype)
    else:
        values = rng.normal(size=(R, V)).astype(np.float32)
    return (torch.arange(1, R + 1, dtype=torch.int32, device=device),
            torch.from_numpy(values).to(device=device, dtype=_TORCH[dtype]),
            torch.from_numpy(rng.integers(-1, V, R).astype(np.int32)).to(device),
            torch.from_numpy(rng.integers(0, 4, R).astype(np.int32)).to(device),
            torch.from_numpy(rng.integers(0, 50, 64).astype(np.int32)).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "uint8"])
@pytest.mark.parametrize("R,V,k", [(64, 25600, 1), (64, 100, 5), (7, 3, 33),
                                   (256, 128, 8), (33, 2049, 2)])
def test_kernel_matches_plain_on_cuda(card, R, V, k, dtype):
    """Bit-exact against the plain fold, one launch per call."""
    rng = np.random.default_rng(R + V + k)
    acc = _arena(rng, R, V, dtype, card)
    snaps = [_arena(rng, R, V, dtype, card) for _ in range(k)]
    want = enoki_merge_rows_plain(tuple(t.clone() for t in acc), snaps)
    n0 = enoki_merge_rows.launches
    got = enoki_merge_rows(tuple(t.clone() for t in acc), snaps)
    torch.cuda.synchronize()
    assert enoki_merge_rows.launches == n0 + 1
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@enoki_function(name="tcu_counter", keygroups=["tcu_kg"], codec_width=256)
def tcu_counter(kv, x):
    cur, _ = kv.get("count")
    kv.set("count", cur + x[0])
    return cur[:1] + x[:1]


@pytest.mark.cuda
def test_fused_delivery_merge_launches_once(card):
    """A CUDA cluster: K=5 pending snapshots fold with ONE kernel launch,
    equal to the CPU cluster's plain fold of the same requests."""
    got = {}
    for device in ("cuda", "cpu"):
        c = Cluster({"edge": "edge", "edge2": "edge"}, measure_compute=False,
                    device=device)
        c.deploy(get_function("tcu_counter"), ["edge", "edge2"])
        for i in range(5):
            c.invoke("tcu_counter", "edge", np.full(1, i + 1.0, np.float32),
                     t_send=10.0 * i)
        n0 = enoki_merge_rows.launches
        c.flush_replication(1e12)
        launched = enoki_merge_rows.launches - n0
        assert c.stats.merge_dispatches == c.stats.merge_aligned == 1
        assert launched == (1 if device == "cuda" else 0)
        got[device] = arena_clone(c.store_of("tcu_kg", "edge2")), c
    cuda_store, cpu_store = got["cuda"][0], got["cpu"][0]
    assert stores_equal(cuda_store, cpu_store)
    acc = arena_clone(cuda_store)
    n0 = enoki_merge_rows.launches
    merge_snapshots_fused(acc, [cuda_store] * 3, aligned=True)
    assert enoki_merge_rows.launches == n0 + 1


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

_FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,D", [
    (1, 128, 128, 4, 4, 32), (2, 256, 256, 4, 2, 64), (1, 512, 512, 8, 2, 32),
    (2, 128, 128, 2, 1, 128), (1, 100, 100, 4, 2, 64),
    (1, 128, 256, 4, 2, 64), (1, 128, 128, 4, 4, 112),
    (2, 100, 100, 4, 2, 112), (1, 128, 128, 4, 4, 96), (2, 100, 100, 4, 2, 96),
    (1, 128, 128, 4, 4, 256), (2, 100, 300, 4, 2, 256),
    (1, 384, 384, 4, 2, 256)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 64)])
def test_flash_kernel_matches_plain_on_cuda(card, B, Sq, Skv, H, KV, D,
                                            dtype, causal, window):
    """One launch per call, within the reference's tolerance of the plain
    version on the same card inputs."""
    from repro_torch.kernels.flash_attention import kernel as fk
    rng = np.random.default_rng(B + Sq + Skv + H + D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(card, _TORCH[dtype])
               for s in ((B, H, Sq, D), (B, KV, Skv, D), (B, KV, Skv, D)))
    want = fk.flash_attention_bhsd_plain(q, k, v, causal=causal,
                                         window=window)
    n0 = fk.flash_attention_bhsd.launches
    got = fk.flash_attention_bhsd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fk.flash_attention_bhsd.launches == n0 + 1
    tol = _FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_kernel_at_the_internlm2_prefill_geometry(card):
    """One internlm2-1.8b prefill layer (B=4, S=4096, H=16, KV=8, D=128,
    bf16, causal): the wgmma kernel within the reference's bf16 tolerance
    of the plain version, one launch."""
    from repro_torch.kernels.flash_attention import kernel as fk
    g = torch.Generator(device=card).manual_seed(1)
    q = torch.randn((4, 16, 4096, 128), generator=g, device=card).bfloat16()
    k, v = (torch.randn((4, 8, 4096, 128), generator=g, device=card)
            .bfloat16() for _ in range(2))
    want = fk.flash_attention_bhsd_plain(q, k, v, causal=True)
    n0 = fk.flash_attention_bhsd.launches
    got = fk.flash_attention_bhsd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fk.flash_attention_bhsd.launches == n0 + 1
    tol = _FLASH_TOL["bfloat16"]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 96)])
def test_flash_kernel_head_dim_112_with_ragged_sq_and_skv(card, causal,
                                                         window):
    """D=112 loads as two 64-column slabs whose last 16 columns TMA fills
    with zeros, and ragged Sq and Skv leave zero-filled rows in the last
    tiles: every output finite and within tolerance of plain."""
    from repro_torch.kernels.flash_attention import kernel as fk
    g = torch.Generator(device=card).manual_seed(2)
    q = torch.randn((2, 4, 200, 112), generator=g, device=card).bfloat16()
    k, v = (torch.randn((2, 2, 300, 112), generator=g, device=card)
            .bfloat16() for _ in range(2))
    want = fk.flash_attention_bhsd_plain(q, k, v, causal=causal,
                                         window=window)
    got = fk.flash_attention_bhsd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    tol = _FLASH_TOL["bfloat16"]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 256])
def test_flash_kernel_reads_the_model_layout(card, D):
    """``ops.flash_attention`` hands the kernel strided views of (B,S,H,D)
    tensors and an output view: the same numbers as the contiguous call."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ops import flash_attention
    g = torch.Generator(device=card).manual_seed(0)
    q = torch.randn((2, 192, 8, D), generator=g, device=card).bfloat16()
    k = torch.randn((2, 192, 4, D), generator=g, device=card).bfloat16()
    v = torch.randn((2, 192, 4, D), generator=g, device=card).bfloat16()
    got = flash_attention(q, k, v, causal=True)
    want = fk.flash_attention_bhsd(*(t.transpose(1, 2).contiguous()
                                     for t in (q, k, v)), causal=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want.transpose(1, 2))
    with pytest.raises(ValueError, match="head dim"):
        fk.flash_attention_bhsd(*(torch.zeros((1, 2, 64, 48), device=card)
                                  for _ in range(3)))


@pytest.mark.cuda
@pytest.mark.parametrize("pods", [2, 3, 4])
@pytest.mark.parametrize("topology", ["full", "ring"])
def test_pod_replicate_step_on_the_card_equals_the_cpu(card, topology, pods):
    """``make_pod_replicate_step`` with ``merge_arena_aligned`` over pods
    stacked on the card: the same bytes as the same step on the CPU (the
    plain version), one kernel launch per merge (full: pods - 1, ring:
    pods), and the stacked input untouched."""
    from repro_torch.core import replication as rep
    rng = np.random.default_rng(40 + pods)
    R, V = 64, 3000
    keys = np.broadcast_to(np.arange(1, R + 1, dtype=np.int32), (pods, R))
    host = Store(torch.from_numpy(keys.copy()),
                 torch.from_numpy(rng.normal(size=(pods, R, V))
                                  .astype(np.float32)),
                 torch.from_numpy(rng.integers(-1, V, (pods, R))
                                  .astype(np.int32)),
                 torch.from_numpy(rng.integers(0, 4, (pods, R))
                                  .astype(np.int32)),
                 torch.from_numpy(rng.integers(0, 50, (pods, 64))
                                  .astype(np.int32)))
    state = Store(*(t.to(card) for t in host))
    want = rep.make_pod_replicate_step(rep.merge_arena_aligned, pods,
                                       topology, device="cpu")(host)
    step = rep.make_pod_replicate_step(rep.merge_arena_aligned, pods,
                                       topology, device=card)
    n0 = enoki_merge_rows.launches
    got = step(state)
    torch.cuda.synchronize()
    assert enoki_merge_rows.launches - n0 == (pods - 1 if topology == "full"
                                              else pods)
    for g, w, s0, h in zip(got, want, state, host):
        assert torch.equal(g.cpu(), w)
        assert torch.equal(s0.cpu(), h)


@pytest.mark.cuda
def test_flash_give_up_word_raises_then_clears(card):
    """A give-up counted in the device word (set here by hand) makes
    ``check_give_ups`` raise once, and the word is clear after it; a
    D=256 launch that completes leaves it at 0."""
    from repro_torch.kernels.flash_attention import kernel as fk
    g = torch.Generator(device=card).manual_seed(4)
    q, k, v = (torch.randn((1, 2, 128, 256), generator=g, device=card)
               .bfloat16() for _ in range(3))
    fk.flash_attention_bhsd(q, k, v)
    assert fk.check_give_ups() == 0
    word = fk.give_up_word(card)
    assert word.dtype == torch.int32 and word.shape == (1,)
    word.fill_(3)
    with pytest.raises(RuntimeError, match="3 on cuda:0"):
        fk.check_give_ups()
    assert int(word.item()) == 0
    assert fk.check_give_ups() == 0


@pytest.mark.cuda
def test_prefill_launches_the_kernel_once_per_layer(card):
    """A FLASH prefill of reduced internlm2 on the card: one kernel launch
    per layer, agreeing with the REFERENCE path (plain torch)."""
    from repro_torch.configs import (AttnImpl, ShapeConfig, StepKind,
                                     get_arch, reduced)
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch import serve
    from repro_torch.models import model_zoo as zoo
    arch = reduced(get_arch("internlm2-1.8b"))
    params = zoo.init_params(arch, seed=0, dtype=torch.bfloat16)
    tokens = torch.randint(0, arch.vocab_size, (2, 128), device=card,
                           dtype=torch.int32)
    shape = ShapeConfig("p", 128, 2, StepKind.PREFILL)
    out = {}
    for impl in (AttnImpl.FLASH, AttnImpl.REFERENCE):
        n0 = fk.flash_attention_bhsd.launches
        logits, cache = serve.make_prefill_step(arch, shape, impl=impl)(
            params, {"tokens": tokens})
        torch.cuda.synchronize()
        n = fk.flash_attention_bhsd.launches - n0
        assert n == (arch.num_layers if impl is AttnImpl.FLASH else 0)
        assert cache["k"].is_cuda and int(cache["length"]) == 128
        out[impl] = logits.float()
    err = (out[AttnImpl.FLASH] - out[AttnImpl.REFERENCE]).abs().max()
    assert float(err / out[AttnImpl.REFERENCE].abs().max()) < 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("D,geometry", [(96, (4, 1024, 32, 32)),
                                        (256, (2, 1024, 16, 16))])
def test_flash_kernel_new_head_dims_at_width(card, D, geometry):
    """phi-3-vision's (D=96, H=KV=32) and gemma-7b's (D=256, H=KV=16)
    prefill layers at S=1024, bf16, causal and a window: within the
    reference's bf16 tolerance of the plain version, one launch each."""
    from repro_torch.kernels.flash_attention import kernel as fk
    B, S, H, KV = geometry
    g = torch.Generator(device=card).manual_seed(D)
    q = torch.randn((B, H, S, D), generator=g, device=card).bfloat16()
    k, v = (torch.randn((B, KV, S, D), generator=g, device=card)
            .bfloat16() for _ in range(2))
    for causal, window in ((True, 0), (True, 300)):
        want = fk.flash_attention_bhsd_plain(q, k, v, causal=causal,
                                             window=window)
        n0 = fk.flash_attention_bhsd.launches
        got = fk.flash_attention_bhsd(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert fk.flash_attention_bhsd.launches == n0 + 1
        tol = _FLASH_TOL["bfloat16"]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id,cap_multiple", [
    ("grok-1-314b", 128), ("grok-1-314b", 4), ("kimi-k2-1t-a32b", 8)])
def test_moe_apply_on_the_card_equals_the_cpu(card, arch_id, cap_multiple):
    """``moe_apply`` of reduced grok-1 and kimi-k2 in f32 on the card
    against the CPU on the same numbers: the same routes, slots and kept
    assignments (cap_multiple 4 drops some), outputs within 1e-5 of their
    scale (f32 products in another order)."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import moe
    arch = reduced(get_arch(arch_id))
    gen = torch.Generator().manual_seed(0)
    params = moe.moe_init(gen, arch)
    params["router"][:, 0] += 1.0 if cap_multiple == 4 else 0.0
    x = torch.randn((2, 32, arch.d_model), generator=gen)
    on_card = {k: (v.to(card) if isinstance(v, torch.Tensor) else
                   {kk: vv.to(card) for kk, vv in v.items()})
               for k, v in params.items()}
    routes = []
    for p, xx in ((params, x), (on_card, x.to(card))):
        idx, _, _ = moe.route(p["router"], xx.reshape(64, -1), arch.moe)
        cap = moe.capacity(64, arch.moe, cap_multiple)
        slot, kept = moe.dispatch_indices(idx, arch.moe.num_experts, cap)
        routes.append((idx.cpu(), slot.cpu(), kept.cpu()))
    for a, b in zip(*routes):
        assert torch.equal(a, b)
    want, waux = moe.moe_apply(params, x, arch, cap_multiple=cap_multiple)
    got, gaux = moe.moe_apply(on_card, x.to(card), arch,
                              cap_multiple=cap_multiple)
    torch.cuda.synchronize()
    err = (got.cpu() - want).abs().max() / want.abs().max()
    assert float(err) < 1e-5
    assert abs(float(gaux) - float(waux)) <= 1e-6 * abs(float(waux))


# ---------------------------------------------------------------------------
# ssd chunk
# ---------------------------------------------------------------------------

_SSD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}     # tests/test_kernels.py


def _ssd_inputs(card, B, H, S, P, N, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((B, H, S, P)),
            -np.logaddexp(rng.standard_normal((B, H, S)), 0) * 0.5,
            rng.standard_normal((B, 1, S, N)) * 0.3,
            rng.standard_normal((B, 1, S, N)) * 0.3)
    return [torch.from_numpy(a.astype(np.float32)).to(card, _TORCH[dtype])
            for a in arrs]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,S,P,N,chunk", [
    (1, 2, 128, 32, 16, 32), (2, 4, 256, 64, 64, 64), (1, 1, 64, 16, 8, 16),
    (1, 3, 200, 64, 64, 128), (2, 2, 100, 32, 16, 32),
    (1, 8, 1024, 64, 64, 128)])
def test_ssd_kernel_matches_plain_on_cuda(card, B, H, S, P, N, chunk, dtype):
    """y and the final state, one launch per call, within the reference's
    tolerance of the plain version on the same card inputs (ragged last
    chunks included)."""
    from repro_torch.kernels.ssd_chunk import kernel as sk
    x, a, b, c = _ssd_inputs(card, B, H, S, P, N, dtype, B + H + S)
    want_y, want_s = sk.ssd_chunk_bhcp_plain(x, a, b, c, chunk=chunk)
    n0 = sk.ssd_chunk_bhcp.launches
    got_y, got_s = sk.ssd_chunk_bhcp(x, a, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert sk.ssd_chunk_bhcp.launches == n0 + 1
    assert got_y.dtype == x.dtype and got_s.dtype == torch.float32
    tol = _SSD_TOL[dtype]
    torch.testing.assert_close(got_y.float(), want_y.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(got_s, want_s, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk", [(128, 128), (100, 128)])
def test_ssd_kernels_with_one_chunk(card, S, chunk, dtype):
    """chunk >= S: one chunk, so the state-passing kernel only hands the
    chunk's contribution on as the final state, and every entering state
    is zero."""
    from repro_torch.kernels.ssd_chunk import kernel as sk
    x, a, b, c = _ssd_inputs(card, 2, 5, S, 64, 64, dtype, S)
    want_y, want_s = sk.ssd_chunk_bhcp_plain(x, a, b, c, chunk=chunk)
    n0 = sk.ssd_chunk_bhcp.launches
    got_y, got_s = sk.ssd_chunk_bhcp(x, a, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert sk.ssd_chunk_bhcp.launches == n0 + 1
    tol = _SSD_TOL[dtype]
    torch.testing.assert_close(got_y.float(), want_y.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(got_s, want_s, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_ssd_kernels_at_the_zamba2_prefill_geometry(card):
    """One zamba2-7b Mamba-2 prefill layer in f32 (B=4, H=112, S=4096,
    P=N=64, chunk 128): y and the final state within the reference's f32
    tolerance of the plain version, one counted call."""
    from repro_torch.kernels.ssd_chunk import kernel as sk
    x, a, b, c = _ssd_inputs(card, 4, 112, 4096, 64, 64, "float32", 9)
    want_y, want_s = sk.ssd_chunk_bhcp_plain(x, a, b, c, chunk=128)
    n0 = sk.ssd_chunk_bhcp.launches
    got_y, got_s = sk.ssd_chunk_bhcp(x, a, b, c, chunk=128)
    torch.cuda.synchronize()
    assert sk.ssd_chunk_bhcp.launches == n0 + 1
    tol = _SSD_TOL["float32"]
    torch.testing.assert_close(got_y, want_y, rtol=tol, atol=tol)
    torch.testing.assert_close(got_s, want_s, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_ssd_kernel_reads_the_model_layout(card):
    """``ops.ssd_chunk`` hands the kernel strided views of (B,S,H,P) and
    (B,S,H) tensors and a y view: the same numbers as the contiguous
    kernel-layout call on the dt-weighted input."""
    from repro_torch.kernels.ssd_chunk import kernel as sk
    from repro_torch.kernels.ssd_chunk.ops import ssd_chunk
    g = torch.Generator(device=card).manual_seed(0)
    B, S, H, P, N = 2, 320, 6, 64, 64
    x = torch.randn((B, S, H, P), generator=g, device=card)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=card) - 2)
    b, c = (torch.randn((B, S, N), generator=g, device=card) * 0.3
            for _ in range(2))
    y, state = ssd_chunk(x, -dt, b, c, dt, chunk=128)
    want_y, want_s = sk.ssd_chunk_bhcp(
        (x * dt[..., None]).transpose(1, 2).contiguous(),
        (-dt).transpose(1, 2).contiguous(), b[:, None], c[:, None])
    torch.cuda.synchronize()
    assert torch.equal(y, want_y.transpose(1, 2))
    assert torch.equal(state, want_s)


@pytest.mark.cuda
def test_zamba_prefill_launches_both_kernels(card):
    """A FLASH prefill of reduced zamba2 on the card: one SSD launch per
    Mamba-2 layer, one attention launch per shared-block application, and
    no launch under REFERENCE; the two paths agree."""
    from repro_torch.configs import (AttnImpl, ShapeConfig, StepKind,
                                     get_arch, reduced)
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd_chunk import kernel as sk
    from repro_torch.launch import serve
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.transformer import plan
    arch = reduced(get_arch("zamba2-7b"))
    params = zoo.init_params(arch, seed=0, dtype=torch.bfloat16)
    tokens = torch.randint(0, arch.vocab_size, (2, 128), device=card,
                           dtype=torch.int32)
    shape = ShapeConfig("p", 128, 2, StepKind.PREFILL)
    out = {}
    for impl in (AttnImpl.FLASH, AttnImpl.REFERENCE):
        n0 = (sk.ssd_chunk_bhcp.launches, fk.flash_attention_bhsd.launches)
        logits, cache = serve.make_prefill_step(arch, shape, impl=impl)(
            params, {"tokens": tokens})
        torch.cuda.synchronize()
        flash = impl is AttnImpl.FLASH
        assert sk.ssd_chunk_bhcp.launches - n0[0] == (
            arch.num_layers if flash else 0)
        assert fk.flash_attention_bhsd.launches - n0[1] == (
            plan(arch)["groups"] if flash else 0)
        assert cache["mamba"]["state"].is_cuda and \
            cache["mamba"]["state"].dtype == torch.float32
        out[impl] = logits.float()
    err = (out[AttnImpl.FLASH] - out[AttnImpl.REFERENCE]).abs().max()
    assert float(err / out[AttnImpl.REFERENCE].abs().max()) < 5e-2


# ---------------------------------------------------------------------------
# mlstm chunk
# ---------------------------------------------------------------------------

_MLSTM_TOL = {"float32": 1e-4, "bfloat16": 5e-2}   # tests/test_kernels.py


def _mlstm_inputs(card, B, H, S, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    logsig = lambda x: -np.logaddexp(0.0, -x)
    qkv = [torch.from_numpy(rng.standard_normal((B, H, S, d)).astype(
        np.float32)).to(card, _TORCH[dtype]) for _ in range(3)]
    gates = [torch.from_numpy(logsig(rng.standard_normal((B, H, S)) + shift)
                              .astype(np.float32)).to(card)
             for shift in (-2.0, 2.0)]
    return qkv + gates


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,S,d,chunk", [
    (1, 2, 128, 32, 32), (2, 2, 64, 64, 16), (1, 4, 256, 16, 64),
    (2, 2, 128, 128, 16), (1, 2, 256, 512, 64), (2, 4, 512, 512, 64),
    (1, 3, 100, 48, 20)])
def test_mlstm_kernel_matches_plain_on_cuda(card, B, H, S, d, chunk, dtype):
    """h and the final carry (C, n, m), one launch per call, within the
    reference's tolerance of the plain version on the same card inputs
    (head dims 16 to 512, a partial column tile at d=48, chunks 16 to 64)."""
    from repro_torch.kernels.mlstm_chunk import kernel as mk
    ins = _mlstm_inputs(card, B, H, S, d, dtype, B + H + S + d)
    want_h, want_c = mk.mlstm_chunk_bhsd_plain(*ins, chunk=chunk)
    n0 = mk.mlstm_chunk_bhsd.launches
    got_h, got_c = mk.mlstm_chunk_bhsd(*ins, chunk=chunk)
    torch.cuda.synchronize()
    assert mk.mlstm_chunk_bhsd.launches == n0 + 1
    assert got_h.dtype == ins[0].dtype
    tol = _MLSTM_TOL[dtype]
    torch.testing.assert_close(got_h.float(), want_h.float(), rtol=tol,
                               atol=tol)
    for got, want in zip(got_c, want_c):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_mlstm_kernel_reads_the_model_layout(card):
    """``ops.mlstm_chunk`` hands the kernel strided views of (B,S,H,d) and
    (B,S,H) tensors and an h view: the same numbers as the contiguous
    kernel-layout call; what the kernel does not take raises on the card
    too."""
    from repro_torch.kernels.mlstm_chunk import kernel as mk
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk
    ins = _mlstm_inputs(card, 2, 4, 192, 128, "float32", 1)
    model = [x.transpose(1, 2).contiguous() for x in ins]
    h, carry = mlstm_chunk(*model, chunk=64)
    want_h, want_c = mk.mlstm_chunk_bhsd(*ins, chunk=64)
    torch.cuda.synchronize()
    assert torch.equal(h, want_h.transpose(1, 2))
    for got, want in zip(carry, want_c):
        assert torch.equal(got, want)
    n0 = mk.mlstm_chunk_bhsd.launches
    with pytest.raises(ValueError, match="does not divide"):
        mk.mlstm_chunk_bhsd(*ins, chunk=50)
    with pytest.raises(ValueError, match="head dim"):
        z = torch.zeros((2, 4, 192, 40), device=card)
        mk.mlstm_chunk_bhsd(z, z, z, ins[3], ins[4])
    with pytest.raises(ValueError, match="float32"):
        mk.mlstm_chunk_bhsd(*ins[:3], ins[3].bfloat16(), ins[4])
    assert mk.mlstm_chunk_bhsd.launches == n0


@pytest.mark.cuda
def test_mlstm_seq_launches_the_kernel_once(card):
    """One ``mlstm_seq(impl=FLASH)`` on the card launches the kernel once
    and agrees with REFERENCE (the plain cell), which launches nothing."""
    from repro_torch.configs import AttnImpl, get_arch, reduced
    from repro_torch.kernels.mlstm_chunk import kernel as mk
    from repro_torch.models import xlstm
    arch = reduced(get_arch("xlstm-350m"))
    params = xlstm.mlstm_init(torch.Generator(device=card).manual_seed(0),
                              arch)
    params["norm"].fill_(1.0)
    x = torch.randn((2, 96, arch.d_model), device=card)
    out = {}
    for impl in (AttnImpl.FLASH, AttnImpl.REFERENCE):
        n0 = mk.mlstm_chunk_bhsd.launches
        y, cache = xlstm.mlstm_seq(params, x, arch, return_state=True,
                                   impl=impl)
        torch.cuda.synchronize()
        assert mk.mlstm_chunk_bhsd.launches - n0 == (
            1 if impl is AttnImpl.FLASH else 0)
        out[impl] = (y, cache)
    (yf, cf), (yr, cr) = out[AttnImpl.FLASH], out[AttnImpl.REFERENCE]
    torch.testing.assert_close(yf, yr, rtol=1e-4, atol=1e-4)
    for key in ("C", "n", "m"):
        torch.testing.assert_close(cf[key], cr[key], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_xlstm_prefill_and_decode_on_cuda(card):
    """A FLASH prefill of reduced xlstm on the card: one mLSTM launch per
    mLSTM layer, none under REFERENCE, the two paths agreeing; then a few
    decode steps on the card from the prefill's session state."""
    from repro_torch.configs import (AttnImpl, ShapeConfig, StepKind,
                                     get_arch, reduced)
    from repro_torch.kernels.mlstm_chunk import kernel as mk
    from repro_torch.launch import serve
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.transformer import plan
    arch = reduced(get_arch("xlstm-350m"))
    params = zoo.init_params(arch, seed=0, dtype=torch.bfloat16)
    for cell in (params["blocks"]["mlstm"]["cell"],
                 params["blocks"]["slstm"]["cell"]):
        cell["norm"].fill_(1.0)     # the reference's init zeroes them
    tokens = torch.randint(0, arch.vocab_size, (2, 128), device=card,
                           dtype=torch.int32)
    shape = ShapeConfig("p", 128, 2, StepKind.PREFILL)
    p = plan(arch)
    out = {}
    for impl in (AttnImpl.FLASH, AttnImpl.REFERENCE):
        n0 = mk.mlstm_chunk_bhsd.launches
        logits, cache = serve.make_prefill_step(arch, shape, impl=impl)(
            params, {"tokens": tokens})
        torch.cuda.synchronize()
        assert mk.mlstm_chunk_bhsd.launches - n0 == (
            p["groups"] * p["mlstm_per"] if impl is AttnImpl.FLASH else 0)
        assert cache["mlstm"]["C"].is_cuda and \
            cache["mlstm"]["C"].dtype == torch.float32
        out[impl] = (logits.float(), cache)
    ref = out[AttnImpl.REFERENCE][0]
    err = (out[AttnImpl.FLASH][0] - ref).abs().max()
    assert float(err / ref.abs().max()) < 5e-2
    cache = {k: (v[None] if k == "length" else
                 {kk: vv[None] for kk, vv in v.items()})
             for k, v in out[AttnImpl.FLASH][1].items()}
    step = serve.make_decode_step(arch)
    tok = torch.argmax(out[AttnImpl.FLASH][0][:, -1], dim=-1)[None, :, None]
    tok = tok.to(torch.int32)
    n0 = mk.mlstm_chunk_bhsd.launches
    for _ in range(4):
        tok, cache = step(params, cache, tok)
    torch.cuda.synchronize()
    assert mk.mlstm_chunk_bhsd.launches == n0, "decode runs the step cell"
    assert int(cache["length"][0]) == 132
    assert bool(((tok >= 0) & (tok < arch.vocab_size)).all())


# ---------------------------------------------------------------------------
# the redesigned merge: pointers by value, a row's blocks one cluster
# ---------------------------------------------------------------------------

def _fold_plain(acc, snaps):
    return enoki_merge_rows_plain(
        tuple(None if t is None else t.clone() for t in acc), snaps)


@pytest.mark.cuda
@pytest.mark.parametrize("k,launches", [(64, 1), (65, 2), (130, 3)])
def test_merge_past_the_by_value_limit_folds_in_several_launches(
        card, k, launches):
    """K above the 64 records a launch takes by value: one launch per group
    of 64, in order, still equal to the sequential fold."""
    rng = np.random.default_rng(k)
    acc = _arena(rng, 16, 40, "float32", card)
    snaps = [_arena(rng, 16, 40, "float32", card) for _ in range(k)]
    want = _fold_plain(acc, snaps)
    n0 = enoki_merge_rows.launches
    got = enoki_merge_rows(tuple(t.clone() for t in acc), snaps)
    torch.cuda.synchronize()
    assert enoki_merge_rows.launches == n0 + launches
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,width,vec", [
    ("float32", 14340, 16),     # 57,360 bytes: 16-byte path
    ("float32", 14337, 4),      # 57,348 bytes: 4-byte path
    ("uint8", 57345, 1),        # byte path
    ("bfloat16", 28673, 1),     # 57,346 bytes: 2-byte rows, byte path
    ("int32", 262144, 16)])     # 1 MB rows
def test_merge_row_over_a_full_cluster(card, dtype, width, vec):
    """Rows that span the most chunks a cluster takes (8), on each access
    path: bit-exact against the plain fold, K = 1 and K = 8."""
    from repro_torch.kernels.enoki_merge import kernel as ek
    rng = np.random.default_rng(width)
    acc = _arena(rng, 5, width, dtype, card)
    row_bytes, _, chunks = ek.launch_geometry(acc[1])
    assert chunks == ek.MAX_CHUNKS
    assert ek._vec(row_bytes, [acc[1].data_ptr()]) == vec
    for k in (1, 8):
        snaps = [_arena(rng, 5, width, dtype, card) for _ in range(k)]
        want = _fold_plain(acc, snaps)
        got = enoki_merge_rows(tuple(t.clone() for t in acc), snaps)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_merge_misaligned_payload_and_empty_arena(card):
    """A payload base off 16 bytes takes the 4-byte path, and an arena of no
    rows still folds its version vector: both as the plain fold does."""
    from repro_torch.kernels.enoki_merge import kernel as ek
    rng = np.random.default_rng(3)
    acc = _arena(rng, 8, 33, "float32", card)
    flat = torch.zeros(8 * 32 + 1, device=card)
    vals = flat[1:].view(8, 32)
    vals.copy_(acc[1][:, :32])
    acc = (acc[0], vals, acc[2], acc[3], acc[4])
    assert ek._vec(128, [vals.data_ptr()]) == 4
    snaps = [_arena(rng, 8, 32, "float32", card) for _ in range(3)]
    want = _fold_plain(acc, snaps)
    got = enoki_merge_rows(tuple(t.clone() for t in acc), snaps)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    empty = lambda: (None, torch.zeros((0, 4), device=card), None,
                     torch.zeros(0, dtype=torch.int32, device=card),
                     torch.from_numpy(rng.integers(0, 9, 6).astype(
                         np.int32)).to(card))
    acc, snaps = empty(), [empty() for _ in range(2)]
    want = _fold_plain(acc, snaps)
    got = enoki_merge_rows(tuple(None if t is None else t.clone()
                                 for t in acc), snaps)
    torch.cuda.synchronize()
    assert torch.equal(got[4], want[4]) and got[1].shape == (0, 4)


# ---------------------------------------------------------------------------
# the redesigned mLSTM: q k^T of every chunk at once, then one CTA per
# (b, h, 64 columns of C)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,S,chunk", [(16, 128, 64), (32, 96, 32),
                                       (64, 128, 64), (80, 128, 64),
                                       (80, 100, 20), (128, 192, 64),
                                       (512, 256, 64)])
def test_mlstm_column_tiles_match_plain_in_the_model_layout(card, d, S, chunk,
                                                            dtype):
    """1, 1, 1, 2 (twice: a ragged 16-column tile, and a chunk of 20), 2 and
    8 CTAs per (b, h), read from the model layout (strided q/k/v and gates,
    h written through a view): h and the final carry C, n, m within the
    reference's tolerance of the plain version, one call."""
    from repro_torch.kernels.mlstm_chunk import kernel as mk
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk
    assert mk.column_tiles(d) == {16: 1, 32: 1, 64: 1, 80: 2, 128: 2,
                                  512: 8}[d]
    ins = _mlstm_inputs(card, 2, 3, S, d, dtype, d + S + chunk)
    want_h, want_c = mk.mlstm_chunk_bhsd_plain(*ins, chunk=chunk)
    model = [x.transpose(1, 2).contiguous() for x in ins]
    n0 = mk.mlstm_chunk_bhsd.launches
    h, carry = mlstm_chunk(*model, chunk=chunk)
    torch.cuda.synchronize()
    assert mk.mlstm_chunk_bhsd.launches == n0 + 1
    tol = _MLSTM_TOL[dtype]
    torch.testing.assert_close(h.transpose(1, 2).float(), want_h.float(),
                               rtol=tol, atol=tol)
    for got, want in zip(carry, want_c):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# what the card once refused and the CPU took (flash, SSD)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 256])
@pytest.mark.parametrize("case", ["misaligned_base", "odd_stride",
                                  "H_65536", "B_65536"])
def test_flash_takes_what_the_cpu_takes(card, case, D):
    """The cases of test_torch_flash_attention.py's
    test_every_device_takes_misaligned_rows_and_large_grids on the card, at
    D=32 and at D=256: equal to the aligned call, and within tolerance of
    the plain version."""
    from repro_torch.kernels.flash_attention import kernel as fk
    B, S, H, KV = {"misaligned_base": (2, 64, 4, 2),
                   "odd_stride": (1, 64, 4, 2),
                   "H_65536": (1, 2, 65536, 1),
                   "B_65536": (65536, 2, 1, 1)}[case]
    gen = torch.Generator(device=card).manual_seed(11)
    q, k, v = (torch.randn((B, h, S, D), generator=gen, device=card)
               .to(torch.bfloat16) for h in (H, KV, KV))
    want = fk.flash_attention_bhsd(q, k, v)
    if case == "misaligned_base":
        def off(t):
            buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
            view = buf[1:].view(t.shape)
            return view.copy_(t)
        out = off(torch.zeros_like(q))
        got = fk.flash_attention_bhsd(off(q), off(k), off(v), out=out)
        assert got is out
    elif case == "odd_stride":
        wide = torch.zeros((B, H, S, D + 1), dtype=q.dtype, device=card)
        wide[..., :D] = q
        got = fk.flash_attention_bhsd(wide[..., :D], k, v)
    else:
        got = want
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    plain = fk.flash_attention_bhsd_plain(q, k, v)
    torch.testing.assert_close(got.float(), plain.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,chunk", [(65536, 2, 1), (1, 65536, 1)])
def test_ssd_takes_65536_batches_and_chunks(card, B, S, chunk):
    """B = 65,536, and 65,536 chunks (chunk 1, S = 65,536, B = H = 1,
    P = N = 16): the kernels take both, as the CPU does, within the
    reference's f32 tolerance of the plain version."""
    from repro_torch.kernels.ssd_chunk import kernel as sk
    x, a, b, c = _ssd_inputs(card, B, 1, S, 16, 16, "float32", 5)
    want_y, want_s = sk.ssd_chunk_bhcp_plain(x, a, b, c, chunk=chunk)
    got_y, got_s = sk.ssd_chunk_bhcp(x, a, b, c, chunk=chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_y, want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got_s, want_s, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# runtime and checkpoint: recovery on the card
# ---------------------------------------------------------------------------

_RT_NODES = ("edge", "edge2", "cloud")


@enoki_function(name="tcu_rt_ctr", keygroups=["tcu_rt_kg"], codec_width=256)
def tcu_rt_ctr(kv, x):
    cur, found = kv.get("count")
    new = torch.where(found, cur[0] + x[0], x[0])
    kv.set("count", new.expand(256))
    return new.reshape(1)


@enoki_function(name="tcu_rt_probe", keygroups=["tcu_rt_probekg"],
                codec_width=256)
def tcu_rt_probe(kv, x):
    cur, _ = kv.get("beacon")
    return cur[:1] + x[:1]


def _chaos_on(device, seed=7, rounds=12):
    from repro_torch.runtime import (ElasticMembership, FailureInjector,
                                     chaos_schedule, run_chaos)
    c = Cluster({n: ("cloud" if n == "cloud" else "edge") for n in _RT_NODES},
                measure_compute=False, fault_seed=seed, device=device)
    c.deploy(get_function("tcu_rt_ctr"), list(_RT_NODES))
    c.deploy(get_function("tcu_rt_probe"), ["edge2"])
    m = ElasticMembership(c)
    inj = FailureInjector(c, membership=m)
    plan = chaos_schedule(seed, rounds, _RT_NODES, victim="edge2")
    one = np.ones(1, np.float32)
    lost = []

    def write(node, r, t):
        c.invoke("tcu_rt_ctr", node, one, t_send=t + 1.0)
        c.drain_transport(t + 1.0)

    def probe(r, t):
        ticket = c.engine.submit("tcu_rt_probe", "edge2", one, t_send=t + 2.0)
        if ticket not in c.engine.flush():
            lost.append(r)

    n0 = enoki_merge_rows.launches
    run_chaos(c, m, inj, plan, write, probe=probe)
    if device == "cuda":
        torch.cuda.synchronize()
    return c, plan, lost, enoki_merge_rows.launches - n0


@pytest.mark.cuda
def test_chaos_run_on_the_card_equals_the_cpu_run(card):
    """The seed-7 chaos plan at width 256: every delivery merge an aligned
    kernel launch, and every arena (vv included) equal to the CPU run's."""
    gpu, plan, lost, launches = _chaos_on("cuda")
    cpu, _, lost_cpu, _ = _chaos_on("cpu")
    assert lost and lost == lost_cpu
    assert gpu.stats.merge_fallback == 0
    assert launches == gpu.stats.merge_dispatches > 0
    writes = sum(len(plan.writers_for(r)) for r in range(plan.rounds))
    for node in _RT_NODES:
        g, h = gpu.store_of("tcu_rt_kg", node), cpu.store_of("tcu_rt_kg", node)
        assert float(g.values[0, 0]) == writes
        for x, y in zip(g, h):
            assert x.is_cuda and torch.equal(x.cpu(), y), node


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_arena_checkpoint_restores_on_the_card_and_the_cpu(
        card, tmp_path, dtype):
    """A card arena saved, then written in place: the checkpoint restores
    onto the card and onto the CPU equal to the arena as saved."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.keygroup import KeygroupSpec, arena_new
    rng = np.random.default_rng(5)
    acc = _arena(rng, 64, 25600, "float32", card)
    arena = Store(*(t.to(dtype) if t.is_floating_point() else t
                    for t in acc))
    saved = arena_clone(arena)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"kg": arena}, blocking=False)
    kv_set_fold(arena, arena.keys[:2].clone(),
                torch.full((2, 25600), 7.0, dtype=dtype, device=card),
                torch.tensor([3, 3], dtype=torch.int32, device=card),
                torch.tensor(2**22, dtype=torch.int32, device=card), 1)
    mgr.wait()
    for device in ("cuda", "cpu"):
        spec = KeygroupSpec(name="kg", value_width=25600, dtype=dtype,
                            device=device)
        got = mgr.restore({"kg": arena_new(spec, 64)})["kg"]
        for x, y in zip(got, saved):
            assert x.device.type == device and x.dtype == y.dtype
            assert torch.equal(x, y.to(device))


# ---------------------------------------------------------------------------
# the warm paths as captured CUDA graphs (core/graphs.py)
# ---------------------------------------------------------------------------

_GRAPH_WIDTH = 64


@enoki_function(name="tcu_graph_acc", keygroups=["tcu_graph_kg"],
                codec_width=_GRAPH_WIDTH)
def tcu_graph_acc(kv, x):
    cur, _ = kv.get("acc")
    rows, _ = kv.scan(["h0", "h1"])
    kv.set("acc", cur + x)
    kv.set("h0", 2.0)           # a Python constant: filled on the device
    return torch.stack([cur[0] + x[0], rows[:, 0].sum()])


@enoki_function(name="tcu_graph_peek", keygroups=["tcu_graph_kg"],
                codec_width=_GRAPH_WIDTH)
def tcu_graph_peek(kv, x):
    cur, _ = kv.get("acc")
    return cur[:2] + x[:2]


@enoki_function(name="tcu_graph_free", codec_width=_GRAPH_WIDTH)
def tcu_graph_free(kv, x):
    kv.set("tmp", x)            # stateless: a per-request clone of the arena
    cur, _ = kv.get("tmp")
    return cur[:2] * 2.0


@enoki_function(name="tcu_graph_fill", keygroups=["tcu_graph_kg"],
                codec_width=_GRAPH_WIDTH)
def tcu_graph_fill(kv, x):
    for i in range(40):         # heavy: a block of 16 requests a graph
        kv.set(f"f{i}", x + float(i))
    return x[:1]


@enoki_function(name="tcu_perfthr_acc", keygroups=["tcu_perfthrkg"],
                codec_width=8)
def tcu_perfthr_acc(kv, x):
    cur, _ = kv.get("acc")
    kv.set("acc", cur + x)
    return cur[:1] + x[:1]


def _graph_cluster(device):
    c = Cluster({"edge": "edge", "edge2": "edge", "cloud": "cloud"},
                measure_compute=False, device=device)
    example = np.zeros(_GRAPH_WIDTH, np.float32)
    for fn, nodes in (("tcu_graph_acc", ["edge", "edge2", "cloud"]),
                      ("tcu_graph_peek", ["edge2"]),
                      ("tcu_graph_free", ["edge"]),
                      ("tcu_graph_fill", ["edge"])):
        c.deploy(get_function(fn), nodes, example_input=example)
    return c


def _same_arena(a, b, what):
    for x, y in zip(a, b):
        assert torch.equal(x, y), what


@pytest.mark.cuda
@pytest.mark.parametrize("fn,node", [("tcu_graph_acc", "edge"),
                                     ("tcu_graph_peek", "edge2"),
                                     ("tcu_graph_free", "edge"),
                                     ("tcu_graph_fill", "edge")])
def test_fold_graph_matches_eager_for_every_bucket(card, fn, node):
    """The batched fold's replays against its eager body over the whole
    batch, bit for bit: stores, clock and ys, for every bucket (full and
    padded), twice each (a capture's first replay, then a warm one), for a
    mutating, a read-only, an independent and a heavy handler (40 kv ops:
    blocks of 16 requests, the clock carried between replays); then again
    after the arena is replaced, as a crash re-home replaces it (new
    captures, except for the independent handler, whose arena is an
    input)."""
    from repro_torch.core.engine import DEFAULT_BUCKETS
    c = _graph_cluster("cuda")
    bh = c.nodes[node].batched_handlers[fn]
    # 1024 kv ops a graph: 4, 1, 2 and 40 ops a request
    assert bh.block == {"tcu_graph_acc": 256, "tcu_graph_peek": 1024,
                        "tcu_graph_free": 512, "tcu_graph_fill": 16}[fn]
    independent = fn == "tcu_graph_free"
    rng = np.random.default_rng(7)
    clock = c.nodes[node].clock
    store = (c.scratch_arena(c.specs[fn]) if independent
             else c.store_of("tcu_graph_kg", node))
    replays = 0
    for replaced in (False, True):
        if replaced and not independent:
            store = arena_clone(store)
        sizes = set()
        for b in DEFAULT_BUCKETS:
            for n in (b, max(1, b - 3)):
                xs = rng.integers(-4, 5, (b, _GRAPH_WIDTH)).astype(np.float32)
                valid = torch.arange(b, device=card) < n
                twin = arena_clone(store)
                st, clk, ys, ops = bh(store, clock, xs, valid,
                                      independent=independent)
                est, eclk, eys, eops = bh.eager(twin, clock, xs, valid,
                                                independent=independent)
                torch.cuda.synchronize()
                assert st is store and ops == eops
                _same_arena(store, twin, f"{fn} bucket {b} n {n}")
                assert torch.equal(clk, eclk) and torch.equal(ys, eys)
                clock = clk
                replays += -(-b // bh.block)
            sizes.add(min(b, bh.block))
        assert bh.steps.captures == len(sizes) * (
            1 if independent else 1 + replaced)
    assert bh.steps.replays == replays


@pytest.mark.cuda
def test_capture_survives_dropped_clusters(card):
    """A dropped cluster holds its fold graphs in reference cycles, so only
    the garbage collector tears them down; with a full collection due
    every 700 allocations, a new cluster's restore after a crash (which
    captures the restored node's fold graphs) still succeeds, and its
    replays equal the eager body."""
    import gc
    from repro_torch.analysis.jitprof import CompileCounter
    from repro_torch.runtime import ElasticMembership
    x = np.ones(_GRAPH_WIDTH, np.float32)
    threshold = gc.get_threshold()
    for _ in range(3):
        c = _graph_cluster("cuda")
        c.engine.buckets = (1, 8)
        c.engine.prewarm()
        m = ElasticMembership(c)
        m.crash("edge2")
        gc.set_threshold(700, 1, 1)
        try:
            assert m.restore("edge2") == ["tcu_graph_kg"]
        finally:
            gc.set_threshold(*threshold)
        bh = c.nodes["edge2"].batched_handlers["tcu_graph_acc"]
        store = c.store_of("tcu_graph_kg", "edge2")
        twin = arena_clone(store)
        clock = c.nodes["edge2"].clock
        xs = np.stack([x] * 8)
        valid = torch.ones(8, dtype=torch.bool, device=card)
        with CompileCounter() as cc:
            _, clk, ys, _ = bh(store, clock, xs, valid)
        _, eclk, eys, _ = bh.eager(twin, clock, xs, valid)
        torch.cuda.synchronize()
        assert cc.events == 0
        _same_arena(store, twin, "after a restore")
        assert torch.equal(clk, eclk) and torch.equal(ys, eys)
        del c, m, bh


def _rounds(c, x, rounds, buckets):
    for _ in range(rounds):
        for node in c.nodes:
            for b in buckets:
                c.invoke_batch("tcu_graph_acc", node, [x] * b)
            if node == "edge2":
                c.invoke_batch("tcu_graph_peek", node, [x] * 8)
        c.flush_replication(1e12)


@pytest.mark.cuda
def test_warm_serving_makes_no_capture_on_the_card(card):
    """``tests/test_perf_paths.py``'s guarantee on the card: after
    ``prewarm`` and a settling round, three warm rounds over every bucket on
    three nodes capture nothing, and the replicas equal a CPU twin's."""
    from repro_torch.analysis.jitprof import CompileCounter
    from repro_torch.core.engine import DEFAULT_BUCKETS
    gpu, cpu = _graph_cluster("cuda"), _graph_cluster("cpu")
    assert gpu.engine.prewarm() == cpu.engine.prewarm() > 0
    x = np.arange(_GRAPH_WIDTH, dtype=np.float32) % 5
    _rounds(gpu, x, 1, DEFAULT_BUCKETS)
    with CompileCounter() as cc:
        _rounds(gpu, x, 3, DEFAULT_BUCKETS)
    assert cc.events == 0, f"{cc.events} captures in warm rounds"
    _rounds(cpu, x, 4, DEFAULT_BUCKETS)
    for node in ("edge", "edge2", "cloud"):
        for a, b in zip(gpu.store_of("tcu_graph_kg", node),
                        cpu.store_of("tcu_graph_kg", node)):
            assert a.is_cuda and torch.equal(a.cpu(), b), node


def _interleaved_median(variants, repeats=5, warmup=1):
    """``benchmarks.common``'s method (which imports jax): ``warmup``
    unrecorded rounds, then ``repeats`` rounds visiting every variant in
    turn; the median ops/s of each."""
    import statistics
    import time
    for _ in range(warmup):
        for fn in variants.values():
            fn()
    samples = {k: [] for k in variants}
    for _ in range(repeats):
        for k, fn in variants.items():
            t0 = time.perf_counter()
            ops = fn()
            samples[k].append(ops / (time.perf_counter() - t0))
    return {k: statistics.median(v) for k, v in samples.items()}, samples


@pytest.mark.cuda
def test_batched_invoke_throughput_regression(card):
    """``tests/test_perf_paths.py``'s §4.2 claim through the port on the
    card, with its method and floor: one ``invoke_batch`` of 64 (one fold
    graph replay) against 64 sequential ``invoke``s, interleaved repeats 5,
    warmup 1, medians; batched/sequential >= 2.5."""
    c = Cluster({"edge": "edge"}, measure_compute=False, device=card)
    c.deploy(get_function("tcu_perfthr_acc"), ["edge"])
    x = np.ones((8,), np.float32)
    n = 64

    def sequential() -> int:
        for i in range(n):
            c.invoke("tcu_perfthr_acc", "edge", x, t_send=float(i))
        torch.cuda.synchronize()
        return n

    def batched() -> int:
        c.invoke_batch("tcu_perfthr_acc", "edge", [x] * n)
        torch.cuda.synchronize()
        return n

    med, samples = _interleaved_median({"sequential": sequential,
                                        "batched": batched})
    ratio = med["batched"] / med["sequential"]
    assert ratio >= 2.5, (f"batched/sequential median ratio {ratio:.2f} "
                          f"(samples {samples})")


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", ["internlm2-1.8b", "zamba2-7b",
                                     "xlstm-350m", "grok-1-314b",
                                     "kimi-k2-1t-a32b", "whisper-tiny"])
def test_decode_graph_matches_eager(card, arch_id):
    """Eight pod-steps (2 pods x 2 sessions, reduced depth, bf16) replayed
    from one captured graph against the eager pod-step on a copy of the
    cache: tokens equal every step and every cache leaf equal at the end;
    zamba2's 64-slot ring wraps (positions 60..67); the moe step routes,
    dispatches and combines inside the graph (no host read, a fixed order
    of sums); whisper's position embedding is gathered at the device-side
    length and its cross K/V read; one capture."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.tree import tree_flatten, tree_map
    from repro_torch.launch import serve
    from repro_torch.models import model_zoo as zoo
    arch = reduced(get_arch(arch_id))
    params = zoo.init_params(arch, seed=0, dtype=torch.bfloat16)
    if arch.family == "ssm":
        for cell in (params["blocks"]["mlstm"]["cell"],
                     params["blocks"]["slstm"]["cell"]):
            cell["norm"].fill_(1.0)
    live = tree_map(lambda v: torch.stack([v] * 2),
                    zoo.init_cache(arch, 2, 72, device=card))
    live["length"].fill_(60)
    twin = tree_map(torch.clone, live)
    step = serve.make_decode_step(arch, n_pods=2)
    tok = torch.randint(0, arch.vocab_size, (2, 2, 1), device=card,
                        dtype=torch.int32)
    etok = tok
    for _ in range(8):
        tok, live = step(params, live, tok)
        etok, twin = step.eager(params, twin, etok)
        torch.cuda.synchronize()
        assert torch.equal(tok, etok)
    for x, y in zip(tree_flatten(live)[0], tree_flatten(twin)[0]):
        assert torch.equal(x, y)
    assert step.steps.captures == 1 and step.steps.replays == 8
    assert int(live["length"][0]) == 68


@pytest.mark.cuda
@pytest.mark.parametrize("S", [128, 100])
def test_slstm_scan_graph_matches_loop(card, S):
    """The captured sLSTM scan (blocks of 64 timesteps; S=100 replays 64,
    then its 36-step tail as 32 and 4) against the eager loop over time on the same card
    inputs, bf16 as the model serves: hs and the carry bit for bit."""
    from repro_torch.configs import get_arch
    from repro_torch.models import xlstm
    arch = get_arch("xlstm-350m")
    gen = torch.Generator(device="cuda").manual_seed(S)
    p = xlstm.slstm_init(torch.Generator().manual_seed(0), arch,
                         dtype=torch.bfloat16)
    r, b = p["r"].to(card), p["b"].to(card)
    B, d = 4, arch.d_model
    wx = torch.randn((B, S, 4 * d), generator=gen, device=card).to(
        torch.bfloat16)
    init = xlstm.slstm_cache_init(arch, B, torch.bfloat16, device=card)
    carry = (init["c"], init["n"], init["m"], init["h"])
    h = arch.xlstm.num_heads
    r0 = xlstm.SLSTM_STEPS.replays
    got_hs, got_c = xlstm.slstm_scan(wx, r, b, carry, h)
    want_hs, want_c = xlstm.slstm_loop(wx, r, b, carry, h)
    torch.cuda.synchronize()
    assert xlstm.SLSTM_STEPS.replays - r0 == {128: 2, 100: 3}[S]
    assert torch.equal(got_hs, want_hs)
    for x, y in zip(got_c, want_c):
        assert torch.equal(x, y)
