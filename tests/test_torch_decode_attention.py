"""Ring decode attention (``kernels/decode_attention``) on the CPU.

* ``decode_attention_ref`` (the plain version, which CPU tensors take)
  against a plain masked softmax written out here in float64: the scores
  of the slots whose positions lie in [0, length], the softmax, P rounded
  to the cache's dtype, P.V, over a partly filled ring (positions -1 past
  ``length``) and a wrapped one (``length`` >= W), G in {1, 2}, Dh in {64,
  112, 128}, and a tensor-parallel rank's head counts.  Tolerance: one
  bf16 step of the output (2**-7 relative, the last rounding) and 1e-4
  absolute (the f32 sums taken in another order; P rounded to bf16 from
  an f32 and from an f64 softmax may fall on either side of a step);
* the wrapper on CPU tensors returns the plain version's tensor bit for
  bit and counts no launch; it refuses what the kernel does not take;
* ``transformer._ring_decode_attn`` on the CPU equals, bit for bit, the
  einsums it ran before the kernel (copied below as they stood), the
  ring's slot writes included;
* under the cost walker the wrapper is one kernel of its analytic work,
  on fake tensors and on real ones.

The CUDA kernel against the plain version is ``tests/test_torch_cuda.py``
(``-k decode_attention``).
"""
import dataclasses

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_arch, reduced
from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.launch import roofline as rl
from repro_torch.models import attention as attn
from repro_torch.models import model_zoo as zoo
from repro_torch.models import transformer
from repro_torch.models.layers import apply_rope, tp_in, tp_out


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


def ring(seed, B=2, W=256, KV=4, G=1, dh=64, length=150,
         dtype=torch.bfloat16, q_dtype=torch.bfloat16):
    """Scaled q (B,1,KV,G,Dh), a ring k, v (B,W,KV,Dh) and its positions
    (B,W) after ``length`` + 1 tokens: slot s holds the newest position p
    <= length with p % W == s, -1 where none has landed yet."""
    gen = torch.Generator().manual_seed(seed)
    q = (torch.randn((B, 1, KV, G, dh), generator=gen) * dh ** -0.5
         ).to(q_dtype)
    k = torch.randn((B, W, KV, dh), generator=gen).to(dtype)
    v = torch.randn((B, W, KV, dh), generator=gen).to(dtype)
    s = torch.arange(W)
    newest = s + (length - s).div(W, rounding_mode="floor") * W
    pos = torch.where(s <= length, newest, -1).to(torch.int32)
    return q, k, v, pos.expand(B, W).clone(), torch.tensor(length,
                                                           dtype=torch.int32)


def plain(q, k, v, pos, length):
    """The masked softmax written out in float64, P rounded to v's dtype
    as the model rounds it."""
    B, _, KV, G, dh = q.shape
    s = torch.einsum("bkgd,bwkd->bkgw", q[:, 0].double(), k.double())
    keep = (pos >= 0) & (pos <= int(length))
    s = s.masked_fill(~keep[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).to(v.dtype).double()
    out = torch.einsum("bkgw,bwkd->bkgd", p, v.double())
    return out.reshape(B, 1, KV * G * dh)


@pytest.mark.parametrize("dh", [64, 112, 128])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("length", [150, 700], ids=["partial", "wrapped"])
def test_ref_matches_a_plain_masked_softmax(length, G, dh):
    q, k, v, pos, n = ring(dh + G, G=G, dh=dh, length=length)
    assert bool((pos < 0).any()) == (length < 255)
    got = decode_attention_ref(q, k, v, pos, n)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 1, 4 * G * dh)
    torch.testing.assert_close(got.double(), plain(q, k, v, pos, n),
                               rtol=2 ** -7, atol=1e-4)


@pytest.mark.parametrize("KV,G", [(8, 1), (1, 8)],
                         ids=["kv_heads_split", "model_over_kv_heads"])
def test_ref_at_a_tensor_parallel_ranks_head_counts(KV, G):
    """zamba2-7b's 32 heads on a ``model`` axis of 4: a rank holds 8 query
    heads over its 8 KV heads, or, where ``model`` exceeds the KV heads,
    its group's one KV head read by all 8."""
    q, k, v, pos, n = ring(KV, KV=KV, G=G, dh=112, length=190)
    torch.testing.assert_close(decode_attention_ref(q, k, v, pos, n).double(),
                               plain(q, k, v, pos, n), rtol=2 ** -7,
                               atol=1e-4)


@pytest.mark.parametrize("dtype,q_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32)])
def test_cpu_wrapper_takes_the_plain_version(dtype, q_dtype):
    q, k, v, pos, n = ring(3, W=64, G=2, dh=32, length=40, dtype=dtype,
                           q_dtype=q_dtype)
    before = dk.decode_attention.launches
    got = dk.decode_attention(q, k, v, pos, n)
    assert dk.decode_attention.launches == before
    assert got.dtype == q_dtype
    assert torch.equal(got, decode_attention_ref(q, k, v, pos, n))


@pytest.mark.parametrize("change,match", [
    (lambda a: {**a, "q": a["q"][..., :60], "k": a["k"][..., :60],
                "v": a["v"][..., :60]}, "multiple of 8"),
    (lambda a: {**a, "k": a["k"].half(), "v": a["v"].half()}, "bfloat16"),
    (lambda a: {**a, "v": a["v"].float()}, "alike"),
    (lambda a: {**a, "pos": a["pos"].long()}, "int32"),
    (lambda a: {**a, "length": a["length"].reshape(1)}, "0-d"),
    (lambda a: {**a, "v": a["v"][:, :-1]}, "do not match"),
    (lambda a: {**a, "k": a["k"].transpose(2, 3).contiguous().transpose(
        2, 3)}, "contiguous")])
def test_wrapper_refuses_what_the_kernel_does_not_take(change, match):
    q, k, v, pos, n = ring(4, W=64, dh=64, length=40)
    args = change({"q": q, "k": k, "v": v, "pos": pos, "length": n})
    with pytest.raises(ValueError, match=match):
        dk.decode_attention(**args)


def parent_ring_decode_attn(ap, x1, ck, cv, cpos, length, arch, mesh=None):
    """``transformer._ring_decode_attn`` as it stood before the kernel."""
    B = x1.shape[0]
    dh = arch.resolved_head_dim
    pos = length.reshape(1, 1).expand(B, 1).to(torch.int32)
    x1 = tp_in(x1, mesh)
    q, k, v = attn._project_qkv(ap, x1, x1, arch)
    if arch.rope_theta > 0:
        q = apply_rope(q, pos, arch.rope_theta)
        k = apply_rope(k, pos, arch.rope_theta)
    W, KV = ck.shape[1], ck.shape[2]
    slot = torch.remainder(length, W).reshape(1).long()
    ck.index_copy_(1, slot, k.to(ck.dtype))
    cv.index_copy_(1, slot, v.to(cv.dtype))
    cpos.index_copy_(1, slot, pos)
    G = q.shape[2] // KV
    qg = attn._scaled(q, dh ** -0.5).reshape(B, 1, KV, G, dh)
    s = attn._einsum_f32("bqkgd,bskd->bqkgs", qg, ck)
    valid = (cpos >= 0) & (cpos <= length)
    s = torch.where(valid[:, None, None, None, :], s, attn.NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = attn._einsum_f32("bqkgs,bskd->bqkgd", p.to(cv.dtype), cv)
    return tp_out(out.reshape(B, 1, -1).to(x1.dtype) @ ap["wo"], mesh)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("num_kv_heads", [4, 2])
def test_ring_decode_attn_on_the_cpu_equals_the_parents(num_kv_heads, dtype):
    """Eight tokens through zamba2's shared block (reduced, 64-slot ring
    from position 60, so it wraps), in both versions on copies of one
    ring: every output and the ring's K, V and positions bit for bit."""
    arch = dataclasses.replace(reduced(get_arch("zamba2-7b")),
                               num_kv_heads=num_kv_heads)
    params = zoo.init_params(arch, seed=0, dtype=dtype, device="cpu")
    ap = params["shared"]["attn"]
    cache = transformer.init_cache(arch, 2, 72, dtype=dtype, device="cpu")
    ring_ = [cache["shared_k"][0], cache["shared_v"][0],
             cache["shared_pos"][0]]
    gen = torch.Generator().manual_seed(1)
    for t in ring_[:2]:
        t.copy_(torch.randn(t.shape, generator=gen).to(dtype))
    ring_[2].copy_(torch.arange(ring_[2].shape[1], dtype=torch.int32))
    twin = [t.clone() for t in ring_]
    width = ap["wq"].shape[0]
    for step in range(60, 68):
        length = torch.tensor(step, dtype=torch.int32)
        x1 = torch.randn((2, 1, width), generator=gen).to(dtype)
        got = transformer._ring_decode_attn(ap, x1, *ring_, length, arch)
        want = parent_ring_decode_attn(ap, x1, *twin, length, arch)
        assert torch.equal(got, want), step
    for a, b in zip(ring_, twin):
        assert torch.equal(a, b)


def test_walker_charges_the_kernels_work():
    """Under the cost walker one call is one ``decode_attention`` launch of
    ``decode_attention_work`` (every slot of the ring: the walker reads no
    positions), on fake tensors (nothing runs) and on real CPU tensors
    (the plain version runs, its aten ops uncounted)."""
    B, W, KV, G, dh = 2, 64, 4, 2, 32
    want = rl.decode_attention_work(B, KV, G, W, dh, 2, 2)
    assert want == (4.0 * B * KV * G * W * dh,
                    float(2 * B * W * KV * dh * 2 + 4 * B * W
                          + 2 * B * KV * G * dh * 2))
    before = dk.decode_attention.launches
    with FakeTensorMode():
        args = ring(5, B=B, W=W, KV=KV, G=G, dh=dh, length=30)
    real = ring(5, B=B, W=W, KV=KV, G=G, dh=dh, length=30)
    for case in (args, real):
        walk = rl.CostMode()
        with walk:
            out = dk.decode_attention(*case)
        res = walk.result()
        assert res["kernel_launches"] == {"decode_attention": 1}
        assert (res["flops_per_device"], res["bytes_per_device"]) == want
        assert out.shape == (B, 1, KV * G * dh)
    assert dk.decode_attention.launches == before
