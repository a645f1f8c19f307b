"""The port's flash attention against the reference Pallas kernel.

On the CPU the port's wrapper takes its plain version (the same online
softmax over the reference's blocks); the reference kernel runs in Pallas
interpret mode with 64-row blocks, as ``tests/test_kernels.py`` runs it, and
both are also held against the reference's O(S²) oracle.  Inputs are made by
numpy from a seed and cast in each framework.  Tolerances are the
reference's own (``tests/test_kernels.py``): 2e-5 in float32 (summation
order only) and 2e-2 in bfloat16 (the output and p are rounded to bf16 at
different points of two accumulation orders).  The CUDA kernel against this
plain version is ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as ref_oracle
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from torch_parity import port_lockdep, to_np  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")

_DT = {"float32": (jnp.float32, torch.float32, 2e-5),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, B, Sq, Skv, H, KV, D, dtype):
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, D)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, D)).astype(np.float32))
    jdt, tdt, tol = _DT[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs], tol)


def _close(got, want, tol, what):
    np.testing.assert_allclose(to_np(got).astype(np.float32),
                               to_np(want).astype(np.float32), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("B,S,H,KV,D", [
    (1, 128, 4, 4, 32), (2, 256, 4, 2, 64), (1, 512, 8, 2, 32),
    (2, 128, 2, 1, 128), (1, 128, 4, 4, 112),     # 112: zamba2's shared block
    (1, 128, 4, 4, 96), (1, 128, 2, 1, 256),      # phi-3-vision's, gemma-7b's
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_pallas_interpret(B, S, H, KV, D, dtype, causal):
    (jq, jk, jv), (q, k, v), tol = _inputs(0, B, S, S, H, KV, D, dtype)
    n0 = fk.flash_attention_bhsd.launches
    out = flash_attention(q, k, v, causal=causal)
    assert fk.flash_attention_bhsd.launches == n0, "a CPU call launched"
    assert out.shape == q.shape and out.dtype == q.dtype
    ref = ref_flash(jq, jk, jv, causal=causal, bq=64, bk=64, interpret=True)
    _close(out, ref, tol, "port vs Pallas interpret")
    _close(out, ref_oracle(jq, jk, jv, causal=causal), tol,
           "port vs reference oracle")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_sliding_window(causal):
    (jq, jk, jv), (q, k, v), tol = _inputs(1, 1, 256, 256, 2, 2, 32,
                                           "float32")
    out = flash_attention(q, k, v, causal=causal, window=64)
    ref = ref_flash(jq, jk, jv, causal=causal, window=64, bq=64, bk=64,
                    interpret=True)
    _close(out, ref, tol, "sliding window")
    _close(out, ref_oracle(jq, jk, jv, causal=causal, window=64), tol,
           "sliding window vs oracle")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv", [(100, 100), (128, 256)])
def test_flash_ragged_and_uneven(Sq, Skv, dtype):
    """S=100 (the reference shrinks its blocks to S) and Sq != Skv
    (positions align at the start)."""
    (jq, jk, jv), (q, k, v), tol = _inputs(2, 1, Sq, Skv, 4, 2, 64, dtype)
    for causal in (True, False):
        out = flash_attention(q, k, v, causal=causal)
        blk = 64 if Sq % 64 == 0 and Skv % 64 == 0 else Sq
        ref = ref_flash(jq, jk, jv, causal=causal, bq=blk, bk=blk,
                        interpret=True)
        _close(out, ref, tol, f"Sq={Sq} Skv={Skv} causal={causal}")


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 64)])
def test_port_oracle_matches_reference_oracle(causal, window):
    (jq, jk, jv), (q, k, v), tol = _inputs(3, 2, 128, 128, 4, 2, 32,
                                           "float32")
    _close(flash_attention_ref(q, k, v, causal=causal, window=window),
           ref_oracle(jq, jk, jv, causal=causal, window=window), tol,
           "oracles")


def test_plain_version_blocks_like_the_reference():
    """The plain version over several of the reference's 256/512 blocks,
    each ragged at its end (S=600: query blocks of 256, 256, 88; key blocks
    of 512, 88), against the reference's oracle: the same function up to
    f32 summation order."""
    (jq, jk, jv), (q, k, v), tol = _inputs(4, 1, 600, 600, 4, 2, 64,
                                           "float32")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    for causal, window in ((True, 100), (True, 0), (False, 0)):
        got = fk.flash_attention_bhsd_plain(qt, kt, vt, causal=causal,
                                            window=window).transpose(1, 2)
        _close(got, ref_oracle(jq, jk, jv, causal=causal, window=window),
               tol, f"causal={causal} window={window}")


def test_wrapper_refuses_what_the_kernel_does_not_take():
    _, (q, k, v), _ = _inputs(5, 1, 64, 64, 4, 2, 32, "float32")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    for d in (48, 512):
        with pytest.raises(ValueError, match="head dim"):
            fk.flash_attention_bhsd(torch.zeros(1, 4, 64, d),
                                    torch.zeros(1, 2, 64, d),
                                    torch.zeros(1, 2, 64, d))
    with pytest.raises(ValueError, match="dtype"):
        fk.flash_attention_bhsd(qt, kt.half(), vt)
    with pytest.raises(ValueError, match="multiple"):
        fk.flash_attention_bhsd(qt[:, :3], kt, vt)
    with pytest.raises(ValueError, match="contiguous"):
        fk.flash_attention_bhsd(torch.zeros(1, 4, 32, 64).transpose(2, 3),
                                kt, vt)
    with pytest.raises(ValueError, match="device"):
        fk.flash_attention_bhsd(qt.to("meta"), kt.to("meta"), vt.to("meta"))


def _misaligned(t):
    """``t``'s numbers in a view whose base sits one element past 16 bytes."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("case", ["misaligned_base", "odd_stride",
                                  "H_65536", "B_65536"])
def test_every_device_takes_misaligned_rows_and_large_grids(case):
    """Inputs the card once refused while the CPU took them: a bf16 base
    one element off 16 bytes, a row stride that breaks 16-byte rows, and
    65,536 heads or batches (past a grid's y and z limit).  The wrapper
    takes each on every device: here the numbers equal the aligned call's
    and the reference oracle's; ``test_torch_cuda.py`` pins the card."""
    B, S, H, KV, D = {"misaligned_base": (2, 64, 4, 2, 32),
                      "odd_stride": (1, 64, 4, 2, 32),
                      "H_65536": (1, 2, 65536, 1, 32),
                      "B_65536": (65536, 2, 1, 1, 32)}[case]
    (jq, jk, jv), (q, k, v), tol = _inputs(11, B, S, S, H, KV, D,
                                           "bfloat16")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    want = fk.flash_attention_bhsd(qt, kt, vt)
    if case == "misaligned_base":
        args = [_misaligned(t) for t in (qt, kt, vt)]
        out = _misaligned(torch.zeros_like(qt))
        assert not fk.rows_aligned(out) and not fk.rows_aligned(args[0])
        got = fk.flash_attention_bhsd(*args, out=out)
        assert got is out
    elif case == "odd_stride":
        # rows of D + 1 elements: every row but the first off 16 bytes
        wide = torch.zeros(B, H, S, D + 1, dtype=qt.dtype)
        wide[..., :D] = qt
        assert not fk.rows_aligned(wide[..., :D])
        got = fk.flash_attention_bhsd(wide[..., :D], kt, vt)
    else:
        got = fk.flash_attention_bhsd(qt, kt, vt)
    assert torch.equal(got, want)
    _close(got.transpose(1, 2), ref_oracle(jq, jk, jv, causal=True), tol,
           case)


# ---------------------------------------------------------------------------
# the bf16 kernel's tensor maps, as the host builds them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [32, 64, 96, 112, 128, 256])
@pytest.mark.parametrize("layout", ["contiguous", "model"])
def test_tma_geometry_of_the_kernel_and_model_layouts(D, layout):
    """The contiguous (B,H,S,D) layout and the transposed (B,S,H,D) model
    layout: the head dim innermost, the rest ordered by stride, byte
    strides of the view's own, a box of one swizzled slab by the tile's
    rows (D=96 to 128 load as two slabs, D=256 as four, with 64-key K/V
    tiles), and the order the kernel reads the s, h and b coordinates by."""
    B, H, S = 2, 3, 100
    if layout == "contiguous":
        view = torch.zeros((B, H, S, D), dtype=torch.bfloat16)
        want_sizes, roles = (S, H, B), "shb"
    else:
        view = torch.zeros((B, S, H, D), dtype=torch.bfloat16).transpose(1, 2)
        want_sizes, roles = (H, S, B), "hsb"
    kv_rows = fk.kv_tile_rows(D)
    assert kv_rows == {32: 64, 64: 64, 96: 96, 112: 96, 128: 96, 256: 64}[D]
    geo = fk._tma_geometry(view, kv_rows)
    swizzle = 64 if D == 32 else 128
    assert geo.swizzle == swizzle
    slabs = -(-D // geo.box[0])
    assert slabs == {32: 1, 64: 1, 96: 2, 112: 2, 128: 2, 256: 4}[D]
    assert geo.dims == (D, *want_sizes)
    strides = {"s": view.stride(2) * 2, "h": view.stride(1) * 2,
               "b": view.stride(0) * 2}
    assert geo.strides == tuple(strides[r] for r in roles)
    assert list(geo.strides) == sorted(geo.strides)
    rows = {"s": kv_rows, "h": 1, "b": 1}
    assert geo.box == (swizzle // 2, *(rows[r] for r in roles))
    assert geo.order == tuple(1 + roles.index(r) for r in "shb")
    packed = geo.packed()
    assert len(packed) == 15 and packed[11] == swizzle
    q_geo = fk._tma_geometry(view, fk.Q_TILE_ROWS)
    assert q_geo.box[geo.order[0]] == fk.Q_TILE_ROWS


def test_tma_geometry_refuses_what_tma_refuses():
    """A row stride that is not a multiple of 16 bytes, a head dim that is
    not contiguous, and a size-1 dim's stride taken as the view's extent."""
    base = torch.zeros((1, 2, 64, 72), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 16"):
        fk._tma_geometry(torch.zeros((1, 2, 64, 68), dtype=torch.bfloat16)
                         [..., :64], 64)
    with pytest.raises(ValueError, match="contiguous"):
        fk._tma_geometry(base[..., :64].transpose(2, 3), 64)
    one = fk._tma_geometry(torch.zeros((1, 1, 5, 64), dtype=torch.bfloat16),
                           64)
    assert one.dims == (64, 5, 1, 1) and one.strides == (128, 640, 640)


@pytest.mark.parametrize("D,causal,window", [(96, True, 0), (96, False, 0),
                                             (256, True, 0), (256, False, 0),
                                             (256, True, 40)])
def test_new_head_dims_ragged_against_pallas(D, causal, window):
    """D=96 and D=256 at a ragged S=100 (the reference shrinks its blocks
    to S) and Sq != Skv, f32, against the Pallas kernel in interpret
    mode."""
    for Sq, Skv in ((100, 100), (64, 128)):
        (jq, jk, jv), (q, k, v), tol = _inputs(12, 1, Sq, Skv, 4, 2, D,
                                               "float32")
        out = flash_attention(q, k, v, causal=causal, window=window)
        blk = 64 if Sq % 64 == 0 and Skv % 64 == 0 else Sq
        ref = ref_flash(jq, jk, jv, causal=causal, window=window, bq=blk,
                        bk=blk, interpret=True)
        _close(out, ref, tol, f"D={D} Sq={Sq} Skv={Skv}")


@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_dense_forward_at_head_dim_256(impl):
    """The fault the port had: gemma-7b's head dim is 256, which the
    reduced config (head dim 32) hid.  A dense forward of reduced gemma
    with ``head_dim=256`` under FLASH (and REFERENCE) against the
    reference's on the same weights, f32 (1e-4)."""
    import dataclasses
    from repro import configs as rc
    from repro.models import model_zoo as ref_zoo
    from repro_torch import configs as tc
    from repro_torch.core.carry import params_from_numpy
    from repro_torch.models import model_zoo as zoo
    arch_r = dataclasses.replace(rc.reduced(rc.get_arch("gemma-7b")),
                                 head_dim=256, num_layers=2)
    arch_t = dataclasses.replace(tc.reduced(tc.get_arch("gemma-7b")),
                                 head_dim=256, num_layers=2)
    params_r = ref_zoo.init_params(arch_r, jax.random.PRNGKey(0))
    params_t = params_from_numpy(arch_t, jax.device_get(params_r),
                                 device="cpu")
    tokens = np.random.default_rng(13).integers(
        0, arch_r.vocab_size, (2, 64)).astype(np.int32)
    want, _, _ = ref_zoo.forward_seq(arch_r, params_r, jnp.asarray(tokens),
                                     impl=rc.AttnImpl(impl),
                                     compute_dtype=jnp.float32)
    got, _, _ = zoo.forward_seq(arch_t, params_t, torch.from_numpy(tokens),
                                impl=tc.AttnImpl(impl),
                                compute_dtype=torch.float32)
    want, got = to_np(want), to_np(got)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4


def test_cpu_calls_make_no_give_up_word():
    """The give-up word belongs to CUDA launches: a CPU call (the plain
    version) makes none, and ``check_give_ups`` then reads nothing and
    returns 0 without touching a card."""
    rng = np.random.default_rng(21)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 64, 256))
                                .astype(np.float32)) for _ in range(3))
    fk.flash_attention_bhsd(q, k, v)
    assert fk._give_up_words == {}
    assert fk.check_give_ups() == 0
