"""Mamba-2 (SSD) block: the counterpart of ``repro.models.ssm``.

Sequence mode is the SSD chunked algorithm (intra-chunk quadratic +
inter-chunk low-rank recurrence); decode carries an O(1) recurrent state.
``mamba2_seq`` takes ``impl``: REFERENCE runs the plain ``ssd_scan``, the
reference's own jnp algorithm; FLASH runs the SSD kernel
(``kernels/ssd_chunk``), which on a CUDA tensor is the hand-written Hopper
kernel and returns the final state itself, so a prefill never scans twice.
The reference runs ``ssd_scan`` alone; its docstring names the kernel as the
intended replacement of the scan.

Projections are kept separate (w_z/w_x/w_B/w_C/w_dt), as in the reference,
so a parameter tree carries across key for key.

Conventions: n_groups=1 (B, C shared across heads), A scalar per head.
    x          (B, S, D)
    x_inner    (B, S, H, P)     P = head_dim, H = expand*D / P
    B_, C_     (B, S, N)        N = state_dim
    state      (B, H, P, N)     f32

Decode writes the cache it is handed IN PLACE (the conv windows and the
state) and returns the same tensors.

Tensor parallelism (``mesh`` with a ``model`` axis): ``w_z`` and ``w_x``
hold the rank's d_inner columns, ``w_out`` its rows (one ``psum`` over
``model`` a layer), and ``transformer.tp_view`` has cut ``conv_x``,
``norm``, ``w_dt``, ``A_log``, ``D`` and ``dt_bias`` to the rank's columns
and heads, so the scan runs on the rank's H / model heads.  ``w_B``,
``w_C``, ``conv_B`` and ``conv_C`` run whole on every rank; B and C then
feed the rank's own heads, so they pass through ``shared_for_heads``
(their cotangent summed over ``model``).  The gated norm normalises over
the whole d_inner (``layers.rmsnorm(mesh=)``).  The cache holds the
rank's ``conv_x`` columns and state heads, ``conv_B`` and ``conv_C``
whole.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, AttnImpl
from repro_torch.models.layers import dense_init, rmsnorm, tp_in, tp_out


def ssm_dims(arch: ArchConfig) -> Tuple[int, int, int]:
    """(d_inner, n_heads, state_dim) of a Mamba2 block."""
    cfg = arch.ssm
    d_inner = cfg.expand * arch.d_model
    n_heads = d_inner // cfg.head_dim
    return d_inner, n_heads, cfg.state_dim


def mamba2_init(gen: torch.Generator, arch: ArchConfig,
                dtype=torch.float32) -> dict:
    """The reference's tree, shapes and scales; ``A_log``, ``D`` and
    ``dt_bias`` are f32 whatever ``dtype`` is."""
    cfg = arch.ssm
    d = arch.d_model
    di, h, n = ssm_dims(arch)
    full = lambda shape, value, dt: torch.full(shape, value, dtype=dt,
                                               device=gen.device)
    return {
        "w_z": dense_init(gen, (d, di), dtype=dtype),
        "w_x": dense_init(gen, (d, di), dtype=dtype),
        "w_B": dense_init(gen, (d, n), dtype=dtype),
        "w_C": dense_init(gen, (d, n), dtype=dtype),
        "w_dt": dense_init(gen, (d, h), dtype=dtype),
        "conv_x": dense_init(gen, (cfg.conv_width, di), scale=0.5,
                             dtype=dtype),
        "conv_B": dense_init(gen, (cfg.conv_width, n), scale=0.5,
                             dtype=dtype),
        "conv_C": dense_init(gen, (cfg.conv_width, n), scale=0.5,
                             dtype=dtype),
        "A_log": full((h,), 0.0, torch.float32),        # A = -exp(A_log) = -1
        "D": full((h,), 1.0, torch.float32),
        "dt_bias": full((h,), -2.0, torch.float32),     # softplus(-2) ≈ 0.13
        "norm": full((di,), 0.0, dtype),
        "w_out": dense_init(gen, (di, d), dtype=dtype),
    }


# ---------------------------------------------------------------------------
# Causal depthwise conv (width W) as shifted adds
# ---------------------------------------------------------------------------

def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B,S,C), w (W,C): y[t] = Σ_i w[i]·x[t-W+1+i]."""
    W, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    y = torch.zeros_like(x)
    for i in range(W):
        y = y + pad[:, i:i + S, :] * w[i]
    return y


def conv_step(x1: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token conv.  x1 (B,C); conv_state (B,W-1,C) holds prior
    inputs and is shifted IN PLACE to hold the last W-1, x1 included."""
    window = torch.cat([conv_state, x1[:, None, :]], dim=1)   # (B,W,C)
    y = torch.einsum("bwc,wc->bc", window, w)
    conv_state.copy_(window[:, 1:, :])
    return y, conv_state


# ---------------------------------------------------------------------------
# SSD chunked scan (sequence mode), the plain path
# ---------------------------------------------------------------------------

def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., L) -> (..., L, L) with out[i,j] = Σ_{k=j+1..i} a[k], -inf
    above the diagonal."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, out, -torch.inf)


def ssd_scan(x: torch.Tensor, a_dt: torch.Tensor, B_: torch.Tensor,
             C_: torch.Tensor, dt: torch.Tensor, chunk: int,
             init_state: torch.Tensor = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  x (B,S,H,P); a_dt (B,S,H) = A·dt (negative);
    B_/C_ (B,S,N); dt (B,S,H).  Returns (y (B,S,H,P), final_state
    (B,H,P,N)).  The chunk is the largest divisor of S <= ``chunk``."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    chunk = min(chunk, S)
    while S % chunk:                 # largest divisor of S <= chunk
        chunk -= 1
    nc = S // chunk
    xc = x.reshape(Bb, nc, chunk, H, P)
    ac = a_dt.reshape(Bb, nc, chunk, H).permute(0, 3, 1, 2)     # (B,H,c,l)
    Bc = B_.reshape(Bb, nc, chunk, N)
    Cc = C_.reshape(Bb, nc, chunk, N)
    dtc = dt.reshape(Bb, nc, chunk, H)
    xdt = xc * dtc[..., None]                                    # dt-weighted

    # intra-chunk (quadratic in chunk length)
    L = torch.exp(_segsum(ac))                                   # (B,H,c,l,l)
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)             # (B,c,l,s)
    y_diag = torch.einsum("bcls,bhcls,bcshp->bclhp", scores, L, xdt)

    # per-chunk final states
    a_cum = torch.cumsum(ac, dim=-1)                             # (B,H,c,l)
    decay_to_end = torch.exp(a_cum[..., -1:] - a_cum)            # (B,H,c,l)
    chunk_states = torch.einsum("bcsn,bhcs,bcshp->bchpn", Bc, decay_to_end,
                                xdt)

    # inter-chunk recurrence over c (the reference's lax.scan)
    chunk_decay = torch.exp(a_cum[..., -1])                      # (B,H,c)
    state = (torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
             if init_state is None else init_state)
    prev = []
    for i in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, :, i, None, None] + chunk_states[:, i]
    prev_states = torch.stack(prev, dim=1)                       # (B,c,H,P,N)

    # inter-chunk contribution to outputs
    state_decay = torch.exp(a_cum)                               # (B,H,c,l)
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, prev_states,
                         state_decay)
    y = (y_diag + y_off).reshape(Bb, S, H, P)
    return y, state


def ssd_step(x1: torch.Tensor, a_dt1: torch.Tensor, B1: torch.Tensor,
             C1: torch.Tensor, dt1: torch.Tensor, state: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step.  x1 (B,H,P); a_dt1/dt1 (B,H); B1/C1 (B,N);
    state (B,H,P,N), updated IN PLACE."""
    decay = torch.exp(a_dt1)[..., None, None]                    # (B,H,1,1)
    inject = torch.einsum("bhp,bn->bhpn", x1 * dt1[..., None], B1)
    state.mul_(decay).add_(inject)
    y = torch.einsum("bhpn,bn->bhp", state, C1)
    return y, state


# ---------------------------------------------------------------------------
# Full block (sequence + decode modes)
# ---------------------------------------------------------------------------

def shared_for_heads(t: torch.Tensor, mesh) -> torch.Tensor:
    """B or C, computed whole on every rank of ``model``, before the scan
    of the rank's own heads: the same values, the cotangent summed over
    ``model`` (each rank's covers only its heads)."""
    return tp_in(t, mesh)


def mamba2_seq(params: dict, x: torch.Tensor, arch: ArchConfig,
               return_state: bool = False,
               impl: AttnImpl = AttnImpl.REFERENCE, mesh=None):
    """x (B,S,D) -> y (B,S,D) [, cache].  The scan's inputs are f32, as in
    the reference; FLASH runs the SSD kernel, REFERENCE the plain scan.
    With ``mesh``: the rank's heads (the module docstring)."""
    cfg = arch.ssm
    Bb, S, _ = x.shape
    xv = tp_in(x, mesh)
    z = xv @ params["w_z"]
    x_pre = xv @ params["w_x"]
    b_pre = x @ params["w_B"]
    c_pre = x @ params["w_C"]
    xi = F.silu(causal_conv(x_pre, params["conv_x"]))
    B_ = shared_for_heads(F.silu(causal_conv(b_pre, params["conv_B"])), mesh)
    C_ = shared_for_heads(F.silu(causal_conv(c_pre, params["conv_C"])), mesh)
    dt = F.softplus((xv @ params["w_dt"]).float() + params["dt_bias"])
    a = -torch.exp(params["A_log"])                              # (H,)
    xi_h = xi.reshape(Bb, S, -1, cfg.head_dim).float()
    if impl == AttnImpl.FLASH:
        from repro_torch.kernels.ssd_chunk.ops import ssd_chunk
        y, final_state = ssd_chunk(xi_h, a * dt, B_.float(), C_.float(), dt,
                                   chunk=cfg.chunk_size)
    else:
        y, final_state = ssd_scan(xi_h, a * dt, B_.float(), C_.float(), dt,
                                  cfg.chunk_size)
    y = y + xi_h * params["D"][:, None]
    y = y.reshape(Bb, S, -1).to(x.dtype)
    y = rmsnorm(y, params["norm"], mesh=mesh) * F.silu(z)
    out = tp_out(y @ params["w_out"], mesh)
    if not return_state:
        return out
    # copies, so the cache does not keep the (B, S, ·) projections alive
    w = cfg.conv_width - 1
    cache = {"conv_x": x_pre[:, -w:, :].clone(),
             "conv_B": b_pre[:, -w:, :].clone(),
             "conv_C": c_pre[:, -w:, :].clone(), "state": final_state.float()}
    return out, cache


def mamba2_cache_init(arch: ArchConfig, batch: int, dtype=torch.float32,
                      device=None, model: int = 1) -> dict:
    """A zeroed cache; ``model`` > 1: a rank's part of it (d_inner / model
    conv columns and H / model state heads)."""
    cfg = arch.ssm
    di, h, n = ssm_dims(arch)
    w = cfg.conv_width - 1
    zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    return {
        "conv_x": zeros((batch, w, di // model), dtype),
        "conv_B": zeros((batch, w, n), dtype),
        "conv_C": zeros((batch, w, n), dtype),
        "state": zeros((batch, h // model, cfg.head_dim, n), torch.float32),
    }


def mamba2_decode(params: dict, x1: torch.Tensor, cache: dict,
                  arch: ArchConfig, mesh=None) -> Tuple[torch.Tensor, dict]:
    """x1 (B, 1, D) -> (y (B, 1, D), cache), the cache written in place.
    With ``mesh``: the rank's heads and cache (the module docstring)."""
    cfg = arch.ssm
    xq = x1[:, 0, :]
    xv = tp_in(xq, mesh)
    z = xv @ params["w_z"]
    xi, _ = conv_step(xv @ params["w_x"], cache["conv_x"], params["conv_x"])
    xi = F.silu(xi)
    B_, _ = conv_step(xq @ params["w_B"], cache["conv_B"], params["conv_B"])
    C_, _ = conv_step(xq @ params["w_C"], cache["conv_C"], params["conv_C"])
    B_ = shared_for_heads(F.silu(B_), mesh)
    C_ = shared_for_heads(F.silu(C_), mesh)
    dt = F.softplus((xv @ params["w_dt"]).float() + params["dt_bias"])
    a = -torch.exp(params["A_log"])
    xi_h = xi.reshape(xq.shape[0], -1, cfg.head_dim).float()
    y, _ = ssd_step(xi_h, a * dt, B_.float(), C_.float(), dt, cache["state"])
    y = y + xi_h * params["D"][:, None]
    y = y.reshape(xq.shape[0], -1).to(x1.dtype)
    y = rmsnorm(y, params["norm"], mesh=mesh) * F.silu(z)
    y = tp_out(y @ params["w_out"], mesh)
    return y[:, None, :], cache
