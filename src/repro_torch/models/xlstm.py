"""xLSTM blocks (arXiv:2405.04517): the counterpart of ``repro.models.xlstm``.

mLSTM (matrix memory) runs its sequence mode in the stabilised chunkwise
form: within a chunk a decay-masked quadratic term, across chunks a
(dqk × dv) matrix state C with its normaliser n and running max m.
``mlstm_seq`` takes ``impl``: REFERENCE runs the plain ``mlstm_cell_seq``,
the reference's own algorithm; FLASH runs the mLSTM kernel
(``kernels/mlstm_chunk``), which on a CUDA tensor is the hand-written
Hopper kernel and returns the final carry itself, so a prefill never scans
twice.  The reference runs its jnp cell alone.

sLSTM (scalar memory, hidden-state-recurrent gates) is sequential by design.
The reference's ``lax.scan`` over time is ``slstm_scan``: blocks of
``SLSTM_BLOCK`` timesteps through a ``core.graphs.StepCache``, so on CUDA
a sequence is S / SLSTM_BLOCK replays of one captured block (a ragged
tail replays blocks of falling powers of two) instead of about 25 small
launches a timestep from the host; the block's body is the plain loop
over time, so a replay is bit for bit the eager loop.  The reference has
no Pallas kernel for the recurrence, and the port adds none.

Block structure (pre-LN residual):
  mLSTM block: x → up(2D)‖gate(2D) → conv4 → q,k,v → cell → groupnorm·silu(gate) → down
  sLSTM block: x → cell (block-diag recurrent gates/head) → groupnorm → GeGLU FFN(4/3)

Decode writes the cache it is handed IN PLACE (mLSTM: the conv window, C,
n, m; sLSTM: c, n, m, h) and returns the same tensors.

Tensor parallelism (``mesh`` with a ``model`` axis).  mLSTM: ``w_up`` and
``w_gate`` hold the rank's d_inner columns, and ``transformer.tp_view``
has cut ``conv``, ``norm``, ``b_i``, ``b_f`` and both halves of ``w_if``
to the rank's columns and heads.  ``w_q``, ``w_k`` and ``w_v`` read the
whole conv output ``u`` and up-projection, gathered over ``model``
(``gather_param``: each rank reads them for its own heads, so their
cotangents are reduce-scattered back), and give the rank's heads, the
cell's and the groupnorm's; ``w_down`` holds its rows (one ``psum``).
sLSTM: ``w_in``, ``r``, ``b`` and ``norm`` stay whole, so the recurrence
runs whole on every rank; its GeGLU feed-forward is column/row parallel.
The cache holds the rank's mLSTM conv columns and C, n, m heads, and the
whole sLSTM state.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, AttnImpl
from repro_torch.core.graphs import StepCache
from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk
from repro_torch.models.layers import (_gelu, dense_init, groupnorm_heads,
                                       tp_in, tp_out)
from repro_torch.models.ssm import causal_conv, conv_step


def mlstm_dims(arch: ArchConfig) -> Tuple[int, int, int]:
    """(d_inner, heads, head dim) of an mLSTM block."""
    cfg = arch.xlstm
    di = int(cfg.proj_factor_mlstm * arch.d_model)
    h = cfg.num_heads
    return di, h, di // h


def _full(gen: torch.Generator, shape, value: float, dtype) -> torch.Tensor:
    return torch.full(shape, value, dtype=dtype, device=gen.device)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, arch: ArchConfig,
               dtype=torch.float32) -> dict:
    """The reference's tree, shapes and scales; ``w_if``, ``b_i`` and
    ``b_f`` are f32 whatever ``dtype`` is."""
    d = arch.d_model
    di, h, dh = mlstm_dims(arch)
    return {
        "w_up": dense_init(gen, (d, di), dtype=dtype),
        "w_gate": dense_init(gen, (d, di), dtype=dtype),
        "conv": dense_init(gen, (4, di), scale=0.5, dtype=dtype),
        "w_q": dense_init(gen, (di, di), dtype=dtype),
        "w_k": dense_init(gen, (di, di), dtype=dtype),
        "w_v": dense_init(gen, (di, di), dtype=dtype),
        "w_if": dense_init(gen, (di, 2 * h), scale=di ** -0.5,
                           dtype=torch.float32),
        "b_i": _full(gen, (h,), -3.0, torch.float32),  # sparse writes at init
        "b_f": _full(gen, (h,), 3.0, torch.float32),   # long memory at init
        "norm": _full(gen, (h, dh), 0.0, dtype),
        "w_down": dense_init(gen, (di, d), dtype=dtype),
    }


def _chunk_for(S: int, chunk: int) -> int:
    """The largest divisor of S <= chunk (the reference's rule)."""
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    return chunk


def _mlstm_chunk_parallel(q, k, v, log_i, log_f, carry):
    """One chunk, all heads.  q/k/v (B,H,L,dh) f32; log_i/f (B,H,L);
    carry = (C (B,H,dh,dh), n (B,H,dh), m (B,H))."""
    C, n, m = carry
    L = q.shape[2]
    b = torch.cumsum(log_f, dim=-1)                           # (B,H,L)
    # intra-chunk decay: D[i,j] = b[i] - b[j] + log_i[j], j <= i
    D = b[..., :, None] - b[..., None, :] + log_i[..., None, :]
    tril = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    D = torch.where(tril, D, -torch.inf)
    m_intra = D.amax(dim=-1)                                  # (B,H,L)
    m_inter = b + m[..., None]                                # (B,H,L)
    m_tot = torch.maximum(m_intra, m_inter)
    scale = q.shape[-1] ** -0.5

    S = torch.einsum("bhld,bhsd->bhls", q, k) * scale
    W = S * torch.exp(D - m_tot[..., None])                   # weights
    h_intra = torch.einsum("bhls,bhsd->bhld", W, v)
    dec_in = torch.exp(m_inter - m_tot)                       # (B,H,L)
    h_inter = torch.einsum("bhld,bhde->bhle", q * scale, C) * dec_in[..., None]

    norm_intra = W.sum(dim=-1)
    norm_inter = torch.einsum("bhld,bhd->bhl", q * scale, n) * dec_in
    denom = torch.maximum((norm_intra + norm_inter).abs(), torch.exp(-m_tot))
    h_out = (h_intra + h_inter) / denom[..., None]            # (B,H,L,dh)

    # carry to end of chunk
    m_next = torch.maximum(b[..., -1] + m,
                           (b[..., -1:] - b + log_i).amax(dim=-1))
    dec_C = torch.exp(b[..., -1] + m - m_next)                # (B,H)
    w_kv = torch.exp(b[..., -1:] - b + log_i - m_next[..., None])  # (B,H,L)
    C_next = C * dec_C[..., None, None] + torch.einsum(
        "bhl,bhld,bhle->bhde", w_kv, k, v)
    n_next = n * dec_C[..., None] + torch.einsum("bhl,bhld->bhd", w_kv, k)
    return h_out, (C_next, n_next, m_next)


def mlstm_cell_seq(q, k, v, log_i, log_f, chunk: int, carry=None):
    """q/k/v (B,S,H,dh); gates (B,S,H).  Returns (h (B,S,H,dh), carry).
    The chunk is the largest divisor of S <= ``chunk``."""
    B, S, H, dh = q.shape
    chunk = _chunk_for(S, chunk)
    if carry is None:
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                           device=q.device)
        carry = (zeros(B, H, dh, dh), zeros(B, H, dh), zeros(B, H))
    t = lambda x: x.transpose(1, 2)
    hs = []
    for s0 in range(0, S, chunk):
        sl = slice(s0, s0 + chunk)
        h, carry = _mlstm_chunk_parallel(t(q[:, sl]), t(k[:, sl]),
                                         t(v[:, sl]), t(log_i[:, sl]),
                                         t(log_f[:, sl]), carry)
        hs.append(h)
    return t(torch.cat(hs, dim=2)), carry


def mlstm_cell_step(q1, k1, v1, log_i1, log_f1, carry):
    """One token.  q1/k1/v1 (B,H,dh); gates (B,H).  The carry (C, n, m) is
    updated IN PLACE and returned."""
    C, n, m = carry
    m_new = torch.maximum(log_f1 + m, log_i1)
    i_ = torch.exp(log_i1 - m_new)
    f_ = torch.exp(log_f1 + m - m_new)
    C.mul_(f_[..., None, None]).add_(i_[..., None, None] * torch.einsum(
        "bhd,bhe->bhde", k1, v1))
    n.mul_(f_[..., None]).add_(i_[..., None] * k1)
    m.copy_(m_new)
    scale = q1.shape[-1] ** -0.5
    num = torch.einsum("bhd,bhde->bhe", q1 * scale, C)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", q1 * scale, n).abs(),
                        torch.exp(-m_new))
    return num / den[..., None], (C, n, m)


def _whole_columns(t: torch.Tensor, mesh) -> torch.Tensor:
    """The rank's d_inner columns of ``t`` gathered whole over ``model``
    (``gather_param``: its cotangent reduce-scattered, as each rank reads
    the whole for its own heads)."""
    if mesh is None:
        return t
    from repro_torch.parallel.collectives import gather_param
    return gather_param(t, mesh, "model", t.ndim - 1)


def _mlstm_gates(params, u, h: int):
    """log input and forget gates, f32 (..., H).  ``w_if`` is upcast: the
    reference's f32 @ bf16 promotes to an f32 product of the bf16-rounded
    weights, where torch would refuse the mixed product."""
    gates = u.float() @ params["w_if"].float()
    log_i = F.logsigmoid(gates[..., :h] + params["b_i"])
    log_f = F.logsigmoid(gates[..., h:] + params["b_f"])
    return log_i, log_f


def mlstm_seq(params: dict, x: torch.Tensor, arch: ArchConfig,
              return_state: bool = False,
              impl: AttnImpl = AttnImpl.REFERENCE, mesh=None):
    """x (B,S,D) -> y (B,S,D) [, cache].  q/k/v and the gates are f32, as
    in the reference; FLASH runs the mLSTM kernel over the chunk the plain
    cell would take, REFERENCE the plain cell.  With ``mesh``: the rank's
    heads (the module docstring)."""
    _, _, dh = mlstm_dims(arch)
    B, S, _ = x.shape
    xv = tp_in(x, mesh)
    up = xv @ params["w_up"]
    gate = xv @ params["w_gate"]
    u = F.silu(causal_conv(up, params["conv"]))
    u_all, up_all = _whole_columns(u, mesh), _whole_columns(up, mesh)
    q = (u_all @ params["w_q"]).reshape(B, S, -1, dh).float()
    k = (u_all @ params["w_k"]).reshape(B, S, -1, dh).float()
    v = (up_all @ params["w_v"]).reshape(B, S, -1, dh).float()
    log_i, log_f = _mlstm_gates(params, u_all, q.shape[2])
    if impl == AttnImpl.FLASH:
        hcell, (C, n, m) = mlstm_chunk(
            q, k, v, log_i, log_f,
            chunk=_chunk_for(S, arch.xlstm.chunk_size))
    else:
        hcell, (C, n, m) = mlstm_cell_seq(q, k, v, log_i, log_f,
                                          arch.xlstm.chunk_size)
    hcell = groupnorm_heads(hcell.to(x.dtype), params["norm"])
    out = hcell.reshape(B, S, -1) * F.silu(gate)
    out = tp_out(out @ params["w_down"], mesh)
    if not return_state:
        return out
    # a copy, so the cache does not keep the (B, S, ·) projection alive
    return out, {"conv": up[:, -3:, :].clone(), "C": C, "n": n, "m": m}


def mlstm_cache_init(arch: ArchConfig, batch: int, dtype=torch.float32,
                     device=None, model: int = 1) -> dict:
    """A zeroed cache; ``model`` > 1: a rank's part of it (d_inner / model
    conv columns, H / model heads of C, n and m)."""
    di, h, dh = mlstm_dims(arch)
    di, h = di // model, h // model
    zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    return {
        "conv": zeros((batch, 3, di), dtype),
        "C": zeros((batch, h, dh, dh), torch.float32),
        "n": zeros((batch, h, dh), torch.float32),
        "m": zeros((batch, h), torch.float32),
    }


def mlstm_decode(params: dict, x1: torch.Tensor, cache: dict,
                 arch: ArchConfig, mesh=None) -> Tuple[torch.Tensor, dict]:
    """x1 (B, 1, D) -> (y (B, 1, D), cache), the cache written in place.
    With ``mesh``: the rank's heads and cache (the module docstring)."""
    _, _, dh = mlstm_dims(arch)
    xq = tp_in(x1[:, 0, :], mesh)
    up = xq @ params["w_up"]
    gate = xq @ params["w_gate"]
    u, _ = conv_step(up, cache["conv"], params["conv"])
    u_all = _whole_columns(F.silu(u), mesh)
    up_all = _whole_columns(up, mesh)
    q = (u_all @ params["w_q"]).reshape(xq.shape[0], -1, dh).float()
    k = (u_all @ params["w_k"]).reshape(xq.shape[0], -1, dh).float()
    v = (up_all @ params["w_v"]).reshape(xq.shape[0], -1, dh).float()
    log_i, log_f = _mlstm_gates(params, u_all, q.shape[1])
    hc, _ = mlstm_cell_step(q, k, v, log_i, log_f,
                            (cache["C"], cache["n"], cache["m"]))
    hc = groupnorm_heads(hc[:, None].to(x1.dtype), params["norm"])[:, 0]
    out = (hc.reshape(xq.shape[0], -1) * F.silu(gate)) @ params["w_down"]
    return tp_out(out, mesh)[:, None, :], cache


# ---------------------------------------------------------------------------
# sLSTM (sequential; 1-in-8 layers)
# ---------------------------------------------------------------------------

def slstm_init(gen: torch.Generator, arch: ArchConfig,
               dtype=torch.float32) -> dict:
    """The reference's tree, shapes and scales; the bias ``b`` is f32."""
    d = arch.d_model
    h = arch.xlstm.num_heads
    dh = d // h
    dff = int(arch.xlstm.proj_factor_slstm * d)
    return {
        "w_in": dense_init(gen, (d, 4 * d), dtype=dtype),       # z,i,f,o
        "r": dense_init(gen, (4, h, dh, dh), scale=dh ** -0.5, dtype=dtype),
        "b": torch.cat([_full(gen, (2 * d,), 0.0, torch.float32),
                        _full(gen, (d,), 3.0, torch.float32),   # forget bias
                        _full(gen, (d,), 0.0, torch.float32)]),
        "norm": _full(gen, (h, dh), 0.0, dtype),
        "w_ff_gate": dense_init(gen, (d, dff), dtype=dtype),
        "w_ff_up": dense_init(gen, (d, dff), dtype=dtype),
        "w_ff_down": dense_init(gen, (dff, d), dtype=dtype),
    }


def slstm_cell_step(wx_t: torch.Tensor, r: torch.Tensor, b: torch.Tensor,
                    carry, h_heads: int):
    """One timestep.  wx_t (B,4D) input pre-activations; r (4,H,dh,dh)
    recurrent block-diagonal weights; carry = (c,n,m,hid) each (B,H,dh)
    (m is (B,H)).  Returns (new carry, hid): new tensors, the carry is not
    written."""
    c, n, m, hid = carry
    B = wx_t.shape[0]
    d = wx_t.shape[1] // 4
    dh = d // h_heads
    rec = torch.einsum("bhd,ghde->gbhe", hid, r.to(hid.dtype))  # (4,B,H,dh)
    # bf16 + f32 bias promotes to f32, as jnp does; then + the bf16 rec
    pre = wx_t.reshape(B, 4, h_heads, dh).transpose(0, 1) + \
        b.reshape(4, 1, h_heads, dh) + rec
    z = torch.tanh(pre[0])
    i_t = pre[1].float()
    f_t = pre[2].float()
    o = torch.sigmoid(pre[3])
    log_i = i_t                                                 # exp-input gate
    log_f = F.logsigmoid(f_t)
    m_scalar = torch.maximum(log_f + m[..., None], log_i)       # (B,H,dh) stab.
    i_ = torch.exp(log_i - m_scalar)
    f_ = torch.exp(log_f + m[..., None] - m_scalar)
    c = f_ * c + i_ * z.float()
    n = f_ * n + i_
    hid_new = (o.float() * c / torch.clamp(n, min=1e-6)).to(hid.dtype)
    m_new = m_scalar.amax(dim=-1)                               # per-head
    return (c, n, m_new, hid_new), hid_new


def slstm_cache_init(arch: ArchConfig, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    h = arch.xlstm.num_heads
    dh = arch.d_model // h
    zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    return {
        "c": zeros((batch, h, dh), torch.float32),
        "n": zeros((batch, h, dh), torch.float32),
        "m": zeros((batch, h), torch.float32),
        "h": zeros((batch, h, dh), dtype),
    }


#: timesteps of one captured sLSTM block: 64 steps are ~1,600 graph nodes
#: (a small capture), and a 2,048-token prefill replays it 32 times a layer
SLSTM_BLOCK = 64


def slstm_blocks(S: int):
    """(start, length) of the blocks ``slstm_scan`` cuts S timesteps into:
    whole blocks of SLSTM_BLOCK, then the ragged tail as falling powers of
    two (36 = 32 + 4), so a batch size meets at most 7 block lengths
    whatever its prompt lengths."""
    whole, tail = divmod(S, SLSTM_BLOCK)
    lengths = [SLSTM_BLOCK] * whole + [
        1 << i for i in reversed(range(tail.bit_length())) if tail >> i & 1]
    starts = [sum(lengths[:j]) for j in range(len(lengths))]
    return list(zip(starts, lengths))


def slstm_loop(wx: torch.Tensor, r: torch.Tensor, b: torch.Tensor, carry,
               h_heads: int):
    """The recurrence over wx's (B, S, 4D) timesteps as a Python loop, the
    reference's ``lax.scan``: (hs (B, S, H, dh), final carry)."""
    hs = []
    for t in range(wx.shape[1]):
        carry, hid = slstm_cell_step(wx[:, t], r, b, carry, h_heads)
        hs.append(hid)
    return torch.stack(hs, dim=1), carry


def _slstm_block(state, params, inputs, h_heads):
    wx, r, b, carry = inputs
    return slstm_loop(wx, r, b, carry, h_heads)


#: the sLSTM block step, process-wide (as the reference's jit cache is):
#: every input is copied into the graph's static buffers (wx's block, r, b
#: and the carry), so one graph per (B, block length, dtypes) serves every
#: layer and every sequence, and the cache's ``MAX_ENTRIES`` bounds it
SLSTM_STEPS = StepCache("slstm_scan", _slstm_block)


def slstm_scan(wx: torch.Tensor, r: torch.Tensor, b: torch.Tensor, carry,
               h_heads: int):
    """``slstm_loop`` in the blocks of ``slstm_blocks`` through
    ``SLSTM_STEPS``: on CUDA one replay a block, the carry copied out of
    one replay and into the next; on the CPU the loop itself, block by
    block.  Bit for bit ``slstm_loop``.

    Under autograd (grad mode on and ``wx``, ``r``, ``b`` or the carry
    requiring grad) the blocks run ``slstm_loop`` eagerly and never touch
    ``SLSTM_STEPS``: a replay's outputs are clones of a graph's static
    buffers, with no autograd history, so the cell's weights would get no
    gradient on the card."""
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (wx, r, b, *carry))
    hs = []
    for t0, length in slstm_blocks(wx.shape[1]):
        block = wx[:, t0:t0 + length]
        if grad:
            hb, carry = slstm_loop(block, r, b, tuple(carry), h_heads)
        else:
            hb, carry = SLSTM_STEPS(inputs=(block, r, b, tuple(carry)),
                                    static=(h_heads,))
        hs.append(hb)
    return torch.cat(hs, dim=1), carry


def _slstm_cell(params, x, arch, carry):
    """The reference's ``lax.scan`` over time (``slstm_scan``)."""
    wx = x @ params["w_in"]                                     # (B,S,4D)
    return slstm_scan(wx, params["r"], params["b"], carry,
                      arch.xlstm.num_heads)                     # (B,S,H,dh)


def _slstm_ffn(params: dict, y: torch.Tensor, mesh) -> torch.Tensor:
    """GeGLU FFN (proj factor 4/3; jax.nn.gelu is the tanh approximation),
    with ``mesh`` column/row parallel over ``model``."""
    y = tp_in(y, mesh)
    g = _gelu(y @ params["w_ff_gate"]) * (y @ params["w_ff_up"])
    return tp_out(g @ params["w_ff_down"], mesh)


def slstm_seq(params: dict, x: torch.Tensor, arch: ArchConfig,
              return_state: bool = False, mesh=None):
    """x (B,S,D) -> y (B,S,D) [, cache]; with ``mesh`` the recurrence
    whole on every rank and the feed-forward column/row parallel."""
    B, S, d = x.shape
    init = slstm_cache_init(arch, B, x.dtype, device=x.device)
    hs, carry = _slstm_cell(params, x, arch,
                            (init["c"], init["n"], init["m"], init["h"]))
    y = groupnorm_heads(hs.to(x.dtype), params["norm"]).reshape(B, S, d)
    out = _slstm_ffn(params, y, mesh)
    if not return_state:
        return out
    return out, {"c": carry[0], "n": carry[1], "m": carry[2], "h": carry[3]}


def slstm_decode(params: dict, x1: torch.Tensor, cache: dict,
                 arch: ArchConfig, mesh=None) -> Tuple[torch.Tensor, dict]:
    """x1 (B, 1, D) -> (y (B, 1, D), cache), the cache written in place."""
    B, _, d = x1.shape
    h = arch.xlstm.num_heads
    wx = x1[:, 0, :] @ params["w_in"]
    carry = (cache["c"], cache["n"], cache["m"], cache["h"])
    carry, hid = slstm_cell_step(wx, params["r"], params["b"], carry, h)
    for key, new in zip(("c", "n", "m", "h"), carry):
        cache[key].copy_(new)
    y = groupnorm_heads(hid[:, None].to(x1.dtype),
                        params["norm"]).reshape(B, 1, d)
    return _slstm_ffn(params, y, mesh), cache
