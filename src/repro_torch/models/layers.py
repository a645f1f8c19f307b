"""Shared neural-net building blocks (plain torch, dict params): the
counterpart of ``repro.models.layers``.

The f32 upcasts sit where the reference has them: the norms and RoPE
compute in float32 and cast back to the input's dtype, and the loss is
float32 throughout.

With ``mesh`` (tensor parallelism over its ``model`` axis) ``rmsnorm``
normalises a row whose columns are cut over ``model``, and the MLPs are
Megatron's: ``w_gate``/``w_up`` hold the rank's columns and ``w_down`` its
rows; the input enters through ``vary`` (its cotangent summed over
``model``) and the output leaves through one ``psum`` over ``model``, the
row-parallel bias added after it.  ``cross_entropy_loss`` then reads
vocab-sharded logits and takes the masked mean over the global batch.

A ``SeqSharded`` mesh (the prefill's ``seq_shard``) is Megatron's sequence
parallelism: the residual stream between layers is the rank's slice of the
sequence, a layer takes its input whole (``seq_gather`` after the norm)
and ``tp_out`` reduce-scatters its row-parallel output back to the slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import Activation


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
            mesh=None) -> torch.Tensor:
    """With ``mesh``: ``x`` and ``scale`` are this rank's columns of a row
    cut over ``model`` (a gated norm over a sharded d_inner), and the mean
    square is the whole row's: the ranks' sums of squares are summed over
    ``model``.  The sum then scales this rank's own columns, so its
    cotangent is summed over ``model`` too (``vary``)."""
    dtype = x.dtype
    x = x.float()
    if mesh is None:
        var = torch.mean(x * x, dim=-1, keepdim=True)
    else:
        from repro_torch.parallel.collectives import axis_size, psum, vary
        ss = psum(torch.sum(x * x, dim=-1, keepdim=True), mesh, "model")
        var = vary(ss, mesh, "model") / (x.shape[-1] *
                                         axis_size(mesh, "model"))
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim with the population variance
    (``jnp.var``); no model of the zoo calls it, as in the reference."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(dtype)


def groupnorm_heads(x: torch.Tensor, scale: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """Per-head groupnorm over the feature dim.  x: (..., H, Dh).  The
    population variance (``jnp.var``), where ``torch.var`` defaults to the
    unbiased one; the scale multiplies (no ``1 +`` as in rmsnorm)."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # filled on the device (no copy from the host: decode is captured)
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) int.  Split-halves layout."""
    if theta <= 0:
        return x
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)          # (Dh/2,)
    angles = positions[..., None].float() * freqs           # (B, S, Dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(max_len: int, dim: int, device=None) -> torch.Tensor:
    """Whisper-style absolute sinusoidal embeddings (max_len, dim), f32,
    made on ``device`` (nothing is copied from the host, so a captured
    decode step may make them)."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    idx = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    log10k = torch.log(torch.full((), 10000.0, dtype=torch.float32,
                                  device=device))
    inv = torch.exp(-log10k * idx / max(dim // 2 - 1, 1))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _act(x: torch.Tensor, kind: Activation) -> torch.Tensor:
    if kind == Activation.SWIGLU or kind == Activation.GEGLU:
        raise ValueError("gated activations handled in gated_mlp")
    if kind == Activation.GELU:
        return _gelu(x)
    return F.relu(x)


class SeqSharded:
    """A mesh whose ``model`` axis also cuts the residual stream's
    sequence (dim 1) between layers: every attribute is the mesh's, and
    ``seq_gather``, ``seq_part`` and ``tp_out`` read the cut."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __getattr__(self, name):
        return getattr(self.mesh, name)


def seq_sharded(mesh) -> bool:
    return isinstance(mesh, SeqSharded)


def unsharded(mesh):
    """The mesh itself of a ``SeqSharded`` one (None stays None)."""
    return mesh.mesh if seq_sharded(mesh) else mesh


def seq_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """A layer's input (B, S, ...) whole: under ``SeqSharded`` the ranks'
    slices gathered over ``model`` (its cotangent, the same on every rank,
    sliced back); else ``x``."""
    if not seq_sharded(mesh):
        return x
    from repro_torch.parallel.collectives import all_gather_dim
    return all_gather_dim(x, mesh, "model", 1)


def seq_part(x: torch.Tensor, mesh) -> torch.Tensor:
    """Under ``SeqSharded``, this rank's slice of a (B, S, ...) value the
    same on every rank (no collective); else ``x``."""
    if not seq_sharded(mesh):
        return x
    from repro_torch.parallel.collectives import shard
    return shard(x, mesh, "model", 1)


def tp_in(x: torch.Tensor, mesh) -> torch.Tensor:
    """A column-parallel layer's input, the same on every rank of
    ``model``: its cotangent is summed over ``model``."""
    if mesh is None:
        return x
    from repro_torch.parallel.collectives import vary
    return vary(x, mesh, "model")


def tp_out(y: torch.Tensor, mesh) -> torch.Tensor:
    """A row-parallel layer's partial output summed over ``model``; under
    ``SeqSharded`` reduce-scattered to the rank's slice of the sequence."""
    if mesh is None:
        return y
    from repro_torch.parallel.collectives import psum, psum_scatter
    if seq_sharded(mesh):
        return psum_scatter(y, mesh, "model", 1)
    return psum(y, mesh, "model")


def gated_mlp(params: dict, x: torch.Tensor, kind: Activation,
              mesh=None) -> torch.Tensor:
    """SwiGLU / GeGLU: down( act(x@gate) * (x@up) )."""
    x = tp_in(x, mesh)
    gate = x @ params["w_gate"]
    up = x @ params["w_up"]
    if kind == Activation.GEGLU:
        h = _gelu(gate) * up
    else:
        h = F.silu(gate) * up
    return tp_out(h @ params["w_down"], mesh)


def plain_mlp(params: dict, x: torch.Tensor, kind: Activation,
              mesh=None) -> torch.Tensor:
    """up, bias, activation, down, bias; with ``mesh`` the ``b_up`` handed
    in is the rank's columns' (``transformer``'s tensor-parallel view)."""
    h = tp_in(x, mesh) @ params["w_up"]
    if "b_up" in params:
        h = h + params["b_up"].to(h.dtype)
    h = _act(h, kind)
    out = tp_out(h @ params["w_down"], mesh)
    if "b_down" in params:
        out = out + params["b_down"].to(out.dtype)
    return out


def mlp_apply(params: dict, x: torch.Tensor, kind: Activation,
              mesh=None) -> torch.Tensor:
    if kind in (Activation.SWIGLU, Activation.GEGLU):
        return gated_mlp(params, x, kind, mesh)
    return plain_mlp(params, x, kind, mesh)


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
               dtype=torch.float32) -> torch.Tensor:
    """Normal(0, 1) * scale (default fan_in**-0.5), drawn in f32 from
    ``gen`` on the generator's device (on the meta device, which has no
    generator, ``gen`` only names the device: shapes, no numbers)."""
    if gen.device.type == "meta":   # shapes only (a meta draw would load
        return torch.empty(tuple(shape), dtype=dtype, device="meta")  # dynamo)
    fan_in = shape[0] if len(shape) >= 2 else 1
    s = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * s).to(dtype)


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, kind: Activation,
             dtype=torch.float32, bias: bool = False) -> dict:
    if kind in (Activation.SWIGLU, Activation.GEGLU):
        return {
            "w_gate": dense_init(gen, (d_model, d_ff), dtype=dtype),
            "w_up": dense_init(gen, (d_model, d_ff), dtype=dtype),
            "w_down": dense_init(gen, (d_ff, d_model), dtype=dtype),
        }
    p = {
        "w_up": dense_init(gen, (d_model, d_ff), dtype=dtype),
        "w_down": dense_init(gen, (d_ff, d_model), dtype=dtype),
    }
    if bias:
        p["b_up"] = torch.zeros((d_ff,), dtype=dtype, device=gen.device)
        p["b_down"] = torch.zeros((d_model,), dtype=dtype, device=gen.device)
    return p



# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None, mesh=None,
                       vocab_axis: Optional[str] = None,
                       batch_axes: Tuple[str, ...] = ()) -> torch.Tensor:
    """Mean token cross-entropy in f32: logsumexp minus the gold logit.
    logits (B, S, V) f32/bf16; labels (B, S) int; with ``mask`` (B, S) the
    masked mean, its denominator clamped at 1.

    On a ``mesh``: ``vocab_axis`` names the axis the logits' vocabulary is
    sharded on (this rank holds ids ``[lo, lo + V_local)``): the row max
    is the ``pmax`` of the ranks' (held constant, as logsumexp's shift
    is), the normaliser the ``psum`` of their sums of exps, and the gold
    logit comes from the rank that owns the label, added with ``psum``.
    ``batch_axes`` name the axes the batch is sharded on: the mean is over
    the GLOBAL batch, ``psum(sum nll * mask) / max(psum(sum mask), 1)``,
    not the mean of the ranks' means."""
    logits = logits.float()
    if vocab_axis is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    else:
        from repro_torch.parallel.collectives import axis_index, pmax, psum
        v_local = logits.shape[-1]
        m = pmax(logits.detach().amax(dim=-1), mesh, vocab_axis)
        sumexp = psum(torch.exp(logits - m[..., None]).sum(dim=-1), mesh,
                      vocab_axis)
        logz = m + torch.log(sumexp)
        at = labels.long() - axis_index(mesh, vocab_axis) * v_local
        mine = (at >= 0) & (at < v_local)
        got = torch.gather(logits, -1, torch.clamp(at, 0, v_local - 1)[
            ..., None])[..., 0]
        gold = psum(torch.where(mine, got, torch.zeros_like(got)), mesh,
                    vocab_axis)
    nll = logz - gold
    if mesh is None or not batch_axes:
        if mask is None:
            return nll.mean()
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    from repro_torch.parallel.collectives import psum
    if mask is None:
        num = nll.sum()
        den = torch.full((), float(nll.numel()), device=nll.device)
    else:
        mask = mask.float()
        num, den = (nll * mask).sum(), mask.sum()
    for a in batch_axes:
        num, den = psum(num, mesh, a), psum(den, mesh, a)
    return num / torch.clamp(den, min=1.0)
