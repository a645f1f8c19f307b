"""Mixture-of-Experts layer: top-k routing with sort-based dispatch; the
counterpart of ``repro.models.moe``.

Dispatch never materialises a (tokens x experts) tensor: assignments are
sorted by expert id (a stable sort), ranked within their expert from
per-expert offsets, and copied into a fixed-capacity (E, C, D) bucket
tensor; an assignment ranked past the capacity is dropped (Switch/GShard).
The expert FFN is a grouped product over the expert dim (``torch.bmm`` on
the compute dtype, as the reference leaves its einsum to XLA: the layer has
no Pallas kernel).  The router runs in float32, and an auxiliary
load-balancing loss (Switch's fraction x probability product) is returned
for the training objective.

Two differences of form, none of value:

* The reference scatters with ``mode="drop"`` and gathers with
  ``mode="fill"``.  Here the bucket tensor has one trash row past E·C,
  where dropped assignments land and which the experts never read, and the
  gather reads a zero row at index E·C.
* The combine ``y.at[token_of].add(contrib)`` becomes a sum over each
  token's k contributions, which ``token_of = repeat(arange(T), k)`` lays
  side by side, added in index order in the activation dtype as the
  scatter adds them.  ``index_add_`` on CUDA floats adds in no fixed order,
  and a decode step replayed from a captured graph must equal the eager
  step bit for bit.

Nothing here reads a tensor's value on the host (no ``bincount``,
``nonzero``, boolean-mask indexing or ``.item()``): the per-expert counts
are a fixed-size ``scatter_add_``, and ``capacity`` is a Python int from
static shapes, so a decode step can be captured.

``moe_apply_ep`` is the expert-parallel dispatch over a (``data``,
``model``) mesh, one rank a (data shard, expert column); its combine runs in
the same fixed index order, then one ``psum`` over ``model``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import Activation, ArchConfig, MoEConfig
from repro_torch.models.layers import dense_init, gated_mlp, mlp_init


def moe_init(gen: torch.Generator, arch: ArchConfig,
             dtype=torch.float32) -> dict:
    """The router (d, E) in float32 whatever ``dtype`` is, and the experts'
    stacked (E, d, f) gate and up and (E, f, d) down weights; kimi-k2's
    shared expert is one SwiGLU MLP."""
    cfg = arch.moe
    d, f, e = arch.d_model, cfg.d_expert, cfg.num_experts
    p = {
        "router": dense_init(gen, (d, e), scale=d ** -0.5,
                             dtype=torch.float32),
        "w_gate": dense_init(gen, (e, d, f), dtype=dtype),
        "w_up": dense_init(gen, (e, d, f), dtype=dtype),
        "w_down": dense_init(gen, (e, f, d), dtype=dtype),
    }
    if cfg.shared_expert:
        p["shared"] = mlp_init(gen, d, f, Activation.SWIGLU, dtype=dtype)
    return p


def capacity(tokens: int, cfg: MoEConfig, multiple: int = 128) -> int:
    """Static per-expert bucket capacity, padded to ``multiple`` (128 for
    sequence mode; decode uses 8, which wastes fewer rows at a tiny
    per-expert batch)."""
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(multiple, ((c + multiple - 1) // multiple) * multiple)


def route(router_w: torch.Tensor, x: torch.Tensor, cfg: MoEConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing.  x (T, D) -> (expert_idx (T, k) int64, weight (T, k)
    in x's dtype, aux_loss f32).

    The reference computes ``x.astype(f32) @ router_w`` with a router the
    model has cast to the compute dtype; JAX promotes that mixed product to
    f32.  Both operands are upcast here, so the logits are the same f32
    product of the same values."""
    logits = x.float() @ router_w.float()                     # (T, E)
    probs = torch.softmax(logits, dim=-1)
    weight, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)  # (T, k)
    weight = weight / torch.clamp(weight.sum(-1, keepdim=True), min=1e-9)
    # Switch aux loss: E * sum_e fraction_e * mean_prob_e (whole counts in
    # f32: exact, in any order of addition)
    e = cfg.num_experts
    counts = torch.zeros((e,), dtype=torch.float32, device=x.device)
    counts.scatter_add_(0, expert_idx.reshape(-1),
                        torch.ones((expert_idx.numel(),), dtype=torch.float32,
                                   device=x.device))
    fraction = counts / (x.shape[0] * cfg.top_k)
    aux = e * torch.sum(fraction * probs.mean(dim=0))
    return expert_idx, weight.to(x.dtype), aux


def dispatch_indices(expert_idx: torch.Tensor, num_experts: int, cap: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bucket slot for each (token, k) assignment via sort-based ranking.

    Returns (slot (A,) int64, kept (A,) bool) where A = T*k and slot = e*cap
    + the assignment's rank within expert e, or num_experts*cap (the trash
    row) when that rank is cap or more (dropped)."""
    flat = expert_idx.reshape(-1).long()                      # (A,)
    a = flat.shape[0]
    order = torch.argsort(flat, stable=True)                  # grouped by expert
    counts = torch.zeros((num_experts,), dtype=torch.int32,
                         device=flat.device)
    counts.scatter_add_(0, flat, torch.ones((a,), dtype=torch.int32,
                                            device=flat.device))
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    sorted_e = flat[order]
    rank_sorted = torch.arange(a, dtype=torch.int32,
                               device=flat.device) - starts[sorted_e]
    rank = torch.zeros((a,), dtype=torch.int32, device=flat.device)
    rank.scatter_(0, order, rank_sorted)
    kept = rank < cap
    slot = torch.where(kept, flat * cap + rank.long(),
                       torch.full_like(flat, num_experts * cap))
    return slot, kept


def moe_apply(params: dict, x: torch.Tensor, arch: ArchConfig,
              cap_multiple: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux_loss * aux_loss_weight)."""
    cfg = arch.moe
    B, S, D = x.shape
    t, k, e = B * S, cfg.top_k, cfg.num_experts
    xt = x.reshape(t, D)
    expert_idx, weight, aux = route(params["router"], xt, cfg)
    cap = capacity(t, cfg, cap_multiple)
    slot, kept = dispatch_indices(expert_idx, e, cap)

    # copy tokens (each k times, token-major) into the buckets; the dropped
    # land in the trash row past e * cap
    buckets = torch.zeros((e * cap + 1, D), dtype=x.dtype, device=x.device)
    buckets.index_copy_(0, slot, xt.repeat_interleave(k, dim=0))
    buckets = buckets[:e * cap].reshape(e, cap, D)

    # expert FFN: a grouped product over the expert dim
    h = F.silu(torch.bmm(buckets, params["w_gate"])) * \
        torch.bmm(buckets, params["w_up"])
    y_buckets = torch.bmm(h, params["w_down"])

    # gather back (the row past e * cap is zero) and combine with the
    # routing weights, each token's k contributions in index order
    y_flat = torch.cat([y_buckets.reshape(e * cap, D),
                        torch.zeros((1, D), dtype=y_buckets.dtype,
                                    device=x.device)])
    gathered = torch.where(kept[:, None], y_flat[slot],
                           torch.zeros((), dtype=y_flat.dtype,
                                       device=x.device))
    contrib = (gathered * weight.reshape(t * k, 1).to(gathered.dtype)
               ).to(x.dtype).reshape(t, k, D)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]

    if cfg.shared_expert:
        y = y + gated_mlp(params["shared"], xt, Activation.SWIGLU)
    return y.reshape(B, S, D), aux * cfg.aux_loss_weight


def expert_sharding_strategy(cfg: MoEConfig, model_shards: int) -> str:
    """'ep': shard E over model (E % shards == 0); 'tp': shard d_expert."""
    if cfg.num_experts % model_shards == 0:
        return "ep"
    return "tp"


# ---------------------------------------------------------------------------
# Explicit expert-parallel dispatch over a mesh
# ---------------------------------------------------------------------------
#
# Routing is computed globally (every rank alike), then each rank, at
# (data d, model c), takes its data shard's tokens and keeps ONLY the
# assignments that hit its model column's experts; the columns combine with
# one psum over ``model`` and the data shards with one all_gather over
# ``data`` (the reference's out_spec P("data", None) assembles the same
# array), so every rank ends with the whole output.

def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard, or the tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


def ep_dispatch(expert_idx_l: torch.Tensor, lo: int, e_local: int, cap: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot, kept) of one rank's assignments (T_l, k) for its experts
    ``lo .. lo + e_local - 1``: a foreign expert's assignment goes to a
    trash bucket ``e_local`` (ranked there, never kept), and every
    assignment not kept to the trash row ``e_local * cap``."""
    rel = expert_idx_l.long() - lo
    valid = (rel >= 0) & (rel < e_local)
    eff = torch.where(valid, rel, torch.full_like(rel, e_local))
    slot, kept = dispatch_indices(eff, e_local + 1, cap)
    kept = kept & valid.reshape(-1)
    slot = torch.where(kept, slot, torch.full_like(slot, e_local * cap))
    return slot, kept


def moe_apply_ep(params: dict, x: torch.Tensor, arch: ArchConfig, mesh,
                 cap_multiple: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE on every rank of a (``data``, ``model``) mesh.
    ``x`` (B, S, D) and the router and shared expert are the same on every
    rank; ``w_gate``/``w_up``/``w_down`` are this rank's ``E / model``
    experts (its ``model`` column's, as ``param_partition_specs`` shards
    them), plain tensors or DTensors.  Needs E % model == 0 and (B*S) %
    data == 0 (``ValueError`` otherwise; ``transformer._moe_block_seq``
    falls back to ``moe_apply``).  Capacity is per data shard, as in the
    reference.  Returns (y (B, S, D), aux * aux_loss_weight), the same on
    every rank; gradients as ``parallel.collectives`` states them."""
    from repro_torch.launch.mesh import axis_sizes
    from repro_torch.parallel.collectives import (all_gather, axis_index,
                                                  psum, shard, vary)
    cfg = arch.moe
    B, S, D = x.shape
    sizes = axis_sizes(mesh)
    n_model, n_data = sizes.get("model", 1), sizes.get("data", 1)
    t, k = B * S, cfg.top_k
    if cfg.num_experts % n_model or t % n_data:
        raise ValueError(f"expert parallelism needs E % model == 0 and "
                         f"tokens % data == 0: E={cfg.num_experts}, "
                         f"model={n_model}, tokens={t}, data={n_data}")
    e_local = cfg.num_experts // n_model
    t_local = t // n_data
    cap = capacity(t_local, cfg, cap_multiple)

    xt = x.reshape(t, D)
    expert_idx, weight, aux = route(params["router"], xt, cfg)
    wg, wu, wd = (vary(_local(params[n]), mesh, "data")
                  for n in ("w_gate", "w_up", "w_down"))
    if wg.shape[0] != e_local:
        raise ValueError(f"{tuple(wg.shape)[0]} experts on a rank; "
                         f"E / model is {e_local}")
    xt_l = vary(shard(xt, mesh, "data"), mesh, "model")
    w_l = vary(shard(weight, mesh, "data"), mesh, "model")
    eidx_l = expert_idx.chunk(n_data)[axis_index(mesh, "data")]

    slot, kept = ep_dispatch(eidx_l, axis_index(mesh, "model") * e_local,
                             e_local, cap)
    buckets = torch.zeros((e_local * cap + 1, D), dtype=x.dtype,
                          device=x.device)
    buckets = buckets.index_copy(0, slot, xt_l.repeat_interleave(k, dim=0))
    buckets = buckets[:e_local * cap].reshape(e_local, cap, D)
    h = F.silu(torch.bmm(buckets, wg)) * torch.bmm(buckets, wu)
    y_buckets = torch.bmm(h, wd)
    y_flat = torch.cat([y_buckets.reshape(e_local * cap, D),
                        torch.zeros((1, D), dtype=y_buckets.dtype,
                                    device=x.device)])
    gathered = torch.where(kept[:, None], y_flat[slot],
                           torch.zeros((), dtype=y_flat.dtype,
                                       device=x.device))
    contrib = (gathered * w_l.reshape(t_local * k, 1).to(gathered.dtype)
               ).to(x.dtype).reshape(t_local, k, D)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    y = psum(y, mesh, "model")
    y = all_gather(y, mesh, "data").reshape(t, D)

    if cfg.shared_expert:
        y = y + gated_mlp(params["shared"], xt, Activation.SWIGLU)
    return y.reshape(B, S, D), aux * cfg.aux_loss_weight
