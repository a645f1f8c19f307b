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

``moe_apply_tp`` is the layer under tensor parallelism: the rank's batch
chunk, its experts (or every expert's d_expert columns), and the global
batch's capacity, dispatch order and aux (the reference's GSPMD
semantics), or the reference's "ep" data shards; its combine runs in the
same fixed index order, then one ``psum`` over ``model``.
``moe_apply_ep``, the reference's expert-parallel dispatch of a batch that
every rank holds, is its "ep" form on that batch.
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


def route(router_w: torch.Tensor, x: torch.Tensor, cfg: MoEConfig,
          mesh=None, batch_axes: Tuple[str, ...] = ()
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing.  x (T, D) -> (expert_idx (T, k) int64, weight (T, k)
    in x's dtype, aux_loss f32).

    The reference computes ``x.astype(f32) @ router_w`` with a router the
    model has cast to the compute dtype; JAX promotes that mixed product to
    f32.  Both operands are upcast here, so the logits are the same f32
    product of the same values.

    With ``mesh`` and ``batch_axes`` (x is the rank's shard of the tokens
    over those axes) the aux loss is the global batch's: the per-expert
    counts and the sums of the probabilities ``psum``-ed over the axes and
    divided by the global counts (a mean of the ranks' auxes is not it: a
    product of means is not the mean of the products)."""
    logits = x.float() @ router_w.float()                     # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k's choice: a stable descending sort, so equal probabilities
    # go lowest expert first (torch.topk breaks ties in no set order)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    weight = top.values[:, :cfg.top_k]                         # (T, k)
    expert_idx = top.indices[:, :cfg.top_k]
    weight = weight / torch.clamp(weight.sum(-1, keepdim=True), min=1e-9)
    # Switch aux loss: E * sum_e fraction_e * mean_prob_e (whole counts in
    # f32: exact, in any order of addition)
    e = cfg.num_experts
    counts = torch.zeros((e,), dtype=torch.float32, device=x.device)
    counts.scatter_add_(0, expert_idx.reshape(-1),
                        torch.ones((expert_idx.numel(),), dtype=torch.float32,
                                   device=x.device))
    if mesh is None or not batch_axes:
        fraction = counts / (x.shape[0] * cfg.top_k)
        aux = e * torch.sum(fraction * probs.mean(dim=0))
        return expert_idx, weight.to(x.dtype), aux
    from repro_torch.parallel.collectives import chunk_index, psum
    prob_sum = probs.sum(dim=0)
    for a in batch_axes:
        if a in mesh.mesh_dim_names:
            counts = psum(counts, mesh, a)
            prob_sum = psum(prob_sum, mesh, a)
    tokens = x.shape[0] * chunk_index(mesh, batch_axes)[1]
    aux = e * torch.sum(counts / (tokens * cfg.top_k) * (prob_sum / tokens))
    return expert_idx, weight.to(x.dtype), aux


def _expert_counts(flat: torch.Tensor, num_experts: int) -> torch.Tensor:
    """(E,) int32: the assignments ``flat`` (A,) to each expert."""
    counts = torch.zeros((num_experts,), dtype=torch.int32,
                         device=flat.device)
    return counts.scatter_add_(0, flat, torch.ones(
        (flat.shape[0],), dtype=torch.int32, device=flat.device))


def rank_in_expert(flat: torch.Tensor, num_experts: int) -> torch.Tensor:
    """(A,) int32: each assignment's rank among the assignments ``flat``
    (A,) int64 to its expert, in index order (a stable sort by expert, then
    the position past the expert's start)."""
    a = flat.shape[0]
    order = torch.argsort(flat, stable=True)                  # grouped by expert
    counts = _expert_counts(flat, num_experts)
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    sorted_e = flat[order]
    rank_sorted = torch.arange(a, dtype=torch.int32,
                               device=flat.device) - starts[sorted_e]
    rank = torch.zeros((a,), dtype=torch.int32, device=flat.device)
    return rank.scatter_(0, order, rank_sorted)


def dispatch_indices(expert_idx: torch.Tensor, num_experts: int, cap: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bucket slot for each (token, k) assignment via sort-based ranking.

    Returns (slot (A,) int64, kept (A,) bool) where A = T*k and slot = e*cap
    + the assignment's rank within expert e, or num_experts*cap (the trash
    row) when that rank is cap or more (dropped)."""
    flat = expert_idx.reshape(-1).long()                      # (A,)
    rank = rank_in_expert(flat, num_experts)
    kept = rank < cap
    slot = torch.where(kept, flat * cap + rank.long(),
                       torch.full_like(flat, num_experts * cap))
    return slot, kept


def _experts(w: dict, tokens: torch.Tensor, weight: torch.Tensor,
             slot: torch.Tensor, kept: torch.Tensor, n: int, cap: int,
             dtype) -> torch.Tensor:
    """The bucketed experts of every form: ``tokens`` (T, D), each copied
    k times (token-major) into ``n`` x ``cap`` bucket rows at ``slot`` (the
    rest to the trash row past ``n * cap``, which the experts never read),
    the grouped SwiGLU FFN over the ``n`` experts of ``w`` (``w_gate``,
    ``w_up``, ``w_down``), then each token's k kept contributions weighted
    by ``weight`` (T, k) and added in index order in ``dtype``: (T, D)."""
    t, d = tokens.shape
    k = weight.shape[1]
    buckets = torch.zeros((n * cap + 1, d), dtype=dtype, device=tokens.device)
    buckets = buckets.index_copy(0, slot, tokens.repeat_interleave(k, dim=0))
    buckets = buckets[:n * cap].reshape(n, cap, d)
    # expert FFN: a grouped product over the expert dim
    h = F.silu(torch.bmm(buckets, w["w_gate"])) * \
        torch.bmm(buckets, w["w_up"])
    y_buckets = torch.bmm(h, w["w_down"])
    # gather back (the row past n * cap is zero) and combine with the
    # routing weights, each token's k contributions in index order
    y_flat = torch.cat([y_buckets.reshape(n * cap, d),
                        torch.zeros((1, d), dtype=y_buckets.dtype,
                                    device=tokens.device)])
    gathered = torch.where(kept[:, None], y_flat[slot],
                           torch.zeros((), dtype=y_flat.dtype,
                                       device=tokens.device))
    contrib = (gathered * weight.reshape(t * k, 1).to(gathered.dtype)
               ).to(dtype).reshape(t, k, d)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y


def moe_apply(params: dict, x: torch.Tensor, arch: ArchConfig,
              cap_multiple: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux_loss * aux_loss_weight)."""
    cfg = arch.moe
    B, S, D = x.shape
    t, e = B * S, cfg.num_experts
    xt = x.reshape(t, D)
    expert_idx, weight, aux = route(params["router"], xt, cfg)
    cap = capacity(t, cfg, cap_multiple)
    slot, kept = dispatch_indices(expert_idx, e, cap)
    y = _experts(params, xt, weight, slot, kept, e, cap, x.dtype)

    if cfg.shared_expert:
        y = y + gated_mlp(params["shared"], xt, Activation.SWIGLU)
    return y.reshape(B, S, D), aux * cfg.aux_loss_weight


def expert_sharding_strategy(cfg: MoEConfig, model_shards: int) -> str:
    """'ep': shard E over model (E % shards == 0); 'tp': shard d_expert."""
    if cfg.num_experts % model_shards == 0:
        return "ep"
    return "tp"


def moe_apply_ep(params: dict, x: torch.Tensor, arch: ArchConfig, mesh,
                 cap_multiple: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE on every rank of a (``data``, ``model``) mesh,
    the reference's ``moe_apply_ep``: ``x`` (B, S, D), the router and the
    shared expert are the same on every rank, ``w_gate``/``w_up``/
    ``w_down`` this rank's ``E / model`` experts (its ``model`` column's,
    as ``param_partition_specs`` shards them).  Routing runs on the whole
    batch; each rank dispatches its data shard's assignments to its
    experts, with capacity per data shard as in the reference; one
    ``psum`` over ``model`` and one ``all_gather`` over ``data`` give every
    rank the whole output.  It is ``moe_apply_tp`` under "ep" with the
    batch unsharded.  Needs E % model == 0 and (B*S) % data == 0
    (``ValueError`` otherwise; the reference's callers fall back to
    ``moe_apply``).  Returns (y (B, S, D), aux * aux_loss_weight), the same
    on every rank; gradients as ``parallel.collectives`` states them."""
    from repro_torch.launch.mesh import axis_sizes
    sizes = axis_sizes(mesh)
    n_model, n_data = sizes.get("model", 1), sizes.get("data", 1)
    t = x.shape[0] * x.shape[1]
    if arch.moe.num_experts % n_model or t % n_data:
        raise ValueError(f"expert parallelism needs E % model == 0 and "
                         f"tokens % data == 0: E={arch.moe.num_experts}, "
                         f"model={n_model}, tokens={t}, data={n_data}")
    return moe_apply_tp(params, x, arch, mesh, (), "ep", cap_multiple)


# ---------------------------------------------------------------------------
# Tensor parallelism: the rank's batch shard, its experts or expert columns
# ---------------------------------------------------------------------------
#
# Under tensor parallelism (``transformer.tp_mesh``) the residual stream is
# the rank's batch shard over ``batch_axes`` (the same on every rank of
# ``model``), and the layer's leaves are the rank's shards by the
# reference's specs (``expert_layout``).  The reference runs the layer under
# GSPMD, which keeps the unsharded semantics; so does ``moe_apply_tp``:
# capacity, dispatch order and aux are the global batch's ("auto"), or the
# reference's data shards' ("ep").

def expert_layout(arch: ArchConfig, model: int) -> dict:
    """How ``parallel.sharding``'s rule lays a moe layer out over ``model``
    ranks: ``experts`` "ep" (the expert dim over ``model``) or "tp" (E %
    model != 0: ``w_gate``/``w_up`` by columns and ``w_down`` by rows of
    d_expert); ``shared`` (kimi-k2's shared expert, else None) "layer"
    when ``model`` divides the layer count (the rule's 3-D test also takes
    the layer-stacked (L, d, f) leaves and shards their LAYER dim), else
    "tp" (column/row on d_expert)."""
    cfg = arch.moe
    shared = None
    if cfg.shared_expert:
        shared = "layer" if arch.num_layers % model == 0 else "tp"
    return {"experts": expert_sharding_strategy(cfg, model),
            "shared": shared}


def moe_apply_tp(params: dict, x: torch.Tensor, arch: ArchConfig, mesh,
                 batch_axes: Tuple[str, ...] = (), moe_impl: str = "auto",
                 cap_multiple: int = 128
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The moe layer on the rank's shards: x (B, S, D) is the rank's chunk
    of the global batch over ``batch_axes`` (``collectives.chunk_index``),
    the same on every rank of ``model``; ``params`` are the rank's leaves
    (``expert_layout``; a layer-sharded shared expert gathered before, by
    ``transformer.tp_view``).  Returns (y (B, S, D), aux *
    aux_loss_weight), y the same on every rank of ``model``.

    * "auto" (the reference's ``moe_apply`` over the whole batch):
      capacity from the global token count; an assignment's bucket slot
      is its rank among ALL assignments to its expert in global order, so
      the rank's own rank plus the counts of the earlier chunks (an
      ``all_gather`` of the per-expert counts, ``gather_chunks``).
    * "ep" where the reference takes it (E % model == 0 and the global
      tokens split over ``data``): capacity and ranks per reference data
      shard, each a run of whole chunks; a batch the same on every data
      rank is cut over ``data`` as ``moe_apply_ep`` cuts it.

    The rank computes its experts' buckets (or, "tp", every expert's on
    its d_expert columns), each token sums its k contributions in index
    order, then one ``psum`` over ``model``; the shared expert is added
    after it: column/row-parallel with its own ``psum`` when the rank holds
    its d_expert columns ("tp"), else whole (gathered from its layer
    shards, or ``moe_apply_ep``'s).  The aux
    is the global batch's (``route``).  The tokens and routing weights
    enter the expert computation through ``vary`` over ``model``."""
    from repro_torch.launch.mesh import axis_sizes
    from repro_torch.parallel.collectives import (all_gather, axis_index,
                                                  chunk_index, gather_chunks,
                                                  psum, shard, vary)
    cfg = arch.moe
    B, S, D = x.shape
    t, e = B * S, cfg.num_experts
    sizes = axis_sizes(mesh)
    n_model, n_data = sizes.get("model", 1), sizes.get("data", 1)
    ci, n = chunk_index(mesh, batch_axes)
    lay = expert_layout(arch, n_model)
    ep = (moe_impl == "ep" and e % n_model == 0 and (t * n) % n_data == 0)
    split = ep and n == 1 and n_data > 1    # the batch on every data rank
    if ep and not split and n % n_data:
        raise ValueError(f"{n} batch chunks do not make the {n_data} data "
                         f"shards of expert parallelism")

    xt = x.reshape(t, D)
    expert_idx, weight, aux = route(params["router"], xt, cfg, mesh,
                                    batch_axes)
    w = {name: params[name] for name in ("w_gate", "w_up", "w_down")}
    if split:
        tokens = shard(xt, mesh, "data")
        w_tok = shard(weight, mesh, "data")
        eidx = expert_idx.chunk(n_data)[axis_index(mesh, "data")]
        w = {name: vary(v, mesh, "data") for name, v in w.items()}
        cap = capacity(t // n_data, cfg, cap_multiple)
        per = 1
    else:
        tokens, w_tok, eidx = xt, weight, expert_idx
        per = n // n_data if ep else n       # chunks a dispatch group
        cap = capacity(t * per, cfg, cap_multiple)
    flat = eidx.reshape(-1).long()
    local_rank = rank_in_expert(flat, e)     # among the rank's own tokens
    rank = local_rank                        # among the group's, in order
    if per > 1:                              # every rank of the group calls
        table = gather_chunks(_expert_counts(flat, e), mesh, batch_axes)
        first = ci - ci % per
        rank = rank + table[first:ci].sum(0, dtype=torch.int32)[flat]
    if lay["experts"] == "ep":
        e_local = e // n_model
        lo = axis_index(mesh, "model") * e_local
    else:
        e_local, lo = e, 0
    rel = flat - lo
    kept = (rank < cap) & (rel >= 0) & (rel < e_local)
    slot = torch.where(kept, rel * cap + local_rank.long(),
                       torch.full_like(flat, e_local * cap))

    y = _experts(w, vary(tokens, mesh, "model"), vary(w_tok, mesh, "model"),
                 slot, kept, e_local, cap, x.dtype)
    y = psum(y, mesh, "model")
    if split:
        y = all_gather(y, mesh, "data").reshape(t, D)

    if cfg.shared_expert:          # by d_expert columns, or whole
        cut = params["shared"]["w_down"].shape[0] < cfg.d_expert
        y = y + gated_mlp(params["shared"], xt, Activation.SWIGLU,
                          mesh if cut else None)
    return y.reshape(B, S, D), aux * cfg.aux_loss_weight
