"""Serving: sessions are Enoki keygroups; the counterpart of
``repro.launch.serve`` on one device.

A decode session's state is a keygroup whose home is the pod serving it:
a KV cache (dense, vlm and moe), recurrent states (xlstm: per-layer mLSTM
matrix memories and sLSTM cells), both (zamba2), or whisper's decoder cache
beside the encoder output's K/V.  The decode hot path touches only
pod-local state, the paper's core property.  Four steps, each made by a
``make_*`` factory:

  prefill                   builds a session batch from prompts (last-position
                            logits + the layer-stacked session state)
  decode                    one greedy token for every session of every pod
  replicate_sessions        anti-entropy: ring-copy session state to the next
                            pod (pod i backs up pod i-1) into a backup copy;
                            a pod failure loses <= R tokens of session state
                            (R = ``EnokiConfig.replication_period``)
  migrate_sessions          failover: adopt the backup copy as live state for
                            the pods flagged dead

There is no mesh and no sharding: multi-pod state is pod-stacked on a
leading dimension of ``n_pods`` logical pods, as
``examples/serve_sessions.py`` runs the reference on one device.  The pods
share ONE copy of the weights (the reference stacks identical copies only
because each pod is another set of chips).  Decode loops over the pods,
each with its own ``length``, and writes every pod's cache IN PLACE (the
counterpart of the reference step's donated cache).  The whole pod-step is
one ``core.graphs.StepCache`` entry, the counterpart of the reference's
``jax.jit(jax.vmap(step))``: on CUDA one captured graph per (weights,
cache geometry and addresses, token shape), replayed by every step; a
cache that ``migrate_sessions`` replaces is a new entry.

Each factory takes ``device=None``, which means the CUDA card (it raises
without one); a step refuses tensors that are not on that device.  The
reference's sharding, parallelism, donation and ``EnokiConfig`` arguments
have no counterpart here: the replication period is the caller's loop
(every R decode steps).

The steps record where they spend their time in ``core.spans`` (off
unless a profiler runs or ``spans.recording()`` is open): prefill in
``serve.prefill`` (the model's sub-layers in spans of their own, the last
position's copy in ``model.head``), a replication in ``serve.replicate``
with the ``bytes`` it reads and writes.

With ``mesh=`` (a ``torch.distributed`` mesh), a ``pod`` axis puts one pod
on each rank: the rank's cache and tokens are its pod's, with no pod dim;
decode touches only them, ``replicate_sessions`` is a ``ppermute`` ring
over ``pod`` (pod i's backup holds pod i - 1's sessions, the reference's
``roll``) and ``migrate_sessions`` a local ``where`` on each rank.
``flash_decode=True`` on a mesh with no ``pod`` axis reads a cache sharded
on the sequence over ``model`` (``attention.decode_self_attention_sharded``);
its collectives cannot be captured, so that step runs eagerly.

On a mesh whose ``data`` or ``model`` axis is larger than 1 the steps of
every family are tensor-parallel: every rank holds its shards of the
weights (``parallel.sharding.local`` of ``param_partition_specs``), its
batch shard over ``data`` and its sessions' cache cut over ``model``
(``session_cache_specs``: KV heads, and zamba2's and xlstm's recurrent
states by heads or d_inner columns, where the reference's
``cache_partition_specs`` picks a dim by size; gathered, the two are the
same tensor).  Where ``model`` exceeds the KV heads, the rank's cache
holds its group's one KV head whole (``rep`` ranks hold each head alike:
``sharding.Grouped``), and each factory's step gathers its group's
``wk``/``wv`` columns once for the weights it is handed (``kv_prepare``:
kept for later calls with those same tensors), so a decode step adds no
collective for them.  Prefill runs each rank's
heads through flash under FLASH and returns the last logits gathered to
every rank; with ``ParallelConfig(seq_shard=True)`` its tokens are the
rank's slice of the sequence too (``forward_seq(seq_shard=True)``), with
the same logits and cache.  Decode's greedy token is the argmax over the
vocabulary shards, ties to the lowest global index as ``jnp.argmax``
breaks them (``greedy_sharded``), or the plain argmax where ``model``
does not divide the vocabulary (whisper's 51,865: every rank holds the
whole logits); its collectives not being capturable, it runs eagerly.
A moe model routes the global batch's tokens (capacity and dispatch
order over every data rank's sessions: ``moe.moe_apply_tp``):
its prefill in the form of ``moe_impl`` ("ep": the reference's data
shards; its ``serve.py`` hands the mesh to the model under "ep" only), its
decode in the global form, as the reference's decode.  With a ``pod`` axis
too, each pod is a group of ranks, and the session ring runs over ``pod``
shard by shard.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import (ArchConfig, AttnImpl, ParallelConfig,
                                      ShapeConfig)
from repro_torch.core import spans
from repro_torch.core.graphs import StepCache
from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.device import check_on, resolve_device
from repro_torch.models import model_zoo as zoo

#: a (nested) dict of tensors: dense and moe ``k``/``v``, whisper's
#: ``self_k``/``self_v``/``cross_k``/``cross_v``, xlstm's ``mlstm`` and
#: ``slstm`` recurrent states, or zamba2's ``mamba``, ``tail`` and
#: shared-block ring; ``length`` always
Cache = dict


def serve_param_dtype(arch: ArchConfig):
    return torch.bfloat16      # serving always runs bf16 weights


def params_shape_tree(arch: ArchConfig) -> dict:
    """The serving parameter tree on the ``meta`` device: shapes and
    dtypes, no storage (the reference's ``jax.eval_shape`` of its init)."""
    return zoo.init_params(arch, seed=0, dtype=serve_param_dtype(arch),
                           device="meta")


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def session_cache_specs(arch: ArchConfig, mesh, batch: int) -> dict:
    """The tensor-parallel steps' layout of a cache of ``batch`` sessions
    (``init_cache``'s tree): every leaf by sessions over ``data`` (when it
    divides ``batch``); ``length`` replicated.  Over ``model``: the dense,
    vlm and moe ``k``/``v`` (L, B, S, KV, Dh) by KV heads; zamba2's
    Mamba-2 ``conv_x`` by d_inner and ``state`` (..., B, H, P, N) by SSM
    heads, ``conv_B``/``conv_C`` whole, the shared block's ``shared_k``/
    ``shared_v`` by KV heads and ``shared_pos`` whole; xlstm's mLSTM
    ``conv`` by d_inner and ``C``/``n``/``m`` by heads, its sLSTM ``c``,
    ``n``, ``m`` and ``h`` whole.  The reference's
    ``cache_partition_specs`` picks a dim by size; gathered, the two are
    the same tensor.  whisper's ``self_k``/``self_v`` (L, B, S, KV, Dh)
    and ``cross_k``/``cross_v`` (L, B, F, KV, Dh) by KV heads too.  Where
    ``model`` exceeds the KV heads every KV dim is ``Grouped``: a rank
    holds its group's head (``transformer.kv_split``)."""
    from repro_torch.launch.mesh import axis_sizes
    from repro_torch.models.transformer import kv_split, plan
    from repro_torch.parallel.sharding import Grouped, P
    sizes = axis_sizes(mesh)
    data = sizes.get("data", 1)
    b = "data" if data > 1 and batch % data == 0 else None
    m = "model" if sizes.get("model", 1) > 1 else None
    heads = m
    if m and kv_split(arch, sizes["model"])[1] > 1:
        heads = Grouped(m, arch.num_kv_heads)
    p = plan(arch)
    if p["kind"] == "zamba":
        def mamba(*lead):
            return {"conv_x": P(*lead, b, None, m),
                    "conv_B": P(*lead, b, None, None),
                    "conv_C": P(*lead, b, None, None),
                    "state": P(*lead, b, m, None, None)}
        kv = P(None, b, None, heads, None)
        out = {"mamba": mamba(None, None), "shared_k": kv, "shared_v": kv,
               "shared_pos": P(None, b, None), "length": P()}
        if p["tail"]:
            out["tail"] = mamba(None)
        return out
    if p["kind"] == "xlstm":
        return {"mlstm": {"conv": P(None, None, b, None, m),
                          "C": P(None, None, b, m, None, None),
                          "n": P(None, None, b, m, None),
                          "m": P(None, None, b, m)},
                "slstm": {"c": P(None, b, None, None),
                          "n": P(None, b, None, None),
                          "m": P(None, b, None),
                          "h": P(None, b, None, None)},
                "length": P()}
    kv = P(None, b, None, heads, None)
    if p["kind"] == "whisper":
        return {"self_k": kv, "self_v": kv, "cross_k": kv, "cross_v": kv,
                "length": P()}
    return {"k": kv, "v": kv, "length": P()}


def kv_prepare(arch: ArchConfig, mesh) -> Callable[[dict], dict]:
    """``prepare(params) -> params'``: where ``model`` exceeds the KV
    heads, ``params`` with every attention's ``wk``/``wv`` gathered to the
    rank's KV head (``transformer.kv_view``, without autograd), once for
    the tensors it is handed: a later call with the same leaves, unchanged
    since, reuses the gathered ones (kept beside weak references to their
    sources, so a step keeps no weights alive).  Elsewhere the identity.
    Every rank of ``model`` calls it alike (the first call gathers)."""
    import weakref
    from repro_torch.launch.mesh import axis_sizes
    from repro_torch.models.transformer import (KV_WEIGHTS, kv_split,
                                                kv_view, map_attention,
                                                tp_mesh)
    held: dict = {}

    def weights(params) -> list:
        out: list = []

        def note(ap):
            out.extend(ap[k] for k in KV_WEIGHTS)
            return ap
        map_attention(note, params)
        return out

    def prepare(params: dict) -> dict:
        tp = tp_mesh(arch, mesh)
        if tp is None or kv_split(arch, axis_sizes(tp)["model"])[1] == 1:
            return params
        now = [(w, w._version) for w in weights(params)]
        if not (held and all(ref() is w and was == v for (ref, was), (w, v)
                             in zip(held["sources"], now))):
            with torch.no_grad():
                held["heads"] = weights(kv_view(params, tp, arch))
            held["sources"] = [(weakref.ref(w), v) for w, v in now]
        heads = iter(held["heads"])
        return map_attention(lambda ap: {k: next(heads) if k in KV_WEIGHTS
                                         else v for k, v in ap.items()},
                             params)
    return prepare


def make_prefill_step(arch: ArchConfig, shape: ShapeConfig,
                      impl: AttnImpl = AttnImpl.REFERENCE, device=None,
                      compute_dtype=torch.bfloat16, mesh=None,
                      moe_impl: Optional[str] = None,
                      parallel: Optional[ParallelConfig] = None
                      ) -> Callable[[dict, dict], tuple]:
    """``prefill(params, batch) -> (logits (B, 1, V), cache)`` for one pod:
    ``batch["tokens"]`` is (B, shape.seq_len), and the batch goes to
    ``forward_seq`` as its ``extra`` (the vlm's ``patch_embeds``,
    whisper's ``frame_embeds``: ``model_zoo.example_batch`` makes them);
    the cache is ``forward_seq``'s, with ``length`` = ``shape.seq_len``.

    With ``mesh`` (``data`` x ``model``): this rank's parameter shards and
    its batch shard over ``data`` (``sharding.batch_specs``: the vlm's
    ``patch_embeds`` and whisper's ``frame_embeds`` too); the logits come
    back whole on every rank (the reference's ``out_shardings=None``), the
    cache as the rank's (``session_cache_specs``).  ``parallel`` (the
    reference's argument) gives ``seq_shard``: the tokens are then the
    rank's (B / data, S / model) block, as ``batch_specs`` lays them, and
    ``model`` must divide S (``ValueError``); logits and cache are those
    without it.  ``moe_impl`` is the moe layers' form (None:
    ``parallel.moe_impl``, "auto" without ``parallel``)."""
    dev = resolve_device(device)
    parallel = parallel or ParallelConfig()
    moe_impl = moe_impl or parallel.moe_impl
    seq_shard = False
    if mesh is not None:
        from repro_torch.launch.mesh import axis_sizes
        from repro_torch.models.transformer import vocab_split
        from repro_torch.parallel.sharding import P, batch_specs, unlocal
        zoo.check_mesh(arch, mesh)
        if "pod" in mesh.mesh_dim_names:
            raise ValueError("make_prefill_step takes a (data, model) mesh")
        model = axis_sizes(mesh).get("model", 1)
        seq_shard = parallel.seq_shard and "model" in mesh.mesh_dim_names
        if seq_shard and shape.seq_len % model:
            raise ValueError(f"seq_shard: model = {model} does not divide "
                             f"the prompt's {shape.seq_len} positions")
        bdim = batch_specs(arch, shape, mesh, parallel)["tokens"][0]
        vocab = "model" if vocab_split(arch, mesh) else None
        logits_spec = P(bdim, None, vocab)
    axes = (bdim,) if mesh is not None and bdim else ()
    prepare = kv_prepare(arch, mesh)

    def prefill(params: dict, batch: dict):
        check_on(dev, params, "params")
        check_on(dev, batch, "batch")
        with spans.span("serve.prefill"):
            params = prepare(params)
            logits, _, cache = zoo.forward_seq(
                arch, params, batch["tokens"], extra=batch, impl=impl,
                return_cache=True, mesh=mesh, moe_impl=moe_impl,
                compute_dtype=compute_dtype, batch_axes=axes,
                seq_shard=seq_shard)
            cache["length"] = torch.tensor(shape.seq_len, dtype=torch.int32,
                                           device=dev)
            # a copy, so the (B, S, V) logits are freed as the step returns
            with spans.span("model.head"):
                last = logits[:, -1:, :].clone()
            del logits
            if mesh is not None:
                last = unlocal(last, mesh, logits_spec)
        return last, cache

    prefill.prepare = prepare
    return prefill


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def greedy_sharded(logits: torch.Tensor, mesh) -> torch.Tensor:
    """The greedy token (B, 1) int32 from this rank's vocabulary shard of
    the last logits (B, V / model): each rank's first maximum, the ``pmax``
    of the values, then the ``pmin`` of the global ids among the ranks
    that hold it, so a tie goes to the lowest global id as ``jnp.argmax``
    breaks it.  A mesh with no ``model`` axis holds the whole vocabulary."""
    from repro_torch.parallel.collectives import axis_index, pmax, pmin
    v_local = logits.shape[-1]
    idx = torch.argmax(logits, dim=-1)
    if "model" not in mesh.mesh_dim_names:
        return idx[:, None].to(torch.int32)
    val = torch.gather(logits, -1, idx[:, None])[:, 0].float()
    top = pmax(val, mesh, "model")
    ids = idx + axis_index(mesh, "model") * v_local
    best = torch.where(val == top, ids, torch.full_like(ids, 2 ** 62))
    return pmin(best, mesh, "model")[:, None].to(torch.int32)


def _unpod(step: Callable) -> Callable:
    """A one-pod stacked step on a rank's unstacked state: every leaf, the
    token and ``length`` viewed with a leading pod dim of 1 (views: the
    step's in-place writes land in the rank's tensors)."""
    def rank_step(params: dict, cache: Cache, token: torch.Tensor):
        nxt, _ = step(params, tree_map(lambda v: v.unsqueeze(0), cache),
                      token.unsqueeze(0))
        return nxt[0], cache
    return rank_step


def make_decode_step(arch: ArchConfig, n_pods: int = 1, device=None,
                     compute_dtype=torch.bfloat16, mesh=None,
                     flash_decode: bool = False,
                     batch: Optional[int] = None
                     ) -> Callable[[dict, Cache, torch.Tensor], tuple]:
    """``step(params, cache, token) -> (next_token, cache)``, greedy.

    The cache is pod-stacked (``init_cache``'s leaves stacked on a leading
    dim of ``n_pods``, ``length`` of shape (n_pods,)), ``token`` is
    (n_pods, B, 1), and the one ``params`` tree serves every pod.  The
    cache is written in place and returned.  The pod-step runs through a
    ``StepCache`` (``step.steps``): the token is copied into the graph's
    static buffer and ``next_token`` out of it; ``step.eager`` runs the
    same pod-step without the cache.

    With ``mesh``: this rank's pod's cache (``init_cache``'s leaves,
    ``length`` 0-d) and token (B, 1); the step returns (B, 1).  With
    ``flash_decode`` too (no ``pod`` axis): the dense and moe caches are
    the rank's sequence shards, and the step runs eagerly.  On inner axes
    (``data`` or ``model`` > 1): the rank's parameter shards, its
    sessions' cache (``session_cache_specs``) and their tokens; the step
    runs eagerly and returns those sessions' greedy tokens
    (``greedy_sharded``, or the plain argmax of logits whole on every
    rank where ``model`` does not divide the vocabulary).  ``batch``
    is the global session count, which ``session_cache_specs`` cuts over
    ``data`` when ``data`` divides it (None: it does); a moe model's
    decode routes those global sessions' tokens."""
    dev = resolve_device(device)
    if mesh is not None:
        fd = flash_decode and "pod" not in mesh.mesh_dim_names
        inner = {} if fd else zoo.check_mesh(arch, mesh)
        if inner:
            from repro_torch.models.transformer import vocab_split
            data = inner.get("data", 1)
            axes = ("data",) if data > 1 and (batch is None or
                                              batch % data == 0) else ()
            split = vocab_split(arch, mesh)
            prepare = kv_prepare(arch, mesh)

            def tp_step(params: dict, cache: Cache, token: torch.Tensor):
                check_on(dev, params, "params")
                check_on(dev, cache, "cache")
                check_on(dev, token, "token")
                params = prepare(params)
                logits, new = zoo.decode_step(arch, params, cache, token,
                                              mesh=mesh,
                                              compute_dtype=compute_dtype,
                                              batch_axes=axes)
                cache["length"].copy_(new["length"])
                if split:
                    return greedy_sharded(logits[:, -1, :], mesh), cache
                nxt = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
                return nxt.to(torch.int32), cache
            tp_step.prepare = prepare
            return tp_step
        if fd:
            def sharded(params: dict, cache: Cache, token: torch.Tensor):
                check_on(dev, params, "params")
                check_on(dev, cache, "cache")
                check_on(dev, token, "token")
                logits, new = zoo.decode_step(arch, params, cache, token,
                                              mesh=mesh, flash_decode=True,
                                              compute_dtype=compute_dtype)
                cache["length"].copy_(new["length"])
                nxt = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
                return nxt.to(torch.int32), cache
            return sharded
        one = make_decode_step(arch, 1, device, compute_dtype)
        step = _unpod(one)
        step.steps = one.steps
        return step

    def pod_step(cache: Cache, params: dict, token: torch.Tensor):
        out = torch.empty(token.shape, dtype=torch.int32, device=dev)
        for pod in range(n_pods):
            pod_cache = tree_map(lambda v: v[pod], cache)
            logits, pod_cache = zoo.decode_step(arch, params, pod_cache,
                                                token[pod],
                                                compute_dtype=compute_dtype)
            out[pod] = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
            cache["length"][pod] = pod_cache["length"]
        return out

    steps = StepCache(f"decode:{arch.name}x{n_pods}", pod_step)

    def _checked(params: dict, cache: Cache, token: torch.Tensor) -> dict:
        check_on(dev, params, "params")
        check_on(dev, cache, "cache")
        check_on(dev, token, "token")
        if cache["length"].shape != (n_pods,) or token.shape[0] != n_pods:
            raise ValueError(f"pod-stacked state must lead with {n_pods} pods")
        return {"state": cache, "params": params, "inputs": token}

    def step(params: dict, cache: Cache, token: torch.Tensor):
        return steps(**_checked(params, cache, token)), cache

    def eager(params: dict, cache: Cache, token: torch.Tensor):
        return steps.eager(**_checked(params, cache, token)), cache

    step.steps = steps
    step.eager = eager
    return step


# ---------------------------------------------------------------------------
# Session anti-entropy / migration (multi-pod)
# ---------------------------------------------------------------------------

def make_replicate_sessions_step(device=None, mesh=None
                                 ) -> Callable[[Cache], Cache]:
    """``replicate(live) -> backup``: every leaf of the (nested) tree
    ``torch.roll(·, 1, 0)`` over the pod dim (pod i's backup slot holds pod
    i-1's sessions); the backup is a fresh copy, off the decode path.  With
    ``mesh``: this rank's pod's sessions (on inner axes the rank's shard of
    them), sent to pod i + 1 (``ppermute`` pairs (i, i + 1)) as the backup
    comes from pod i - 1."""
    dev = resolve_device(device)
    if mesh is not None:
        from repro_torch.launch.mesh import axis_sizes
        from repro_torch.parallel.collectives import ppermute
        pods = axis_sizes(mesh).get("pod", 1)
        perm = [(i, (i + 1) % pods) for i in range(pods)]

        def replicate_ranks(live: Cache) -> Cache:
            check_on(dev, live, "live sessions")
            return tree_map(lambda v: ppermute(v, mesh, "pod", perm), live)
        return replicate_ranks

    def replicate(live: Cache) -> Cache:
        check_on(dev, live, "live sessions")
        # every leaf read once and written once
        with spans.span("serve.replicate", bytes=lambda: 2 * sum(
                v.nbytes for v in tree_flatten(live)[0])):
            return tree_map(lambda v: torch.roll(v, 1, 0), live)

    return replicate


def make_migrate_sessions_step(device=None, mesh=None
                               ) -> Callable[[Cache, Cache, torch.Tensor],
                                             Cache]:
    """``migrate(live, backup, dead) -> live'``: every leaf of the (nested)
    tree ``torch.where(dead[pod], backup, live)``, keygroup restore from the
    surviving replica (paper §2).  With ``mesh``: this rank's pod's live
    and backup sessions, and the whole (P,) dead mask, of which the rank
    reads its pod's flag; no exchange."""
    dev = resolve_device(device)
    if mesh is not None:
        from repro_torch.launch.mesh import axis_sizes
        from repro_torch.parallel.collectives import axis_index
        pods = axis_sizes(mesh).get("pod", 1)

        def migrate_rank(live: Cache, backup: Cache,
                         dead: torch.Tensor) -> Cache:
            check_on(dev, live, "live sessions")
            check_on(dev, backup, "backup sessions")
            check_on(dev, dead, "dead mask")
            if dead.shape != (pods,):
                raise ValueError(f"the dead mask must be ({pods},)")
            flag = dead[axis_index(mesh, "pod")]
            return tree_map(lambda l, b: torch.where(flag, b, l), live,
                            backup)
        return migrate_rank

    def migrate(live: Cache, backup: Cache, dead: torch.Tensor) -> Cache:
        check_on(dev, live, "live sessions")
        check_on(dev, backup, "backup sessions")
        check_on(dev, dead, "dead mask")
        n_pods = dead.shape[0]

        def sel(l, b):
            return torch.where(dead.reshape((n_pods,) + (1,) * (l.ndim - 1)),
                               b, l)
        return tree_map(sel, live, backup)

    return migrate
