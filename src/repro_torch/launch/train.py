"""Training steps on one card: the counterpart of ``repro.launch.train``,
with the paper's three data placements (``EnokiConfig.policy``):

REPLICATED (Enoki / DiLoCo)
    Parameters and optimiser state are pod-stacked keygroups: every leaf
    carries a leading ``n_pods`` dim.  ``make_train_step``'s step runs each
    pod on its own slice of the state against its own slice of the batch
    (the reference's ``jax.vmap(step)``), with no exchange between pods.
    ``make_replicate_step`` is the separate anti-entropy program: each pod's
    delta against the outer params (optionally int8-quantised), their
    mean, the DiLoCo outer Nesterov step, and the outer params broadcast
    back into every pod's slice.  Staleness bound = replication_period
    steps.

CLOUD_CENTRAL (the paper's baseline) and PEER_FETCH (SyncMesh analogue)
    One shared parameter set over the concatenated batch of all pods.  On a
    mesh PEER_FETCH shards the params over the pod axis and gathers them on
    demand; on one card that gather is the identity, so both compute the
    same step as one pod.

Without a mesh the pods are a stacked leading dim on one card, as
``core.replication.make_pod_replicate_step`` stacks them, and the factories
take ``device`` (None: the card, which raises without one) where the
reference takes a mesh.

With ``mesh=`` (a ``torch.distributed`` mesh) every rank holds its shards
of ONE pod's state, with no pod dim, laid out by the reference's specs
(``state_specs``; ``parallel.sharding.local`` cuts them from a full
state), and steps on its shard of the batch:

* ``model`` > 1: tensor parallelism of every family (Megatron column
  and row splits, vocab-parallel embedding, head and loss where
  ``model`` divides the vocabulary, whole ones elsewhere, the vlm's
  patches and whisper's frames gathered, a moe layer's experts or expert
  columns with the global batch's dispatch and aux, the Mamba-2 and
  mLSTM scans on the rank's heads, whisper's cross-attention on them;
  ``models``);
* ``data`` > 1: the batch over ``data`` and the loss's mean over the
  global batch; a gradient is summed over every batch axis its leaf is
  not sharded on;
* ZeRO-1 (``zero1``, the moments sharded over ``data``): each rank
  updates the region of a parameter its moment shard covers and the
  regions are all-gathered back (``sharding.relayout``);
* FSDP (``fsdp``): parameters sharded over ``data`` too, gathered at use
  by ``collectives.gather_param``, whose transpose reduce-scatters their
  gradients;
* ``pod`` > 1: REPLICATED steps each pod (a group of ranks) on its own
  with no pod collective; CLOUD_CENTRAL takes the batch over ``("pod",
  "data")`` and sums the gradients over ``pod`` as well; PEER_FETCH
  shards every leaf's largest free even dim over ``pod`` as well
  (``add_pod_axis_spec``) and gathers it at use like FSDP.

The gradient norm counts each element once (``optim.adamw.global_norm``);
the replicate step works shard by shard, the int8 scale being the whole
leaf's.  Adafactor's factors keep the reference's layout (replicated; over
``pod`` under PEER_FETCH), their means over whole leaves.  ``seq_shard``
changes nothing in a train step (``sharding.batch_specs`` cuts only a
prefill's sequence), as in the reference.
Every step writes the state IN PLACE (the counterpart of the reference's
``donate_argnums=(0,)``) and returns the same tensors.  Gradients come
from ``torch.autograd`` through ``AttnImpl.REFERENCE``, as in the
reference; the kernels refuse autograd.
"""
from __future__ import annotations

import functools

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import (ArchConfig, AttnImpl, EnokiConfig,
                                      ParallelConfig, ReplicationPolicy,
                                      ShapeConfig, StepKind, TrainConfig)
from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.device import check_on, resolve_device
from repro_torch.models import model_zoo as zoo
from repro_torch.optim import (adafactor_init, adafactor_update, adamw_init,
                               adamw_update, diloco_init,
                               diloco_outer_update, warmup_cosine)
from repro_torch.optim.compression import (Int8Payload, int8_compress,
                                           int8_decompress)


# ---------------------------------------------------------------------------
# Per-cell defaults
# ---------------------------------------------------------------------------

def default_parallel(arch: ArchConfig, shape: ShapeConfig) -> ParallelConfig:
    n = arch.param_count()
    big = n > 20e9
    return ParallelConfig(
        fsdp=big and shape.step is StepKind.TRAIN,
        zero1=True,
        seq_shard=False,
        remat=("full" if big else "block") if shape.step is StepKind.TRAIN
        else "none",
        use_scan=True,
        optimizer="adafactor" if n > 200e9 else "adamw",
    )


def param_dtype_for(arch: ArchConfig) -> torch.dtype:
    # >= 200B params: bf16 weights + adafactor, or the state never fits
    return torch.bfloat16 if arch.param_count() > 200e9 else torch.float32


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

def init_state(arch: ArchConfig, seed: int, parallel: ParallelConfig,
               dtype=None, device=None) -> Dict[str, Any]:
    """``{"params", "opt", "step"}`` on ``device`` (None: the card; "meta":
    shapes only): params from ``model_zoo.init_params(arch, seed)``, the
    optimiser's state (AdamW keeps an f32 master only for bf16 params,
    f32 params being their own), and an int32 step."""
    dtype = dtype or param_dtype_for(arch)
    dev = resolve_device(device)
    params = zoo.init_params(arch, seed=seed, dtype=dtype, device=dev)
    if parallel.optimizer == "adafactor":
        opt = adafactor_init(params)
    else:
        opt = adamw_init(params, keep_master=(dtype == torch.bfloat16))
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def state_shapes(arch: ArchConfig, parallel: ParallelConfig,
                 dtype=None) -> Dict[str, Any]:
    """The train state on the ``meta`` device (the reference's
    ``jax.eval_shape``): the params as ``launch.serve.params_shape_tree``
    makes them, in the training dtype, and the optimiser's state beside
    them; no storage."""
    return init_state(arch, 0, parallel, dtype, device="meta")


def opt_specs_tree(opt_shape: Any, arch: ArchConfig, mesh,
                   parallel: ParallelConfig) -> Any:
    """Optimizer-state specs: params-shaped subtrees (m/v/master or
    adafactor full) get the ZeRO/param rule; factored row/col vectors and
    counters replicate."""
    import dataclasses
    from repro_torch.parallel.sharding import (P, _spec_for,
                                               tree_map_with_path)
    zp = dataclasses.replace(parallel, fsdp=parallel.fsdp or parallel.zero1)

    def spec(path, leaf):
        if "count" in path or path[-1] in ("row", "col"):
            return P()          # tiny
        return _spec_for(path, leaf, arch, mesh, zp)

    return tree_map_with_path(spec, opt_shape)


def state_specs(state_shape: Any, arch: ArchConfig, mesh,
                parallel: ParallelConfig,
                peer_fetch_pod: bool = False) -> Dict[str, Any]:
    """Specs of a train state: the params' rule, the optimiser's
    (``opt_specs_tree``), the step replicated; ``peer_fetch_pod`` adds the
    ``pod`` axis to every leaf (``add_pod_axis_spec``)."""
    from repro_torch.parallel.sharding import (P, param_partition_specs,
                                               tree_map_with_path)
    specs = {"params": param_partition_specs(state_shape["params"], arch,
                                             mesh, parallel),
             "opt": opt_specs_tree(state_shape["opt"], arch, mesh, parallel),
             "step": P()}
    if peer_fetch_pod:
        shapes = {"params": state_shape["params"], "opt": state_shape["opt"],
                  "step": state_shape["step"]}
        flat = {}
        tree_map_with_path(lambda path, leaf: flat.__setitem__(
            path, tuple(leaf.shape)), shapes)
        specs = tree_map_with_path(
            lambda path, spec: add_pod_axis_spec(spec, flat[path]), specs)
    return specs


def add_pod_axis_spec(spec, shape: tuple):
    """PEER_FETCH: ``spec`` with the largest free dim of even size also
    sharded over ``pod`` (FSDP across pods; the reference's
    ``_add_pod_axis_spec``)."""
    from repro_torch.parallel.sharding import P
    assign = list(spec) + [None] * (len(shape) - len(spec))
    free = [d for d in range(len(shape)) if assign[d] is None]
    for d in sorted(free, key=lambda d: -shape[d]):
        if shape[d] % 2 == 0 and shape[d] >= 2:
            assign[d] = "pod"
            break
    return P(*assign)


def stack_shapes(shapes: Any, n_pods: int) -> Any:
    """A state tree with a leading pod dim of ``n_pods`` (meta)."""
    return tree_map(lambda l: l.new_empty((n_pods,) + tuple(l.shape)),
                    shapes)


# ---------------------------------------------------------------------------
# The core single-replica train step
# ---------------------------------------------------------------------------

def make_loss_fn(arch: ArchConfig, parallel: ParallelConfig,
                 impl: AttnImpl = AttnImpl.REFERENCE,
                 compute_dtype=torch.bfloat16):
    def loss_fn(params, batch):
        return zoo.lm_loss(arch, params, batch, impl=impl,
                           remat=parallel.remat, compute_dtype=compute_dtype)
    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """``jax.value_and_grad(..., has_aux=True)`` of ``loss_fn`` at
    ``params``: the loss and its parts detached, and one gradient tensor a
    leaf (zeros where the loss does not reach a leaf).  The params are
    differentiated through aliases that share their storage, so the
    state's own tensors never require grad."""
    leaves, treedef = tree_flatten(params)
    alias = [p.detach().requires_grad_(p.is_floating_point())
             for p in leaves]
    with torch.enable_grad():
        loss, parts = loss_fn(tree_unflatten(treedef, alias), batch)
        wrt = [a for a in alias if a.requires_grad]
        got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for a in alias:
        g = next(got) if a.requires_grad else None
        grads.append(torch.zeros_like(a) if g is None else g)
    return (loss.detach(), tree_map(torch.Tensor.detach, parts),
            tree_unflatten(treedef, grads))


def make_step_fn(arch: ArchConfig, parallel: ParallelConfig,
                 cfg: TrainConfig, impl: AttnImpl = AttnImpl.REFERENCE,
                 compute_dtype=torch.bfloat16) -> Callable:
    """``step(state, batch) -> (state, metrics)``: value and gradient of
    ``lm_loss``, ``warmup_cosine``'s lr at the state's step, then AdamW or
    Adafactor (``parallel.optimizer``), all written into ``state``;
    metrics ``loss``, ``ce``, ``lr`` and ``grad_norm`` (0-d tensors on the
    state's device)."""
    loss_fn = make_loss_fn(arch, parallel, impl, compute_dtype)
    update = (adafactor_update if parallel.optimizer == "adafactor"
              else adamw_update)

    def step(state, batch):
        loss, parts, grads = value_and_grad(loss_fn, state["params"], batch)
        lr = warmup_cosine(state["step"], cfg.lr, cfg.warmup_steps,
                           cfg.total_steps)
        params, opt, om = update(grads, state["opt"], state["params"], lr,
                                 weight_decay=cfg.weight_decay,
                                 grad_clip=cfg.grad_clip)
        del grads
        state["step"].add_(1)
        metrics = {"loss": loss, "ce": parts["ce"], "lr": lr, **om}
        return {"params": params, "opt": opt, "step": state["step"]}, metrics

    return step


def batch_axes(arch: ArchConfig, shape: ShapeConfig, mesh,
               parallel: ParallelConfig,
               policy: ReplicationPolicy) -> Tuple[str, ...]:
    """The axes a rank's batch is a shard of: ``data`` where
    ``sharding.batch_specs`` puts the batch on it, and ``pod`` before it
    for CLOUD_CENTRAL and PEER_FETCH on a mesh of several pods (each rank
    steps on its own pod's batch)."""
    from repro_torch.launch.mesh import axis_sizes
    from repro_torch.parallel.sharding import batch_specs
    axes = ()
    if axis_sizes(mesh).get("pod", 1) > 1 and policy in (
            ReplicationPolicy.CLOUD_CENTRAL, ReplicationPolicy.PEER_FETCH):
        axes = ("pod",)
    if batch_specs(arch, shape, mesh, parallel)["tokens"][0] == "data":
        axes += ("data",)
    return axes


def make_mesh_step_fn(arch: ArchConfig, shape: ShapeConfig,
                      parallel: ParallelConfig, cfg: TrainConfig,
                      impl: AttnImpl, compute_dtype, mesh,
                      policy: ReplicationPolicy) -> Tuple[Callable, Any]:
    """``(step, specs)``: ``make_step_fn``'s step on this rank's shards of
    one pod's state (``specs``, the reference's ``state_specs``) and its
    batch shard (``batch_axes``) (the module docstring); AdamW updates
    each moment shard's region, Adafactor each parameter shard with its
    means over whole leaves (``optim.adafactor``).  The parameters' axes
    other than ``model`` are gathered at use
    (``gather_param``); a gradient is summed over the batch axes its leaf
    is not sharded on, reduce-scattered (``psum_scatter``) where the
    moments shard that axis (ZeRO-1) and all-reduced where they do not;
    each moment shard's region of a parameter is updated (``relayout``
    to the moments' layout and back) with the norm over the regions; the
    metrics are the same on every rank.  ``step.grads(params, batch)``
    gives the gradients whole on each rank's parameter shards."""
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel import sharding as sh
    pods = sh.axis_sizes(mesh).get("pod", 1)
    sshape = state_shapes(arch, parallel)
    specs = state_specs(sshape, arch, mesh, parallel,
                        peer_fetch_pod=(policy == ReplicationPolicy.PEER_FETCH
                                        and pods > 1))
    pspecs = sh.spec_leaves(specs["params"])
    if parallel.optimizer == "adamw":
        update = functools.partial(adamw_update, mesh=mesh, axes=[
            sh.spec_axes(s) for s in sh.spec_leaves(specs["opt"]["m"])])
        ospecs = sh.spec_leaves(specs["opt"]["m"])
    else:                     # Adafactor updates each leaf in its layout
        from repro_torch.optim.adafactor import _flatten_up_to
        update = functools.partial(
            adafactor_update, mesh=mesh, specs=pspecs,
            factor_specs=_flatten_up_to(specs["opt"]["v"], sshape["params"]))
        ospecs = pspecs
    baxes = batch_axes(arch, shape, mesh, parallel, policy)

    def gather_at_use(params):
        leaves, treedef = tree_flatten(params)
        out = []
        for x, spec in zip(leaves, pspecs):
            for d, e in enumerate(spec):
                if e is not None and e != "model":
                    x = col.gather_param(x, mesh, e, d)
            out.append(x)
        return tree_unflatten(treedef, out)

    def loss_fn(params, batch):
        return zoo.lm_loss(arch, gather_at_use(params), batch, impl=impl,
                           remat=parallel.remat, compute_dtype=compute_dtype,
                           mesh=mesh, batch_axes=baxes,
                           moe_impl=parallel.moe_impl)

    def reduced_grads(params, batch):
        """The loss, its parts, and each leaf's gradient summed over the
        batch axes with the layout it then has (the parameter's, plus the
        axes it was reduce-scattered over)."""
        loss, parts, grads = value_and_grad(loss_fn, params, batch)
        flat_g, treedef = tree_flatten(grads)
        layouts = []
        for i, (ps, os) in enumerate(zip(pspecs, ospecs)):
            src = list(ps) + [None] * (flat_g[i].ndim - len(ps))
            for a in baxes:
                if a in sh.spec_axes(ps):
                    continue
                d = next((d for d, e in enumerate(os) if e == a), None)
                if d is not None and src[d] is None:
                    flat_g[i] = col.psum_scatter(flat_g[i], mesh, a, d)
                    src[d] = a
                else:
                    flat_g[i] = col.psum(flat_g[i], mesh, a)
            layouts.append(sh.P(*src))
        return loss, parts, flat_g, layouts, treedef

    def grads(params, batch):
        _, _, flat_g, layouts, treedef = reduced_grads(params, batch)
        return tree_unflatten(treedef, [
            sh.relayout(g, mesh, lay, ps)
            for g, lay, ps in zip(flat_g, layouts, pspecs)])

    def step(state, batch):
        loss, parts, flat_g, layouts, treedef = reduced_grads(
            state["params"], batch)
        flat_p = tree_flatten(state["params"])[0]
        g_opt = [sh.relayout(g, mesh, lay, os)
                 for g, lay, os in zip(flat_g, layouts, ospecs)]
        p_opt = [sh.relayout(p, mesh, ps, os)
                 for p, ps, os in zip(flat_p, pspecs, ospecs)]
        del flat_g
        lr = warmup_cosine(state["step"], cfg.lr, cfg.warmup_steps,
                           cfg.total_steps)
        _, opt, om = update(tree_unflatten(treedef, g_opt), state["opt"],
                            tree_unflatten(treedef, p_opt), lr,
                            weight_decay=cfg.weight_decay,
                            grad_clip=cfg.grad_clip)
        del g_opt
        with torch.no_grad():
            for p, po, ps, os in zip(flat_p, p_opt, pspecs, ospecs):
                if po is not p:
                    p.copy_(sh.relayout(po, mesh, os, ps))
        state["step"].add_(1)
        metrics = {"loss": loss, "ce": parts["ce"], "lr": lr, **om}
        return {"params": state["params"], "opt": opt,
                "step": state["step"]}, metrics

    step.grads = grads
    return step, specs


# ---------------------------------------------------------------------------
# Policy-aware builders
# ---------------------------------------------------------------------------

def _pod(tree: Any, p: int) -> Any:
    """Pod ``p``'s slice of a pod-stacked tree (views: writes land in the
    stack)."""
    return tree_map(lambda x: x[p], tree)


def make_train_step(arch: ArchConfig, shape: ShapeConfig, n_pods: int = 1,
                    parallel: Optional[ParallelConfig] = None,
                    enoki: Optional[EnokiConfig] = None,
                    cfg: Optional[TrainConfig] = None,
                    impl: AttnImpl = AttnImpl.REFERENCE, device=None,
                    compute_dtype=torch.bfloat16, mesh=None
                    ) -> Tuple[Callable, Any]:
    """``(step, state_shape)`` (module docstring).  REPLICATED with
    ``n_pods > 1``: the state's leaves are pod-stacked (``state_shape`` on
    the meta device shows them), the batch's leaves too ((n_pods, b, ...)),
    and the metrics come back stacked by pod.  Otherwise one state and one
    batch (the pods' batches concatenated).  With ``mesh`` (``n_pods`` is
    then the mesh's pod count): this rank's pod's state and batch, no pod
    dim, and the rank's metrics (CLOUD_CENTRAL: loss and ce averaged over
    the pods, as the gradients are)."""
    parallel = parallel or default_parallel(arch, shape)
    enoki = enoki or EnokiConfig()
    cfg = cfg or TrainConfig()
    dev = resolve_device(device)
    sshape = state_shapes(arch, parallel)
    step_fn = make_step_fn(arch, parallel, cfg, impl, compute_dtype)

    if mesh is not None:
        from repro_torch.launch.mesh import axis_sizes
        zoo.check_mesh(arch, mesh)
        policy = enoki.policy if axis_sizes(mesh).get("pod", 1) > 1 \
            else ReplicationPolicy.REPLICATED
        mesh_fn, specs = make_mesh_step_fn(arch, shape, parallel, cfg, impl,
                                           compute_dtype, mesh, policy)

        def rank_step(state, batch):
            check_on(dev, state, "state")
            check_on(dev, batch, "batch")
            return mesh_fn(state, batch)
        rank_step.specs = specs
        rank_step.grads = mesh_fn.grads
        rank_step.batch_axes = batch_axes(arch, shape, mesh, parallel,
                                          policy)
        return rank_step, sshape

    if n_pods == 1 or enoki.policy != ReplicationPolicy.REPLICATED:
        def step(state, batch):
            check_on(dev, state, "state")
            check_on(dev, batch, "batch")
            return step_fn(state, batch)
        return step, sshape

    def pod_step(state, batch):
        check_on(dev, state, "state")
        check_on(dev, batch, "batch")
        metrics = []
        for p in range(n_pods):
            _, m = step_fn(_pod(state, p), _pod(batch, p))
            metrics.append(m)
        return state, {k: torch.stack([m[k] for m in metrics])
                       for k in metrics[0]}

    return pod_step, stack_shapes(sshape, n_pods)


# ---------------------------------------------------------------------------
# The anti-entropy step (REPLICATED policy, off the hot path)
# ---------------------------------------------------------------------------

def make_replicate_step(arch: ArchConfig, n_pods: int,
                        parallel: ParallelConfig, enoki: EnokiConfig,
                        device=None, mesh=None) -> Tuple[Callable, Any]:
    """``(replicate, outer_shape)``: ``replicate(stacked_state,
    outer_state) -> (stacked_state, outer_state)``, both written in place.
    Each pod's delta against the outer params (with ``compress_deltas``
    int8-quantised with the pod's own scale, then dequantised: what the
    wire would carry), their mean over the pods, ``diloco_outer_update``,
    and the outer params cast to the params' dtype in every pod's slice.
    ``outer_shape`` is ``diloco_init``'s tree on the meta device.  With
    ``mesh`` (a mesh of ``n_pods`` pods): this rank's shards of its pod's
    params and of the outer state (both laid out by the params' specs),
    no pod dim; shard by shard, the deltas' mean is ``psum / P`` over
    ``pod`` (compressed: the int8 payloads and scales all-gathered and
    dequantised in pod order, as the stacked form stacks them, each scale
    the whole leaf's), the same on every rank of ``pod``."""
    dev = resolve_device(device)
    params = state_shapes(arch, parallel)["params"]
    axes = None
    if mesh is not None:
        from repro_torch.launch.mesh import axis_sizes
        from repro_torch.parallel import sharding as sh
        zoo.check_mesh(arch, mesh)
        pods = axis_sizes(mesh).get("pod", 1)
        if pods != n_pods:
            raise ValueError(f"{n_pods} pods on a mesh of {pods}")
        axes = [sh.spec_axes(s) for s in sh.spec_leaves(
            sh.param_partition_specs(params, arch, mesh, parallel))]

    def mean_delta(o, local, ax=()):
        if mesh is not None:
            from repro_torch.parallel.collectives import all_gather, psum
            d = o - local.float()
            if enoki.compress_deltas:
                q = int8_compress(d, mesh, ax)
                qs = all_gather(q.q, mesh, "pod")
                ss = all_gather(q.scale, mesh, "pod")
                return torch.stack([int8_decompress(Int8Payload(qs[p], ss[p]))
                                    for p in range(n_pods)]).mean(dim=0)
            return psum(d, mesh, "pod") / n_pods
        if enoki.compress_deltas:
            return torch.stack([int8_decompress(int8_compress(
                o - local[p].float())) for p in range(n_pods)]).mean(dim=0)
        return (o[None] - local.float()).mean(dim=0)

    def replicate(state, outer_state):
        check_on(dev, state, "state")
        check_on(dev, outer_state, "outer state")
        local = state["params"]
        with torch.no_grad():
            if axes is None:
                deltas = tree_map(mean_delta, outer_state["outer_params"],
                                  local)
            else:
                flat_o, treedef = tree_flatten(outer_state["outer_params"])
                deltas = tree_unflatten(treedef, [
                    mean_delta(o, l, ax) for o, l, ax in zip(
                        flat_o, tree_flatten(local)[0], axes)])
            new_outer, outer_state = diloco_outer_update(
                outer_state, deltas, enoki.outer_lr, enoki.outer_momentum)
            del deltas
            for no, l in zip(tree_flatten(new_outer)[0],
                             tree_flatten(local)[0]):
                l.copy_(no.to(l.dtype).expand_as(l))
        return state, outer_state

    return replicate, diloco_init(params)
