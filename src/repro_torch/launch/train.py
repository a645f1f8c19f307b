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
reference takes a mesh.  With ``mesh=`` (a ``torch.distributed`` mesh whose
only axis of size > 1 is ``pod``) each rank holds ONE pod's state, with no
pod dim, and steps it on its own pod's batch: REPLICATED steps with no
exchange; CLOUD_CENTRAL averages the gradients over ``pod`` (``psum / P``)
before the update; the replicate step takes the mean of the deltas over
``pod`` with ``psum / P`` (or, compressed, all-gathers the int8 payloads
and scales).  Tensor parallelism and FSDP of whole steps over ``data`` and
``model``, and PEER_FETCH on a mesh, raise ``NotImplementedError``: they
come with the slice after the pod axis.  Every step writes the state IN
PLACE (the counterpart of the reference's ``donate_argnums=(0,)``) and
returns the same tensors.  Gradients come from ``torch.autograd`` through
``AttnImpl.REFERENCE``, as in the reference; the kernels refuse autograd.
"""
from __future__ import annotations

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
                parallel: ParallelConfig) -> Dict[str, Any]:
    """Specs of a train state: the params' rule, the optimiser's
    (``opt_specs_tree``), the step replicated."""
    from repro_torch.parallel.sharding import P, param_partition_specs
    return {"params": param_partition_specs(state_shape["params"], arch,
                                            mesh, parallel),
            "opt": opt_specs_tree(state_shape["opt"], arch, mesh, parallel),
            "step": P()}


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
                 compute_dtype=torch.bfloat16, mean_over=None) -> Callable:
    """``step(state, batch) -> (state, metrics)``: value and gradient of
    ``lm_loss``, ``warmup_cosine``'s lr at the state's step, then AdamW or
    Adafactor (``parallel.optimizer``), all written into ``state``;
    metrics ``loss``, ``ce``, ``lr`` and ``grad_norm`` (0-d tensors on the
    state's device).  ``mean_over=(mesh, P)``: the loss, its parts and the
    gradients are averaged over the mesh's ``pod`` axis (``psum / P``)
    before the update (sync data parallelism across pods)."""
    loss_fn = make_loss_fn(arch, parallel, impl, compute_dtype)
    update = (adafactor_update if parallel.optimizer == "adafactor"
              else adamw_update)

    def pod_mean(tree):
        from repro_torch.parallel.collectives import psum
        mesh, pods = mean_over
        return tree_map(lambda g: psum(g, mesh, "pod") / pods, tree)

    def step(state, batch):
        loss, parts, grads = value_and_grad(loss_fn, state["params"], batch)
        if mean_over is not None:
            loss, parts, grads = pod_mean(loss), pod_mean(parts), \
                pod_mean(grads)
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


# ---------------------------------------------------------------------------
# Policy-aware builders
# ---------------------------------------------------------------------------

def _pod(tree: Any, p: int) -> Any:
    """Pod ``p``'s slice of a pod-stacked tree (views: writes land in the
    stack)."""
    return tree_map(lambda x: x[p], tree)


def pod_mesh_size(mesh, what: str) -> int:
    """The size of ``mesh``'s ``pod`` axis (1 without one); any other axis
    of size > 1 raises ``NotImplementedError``."""
    from repro_torch.launch.mesh import axis_sizes
    sizes = axis_sizes(mesh)
    inner = {a: n for a, n in sizes.items() if a != "pod" and n > 1}
    if inner:
        raise NotImplementedError(
            f"{what} over {inner}: tensor parallelism and FSDP of whole "
            "steps over 'data' and 'model' come with the slice after the "
            "pod axis")
    return sizes.get("pod", 1)


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
        pods = pod_mesh_size(mesh, "make_train_step")
        if enoki.policy == ReplicationPolicy.PEER_FETCH and pods > 1:
            raise NotImplementedError(
                "PEER_FETCH on a mesh comes with the slice after the pod "
                "axis")
        if enoki.policy == ReplicationPolicy.CLOUD_CENTRAL and pods > 1:
            step_fn = make_step_fn(arch, parallel, cfg, impl, compute_dtype,
                                   mean_over=(mesh, pods))

        def rank_step(state, batch):
            check_on(dev, state, "state")
            check_on(dev, batch, "batch")
            return step_fn(state, batch)
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
    ``mesh`` (a pod mesh of ``n_pods``): this rank's pod's state, no pod
    dim; the deltas' mean is ``psum / P`` over ``pod`` (compressed: the
    int8 payloads and scales all-gathered and dequantised in pod order, as
    the stacked form stacks them), the same on every rank."""
    dev = resolve_device(device)
    if mesh is not None and pod_mesh_size(mesh, "make_replicate_step") \
            != n_pods:
        raise ValueError(f"{n_pods} pods on a mesh of "
                         f"{pod_mesh_size(mesh, 'make_replicate_step')}")

    def mean_delta(o, local):
        if mesh is not None:
            from repro_torch.parallel.collectives import all_gather, psum
            d = o - local.float()
            if enoki.compress_deltas:
                q = int8_compress(d)
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
            deltas = tree_map(mean_delta, outer_state["outer_params"], local)
            new_outer, outer_state = diloco_outer_update(
                outer_state, deltas, enoki.outer_lr, enoki.outer_momentum)
            del deltas
            for no, l in zip(tree_flatten(new_outer)[0],
                             tree_flatten(local)[0]):
                l.copy_(no.to(l.dtype).expand_as(l))
        return state, outer_state

    params = state_shapes(arch, parallel)["params"]
    return replicate, diloco_init(params)
