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

There is no mesh and no sharding: the pods are a stacked leading dim on one
card, as ``core.replication.make_pod_replicate_step`` stacks them, and the
factories take ``device`` (None: the card, which raises without one) where
the reference takes a mesh.  Every step writes the state IN PLACE (the
counterpart of the reference's ``donate_argnums=(0,)``) and returns the
same tensors.  Gradients come from ``torch.autograd`` through
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
from repro_torch.optim.compression import int8_compress, int8_decompress


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
                    compute_dtype=torch.bfloat16) -> Tuple[Callable, Any]:
    """``(step, state_shape)`` (module docstring).  REPLICATED with
    ``n_pods > 1``: the state's leaves are pod-stacked (``state_shape`` on
    the meta device shows them), the batch's leaves too ((n_pods, b, ...)),
    and the metrics come back stacked by pod.  Otherwise one state and one
    batch (the pods' batches concatenated)."""
    parallel = parallel or default_parallel(arch, shape)
    enoki = enoki or EnokiConfig()
    cfg = cfg or TrainConfig()
    dev = resolve_device(device)
    sshape = state_shapes(arch, parallel)
    step_fn = make_step_fn(arch, parallel, cfg, impl, compute_dtype)

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
                        device=None) -> Tuple[Callable, Any]:
    """``(replicate, outer_shape)``: ``replicate(stacked_state,
    outer_state) -> (stacked_state, outer_state)``, both written in place.
    Each pod's delta against the outer params (with ``compress_deltas``
    int8-quantised with the pod's own scale, then dequantised: what the
    wire would carry), their mean over the pods, ``diloco_outer_update``,
    and the outer params cast to the params' dtype in every pod's slice.
    ``outer_shape`` is ``diloco_init``'s tree on the meta device."""
    dev = resolve_device(device)

    def mean_delta(o, local):
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
                l.copy_(no.to(l.dtype)[None].expand_as(l))
        return state, outer_state

    params = state_shapes(arch, parallel)["params"]
    return replicate, diloco_init(params)
