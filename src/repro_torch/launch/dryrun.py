"""Multi-pod dry-run of every (arch x shape x mesh) cell: the counterpart of
``repro.launch.dryrun``.

The reference forces 512 host devices and lowers and compiles each cell's
jitted step against ``ShapeDtypeStruct`` stand-ins.  The port's steps are
eager, so for each cell this:

  1. joins a FAKE world of 256 ranks ((16, 16): data x model) or 512
     ((2, 16, 16): pod x data x model) as rank 0
     (``launch.mesh.init_fake_world``: the ``fake`` backend answers every
     collective at once) and builds the production ``DeviceMesh`` over it;
  2. builds the cell's step with the port's own factories
     (``train.make_train_step``/``make_replicate_step``,
     ``serve.make_prefill_step``, ``serve.make_decode_step``/
     ``make_replicate_sessions_step``, each with ``mesh=``), and rank 0's
     arguments: its shards (``parallel.sharding.local``) of the state
     (``train.state_shapes``, ``serve.params_shape_tree``, the cache of
     ``session_cache_specs``) and of the batch (``model_zoo.input_specs``);
  3. runs rank 0's step ONCE, eagerly, on fake tensors
     (``FakeTensorMode``: shapes and dtypes, no storage) under the cost
     walker (``launch.roofline.CostMode``): a sharding mismatch or a width
     that does not split fails HERE, as the reference's ``compile()``
     fails;
  4. records the memory (``argument_bytes``: the rank's state and batch;
     the walker's ``peak_bytes``), the walker's counts as ``hlo``, the
     roofline terms at the card's data-sheet peaks, and ``model_flops``;
     for multi-pod REPLICATED cells it runs the replication step as well
     (``replication_step``): the hot step shows no pod-crossing bytes, the
     replication step does (the reference's property).

Rank 0's program stands for every rank's: every rank runs the same code
on its own shards (SPMD), as the reference's partitioned module stands for
every device.  The fake world is left (``close_world``) at the end of
every cell.

Three outcomes are kept apart: ``skipped`` (``shape_applicable``, as the
reference has it), ``refused`` (``model_zoo.check_mesh``: a width that
``model`` does not divide, which the port refuses where GSPMD would
reshard; a deliberate difference) and ``ok: False`` (anything else, with
its traceback).  Only ``ok: False`` fails the run.

The fake tensors name the card (``cuda``) where this torch is built with
CUDA; a CPU-only build cannot slice a fake CUDA tensor, so there they name
the CPU.  Either way nothing runs on a device and every kernel is charged
its analytic work, so the counts are the same.

Usage::

  python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--policy replicated]
  python -m repro_torch.launch.dryrun --all --both-meshes --out build/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

#: an H100 80GB's device memory, as "fits" reads it
DEVICE_MEMORY_BYTES = 80e9


def fake_device() -> str:
    """The device type the dry-run's fake tensors name (the module
    docstring)."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _fake(tree, device: str):
    """Fake tensors (under the active ``FakeTensorMode``) of a tree of
    meta tensors' shapes and dtypes."""
    from repro_torch.core.tree import tree_map
    return tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype,
                                          device=device), tree)


def _meta_batch(arch, shape, rows: Optional[int] = None) -> dict:
    from repro_torch.models import model_zoo as zoo
    out = {}
    for name, (dims, dtype) in zoo.input_specs(arch, shape).items():
        if rows is not None:
            dims = (rows,) + tuple(dims[1:])
        out[name] = torch.empty(dims, dtype=dtype, device="meta")
    return out


def _batch_spec(axes: Sequence[str], ndim: int):
    from repro_torch.parallel.sharding import P
    entry = None if not axes else (axes[0] if len(axes) == 1 else
                                   tuple(axes))
    return P(entry, *([None] * (ndim - 1)))


def _rank_batch(batch: dict, mesh, axes: Sequence[str]) -> dict:
    """Rank 0's shard of ``batch`` (meta) cut on its leading dim over
    ``axes``; the whole batch without a mesh."""
    if mesh is None:
        return batch
    from repro_torch.parallel import sharding as sh
    return sh.local(batch, mesh, {k: _batch_spec(axes, v.ndim)
                                  for k, v in batch.items()})[0]


def _build_cell(arch, shape, mesh, policy, parallel, device: str):
    """``(run, rep, extras)``: ``run`` and ``rep`` are ``(fn, args)`` of the
    hot step and of the replication step (None where the cell has none),
    their arguments meta tensors of rank 0's shards; ``extras`` goes into
    the record.  ``mesh`` None is one card (a world of one rank)."""
    from repro_torch.configs.base import (AttnImpl, EnokiConfig,
                                          ParallelConfig, ReplicationPolicy,
                                          StepKind)
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import axis_sizes
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import sharding as sh

    impl = AttnImpl(parallel.attn_impl) if parallel is not None \
        else AttnImpl.REFERENCE
    enoki = EnokiConfig(policy=ReplicationPolicy(policy))
    sizes = axis_sizes(mesh) if mesh is not None else {}
    n_pods = sizes.get("pod", 1)
    multi_pod = n_pods > 1
    replicated = enoki.policy == ReplicationPolicy.REPLICATED
    extras: Dict[str, Any] = {}

    if shape.step is StepKind.TRAIN:
        parallel = parallel or train_mod.default_parallel(arch, shape)
        step, sshape = train_mod.make_train_step(
            arch, shape, parallel=parallel, enoki=enoki, impl=impl,
            device=device, mesh=mesh)
        extras["parallel"] = dataclasses.asdict(parallel)
        rows = shape.global_batch // n_pods if multi_pod and replicated \
            else None
        if mesh is None:
            state, batch = sshape, _meta_batch(arch, shape)
        else:
            state = sh.local(sshape, mesh, step.specs)[0]
            batch = _rank_batch(_meta_batch(arch, shape, rows), mesh,
                                step.batch_axes)
        rep = None
        if multi_pod and replicated:
            rstep, outer_shape = train_mod.make_replicate_step(
                arch, n_pods, parallel, enoki, device=device, mesh=mesh)
            pspecs = step.specs["params"]
            outer = sh.local(outer_shape, mesh, {
                "outer_params": pspecs, "momentum": pspecs,
                "round": sh.P()})[0]
            rep = (rstep, (state, outer))
        return (step, (state, batch)), rep, extras

    parallel = parallel or ParallelConfig()
    params_meta = serve_mod.params_shape_tree(arch)

    if shape.step is StepKind.PREFILL:
        # each pod prefills the whole batch on its own (data, model)
        # sub-mesh: the reference's batch is over ``data`` only
        pod_mesh = mesh["data", "model"] if multi_pod else mesh
        step = serve_mod.make_prefill_step(arch, shape, impl=impl,
                                           device=device, mesh=pod_mesh,
                                           parallel=parallel)
        if pod_mesh is None:
            return (step, (params_meta, _meta_batch(arch, shape))), None, \
                extras
        pspecs = sh.param_partition_specs(params_meta, arch, pod_mesh,
                                          parallel)
        params = sh.local(params_meta, pod_mesh, pspecs)[0]
        bspecs = sh.batch_specs(arch, shape, pod_mesh, parallel)
        batch = sh.local(_meta_batch(arch, shape), pod_mesh, bspecs)[0]
        return (step, (params, batch)), None, extras

    # decode: each pod serves its own global_batch / pods sessions
    batch_local = max(1, shape.global_batch // n_pods)
    step = serve_mod.make_decode_step(arch, device=device, mesh=mesh,
                                      flash_decode=parallel.flash_decode,
                                      batch=batch_local)
    cache_meta = zoo.transformer.init_cache(
        arch, batch_local, shape.seq_len, serve_mod.serve_param_dtype(arch),
        device="meta")
    token = torch.empty((batch_local, 1), dtype=torch.int32, device="meta")
    if mesh is None:                    # one pod, stacked as the step takes
        from repro_torch.core.tree import tree_map
        return (step, (params_meta, tree_map(lambda v: v[None], cache_meta),
                       token[None])), None, extras
    pspecs = sh.param_partition_specs(params_meta, arch, mesh, parallel)
    params = sh.local(params_meta, mesh, pspecs)[0]
    cspecs = serve_mod.session_cache_specs(arch, mesh, batch_local)
    cache = sh.local(cache_meta, mesh, cspecs)[0]
    data = sizes.get("data", 1)
    axes = ("data",) if data > 1 and batch_local % data == 0 else ()
    token = _rank_batch({"t": token}, mesh, axes)["t"]
    rep = None
    if multi_pod:
        rstep = serve_mod.make_replicate_sessions_step(device=device,
                                                       mesh=mesh)
        rep = (rstep, (cache,))
    return (step, (params, cache, token)), rep, extras


def _walk(fn: Callable, args: tuple, device: str, pod_size: Optional[int]
          ) -> Tuple[Dict[str, Any], int, int]:
    """``(walk, argument_bytes, output_bytes)`` of ``fn`` run once on fake
    tensors of ``args``' shapes under the cost walker."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.roofline import CostMode
    with FakeTensorMode():
        fargs = _fake(args, device)
        if hasattr(fn, "prepare"):      # a serve step's once-per-weights
            fn.prepare(fargs[0])        # gather, outside the walk
        mode = CostMode(pod_size)
        mode.track(fargs)
        with mode:
            out = fn(*fargs)
        ins = {id(t): t for t in _tensor_list(fargs)}
        return mode.result(), _bytes(ins.values()), _bytes(
            t for t in _tensor_list(out) if id(t) not in ins)


def _tensor_list(tree) -> list:
    from torch.utils._pytree import tree_flatten
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def run_cell(arch_id: str, shape_id: str, multi_pod: bool, policy: str,
             out_dir: Optional[str] = None, verbose: bool = True,
             overrides: Optional[dict] = None, tag: str = "",
             arch=None, shape=None, mesh_shape: Optional[tuple] = None
             ) -> Dict[str, Any]:
    """Dry-run one cell (the module docstring) and return its record,
    written to ``out_dir`` when given.  ``arch``/``shape`` replace the
    registry's configs of the ids (reduced ones in the tests);
    ``mesh_shape`` replaces the production mesh (``(data, model)`` or
    ``(pod, data, model)``; ``(1,)`` is one card with no mesh)."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch, get_shape, shape_applicable
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.roofline import roofline_terms
    from repro_torch.launch.train import default_parallel
    from repro_torch.models import model_zoo as zoo

    arch = arch or get_arch(arch_id)
    shape = shape or get_shape(shape_id)
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    mesh_name = "x".join(str(s) for s in mesh_shape)
    ok, reason = shape_applicable(arch, shape)
    record: Dict[str, Any] = {"arch": arch_id, "shape": shape_id,
                              "mesh": mesh_name, "policy": policy,
                              "skipped": not ok, "tag": tag}
    if not ok:
        record["skip_reason"] = reason
        if verbose:
            print(f"[skip] {arch_id} × {shape_id}: {reason}")
        return _write(record, out_dir)

    device = fake_device()
    chips = math.prod(mesh_shape)
    if dist.is_initialized():
        raise RuntimeError("run_cell needs a process with no world: it "
                           "joins a fake one")
    parallel = None
    if overrides:
        parallel = dataclasses.replace(default_parallel(arch, shape),
                                       **overrides)
        record["overrides"] = overrides
    t0 = time.time()
    mesh_mod.init_fake_world(chips, device)
    try:
        mesh = None
        if chips > 1:
            axes = ("pod", "data", "model")[-len(mesh_shape):]
            mesh = mesh_mod.make_mesh_compat(mesh_shape, axes)
            try:
                zoo.check_mesh(arch, mesh)
            except ValueError as e:
                record.update(ok=None, refused=True, chips=chips,
                              refuse_reason=str(e))
                if verbose:
                    print(f"[refused] {arch_id} × {shape_id} ({mesh_name}): "
                          f"{e}")
                return _write(record, out_dir)
        pod_size = chips // mesh_shape[0] if len(mesh_shape) == 3 else None
        run, rep, extras = _build_cell(arch, shape, mesh, policy,
                                       parallel=parallel, device=device)
        walk, arg_bytes, out_bytes = _walk(run[0], run[1], device, pod_size)
        t_run = time.time() - t0
        mf = zoo.model_flops(arch, shape)
        terms = roofline_terms(walk, mf, chips)
        record.update(
            ok=True, chips=chips, build_s=round(t_run, 1),
            memory={"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                    "peak_bytes": walk["peak_bytes"],
                    "per_device_total": walk["peak_bytes"],
                    "fits": walk["peak_bytes"] <= DEVICE_MEMORY_BYTES},
            hlo=walk, roofline=terms, model_flops=mf, **extras)
        if rep is not None:
            record["replication_step"] = _walk(rep[0], rep[1], device,
                                               pod_size)[0]
        if verbose:
            print(f"[ok]   {arch_id:18s} × {shape_id:12s} mesh="
                  f"{mesh_name:8s} run={t_run:6.1f}s "
                  f"mem/dev={walk['peak_bytes'] / 2**30:8.2f}GiB "
                  f"flops/dev={walk['flops_per_device']:.3e} "
                  f"coll/dev={walk['collective_bytes_per_device']:.3e}B "
                  f"dominant={terms['dominant']}")
    except Exception as e:
        record.update(ok=False, error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[FAIL] {arch_id} × {shape_id} ({mesh_name}): "
                  f"{record['error']}")
    finally:
        mesh_mod.close_world()
    return _write(record, out_dir)


def _write(record: Dict[str, Any], out_dir: Optional[str]
           ) -> Dict[str, Any]:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = record.get("tag") or ""
        name = (f"{record['arch']}_{record['shape']}_{record['mesh']}"
                f"_{record.get('policy', '-')}{('_' + tag) if tag else ''}"
                f".json").replace("/", "-")
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(record, f, indent=1, default=str)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--policy", default="replicated",
                    choices=["replicated", "peer_fetch", "cloud_central"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    ap.add_argument("--set", action="append", default=[],
                    help="ParallelConfig overrides, e.g. --set moe_impl=ep "
                         "--set remat=block --set fsdp=false")
    args = ap.parse_args(argv)
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = ({"true": True, "false": False}.get(v.lower(), v))

    from repro_torch.configs import ARCH_IDS, SHAPES

    if args.all:
        cells = [(a, s.name) for a in ARCH_IDS for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_fail, refused = 0, []
    for mp in meshes:
        for a, s in cells:
            rec = run_cell(a, s, mp, args.policy, args.out,
                           overrides=overrides or None, tag=args.tag)
            if rec.get("refused"):
                refused.append(f"{a} × {s} ({rec['mesh']}): "
                               f"{rec['refuse_reason']}")
            elif not rec.get("ok", False) and not rec.get("skipped"):
                n_fail += 1
    if refused:
        print(f"\nrefused ({len(refused)}):")
        for line in refused:
            print(f"  {line}")
    print(f"\ndry-run complete: {len(cells) * len(meshes)} cells, "
          f"{n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
