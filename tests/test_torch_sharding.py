"""The port's sharding rules (``repro_torch.parallel.sharding``) against the
reference's, spec for spec: the twin of ``tests/test_sharding_rules.py``.

For every architecture of the registry, on shape-only stand-ins of the
single-pod (data 16, model 16) and multi-pod (pod 2, data 16, model 16)
production meshes (no world is needed: the rules read axis sizes only),
the parameter specs (fsdp off and on), the optimiser-state specs (the
train defaults' ZeRO-1 tree, and ``opt_state_specs`` with fsdp), the
cache specs (two (batch, seq) geometries, with and without
``prefer_seq``) and the batch specs of every shape (``seq_shard`` off and
on) equal the reference's leaf for leaf.  The port's trees are on the
``meta`` device, the reference's from ``jax.eval_shape``; the divisibility
property of ``test_sharding_rules.py`` is checked on the port's specs too.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as RefP

from repro import configs as rc
from repro.launch import train as ref_train
from repro.models import model_zoo as ref_zoo
from repro.parallel import sharding as ref_sh
from repro_torch import configs as tc
from repro_torch.launch import train
from repro_torch.models import model_zoo as zoo
from repro_torch.parallel import sharding as sh

jax.config.update("jax_platform_name", "cpu")

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


def _mesh(name):
    sizes = MESHES[name]

    class FakeMesh:
        """Shape-only stand-in (the rules only read the axis sizes)."""
        shape = sizes
        axis_names = tuple(sizes)
    return FakeMesh


def _ref_flat(specs) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, RefP))[0]
    return {tuple(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            tuple(spec) for path, spec in leaves}


def _port_flat(specs, path=()) -> dict:
    if isinstance(specs, sh.P):
        return {path: tuple(specs)}
    out = {}
    for k, v in specs.items():
        out.update(_port_flat(v, path + (str(k),)))
    return out


def _shapes_flat(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes_flat(v, path + (str(k),)))
        return out
    return {path: tuple(tree.shape)}


def _same(port_specs, ref_specs, port_tree, sizes, what):
    got, want = _port_flat(port_specs), _ref_flat(ref_specs)
    assert got == want, what
    shapes = _shapes_flat(port_tree)
    for path, spec in got.items():
        for d, axis in enumerate(spec):
            if axis is None:
                continue
            total = 1
            for a in (axis if isinstance(axis, tuple) else (axis,)):
                total *= sizes[a]
            assert shapes[path][d] % total == 0, (what, path, spec)
    return len(got)


def _params(arch_id):
    port = zoo.init_params(tc.get_arch(arch_id), dtype=torch.bfloat16,
                           device="meta")
    ref = jax.eval_shape(lambda: ref_zoo.init_params(
        rc.get_arch(arch_id), jax.random.PRNGKey(0), dtype=jnp.bfloat16))
    return port, ref


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch_id", rc.ARCH_IDS)
def test_param_specs_match_reference(arch_id, mesh):
    port, ref = _params(arch_id)
    for fsdp in (False, True):
        n = _same(sh.param_partition_specs(port, tc.get_arch(arch_id),
                                           _mesh(mesh),
                                           tc.ParallelConfig(fsdp=fsdp)),
                  ref_sh.param_partition_specs(ref, rc.get_arch(arch_id),
                                               _mesh(mesh),
                                               rc.ParallelConfig(fsdp=fsdp)),
                  port, MESHES[mesh], f"{arch_id} params fsdp={fsdp}")
        assert n > 3


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch_id", rc.ARCH_IDS)
def test_opt_state_specs_match_reference(arch_id, mesh):
    arch_t, arch_r = tc.get_arch(arch_id), rc.get_arch(arch_id)
    par_t = train.default_parallel(arch_t, tc.SHAPES[0])
    par_r = ref_train.default_parallel(arch_r, rc.SHAPES[0])
    assert par_t == tc.ParallelConfig(**vars(par_r))
    sshape_t = train.state_shapes(arch_t, par_t)
    sshape_r = ref_train.state_shapes(arch_r, par_r)
    _same(train.opt_specs_tree(sshape_t["opt"], arch_t, _mesh(mesh), par_t),
          ref_train.opt_specs_tree(sshape_r["opt"], arch_r, _mesh(mesh),
                                   par_r),
          sshape_t["opt"], MESHES[mesh], f"{arch_id} opt")
    _same(train.state_specs(sshape_t, arch_t, _mesh(mesh), par_t),
          ref_train.state_specs(sshape_r, arch_r, _mesh(mesh), par_r),
          sshape_t, MESHES[mesh], f"{arch_id} state")
    port, ref = _params(arch_id)
    for zero1, fsdp in ((True, False), (False, False), (True, True)):
        _same(sh.opt_state_specs(port, arch_t, _mesh(mesh),
                                 tc.ParallelConfig(zero1=zero1, fsdp=fsdp)),
              ref_sh.opt_state_specs(ref, arch_r, _mesh(mesh),
                                     rc.ParallelConfig(zero1=zero1,
                                                       fsdp=fsdp)),
              port, MESHES[mesh], f"{arch_id} moments zero1={zero1}")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch_id", rc.ARCH_IDS)
def test_cache_specs_match_reference(arch_id, mesh):
    arch_t, arch_r = tc.get_arch(arch_id), rc.get_arch(arch_id)
    for batch, seq in ((128, 1024), (32, 2048)):
        port = zoo.init_cache(arch_t, batch, seq, device="meta")
        ref = jax.eval_shape(lambda: ref_zoo.init_cache(arch_r, batch, seq))
        for prefer_seq in (False, True):
            _same(sh.cache_partition_specs(port, arch_t, _mesh(mesh), batch,
                                           prefer_seq=prefer_seq),
                  ref_sh.cache_partition_specs(ref, arch_r, _mesh(mesh),
                                               batch, prefer_seq=prefer_seq),
                  port, MESHES[mesh],
                  f"{arch_id} cache {batch}x{seq} prefer_seq={prefer_seq}")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch_id", rc.ARCH_IDS)
def test_batch_specs_match_reference(arch_id, mesh):
    arch_t, arch_r = tc.get_arch(arch_id), rc.get_arch(arch_id)
    for shape_t, shape_r in zip(tc.SHAPES, rc.SHAPES):
        for seq_shard in (False, True):
            got = sh.batch_specs(arch_t, shape_t, _mesh(mesh),
                                 tc.ParallelConfig(seq_shard=seq_shard))
            want = ref_sh.batch_specs(arch_r, shape_r, _mesh(mesh),
                                      rc.ParallelConfig(seq_shard=seq_shard))
            assert _port_flat(got) == _ref_flat(want), \
                (arch_id, shape_t.name, seq_shard)


def test_whisper_vocab_not_sharded():
    """51865 % 16 != 0: the embedding falls back to replication (the
    divisibility guard), as in the reference."""
    arch = tc.get_arch("whisper-tiny")
    pshape = zoo.init_params(arch, device="meta")
    specs = sh.param_partition_specs(pshape, arch, _mesh("single"),
                                     tc.ParallelConfig())
    assert specs["embed"][0] is None


def test_kimi_experts_are_expert_parallel():
    """384 experts over model 16: the stacked (L, E, d, f) expert weights
    shard E, the router stays whole."""
    arch = tc.get_arch("kimi-k2-1t-a32b")
    pshape = zoo.init_params(arch, dtype=torch.bfloat16, device="meta")
    specs = sh.param_partition_specs(pshape, arch, _mesh("multi"),
                                     tc.ParallelConfig())
    moe = specs["blocks"]["moe"]
    assert tuple(moe["w_gate"]) == (None, "model", None, None)
    assert tuple(moe["w_down"]) == (None, "model", None, None)
    assert tuple(moe["router"]) == (None, None, None)
