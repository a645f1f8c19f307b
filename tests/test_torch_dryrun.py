"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's lowered and compiled cells.

ONE reference subprocess (8 forced host devices) builds the same reduced
cells with ``repro.launch.dryrun._build_cell`` on test meshes, compiles
them and walks their HLO (``analyze_hlo_text``), while the port runs rank
0's step on fake tensors in fake worlds of 4 and 8 ranks:

* a rank's ``argument_bytes`` (its state or weights and its batch) equal
  to ``memory_analysis().argument_size_in_bytes`` (no leaf of these cells
  has a layout that differs between the packages);
* matmul FLOPs a rank within 5 % of the reference's ``flops_per_device``
  for a prefill cell and 10 % for a train cell (remat may recompute);
* a REPLICATED (2, 2, 2) train cell: pod-crossing bytes 0 on the hot step
  and above 0 on the replication step, on both packages; the decode cell's
  session ring likewise on the port;
* where ``model`` exceeds the KV heads (the reduced internlm2's 2 at
  model 4: rep 2) the cells build: a prefill's argument bytes equal the
  reference's (the parameters' storage is the reference's), its matmul
  FLOPs within 5 % of the reference's plus the rep-fold K/V projection
  (each rank projects its group's head whole, the reference 1/model of
  the heads' columns), and a decode cell's argument bytes the
  reference's plus (rep - 1) / rep of the rank's K/V cache (the rank holds
  its group's head whole, the reference 1/model of the heads' columns);
* a width ``model`` does not divide is ``refused``, not ``ok: False``; a
  spec that cuts a leaf along the wrong dim is ``ok: False`` with its
  error; no fake world outlives its cell.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist

from repro_torch import configs as tc
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl

REPO = pathlib.Path(__file__).resolve().parents[1]
BATCH = 8
# (name, arch, shape, mesh)
CELLS = [("prefill", "internlm2-1.8b", "prefill_32k", (2, 2)),
         ("train", "internlm2-1.8b", "train_4k", (2, 2)),
         ("pods", "internlm2-1.8b", "train_4k", (2, 2, 2))]
FLOP_TOL = {"prefill": 0.05, "train": 0.10, "pods": 0.10}
#: the cells where model exceeds the KV heads (2 at model 4)
KV_CELLS = [("prefill_kv", "internlm2-1.8b", "prefill_32k", (1, 4)),
            ("decode_kv", "internlm2-1.8b", "decode_32k", (1, 4))]

SCRIPT = textwrap.dedent("""
    import os, json, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    jax.devices()        # 8 devices before the module sets its own count
    from repro.launch import dryrun as rd
    from repro.launch.roofline import analyze_hlo_text
    from repro.launch.mesh import make_test_mesh
    from repro import configs as rc
    out = {}
    for name, arch_id, shape_id, ms in %r:
        arch = rc.reduced(rc.get_arch(arch_id))
        shape = dataclasses.replace(rc.reduced_shape(rc.get_shape(shape_id)),
                                    global_batch=%d)
        mesh = make_test_mesh(ms, ("pod", "data", "model")[-len(ms):])
        lower, rep, _ = rd._build_cell(arch, shape, mesh, "replicated")
        comp = lower().compile()
        pod = 4 if len(ms) == 3 else None
        rec = {"argument_bytes":
               comp.memory_analysis().argument_size_in_bytes,
               "walk": analyze_hlo_text(comp.as_text(), pod_size=pod)}
        if rep is not None:
            rec["rep"] = analyze_hlo_text(rep().compile().as_text(),
                                          pod_size=pod)
        out[name] = rec
    print(json.dumps(out))
""" % ([list(c[:3]) + [list(c[3])] for c in CELLS + KV_CELLS], BATCH))


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", SCRIPT], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()


def _ref(proc) -> dict:
    if not hasattr(proc, "result"):
        out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, err[-4000:]
        proc.result = json.loads(out.splitlines()[-1])
    return proc.result


def _shape(shape_id: str, batch: int = BATCH):
    return dataclasses.replace(tc.reduced_shape(tc.get_shape(shape_id)),
                               global_batch=batch)


def _cell(arch_id, shape_id, mesh_shape, arch=None, batch=BATCH, **kw):
    rec = dryrun.run_cell(arch_id, shape_id, len(mesh_shape) == 3,
                          kw.pop("policy", "replicated"),
                          arch=arch or tc.reduced(tc.get_arch(arch_id)),
                          shape=_shape(shape_id, batch),
                          mesh_shape=mesh_shape, verbose=False, **kw)
    assert not dist.is_initialized()
    return rec


@pytest.fixture(scope="module")
def port_cells(reference):
    return {name: _cell(a, s, ms) for name, a, s, ms in CELLS + KV_CELLS}


@pytest.mark.parametrize("name", [c[0] for c in CELLS + KV_CELLS[:1]])
def test_argument_bytes_equal_the_reference(reference, port_cells, name):
    got = port_cells[name]
    assert got["ok"] is True, got.get("traceback")
    want = _ref(reference)[name]
    assert got["memory"]["argument_bytes"] == want["argument_bytes"]


@pytest.mark.parametrize("name", [c[0] for c in CELLS])
def test_matmul_flops_near_the_reference(reference, port_cells, name):
    got = port_cells[name]["hlo"]["flops_per_device"]
    want = _ref(reference)[name]["walk"]["flops_per_device"]
    print(f"{name}: port {got:.6e}, reference {want:.6e}")
    assert abs(got - want) <= FLOP_TOL[name] * want


def test_replicated_pods_cross_only_in_the_replication_step(reference,
                                                            port_cells):
    got, want = port_cells["pods"], _ref(reference)["pods"]
    assert got["hlo"]["pod_crossing_bytes_per_device"] == 0
    assert want["walk"]["pod_crossing_bytes_per_device"] == 0
    assert got["replication_step"]["pod_crossing_bytes_per_device"] > 0
    assert want["rep"]["pod_crossing_bytes_per_device"] > 0
    assert got["hlo"]["collective_count"] > 0     # the pod's own TP/DP
    assert got["chips"] == 8 and got["mesh"] == "2x2x2"


def test_decode_sessions_ring_crosses_pods():
    rec = _cell("internlm2-1.8b", "decode_32k", (2, 2, 2))
    assert rec["ok"] is True, rec.get("traceback")
    assert rec["hlo"]["pod_crossing_bytes_per_device"] == 0
    rep = rec["replication_step"]
    assert rep["pod_crossing_bytes_per_device"] > 0
    assert rep["collective_ops"] == {
        "collective-permute": rep["pod_crossing_bytes_per_device"]}


def test_refused_width_is_not_a_failure():
    rec = _cell("whisper-tiny", "prefill_32k", (1, 4),    # 6 (KV) heads
                arch=tc.get_arch("whisper-tiny"))
    assert rec["ok"] is None and rec["refused"] is True
    assert "key/value heads" in rec["refuse_reason"]
    assert "error" not in rec


def test_kv_heads_below_model_build(port_cells):
    """The reduced internlm2's 2 KV heads at model 4, refused until the
    KV groups, build: each rank holds its group's head."""
    for name, *_ in KV_CELLS:
        rec = port_cells[name]
        assert rec["ok"] is True and "refused" not in rec, \
            rec.get("traceback")
        assert rec["hlo"]["collective_count"] > 0


def test_kv_replicated_cells_against_the_reference(reference, port_cells):
    """rep = 2: the prefill's FLOPs are the reference's plus the rep-fold
    K/V projection (each rank projects its head's Dh columns where the
    reference projects Dh / rep), within the prefill's 5 %; the decode
    cell's argument bytes are the reference's plus the rep-fold K/V cache
    (each rank holds its head whole, the reference 1/model of the heads'
    columns: rep x its bytes)."""
    from repro_torch.models import transformer
    arch = tc.reduced(tc.get_arch("internlm2-1.8b"))
    rep = transformer.kv_split(arch, 4)[1]
    assert rep == 2
    L, d, dh = arch.num_layers, arch.d_model, arch.resolved_head_dim
    ref = _ref(reference)
    shape = _shape("prefill_32k")
    extra = L * 2 * 2 * shape.global_batch * shape.seq_len * d * dh * \
        (1 - 1 / rep)
    got = port_cells["prefill_kv"]["hlo"]["flops_per_device"]
    want = ref["prefill_kv"]["walk"]["flops_per_device"]
    print(f"prefill_kv: port {got:.6e}, reference {want:.6e} + K/V "
          f"{extra:.6e}")
    assert abs(got - (want + extra)) <= FLOP_TOL["prefill"] * want
    shape = _shape("decode_32k")
    cache = 2 * L * shape.global_batch * shape.seq_len * dh * 2  # bf16 K, V
    got = port_cells["decode_kv"]["memory"]["argument_bytes"]
    want = ref["decode_kv"]["argument_bytes"]
    assert got - want == cache - cache // rep


def test_mutant_spec_fails_the_cell(monkeypatch):
    """A spec that cuts the query projection (L, d, H·Dh) on d instead of
    its heads hands the step a wrongly shaped shard: ``ok: False``."""
    from repro_torch.parallel import sharding as sh
    real = sh.param_partition_specs

    def wrong(params, arch, mesh, parallel):
        specs = real(params, arch, mesh, parallel)
        return sh.tree_map_with_path(
            lambda path, s: sh.P(None, "model", None)
            if path[-1] == "wq" else s, specs)
    monkeypatch.setattr(sh, "param_partition_specs", wrong)
    rec = _cell("internlm2-1.8b", "prefill_32k", (2, 2))
    assert rec["ok"] is False
    assert rec["error"] and rec["traceback"]


def test_one_card_peak_equals_a_real_cpu_step(monkeypatch):
    """The dry-run's peak on one card (no mesh) is the walker's peak of
    the same step on real CPU tensors (fake CPU tensors on any build)."""
    from repro_torch.launch import train
    from repro_torch.models import model_zoo as zoo
    arch = tc.reduced(tc.get_arch("internlm2-1.8b"))
    shape = _shape("train_4k", 2)
    monkeypatch.setattr(dryrun, "fake_device", lambda: "cpu")
    rec = dryrun.run_cell("internlm2-1.8b", "train_4k", False, "replicated",
                          arch=arch, shape=shape, mesh_shape=(1,),
                          verbose=False)
    assert rec["ok"] is True, rec.get("traceback")
    assert not dist.is_initialized()
    par = train.default_parallel(arch, shape)
    step, _ = train.make_train_step(arch, shape, parallel=par,
                                    device="cpu")
    state = train.init_state(arch, 0, par, device="cpu")
    batch = zoo.example_batch(arch, shape, torch.Generator().manual_seed(0))
    real = rl.analyze_step(step, state, batch)
    assert rec["memory"]["argument_bytes"] == sum(
        t.numel() * t.element_size() for t in
        torch.utils._pytree.tree_flatten((state, batch))[0])
    assert rec["hlo"]["flops_per_device"] == real["flops_per_device"]
    assert abs(rec["memory"]["peak_bytes"] - real["peak_bytes"]) <= \
        0.01 * real["peak_bytes"]


def test_cli_lists_refusals_and_ends_with_the_summary(capsys):
    assert dryrun.main(["--arch", "whisper-tiny", "--shape",
                        "decode_32k"]) == 0
    assert dryrun.main(["--arch", "gemma-7b", "--shape",
                        "long_500k"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "dry-run complete: 1 cells, 0 failures"
    assert any("[refused] whisper-tiny × decode_32k (16x16)" in line
               for line in out)
    assert any(line.startswith("[skip] gemma-7b × long_500k")
               for line in out)
    assert not dist.is_initialized()


def test_fake_world_takes_the_mesh_and_stages_nothing():
    """A fake world of 512 ranks builds the (2, 16, 16) production mesh;
    its backend is ``fake`` for every device type, so the collectives
    stage no CUDA tensor through host memory (the transport is read from
    the backend); ``close_world`` leaves it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.parallel import collectives as col
    mesh_mod.init_fake_world(512, "cuda")
    try:
        assert mesh_mod.world_device() == torch.device("cuda")
        mesh = mesh_mod.make_production_mesh(multi_pod=True)
        assert mesh_mod.axis_sizes(mesh) == {"pod": 2, "data": 16,
                                             "model": 16}
        group = mesh.get_group("pod")
        assert dist.get_process_group_ranks(group) == [0, 256]
        assert col._backend(group, "cuda") == "fake"
        with FakeTensorMode():
            assert not col.staged(group, torch.empty(4, device="cuda"))
    finally:
        mesh_mod.close_world()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no world"):
        mesh_mod.world_device()


@pytest.mark.parametrize("arch_id,shape_id,mesh_shape", [
    ("internlm2-1.8b", "decode_32k", (1,)),
    ("xlstm-350m", "prefill_32k", (2, 2))])
def test_step_caches_run_eagerly_on_fake_tensors(arch_id, shape_id,
                                                  mesh_shape):
    """The one-card decode pod-step and xlstm's sLSTM scan go through a
    ``StepCache``: on fake tensors under the walker each runs its eager
    body and makes no entry (nothing is captured)."""
    from repro_torch.analysis.jitprof import CompileCounter
    from repro_torch.models.transformer import plan
    with CompileCounter() as cc:
        rec = _cell(arch_id, shape_id, mesh_shape, batch=4,
                    overrides={"attn_impl": "flash"})
    assert rec["ok"] is True, rec.get("traceback")
    assert cc.events == 0
    assert rec["hlo"]["flops_per_device"] > 0
    if arch_id == "xlstm-350m":      # FLASH: the mLSTM layers' kernel
        p = plan(tc.reduced(tc.get_arch(arch_id)))
        assert rec["hlo"]["kernel_launches"] == {
            "mlstm_chunk_bhsd": p["groups"] * p["mlstm_per"]}
