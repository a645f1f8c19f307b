"""The port's cost walker (``repro_torch.launch.roofline``) against the
reference's HLO walker.

ONE reference subprocess (4 forced host devices) runs
``repro.launch.roofline.analyze_jit`` on the same programs while the port
walks them: a (m, k) @ (k, n) matmul and a 12-step scan of them (FLOPs
equal: the port's loop runs every step under the walker, the reference
multiplies the while body by its trip count), an elementwise product
(bytes equal), and ``psum``/``all_gather``/``psum_scatter`` over each axis
of a (pod 2, model 2) mesh, the port in a gloo world of 4 CPU ranks
against ``shard_map`` on the reference: operand bytes, pod-crossing bytes
and the all-reduce's and all-gather's wire bytes equal.  The port's
``psum_scatter`` is an all-reduce and a slice (``collectives.
_reduce_scatter``: gloo has no reduce-scatter in every build), so its wire
bytes are the all-reduce's, twice the reference's reduce-scatter: the
walker counts what runs.

Also pinned: the served path's costs (``serving_costs``) against the
reference's shape bounds (``tests/test_roofline_walker.py``), each kernel
wrapper on fake tensors (the right shape, no launch, its analytic work
charged alike on the plain path), no walker no record, and no TPU peak in
the port.
"""
import json
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import kernels
from repro_torch.kernels.enoki_merge.kernel import enoki_merge_rows
from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd
from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunk_bhsd
from repro_torch.kernels.ssd_chunk.kernel import ssd_chunk_bhcp
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import roofline as rl

REPO = pathlib.Path(__file__).resolve().parents[1]
M, K, N, L = 64, 32, 16, 12

SCRIPT = textwrap.dedent("""
    import os, json, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.launch.roofline import analyze_jit
    from repro.launch.mesh import make_test_mesh
    from repro.parallel.sharding import shard_map_compat
    M, K, N, L = %d, %d, %d, %d
    f32 = jnp.float32
    S = jax.ShapeDtypeStruct
    out = {}
    out["mm"] = analyze_jit(jax.jit(lambda a, b: a @ b), S((M, K), f32),
                            S((K, N), f32))
    def scan(x, ws):
        y, _ = jax.lax.scan(lambda x, w: (x @ w, None), x, ws)
        return y
    out["scan"] = analyze_jit(jax.jit(scan), S((M, K), f32),
                              S((L, K, K), f32))
    out["mul"] = analyze_jit(jax.jit(lambda a, b: a * b), S((M, K), f32),
                             S((M, K), f32))
    mesh = make_test_mesh((2, 2), ("pod", "model"))
    def body(fn, axis, out_spec):
        return jax.jit(shard_map_compat(fn, mesh=mesh, in_specs=P(axis),
                                        out_specs=out_spec, check_vma=False,
                                        axis_names={axis}))
    for axis in ("pod", "model"):
        x = S((2 * M, K), f32)
        out[f"psum/{axis}"] = analyze_jit(
            body(lambda v: jax.lax.psum(v, axis), axis, P()), x, pod_size=2)
        out[f"all_gather/{axis}"] = analyze_jit(
            body(lambda v: jax.lax.all_gather(v, axis), axis, P()), x,
            pod_size=2)
        out[f"psum_scatter/{axis}"] = analyze_jit(
            body(lambda v: jax.lax.psum_scatter(v, axis, scatter_dimension=0,
                                                tiled=True), axis, P(axis)),
            x, pod_size=2)
    print(json.dumps(out))
""" % (M, K, N, L))


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


@pytest.fixture(scope="module")
def port_collectives(reference, tmp_path_factory):
    from torch_roofline_ranks import collectives_world
    store = tmp_path_factory.mktemp("roofline") / "world.store"
    return port_mesh.spawn_world(collectives_world, 4, f"file://{store}",
                                 device="cpu", timeout_s=180, threads=1)[0]


def test_matmul_flops_equal_the_reference(reference):
    a, b = torch.randn(M, K), torch.randn(K, N)
    got = rl.analyze_step(torch.matmul, a, b)
    want = _ref(reference)["mm"]
    assert got["flops_per_device"] == want["flops_per_device"] == \
        2 * M * K * N
    assert got["bytes_per_device"] == want["bytes_per_device"]


def test_scanned_matmul_flops_equal_the_reference(reference):
    """12 steps under the walker against the reference's trip-count-aware
    walk of the while body; the port never guesses a trip count."""
    x, ws = torch.randn(M, K), torch.randn(L, K, K)

    def loop(x, ws):
        for w in ws.unbind(0):
            x = x @ w
        return x
    got = rl.analyze_step(loop, x, ws)
    want = _ref(reference)["scan"]
    assert got["flops_per_device"] == want["flops_per_device"] == \
        L * 2 * M * K * K
    assert want["unknown_trip_counts"] == got["unknown_trip_counts"] == 0


def test_elementwise_bytes_equal_the_reference(reference):
    a, b = torch.randn(M, K), torch.randn(M, K)
    got = rl.analyze_step(torch.mul, a, b)
    want = _ref(reference)["mul"]
    assert got["bytes_per_device"] == want["bytes_per_device"] == \
        3 * M * K * 4
    assert got["flops_per_device"] == want["flops_per_device"] == 0


@pytest.mark.parametrize("name", ["psum", "all_gather", "psum_scatter"])
@pytest.mark.parametrize("axis", ["pod", "model"])
def test_collective_bytes_equal_the_reference(reference, port_collectives,
                                              name, axis):
    got = port_collectives[f"{name}/{axis}"]
    want = _ref(reference)[f"{name}/{axis}"]
    print(name, axis, got["collective_ops"], want["collective_ops"])
    assert got["collective_bytes_per_device"] == \
        want["collective_bytes_per_device"] == M * K * 4
    assert got["pod_crossing_bytes_per_device"] == \
        want["pod_crossing_bytes_per_device"]
    assert (got["pod_crossing_bytes_per_device"] > 0) == (axis == "pod")
    assert got["collective_count"] == 1
    wire = want["collective_wire_bytes_per_device"]
    if name == "psum_scatter":       # an all-reduce and a slice on gloo
        assert got["collective_ops"] == {"all-reduce": M * K * 4}
        wire *= 2
    assert got["collective_wire_bytes_per_device"] == wire


def test_serving_costs_keep_the_reference_shape():
    """``tests/test_roofline_walker.py``'s bounds on the port's served
    path: the fold ~linear in the bucket, the aligned merge (one kernel)
    well under the O(S^2) fallback, K-way merges ~linear in K."""
    rows = rl.serving_costs(device="cpu")
    by = {(r["program"], r["size"]): r for r in rows}
    for r in rows:
        assert r["unknown_trips"] == 0, r
    scan8 = by[("fold", "bucket=8")]["bytes"]
    scan64 = by[("fold", "bucket=64")]["bytes"]
    assert 4.0 <= scan64 / scan8 <= 12.0, (scan8, scan64)
    al4 = by[("merge/aligned", "K=4")]["bytes"]
    fb4 = by[("merge/fallback", "K=4")]["bytes"]
    assert al4 < 0.6 * fb4, (al4, fb4)
    al8 = by[("merge/aligned", "K=8")]["bytes"]
    assert al4 < al8 <= 3.0 * al4, (al4, al8)
    for k in (1, 4, 8):
        assert by[("merge/aligned", f"K={k}")]["kernel_launches"] == 1
        assert by[("merge/fallback", f"K={k}")]["kernel_launches"] == 0


def _kernel_calls(dev_tensors):
    """(name, call, analytic (flops, bytes)) of each wrapper at a small
    shape, its operands made by ``dev_tensors(shape, dtype)``."""
    t = dev_tensors
    B, H, KV, S, D = 1, 4, 2, 64, 32
    q, k, v = t((B, H, S, D), torch.float32), t((B, KV, S, D),
                                                  torch.float32), \
        t((B, KV, S, D), torch.float32)
    x, a = t((1, 2, 48, 16), torch.float32), t((1, 2, 48), torch.float32)
    bc = t((1, 1, 48, 8), torch.float32)
    mq = t((1, 2, 32, 16), torch.float32)
    gates = t((1, 2, 32), torch.float32)
    rows = 8
    acc = (t((rows,), torch.int32), t((rows, 4), torch.float32),
           t((rows,), torch.int32), t((rows,), torch.int32),
           t((3,), torch.int32))
    snaps = [tuple(t(a_.shape, a_.dtype) for a_ in acc) for _ in range(2)]
    return [
        ("flash_attention_bhsd", lambda: flash_attention_bhsd(q, k, v),
         rl.flash_work(B, H, KV, S, S, D, 4, True, 0)),
        ("ssd_chunk_bhcp", lambda: ssd_chunk_bhcp(x, a, bc, bc, chunk=16),
         rl.ssd_work(1, 2, 48, 16, 8, 16, 4)),
        ("mlstm_chunk_bhsd",
         lambda: mlstm_chunk_bhsd(mq, mq, mq, gates, gates, chunk=16),
         rl.mlstm_work(1, 2, 32, 16, 16, 4)),
        ("enoki_merge_rows", lambda: enoki_merge_rows(acc, snaps),
         rl.merge_work(2, rows, 16, 3)),
    ]


def _launch_counts():
    return (flash_attention_bhsd.launches, ssd_chunk_bhcp.launches,
            mlstm_chunk_bhsd.launches, enoki_merge_rows.launches)


def test_kernel_wrappers_on_fake_tensors_charge_the_plain_paths_work():
    """Under the walker each wrapper is one op of its analytic work: on
    fake tensors (a dry-run's) it returns the right shapes and launches
    nothing; on real CPU tensors the plain version runs and its aten ops
    are not counted, so both charge the same."""
    before = _launch_counts()
    with FakeTensorMode():
        fake = _kernel_calls(lambda s, d: torch.empty(s, dtype=d))
        for name, call, (flops, nbytes) in fake:
            walk = rl.CostMode()
            with walk:
                out = call()
            res = walk.result()
            assert res["kernel_launches"] == {name: 1}
            assert res["flops_per_device"] == flops
            assert res["bytes_per_device"] == nbytes
            first = out[0] if isinstance(out, tuple) else out
            assert kernels.is_fake(first)
    assert _launch_counts() == before
    shapes = {"flash_attention_bhsd": [(1, 4, 64, 32)],
              "ssd_chunk_bhcp": [(1, 2, 48, 16), (1, 2, 16, 8)],
              "mlstm_chunk_bhsd": [(1, 2, 32, 16), (1, 2, 16, 16),
                                   (1, 2, 16), (1, 2)]}
    gen = torch.Generator().manual_seed(0)

    def real(s, d):
        if d == torch.int32:
            return torch.randint(0, 5, s, dtype=d, generator=gen)
        return torch.randn(s, dtype=d, generator=gen)
    for name, call, (flops, nbytes) in _kernel_calls(real):
        walk = rl.CostMode()
        with walk:
            out = call()
        res = walk.result()
        assert res["kernel_launches"] == {name: 1}, name
        assert (res["flops_per_device"], res["bytes_per_device"]) == \
            (flops, nbytes), name
        if name in shapes:
            got = [tuple(o.shape) for o in torch.utils._pytree.tree_flatten(
                out)[0]]
            assert got == shapes[name], (name, got)
    assert _launch_counts() == before


def test_merge_launches_count_snapshot_groups():
    from repro_torch.kernels.enoki_merge.kernel import MAX_K
    with FakeTensorMode():
        acc = (None, torch.empty(4, 8), None, torch.empty(4,
                                                          dtype=torch.int32),
               None)
        snaps = [acc] * (MAX_K + 1)
        res = rl.analyze_step(enoki_merge_rows, acc, snaps)
    assert res["kernel_launches"] == {"enoki_merge_rows": 2}


def test_no_walker_no_record():
    assert kernels.WALKER is None
    walk = rl.CostMode()
    with walk:
        torch.randn(4, 4) @ torch.randn(4, 4)
    assert kernels.WALKER is None
    seen = walk.result()
    q = torch.randn(1, 2, 16, 32)
    flash_attention_bhsd(q, q, q)
    torch.randn(8, 8) @ torch.randn(8, 8)
    assert walk.result() == seen
    with pytest.raises(RuntimeError, match="active already"):
        with walk:
            with rl.CostMode():
                pass
    assert kernels.WALKER is None


def test_peak_bytes_tracks_live_storage():
    def step(x):
        y = x * 2               # + 4 KB, live
        z = y + 1               # + 4 KB
        del y                   # - 4 KB
        w = z.view(-1)          # a view: no new storage
        return (w * 3).sum()    # + 4 KB, then a 0-d of 4 bytes
    x = torch.randn(32, 32)     # 4 KB, an argument: live from the start
    res = rl.analyze_step(step, x)
    assert res["peak_bytes"] == 3 * 4096 + 4


def test_roofline_terms_at_the_cards_data_sheet_peaks():
    a = {"flops_per_device": 989e12, "bytes_per_device": 3.35e12 / 2,
         "collective_bytes_per_device": 450e9 + 100e9,
         "collective_bytes_inter_node": 100e9}
    t = rl.roofline_terms(a, model_flops_global=2 * 989e12, chips=2)
    assert t["compute_s"] == 1.0 and t["memory_s"] == 0.5
    assert t["collective_in_node_s"] == 1.0
    assert t["collective_inter_node_s"] == 2.0
    assert t["dominant"] == "collective_s" and t["bound_step_s"] == 3.0
    assert t["useful_flops_ratio"] == 1.0
    assert t["roofline_fraction"] == pytest.approx(1 / 3)
    t = rl.roofline_terms(a, 2 * 989e12, 2, inter_pod=True)
    assert t["collective_s"] == 550e9 / rl.INTER_NODE_BYTES_PER_S


def test_attention_pairs_counts_the_kernels_mask():
    assert rl.attention_pairs(4, 4, True, 0) == 10
    assert rl.attention_pairs(4, 4, False, 0) == 16
    assert rl.attention_pairs(4, 4, True, 2) == 7
    assert rl.attention_pairs(3, 5, False, 0) == 15


def test_no_tpu_peak_in_the_port():
    pat = re.compile(r"\b(197e12|819e9|50e9|197\.0e12|819\.0e9)\b")
    bad = []
    for path in sorted((REPO / "src" / "repro_torch").rglob("*.py")):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if pat.search(line):
                bad.append(f"{path.relative_to(REPO)}:{i}: {line.strip()}")
    assert not bad, "\n".join(bad)


def test_step_cache_runs_its_eager_body_under_the_walker():
    """A ``StepCache`` step under the walker runs its eager body (a
    replay's kernels would not reach the walker) and makes no entry: the
    walked counts equal the body's own, and a step walked after it was
    captured counts the same."""
    from repro_torch.analysis.jitprof import CompileCounter
    from repro_torch.core.graphs import StepCache

    def body(state, params, inputs):
        state.mul_(2.0)
        return (state @ params).sum(dim=0)
    steps = StepCache("roofline-test", body)
    state, params = torch.ones(8, 8), torch.ones(8, 8)
    want = rl.analyze_step(body, state.clone(), params, ())
    with CompileCounter() as cc:
        walked = rl.analyze_step(lambda: steps(state=state, params=params))
    assert cc.events == 0 and len(steps) == 0
    steps(state=state, params=params)            # an entry now
    again = rl.analyze_step(lambda: steps(state=state, params=params))
    for got in (walked, again):
        assert got["flops_per_device"] == want["flops_per_device"] == \
            2 * 8 * 8 * 8
        assert got["bytes_per_device"] == want["bytes_per_device"]
    assert len(steps) == 1


def test_walker_leaves_other_threads_as_they_are():
    """While a walker is active on one thread, a ``StepCache`` step on
    another thread keeps its own path (an entry: a capture and replays on
    the card) and a kernel wrapper called there charges nothing; the
    walked thread runs the eager body and is charged."""
    import threading

    from repro_torch.core.graphs import StepCache

    def body(state, params, inputs):
        state.mul_(2.0)
        return (state @ params).sum(dim=0)
    steps = StepCache("roofline-threads", body)
    state, params = torch.ones(8, 8), torch.ones(8, 8)
    q = torch.randn(1, 2, 16, 32)
    seen = {}

    def other():
        seen["walking"] = kernels.walking()
        steps(state=state.clone(), params=params)
        flash_attention_bhsd(q, q, q)
    walk = rl.CostMode()
    with walk:
        assert kernels.walking()
        worker = threading.Thread(target=other)
        worker.start()
        worker.join()
        assert len(steps) == 1                   # the other thread's entry
        steps(state=state, params=params)        # walked: eager, no entry
    assert seen["walking"] is False and not kernels.walking()
    assert len(steps) == 1
    res = walk.result()
    assert res["kernel_launches"] == {}
    assert res["flops_per_device"] == 2 * 8 * 8 * 8
