"""The port's replication (``repro_torch.core.replication``) against the
reference's, on the CPU, from seeded numpy inputs.

* ``anti_entropy_round`` and ``converge``, full and ring, over slot-aligned
  arenas (``merge_arena_aligned``), unaligned ones (``merge_arena``) and
  ``TensorKeygroup``s (lww, mean, max): every replica equal to the
  reference's, bit for bit (keys, values, lengths, versions, vv; a keygroup's
  tree and version), ``mean`` within f32 1e-6.
* The caller's replicas come back untouched though the aligned merge writes
  into its first argument, and ties keep the replica that merges ("a wins").
* ``replicate_pod_axis`` / ``make_pod_replicate_step`` over P in {2, 3, 4}
  pods stacked on a leading dim, against the reference's
  ``replicate_pod_axis`` run under ``shard_map`` on P forced host devices
  (one pod a device) in a subprocess, so ``XLA_FLAGS`` does not reach the
  rest of the suite.  The reference's ``make_pod_replicate_step`` takes
  intra-pod specs over a pod-replicated state; the subprocess maps the
  reference's body over the stacked pod dim instead (``P("pod")``, the
  leading dim dropped inside).  n=3 and n=4 pin the ring's direction: pod
  i merges pod i + 1 (``ppermute``'s pairs ``(i + 1, i)``).
* ``tpu_pod_topology`` and ``merge_arena_keygroups``.
"""
import os
import pathlib
import subprocess
import sys
import textwrap
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import replication as ref_rep
from repro.core.keygroup import TensorKeygroup as RefKG
from repro.core.keygroup import merge_arena_keygroups as ref_merge_kg
from repro.core.network import tpu_pod_topology as ref_tpu_topology
from repro.core.store import Store as RefStore
from repro_torch.core import replication as rep
from repro_torch.core.keygroup import TensorKeygroup, merge_arena_keygroups
from repro_torch.core.network import tpu_pod_topology
from repro_torch.core.store import Store
from torch_parity import port_lockdep  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")

REPO = pathlib.Path(__file__).resolve().parents[1]
S, V, N = 8, 6, 4            # slots, payload width, version-vector nodes
KINDS = ("aligned", "unaligned", "lww", "mean", "max")
ARENA = ("keys", "values", "lengths", "versions", "vv")
MEAN_TOL = 1e-6              # f32: (a + b) / 2 in either framework


def _replicas(kind, n, seed, max_version=3):
    """n replicas of one kind as dicts of numpy arrays: versions in
    0..max_version, so ties are common."""
    rng = np.random.default_rng(seed)
    out = []
    if kind in ("aligned", "unaligned"):
        layout = (1000 + np.arange(S)).astype(np.int32)
        layout[rng.integers(0, S)] = 0                    # an empty slot
        pool = (2000 + np.arange(3 * S)).astype(np.int32)
        for _ in range(n):
            if kind == "aligned":
                keys = layout.copy()
            else:                          # distinct keys, slots drawn
                keys = np.zeros(S, np.int32)
                live = rng.choice(S, size=S - 2, replace=False)
                keys[live] = rng.choice(pool, size=S - 2, replace=False)
            out.append({
                "keys": keys,
                "values": rng.normal(size=(S, V)).astype(np.float32),
                "lengths": rng.integers(-1, V, S).astype(np.int32),
                "versions": rng.integers(0, max_version + 1,
                                         S).astype(np.int32),
                "vv": rng.integers(0, 50, N).astype(np.int32)})
        return out
    for _ in range(n):
        out.append({"w": rng.normal(size=(3, 4)).astype(np.float32),
                    "b": rng.normal(size=(5,)).astype(np.float32),
                    "version": np.int32(rng.integers(0, max_version + 1))})
    return out


def _ref(kind, r):
    if kind in ("aligned", "unaligned"):
        return RefStore(*(jnp.asarray(r[f]) for f in ARENA))
    return RefKG({"w": jnp.asarray(r["w"]), "b": jnp.asarray(r["b"])},
                 jnp.asarray(r["version"]), kind)


def _port(kind, r):
    if kind in ("aligned", "unaligned"):
        return Store(*(torch.from_numpy(np.array(r[f])) for f in ARENA))
    return TensorKeygroup({"w": torch.from_numpy(r["w"].copy()),
                           "b": torch.from_numpy(r["b"].copy())},
                          torch.tensor(r["version"]), kind)


def _merges(kind):
    if kind == "aligned":
        return ref_rep.merge_arena_aligned, rep.merge_arena_aligned
    if kind == "unaligned":
        return ref_rep.merge_arena, rep.merge_arena
    return ref_rep.merge_tensor, rep.merge_tensor


def _np(kind, x) -> dict:
    """A replica of either package as a dict of numpy arrays."""
    if kind in ("aligned", "unaligned"):
        return {f: np.asarray(t) for f, t in zip(ARENA, x)}
    return {"w": np.asarray(x.tree["w"]), "b": np.asarray(x.tree["b"]),
            "version": np.asarray(x.version)}


def _assert_same(kind, want: dict, got: dict, what=""):
    assert want.keys() == got.keys()
    for f in want:
        if kind == "mean" and f in ("w", "b"):
            np.testing.assert_allclose(got[f], want[f], rtol=MEAN_TOL,
                                       atol=MEAN_TOL, err_msg=f"{what} {f}")
        else:
            np.testing.assert_array_equal(got[f], want[f],
                                          err_msg=f"{what} {f}")


# ---------------------------------------------------------------------------
# logical replicas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("topology", ["full", "ring"])
@pytest.mark.parametrize("kind", KINDS)
def test_anti_entropy_and_converge_match_reference(kind, topology, n):
    """One round and a converge from the same replicas: every replica
    equal to the reference's, and the caller's replicas untouched."""
    reps = _replicas(kind, n,
                     seed=zlib.crc32(f"{kind}{topology}{n}".encode()))
    ref_merge, port_merge = _merges(kind)
    ports = [_port(kind, r) for r in reps]
    for fn in (rep.anti_entropy_round, rep.converge):
        want = getattr(ref_rep, fn.__name__)(
            [_ref(kind, r) for r in reps], ref_merge, topology)
        got = fn(ports, port_merge, topology)
        assert len(got) == n
        for i, (w, g) in enumerate(zip(want, got)):
            _assert_same(kind, _np(kind, w), _np(kind, g),
                         f"{fn.__name__} replica {i}")
        for i, (r, p) in enumerate(zip(reps, ports)):
            _assert_same("exact", r, _np(kind, p), f"input {i} written")


@pytest.mark.parametrize("topology", ["full", "ring"])
@pytest.mark.parametrize("kind", ["aligned", "unaligned", "lww"])
def test_ties_keep_the_merging_replica_and_inputs_stay(kind, topology):
    """Equal versions and different payloads everywhere: every replica
    keeps its own payload after a round (a wins a tie), as the reference's
    does; with versions 0..1 the same holds row by row against the
    reference, and the aligned merge, which writes into its first
    argument, never reaches a caller's replica."""
    reps = _replicas(kind, 3, seed=5, max_version=0)
    ref_merge, port_merge = _merges(kind)
    ports = [_port(kind, r) for r in reps]
    got = rep.anti_entropy_round(ports, port_merge, topology)
    want = ref_rep.anti_entropy_round([_ref(kind, r) for r in reps],
                                      ref_merge, topology)
    payload = "values" if kind != "lww" else "w"
    for i in range(3):
        _assert_same(kind, _np(kind, want[i]), _np(kind, got[i]))
        if kind != "unaligned":       # unaligned: b-only keys fill a's gaps
            np.testing.assert_array_equal(_np(kind, got[i])[payload],
                                          reps[i][payload])
    reps = _replicas(kind, 3, seed=6, max_version=1)
    ports = [_port(kind, r) for r in reps]
    for _ in range(2):
        want = ref_rep.anti_entropy_round([_ref(kind, r) for r in reps],
                                          ref_merge, topology)
        got = rep.anti_entropy_round(ports, port_merge, topology)
        for w, g in zip(want, got):
            _assert_same(kind, _np(kind, w), _np(kind, g))
        for r, p in zip(reps, ports):
            _assert_same("exact", r, _np(kind, p))
        reps = [_np(kind, w) for w in want]
        ports = got


def test_unknown_topology_raises():
    ports = [_port("aligned", r) for r in _replicas("aligned", 2, 0)]
    with pytest.raises(ValueError, match="topology"):
        rep.anti_entropy_round(ports, rep.merge_arena_aligned, "star")
    with pytest.raises(ValueError, match="topology"):
        rep.make_pod_replicate_step(rep.merge_arena_aligned, 2, "star",
                                    device="cpu")


def test_merge_arena_keygroups_and_tpu_pod_topology_match_reference():
    a, b = _replicas("unaligned", 2, seed=9)
    want = ref_merge_kg(_ref("unaligned", a), _ref("unaligned", b))
    pa = _port("unaligned", a)
    got = merge_arena_keygroups(pa, _port("unaligned", b))
    _assert_same("unaligned", _np("unaligned", want), _np("unaligned", got))
    _assert_same("exact", a, _np("unaligned", pa))          # pure
    for pods, gbps in ((2, 25.0), (4, 12.5)):
        r, p = ref_tpu_topology(pods, gbps), tpu_pod_topology(pods, gbps)
        assert {k: (l.rtt_ms, l.bandwidth_mbps) for k, l in r.links.items()} \
            == {k: (l.rtt_ms, l.bandwidth_mbps) for k, l in p.links.items()}
        assert (r.default.rtt_ms, r.default.bandwidth_mbps) \
            == (p.default.rtt_ms, p.default.bandwidth_mbps)
        assert r.request_ms("pod0", "pod1", 1 << 20) \
            == p.request_ms("pod0", "pod1", 1 << 20)


# ---------------------------------------------------------------------------
# pods stacked on a leading dim, against the reference under shard_map
# ---------------------------------------------------------------------------

POD_CASES = [(kind, topology, pods) for kind in KINDS
             for topology in ("full", "ring") for pods in (2, 3, 4)]

SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.core import replication as rep
    from repro.core.keygroup import TensorKeygroup
    from repro.core.store import Store

    ARENA = ("keys", "values", "lengths", "versions", "vv")
    data = np.load(sys.argv[1])
    out = {}
    for case in sorted({k.split("/")[0] for k in data.files}):
        kind, topology, pods = case.split(":")
        pods = int(pods)
        leaf = lambda f: jnp.asarray(data[f"{case}/{f}"])
        if kind in ("aligned", "unaligned"):
            state = Store(*(leaf(f) for f in ARENA))
            merge = (rep.merge_arena_aligned if kind == "aligned"
                     else rep.merge_arena)
        else:
            state = TensorKeygroup({"w": leaf("w"), "b": leaf("b")},
                                   leaf("version"), kind)
            merge = rep.merge_tensor
        mesh = Mesh(np.array(jax.devices()[:pods]), ("pod",))

        def body(s, merge=merge, pods=pods, topology=topology):
            mine = jax.tree.map(lambda x: x[0], s)
            new = rep.replicate_pod_axis(mine, merge, axis_name="pod",
                                         num_pods=pods, topology=topology)
            return jax.tree.map(lambda x: x[None], new)

        step = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("pod"),),
                                 out_specs=P("pod"), check_rep=False))
        got = step(state)
        if kind in ("aligned", "unaligned"):
            for f, x in zip(ARENA, got):
                out[f"{case}/{f}"] = np.asarray(x)
        else:
            out[f"{case}/w"] = np.asarray(got.tree["w"])
            out[f"{case}/b"] = np.asarray(got.tree["b"])
            out[f"{case}/version"] = np.asarray(got.version)
    np.savez(sys.argv[2], **out)
    print("POD_AXIS_OK", len(out))
""")


def _stacked(kind, topology, pods) -> dict:
    reps = _replicas(kind, pods,
                     seed=zlib.crc32(f"pod{kind}{topology}{pods}".encode()))
    return {f: np.stack([r[f] for r in reps]) for f in reps[0]}


@pytest.fixture(scope="module")
def reference_pod_axis(tmp_path_factory):
    """Every POD_CASES case through the reference, in one subprocess."""
    d = tmp_path_factory.mktemp("pod_axis")
    inputs = {f"{kind}:{topology}:{pods}/{f}": x
              for kind, topology, pods in POD_CASES
              for f, x in _stacked(kind, topology, pods).items()}
    np.savez(d / "in.npz", **inputs)
    (d / "ref.py").write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, str(d / "ref.py"), str(d / "in.npz"),
                          str(d / "out.npz")], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, f"STDOUT:\n{res.stdout}\nSTDERR:\n{res.stderr}"
    assert "POD_AXIS_OK" in res.stdout
    out = np.load(d / "out.npz")
    return {k: out[k] for k in out.files}


def _stacked_port(kind, stacked):
    if kind in ("aligned", "unaligned"):
        return Store(*(torch.from_numpy(stacked[f].copy()) for f in ARENA))
    return TensorKeygroup({"w": torch.from_numpy(stacked["w"].copy()),
                           "b": torch.from_numpy(stacked["b"].copy())},
                          torch.from_numpy(stacked["version"].copy()), kind)


@pytest.mark.parametrize("kind,topology,pods", POD_CASES)
def test_pod_axis_matches_reference_shard_map(reference_pod_axis, kind,
                                              topology, pods):
    """``make_pod_replicate_step`` on the CPU equals the reference's
    ``replicate_pod_axis`` under ``shard_map``, pod for pod, and leaves the
    stacked state it is handed untouched; ``replicate_pod_axis`` itself
    gives the same."""
    stacked = _stacked(kind, topology, pods)
    state = _stacked_port(kind, stacked)
    _, port_merge = _merges(kind)
    step = rep.make_pod_replicate_step(port_merge, pods, topology,
                                       device="cpu")
    got = _np(kind, step(state))
    want = {f: reference_pod_axis[f"{kind}:{topology}:{pods}/{f}"]
            for f in stacked}
    _assert_same(kind, want, got, f"{kind} {topology} P={pods}")
    _assert_same("exact", stacked, _np(kind, state), "input written")
    again = rep.replicate_pod_axis(state, port_merge, num_pods=pods,
                                   topology=topology)
    _assert_same("exact", got, _np(kind, again))


@pytest.mark.parametrize("pods", [3, 4])
def test_ring_merges_the_next_pod(pods):
    """Pod i merges pod i + 1 (``ppermute`` with pairs (i + 1, i)), not
    pod i - 1 as the logical ring does: one ring round equals
    ``merge(pod i, pod (i + 1) % n)`` and differs from the other way."""
    stacked = _stacked("aligned", "ring", pods)
    state = _stacked_port("aligned", stacked)
    got = rep.replicate_pod_axis(state, rep.merge_arena_aligned,
                                 num_pods=pods, topology="ring")
    pods_in = [_port("aligned", {f: stacked[f][i] for f in ARENA})
               for i in range(pods)]
    merge = rep.merge_arena_aligned
    for i in range(pods):
        want = merge(rep.replica_clone(pods_in[i]), pods_in[(i + 1) % pods])
        _assert_same("aligned", _np("aligned", want),
                     {f: _np("aligned", got)[f][i] for f in ARENA})
    backwards = merge(rep.replica_clone(pods_in[1]), pods_in[0])
    assert not all(np.array_equal(_np("aligned", backwards)[f],
                                  _np("aligned", got)[f][1]) for f in ARENA)


def test_pod_step_refuses_a_wrong_pod_dim_or_device():
    state = _stacked_port("aligned", _stacked("aligned", "full", 3))
    with pytest.raises(ValueError, match="pod dim"):
        rep.replicate_pod_axis(state, rep.merge_arena_aligned, num_pods=2)
    step = rep.make_pod_replicate_step(rep.merge_arena_aligned, 3,
                                       device="meta")
    with pytest.raises(ValueError, match="step on meta"):
        step(state)
