"""The port's ``Cluster``/``Router``/``FaasServer`` against the reference on
``paper_topology``: the same deploy and request sequence through both
packages gives identical replica contents, clocks, merge counters and
``InvokeResult`` timelines (``measure_compute=False``: compute time is
measured wall time), the fused delivery merge stays one merge per drain,
and a ``FaultPlane`` seed replays the same fault schedule in both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ReplicationPolicy as RefPolicy
from repro.core import Cluster as RefCluster
from repro.core import Router as RefRouter
from repro.core import enoki_function as ref_function
from repro.core import get_function as ref_get
from repro.core.network import FaultPlane as RefFaultPlane
from repro.core.network import paper_topology as ref_topology
from repro_torch.configs.base import ReplicationPolicy
from repro_torch.core import Cluster, Router, enoki_function, get_function
from repro_torch.core.network import FaultPlane, paper_topology
from repro_torch.core.store import (arena_clone, merge_stores, store_contents,
                                    stores_equal)
from repro_torch.launch.faas_server import FaasServer, serve_closed_loop
from torch_parity import assert_same_store  # noqa: F401
from torch_parity import port_lockdep  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")

NODES = {"edge": "edge", "edge2": "edge", "cloud": "cloud"}
FIELDS = ("response_ms", "t_sent", "t_received", "t_applied", "kv_ops",
          "node", "chain")


@ref_function(name="tc_counter", keygroups=["tc_cnt"], codec_width=4)
def ref_counter(kv, x):
    cur, found = kv.get("count")
    new = jnp.where(found, cur[0] + 1.0, 1.0)
    kv.set("count", jnp.stack([new, x[0], 0.0, 0.0]))
    return jnp.stack([new])


@ref_function(name="tc_movavg", keygroups=["tc_avg"], codec_width=16)
def ref_movavg(kv, x):
    ptr, found = kv.get("ptr")
    idx = jnp.where(found, ptr[0], 0.0)
    kv.set("v", jnp.concatenate([jnp.atleast_1d(x)[:1], jnp.zeros((15,))]))
    window, _ = kv.scan(["v"])
    kv.set("ptr", jnp.stack([idx + 1.0]))
    return jnp.stack([window[:, 0].mean()])


@enoki_function(name="tc_counter", keygroups=["tc_cnt"], codec_width=4)
def port_counter(kv, x):
    cur, found = kv.get("count")
    new = torch.where(found, cur[0] + 1.0, 1.0)
    zero = torch.zeros((), device=x.device)
    kv.set("count", torch.stack([new, x[0], zero, zero]))
    return torch.stack([new])


@enoki_function(name="tc_movavg", keygroups=["tc_avg"], codec_width=16)
def port_movavg(kv, x):
    ptr, found = kv.get("ptr")
    idx = torch.where(found, ptr[0], 0.0)
    kv.set("v", torch.cat([torch.atleast_1d(x)[:1],
                           torch.zeros((15,), device=x.device)]))
    window, _ = kv.scan(["v"])
    kv.set("ptr", torch.stack([idx + 1.0]))
    return torch.stack([window[:, 0].mean()])


def _pair(fault_seed=0):
    ref = RefCluster(NODES, measure_compute=False, fault_seed=fault_seed)
    port = Cluster(NODES, measure_compute=False, fault_seed=fault_seed,
                   device="cpu")
    for c, get, pol in ((ref, ref_get, RefPolicy), (port, get_function,
                                                      ReplicationPolicy)):
        c.deploy(get("tc_counter"), ["edge", "edge2"])
        c.deploy(get("tc_movavg"), ["edge", "edge2"],
                 policy=pol.CLOUD_CENTRAL, owner="cloud")
    return ref, port


def _same_result(a, b):
    np.testing.assert_array_equal(np.asarray(a.output), np.asarray(b.output))
    for f in FIELDS:
        assert getattr(a, f) == getattr(b, f), f


def _same_cluster(ref, port):
    for name in NODES:
        for kg in ("tc_cnt", "tc_avg"):
            rs = ref.nodes[name].stores.get(kg)
            ps = port.nodes[name].stores.get(kg)
            assert (rs is None) == (ps is None), (name, kg)
            if rs is not None:
                assert_same_store(rs, ps, f"{name}/{kg}")
        assert int(ref.nodes[name].clock) == int(port.nodes[name].clock)
    for f in ("merge_dispatches", "merge_snapshots", "merge_aligned",
              "merge_fallback", "repl_retries", "repl_dropped", "repl_duped"):
        assert getattr(ref.stats, f) == getattr(port.stats, f), f
    assert ref.replication_bytes == port.replication_bytes


def _drive(c, router):
    """One request sequence: router invokes with a session, direct invokes
    at the far replica racing replication, a CLOUD_CENTRAL function, and a
    submit/pump batch."""
    out = []
    for i in range(3):
        out.append(router.invoke("tc_counter", np.full(1, float(i),
                                                       np.float32),
                                 t_send=5.0 * i, session_id="s1"))
        out.append(c.invoke("tc_counter", "edge2",
                            np.full(1, 10.0 + i, np.float32),
                            t_send=5.0 * i + 2.0))
    out.append(router.invoke("tc_movavg", np.ones(1, np.float32),
                             t_send=40.0, session_id="s2"))
    tickets = [router.submit("tc_counter", np.full(1, 20.0 + i, np.float32),
                             t_send=50.0 + i, session_id="s1")
               for i in range(4)]
    done = router.pump(float("inf"))
    out.extend(done[t] for t in tickets)
    out.append(c.invoke("tc_counter", "edge2", np.zeros(1, np.float32),
                        t_send=200.0))
    return out


def test_cluster_router_end_to_end_matches_reference():
    ref, port = _pair()
    want = _drive(ref, RefRouter(ref))
    got = _drive(port, Router(port))
    assert len(want) == len(got)
    for a, b in zip(want, got):
        _same_result(a, b)
    ref.flush_replication()
    port.flush_replication()
    _same_cluster(ref, port)
    assert port.stats.merge_aligned > 0 and port.stats.merge_fallback == 0


def test_delivery_merge_single_dispatch():
    """K=5 pending snapshots at a replica fold in ONE aligned merge, and
    the result equals the sequential per-snapshot baseline — the probe of
    ``tests/test_store_aligned.py``, on the port."""
    c = Cluster({"edge": "edge", "edge2": "edge"}, measure_compute=False,
                device="cpu")
    c.deploy(get_function("tc_counter"), ["edge", "edge2"],
             example_input=np.ones((1,), np.float32))
    assert c._aligned.get("tc_cnt") is True
    K = 5
    for i in range(K):
        c.invoke("tc_counter", "edge", np.ones((1,), np.float32),
                 t_send=i * 10.0)
    with c._queues["edge2"].lock:
        pending = sorted(c._queues["edge2"].heap, key=lambda e: (e[0], e[1]))
    assert len(pending) == K
    baseline = arena_clone(c.nodes["edge2"].stores["tc_cnt"])
    for _, _, kg, snap, _, _ in pending:
        baseline = merge_stores(baseline, snap)
    d0, s0 = c.stats.merge_dispatches, c.stats.merge_snapshots
    c.flush_replication(1e12)
    assert c.stats.merge_dispatches - d0 == 1, "K snapshots != one merge"
    assert c.stats.merge_snapshots - s0 == K
    assert c.stats.merge_aligned == 1
    assert stores_equal(c.nodes["edge2"].stores["tc_cnt"], baseline)


def test_fault_plane_replays_reference_schedule():
    """Same seed, same per-link sends -> the same drop/dup/jitter fates."""
    ref, port = RefFaultPlane(ref_topology(), seed=7), FaultPlane(
        paper_topology(), seed=7)
    for fp in (ref, port):
        fp.set_fault("edge", "edge2", drop_p=0.3, dup_p=0.2, jitter_ms=5.0)
    for i in range(200):
        a, b = ("edge", "edge2") if i % 3 else ("edge2", "edge")
        r, t = ref.transmit(a, b), port.transmit(a, b)
        assert (r.ok, r.copies, r.jitter_ms) == (t.ok, t.copies,
                                                 t.jitter_ms), i


def test_lossy_replication_matches_reference():
    """A lossy, duplicating link and a partition healed mid-run: both
    packages retry, drop and dedup the same way and converge to the same
    replicas."""
    ref, port = _pair(fault_seed=3)
    for c in (ref, port):
        c.faults.set_fault("edge", "edge2", drop_p=0.4, dup_p=0.3,
                           jitter_ms=3.0)
        for i in range(4):
            c.invoke("tc_counter", "edge", np.full(1, float(i), np.float32),
                     t_send=10.0 * i)
        c.faults.partition({"edge"}, {"edge2", "cloud"}, name="p")
        c.invoke("tc_counter", "edge", np.ones(1, np.float32), t_send=60.0)
        c.flush_replication(100.0)
        c.faults.heal("p")
        assert c.drain_transport(t=200.0)
    _same_cluster(ref, port)
    assert port.stats.repl_retries > 0


def test_faas_server_closed_loop_smoke():
    """Two edge replicas behind a wall-clock server: every request served,
    replicas converge after a flush."""
    c = Cluster({"edge": "edge", "edge2": "edge"}, device="cpu")
    c.deploy(get_function("tc_counter"), ["edge", "edge2"])
    with FaasServer(c, window_ms=2.0, time_scale=50.0, workers=2) as srv:
        res = serve_closed_loop(srv, "tc_counter",
                                lambda i: np.full(1, float(i), np.float32),
                                48, concurrency=4, session_prefix="s")
    assert len(res) == 48 and srv.stats.served == 48 and srv.stats.lost == 0
    c.flush_replication()
    a, b = c.store_of("tc_cnt", "edge"), c.store_of("tc_cnt", "edge2")
    assert stores_equal(a, b) and store_contents(a)


def test_cluster_without_device_raises_on_a_cpu_only_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Cluster(NODES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Cluster(NODES, device=None)
