"""The port's ``runtime`` (elastic membership, health, failure injection,
seeded chaos) against the reference on ``Cluster(measure_compute=False)``.

Every scenario runs the same deploy, request and fault sequence through
both packages and compares, bit for bit: the final arenas of every node
(version vectors included), the node clocks, the cluster's merge and
transport counters, ``MembershipStats`` field by field, the engine's
counters, the rehome maps, the owner re-homing and the ``InvokeResult``
timelines.  The scenarios are ``tests/test_failure_recovery.py``'s, the
membership and chaos cases of ``tests/test_partition_tolerance.py``, and
the health/straggler cases of ``tests/test_substrate.py``; each also keeps
its reference contract assertions on the port's run.
"""
import dataclasses
import functools
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.runtime as ref_rt
from repro.configs.base import ReplicationPolicy as RefPolicy
from repro.core import Cluster as RefCluster
from repro.core import Router as RefRouter
from repro.core import enoki_function as ref_function
from repro.core import get_function as ref_get
from repro.core.store import arena_clone as ref_clone
from repro.core.store import stores_equal as ref_stores_equal
import repro_torch.runtime as rt
from repro_torch.configs.base import ReplicationPolicy
from repro_torch.core import Cluster, Router, enoki_function, get_function
from repro_torch.core.store import arena_clone, stores_equal
from torch_parity import assert_same_store, to_np
from torch_parity import port_lockdep  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")

NODES = ("edge", "edge2", "cloud")
RESULT_FIELDS = ("response_ms", "t_sent", "t_received", "t_applied",
                 "kv_ops", "node", "chain")
ONE = np.ones(1, np.float32)


@ref_function(name="rt_ctr", keygroups=["rt_kg"], codec_width=4)
def ref_ctr(kv, x):
    cur, found = kv.get("count")
    new = jnp.where(found, cur[0] + x[0], x[0])
    kv.set("count", jnp.stack([new, 0.0, 0.0, 0.0]))
    return jnp.stack([new])


@ref_function(name="rt_probe", keygroups=["rt_probekg"], codec_width=4)
def ref_probe(kv, x):
    cur, _ = kv.get("beacon")
    return cur[:1] + x[:1]


@enoki_function(name="rt_ctr", keygroups=["rt_kg"], codec_width=4)
def port_ctr(kv, x):
    cur, found = kv.get("count")
    new = torch.where(found, cur[0] + x[0], x[0])
    zero = torch.zeros((), device=x.device)
    kv.set("count", torch.stack([new, zero, zero, zero]))
    return torch.stack([new])


@enoki_function(name="rt_probe", keygroups=["rt_probekg"], codec_width=4)
def port_probe(kv, x):
    cur, _ = kv.get("beacon")
    return cur[:1] + x[:1]


REF = types.SimpleNamespace(
    Cluster=RefCluster, Router=RefRouter, rt=ref_rt, Policy=RefPolicy,
    get=ref_get, clone=ref_clone, stores_equal=ref_stores_equal)
PORT = types.SimpleNamespace(
    Cluster=functools.partial(Cluster, device="cpu"), Router=Router, rt=rt,
    Policy=ReplicationPolicy, get=get_function, clone=arena_clone,
    stores_equal=stores_equal)


def _cluster(P, **kw):
    kw.setdefault("measure_compute", False)
    return P.Cluster({"edge": "edge", "edge2": "edge", "cloud": "cloud"},
                     **kw)


def _deploy(P, c, nodes=("edge", "edge2"), **kw):
    c.deploy(P.get("rt_ctr"), list(nodes), **kw)


def _out(r) -> float:
    return float(to_np(r.output)[0])


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------

def _public(stats) -> dict:
    return {f.name: getattr(stats, f.name)
            for f in dataclasses.fields(stats) if not f.name.startswith("_")}


def _same(a, b, what):
    """Recursive equality of one observation from each package."""
    if hasattr(a, "kv_ops"):                     # an InvokeResult
        np.testing.assert_array_equal(to_np(a.output), to_np(b.output),
                                      err_msg=what)
        for f in RESULT_FIELDS:
            assert getattr(a, f) == getattr(b, f), f"{what}.{f}"
    elif isinstance(a, dict):
        assert list(a) == list(b), what
        for k in a:
            _same(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    else:
        assert a == b, (what, a, b)


def _same_clusters(rc, pc, rm=None, pm=None, what=""):
    assert list(rc.nodes) == list(pc.nodes)
    for name in rc.nodes:
        rs, ps = rc.nodes[name].stores, pc.nodes[name].stores
        assert sorted(rs) == sorted(ps), f"{what} {name} keygroups"
        for kg in rs:
            assert_same_store(rs[kg], ps[kg], f"{what} {name}/{kg}")
        assert int(rc.nodes[name].clock) == int(pc.nodes[name].clock), name
        assert rc.naming.is_alive(name) == pc.naming.is_alive(name), name
        assert rc.naming.is_routable(name) == pc.naming.is_routable(name)
    for kg in rc.policies:
        assert rc.naming.replicas_of(kg) == pc.naming.replicas_of(kg), kg
        assert rc.policies[kg].owner == pc.policies[kg].owner, kg
        assert rc.fence_epoch(kg) == pc.fence_epoch(kg), kg
    assert _public(rc.stats) == _public(pc.stats), what
    assert _public(rc.engine.stats) == _public(pc.engine.stats), what
    assert rc.replication_bytes == pc.replication_bytes
    if rm is not None:
        assert _public(rm.stats) == _public(pm.stats), what
        assert rm.state == pm.state, what


# ---------------------------------------------------------------------------
# tests/test_failure_recovery.py's scenarios, through both packages
# ---------------------------------------------------------------------------

def kill_during_flush_cycle(P, tmp):
    c = _cluster(P)
    _deploy(P, c)
    m = P.rt.ElasticMembership(c)
    inj = P.rt.FailureInjector(c, membership=m)
    tickets = [c.engine.submit("rt_ctr", "edge", ONE, t_send=float(i))
               for i in range(4)]
    inj.kill_node("edge")
    out = c.engine.flush()
    assert set(tickets) <= set(out), "every queued ticket must complete"
    res = [out[t] for t in tickets]
    assert [r.node for r in res] == ["edge2"] * 4
    assert [_out(r) for r in res] == [1.0, 2.0, 3.0, 4.0]
    assert c.engine.stats.reroutes == 4 and c.engine.pending() == []
    return c, m, {"results": res}


def kill_all_replicas_fails_fast(P, tmp):
    c = _cluster(P)
    _deploy(P, c)
    m = P.rt.ElasticMembership(c)
    inj = P.rt.FailureInjector(c, membership=m)
    router = P.Router(c)
    t1 = router.submit("rt_ctr", ONE)
    inj.kill_node("edge")
    inj.kill_node("edge2")
    out = router.flush()
    assert t1 not in out and c.engine.pending() == []
    assert c.engine.stats.dropped_dead == 1
    assert not router.tracks(t1)
    return c, m, {"out": sorted(out)}


def kill_between_submit_and_dispatch(P, tmp):
    c = _cluster(P)
    _deploy(P, c)
    m = P.rt.ElasticMembership(c)
    m.crash("edge")
    rs = c.engine.dispatch("rt_ctr", "edge", [ONE] * 2, t_sends=[0.0, 1.0])
    assert [r.node for r in rs] == ["edge2", "edge2"]
    assert [_out(r) for r in rs] == [1.0, 2.0]
    return c, m, {"results": rs}


def kill_with_pending_replication_then_restore(P, tmp):
    c = _cluster(P)
    _deploy(P, c)
    m = P.rt.ElasticMembership(c)
    inj = P.rt.FailureInjector(c, membership=m)
    r = c.invoke("rt_ctr", "edge", ONE)
    assert c.pending_replication("edge2")
    inj.kill_node("edge2")
    assert c.pending_replication("edge2") == []
    assert m.stats.dropped_deliveries >= 1
    r2 = c.invoke("rt_ctr", "edge", ONE, t_send=r.t_received)
    assert _out(r2) == 2.0
    inj.restore_node("edge2", t=1e12)
    assert c.naming.is_alive("edge2")
    assert P.stores_equal(c.store_of("rt_kg", "edge"),
                          c.store_of("rt_kg", "edge2"))
    return c, m, {"results": [r, r2]}


def partition_then_heal(P, tmp):
    c = _cluster(P)
    _deploy(P, c)
    inj = P.rt.FailureInjector(c)
    inj.partition("edge", "edge2")
    r1 = c.invoke("rt_ctr", "edge", ONE)
    c.flush_replication(1e12)
    assert not P.stores_equal(c.store_of("rt_kg", "edge"),
                              c.store_of("rt_kg", "edge2"))
    r_far = c.invoke("rt_ctr", "edge2", ONE, t_send=0.0)
    assert _out(r_far) == 1.0
    inj.heal("edge", "edge2")
    r2 = c.invoke("rt_ctr", "edge", ONE, t_send=r1.t_received)
    r3 = c.invoke("rt_ctr", "edge2", ONE, t_send=r1.t_received)
    c.flush_replication(1e12)
    assert P.stores_equal(c.store_of("rt_kg", "edge"),
                          c.store_of("rt_kg", "edge2"))
    return c, None, {"results": [r1, r_far, r2, r3]}


def crash_restore_from_checkpoint(P, tmp):
    c = _cluster(P)
    _deploy(P, c, policy=P.Policy.PEER_FETCH, owner="edge")
    m = P.rt.ElasticMembership(c, checkpoint_dir=str(tmp))
    res = [c.invoke("rt_ctr", "edge", ONE),
           c.invoke("rt_ctr", "edge", ONE, t_send=100.0)]
    assert m.checkpoint("edge", step=1)
    expected = P.clone(c.store_of("rt_kg", "edge"))
    res.append(c.invoke("rt_ctr", "edge", ONE, t_send=200.0))
    rehomed = m.crash("edge")
    target = rehomed["rt_kg"]
    assert m.stats.checkpoint_restores == 1
    assert P.stores_equal(expected, c.store_of("rt_kg", target))
    assert c.policies["rt_kg"].owner == target
    r = P.Router(c).invoke("rt_ctr", ONE, t_send=300.0)
    assert r.node == "edge2" and _out(r) == 3.0
    return c, m, {"results": res + [r], "rehomed": rehomed}


def crash_without_checkpoint_restores_fresh(P, tmp):
    c = _cluster(P)
    _deploy(P, c, policy=P.Policy.PEER_FETCH, owner="edge")
    m = P.rt.ElasticMembership(c)
    r0 = c.invoke("rt_ctr", "edge", ONE)
    rehomed = m.crash("edge")
    assert "rt_kg" in rehomed and m.stats.fresh_restores == 1
    r = P.Router(c).invoke("rt_ctr", ONE, t_send=100.0)
    assert r.node == "edge2" and _out(r) == 1.0
    return c, m, {"results": [r0, r], "rehomed": rehomed}


# ---------------------------------------------------------------------------
# tests/test_partition_tolerance.py's membership cases
# ---------------------------------------------------------------------------

def _beating_env(P):
    c = _cluster(P)
    _deploy(P, c)
    hm = P.rt.HealthMonitor(naming=c.naming, timeout_s=10.0, plane=c.faults)
    m = P.rt.ElasticMembership(c, monitor=hm)
    inj = P.rt.FailureInjector(c, membership=m)
    for n in c.nodes:
        hm.beat(n, step=0, t=0.0)
    return c, hm, m, inj


def minority_partition_parks_suspect(P, tmp):
    c, hm, m, inj = _beating_env(P)
    inj.partition("edge", "edge2")
    for t in (5.0, 11.0):
        for n in c.nodes:
            hm.beat(n, step=1, t=t)
    crashed = m.poll(now=15.0)
    assert crashed == []
    assert m.state["edge2"] == "suspect" and m.state["edge"] == "suspect"
    assert m.stats.rebalanced == 0
    assert c.naming.replicas_of("rt_kg") >= {"edge", "edge2"}
    assert P.Router(c).candidates("rt_ctr") == []
    verdicts = {n: hm.verdict_detail(n, 15.0) for n in NODES}
    suspect_state = dict(m.state)
    inj.heal("edge", "edge2")
    for n in c.nodes:
        hm.beat(n, step=2, t=23.0)
    assert m.poll(now=24.0) == []
    assert m.state["edge"] == "alive" and m.state["edge2"] == "alive"
    assert m.stats.false_suspects >= 2
    return c, m, {"crashed": crashed, "verdicts": verdicts,
                  "suspect_state": suspect_state}


def quorum_silence_crashes_within_one_poll(P, tmp):
    c, hm, m, inj = _beating_env(P)
    inj.partition_groups({"edge2"}, {"edge", "cloud"})
    for t in (5.0, 11.0):
        for n in c.nodes:
            hm.beat(n, step=1, t=t)
    crashed = m.poll(now=15.0)
    assert crashed == ["edge2"] and m.state["edge2"] == "dead"
    assert m.stats.crashes == 1 and not c.naming.is_alive("edge2")
    return c, m, {"crashed": crashed}


def stale_epoch_delivery_rejected_after_restore(P, tmp):
    c = _cluster(P)
    _deploy(P, c)
    m = P.rt.ElasticMembership(c)
    inj = P.rt.FailureInjector(c, membership=m)
    res = [c.invoke("rt_ctr", "edge", ONE)]
    c.flush_replication(1e12)
    inj.partition("edge", "edge2")
    res.append(c.invoke("rt_ctr", "edge2", ONE, t_send=10.0))
    c.flush_replication(1e12)
    with c._outbox_lock:
        assert c._outboxes.get(("edge2", "edge"))
    inj.kill_node("edge2")
    assert c.fence_epoch("rt_kg") >= 1
    inj.heal("edge", "edge2")
    inj.restore_node("edge2", t=1e12)
    c.drain_transport(1e12)
    assert m.stats.epoch_rejections >= 1 and c.stats.epoch_rejections >= 1
    assert P.stores_equal(c.store_of("rt_kg", "edge"),
                          c.store_of("rt_kg", "edge2"))
    r = c.invoke("rt_ctr", "edge", ONE, t_send=1e12)
    assert _out(r) == 2.0
    return c, m, {"results": res + [r]}


def resurrection_contract(P, tmp):
    c, hm, m, inj = _beating_env(P)
    m.crash("edge2")
    for n in ("edge", "cloud"):
        hm.beat(n, step=5, t=100.0)
    hm.beat("edge2", step=5, t=100.0)
    assert hm.dead_nodes(now=100.0) == []
    assert not c.naming.is_alive("edge2") and m.state["edge2"] == "dead"
    caught = m.restore("edge2", t=1e12)
    assert c.naming.is_alive("edge2")
    assert m.poll(now=100.0) == [] and m.state["edge2"] == "alive"
    return c, m, {"caught": caught}


SCENARIOS = [kill_during_flush_cycle, kill_all_replicas_fails_fast,
             kill_between_submit_and_dispatch,
             kill_with_pending_replication_then_restore, partition_then_heal,
             crash_restore_from_checkpoint,
             crash_without_checkpoint_restores_fresh,
             minority_partition_parks_suspect,
             quorum_silence_crashes_within_one_poll,
             stale_epoch_delivery_rejected_after_restore,
             resurrection_contract]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_reference(scenario, tmp_path):
    rc, rm, robs = scenario(REF, tmp_path / "ref")
    pc, pm, pobs = scenario(PORT, tmp_path / "port")
    _same(robs, pobs, scenario.__name__)
    _same_clusters(rc, pc, rm, pm, scenario.__name__)


def test_checkpoint_revived_arena_is_a_port_arena(tmp_path):
    """The checkpoint-revived store lands on the keygroup's device with the
    arena's dtypes, and is not aliased to anything the manager kept."""
    pc, pm, obs = crash_restore_from_checkpoint(PORT, tmp_path)
    target = obs["rehomed"]["rt_kg"]
    store = pc.store_of("rt_kg", target)
    template = pc.blank_arena("rt_kg")
    for got, want in zip(store, template):
        assert got.device == want.device and got.dtype == want.dtype
        assert got.shape == want.shape


# ---------------------------------------------------------------------------
# churn: one hypothesis schedule through both packages
# ---------------------------------------------------------------------------

_churn_envs = {}


def _churn_env(P):
    """One cluster per package reused across examples (as the reference's
    churn test does); each example starts by restoring every dead node."""
    key = id(P)
    if key not in _churn_envs:
        c = _cluster(P)
        _deploy(P, c, nodes=NODES)
        m = P.rt.ElasticMembership(c, min_replicas=2)
        _churn_envs[key] = dict(c=c, m=m, r=P.Router(c), t=[0.0], last=[0.0])
    env = _churn_envs[key]
    for n in NODES:
        if env["m"].state.get(n) == "dead":
            env["m"].restore(n, t=1e15)
    return env


def _churn_step(env, op, node):
    c, m, router = env["c"], env["m"], env["r"]
    if op == "crash":
        alive = [n for n in NODES if m.state.get(n) == "alive"]
        if len(alive) > 1 and m.state.get(node) == "alive":
            return m.crash(node)
    elif op == "restore":
        if m.state.get(node) == "dead":
            return m.restore(node, t=1e15)
    else:
        env["t"][0] += 500.0
        r = router.invoke("rt_ctr", ONE, t_send=env["t"][0],
                          session_id="churn")
        v = _out(r)
        assert v > env["last"][0], "reads-your-writes across re-pinning"
        env["last"][0] = v
        c.flush_replication(1e15)
        return r
    return None


@settings(max_examples=10, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(["crash", "restore", "invoke"]),
                          st.sampled_from(NODES)),
                min_size=1, max_size=12))
def test_churn_matches_reference_after_every_step(schedule):
    ref, port = _churn_env(REF), _churn_env(PORT)
    _same_clusters(ref["c"], port["c"], ref["m"], port["m"], "churn start")
    for i, (op, node) in enumerate(schedule):
        a, b = _churn_step(ref, op, node), _churn_step(port, op, node)
        _same(a, b, f"churn step {i} {op} {node}")
        _same_clusters(ref["c"], port["c"], ref["m"], port["m"],
                       f"churn step {i} {op} {node}")
        for kg in port["c"].policies:
            assert any(port["c"].naming.is_alive(n)
                       for n in port["c"].naming.replicas_of(kg)), kg


# ---------------------------------------------------------------------------
# the seeded chaos harness
# ---------------------------------------------------------------------------

def _chaos_run(P, seed, rounds, apply_faults):
    c = P.Cluster({n: ("cloud" if n == "cloud" else "edge") for n in NODES},
                  measure_compute=False, fault_seed=seed)
    c.deploy(P.get("rt_ctr"), list(NODES), policy=P.Policy.REPLICATED)
    c.deploy(P.get("rt_probe"), ["edge2"], policy=P.Policy.REPLICATED)
    m = P.rt.ElasticMembership(c)
    inj = P.rt.FailureInjector(c, membership=m)
    plan = P.rt.chaos_schedule(seed, rounds, NODES, victim="edge2")

    def write(node, r, t):
        c.invoke("rt_ctr", node, ONE, t_send=t + 1.0)
        c.drain_transport(t + 1.0)

    served, lost = [], []

    def probe(r, t):
        ticket = c.engine.submit("rt_probe", "edge2", ONE, t_send=t + 2.0)
        out = c.engine.flush()
        (served if ticket in out else lost).append(r)

    t_end = P.rt.run_chaos(c, m, inj, plan, write, probe=probe,
                           apply_faults=apply_faults)
    return c, m, plan, served, lost, t_end


def test_chaos_seed7_port_twin_and_reference_byte_identical():
    rounds = 12
    pc, pm, plan, served, lost, t_end = _chaos_run(PORT, 7, rounds, True)
    tc, tm, _, served_t, lost_t, _ = _chaos_run(PORT, 7, rounds, False)
    rc, rm, _, served_r, lost_r, t_end_r = _chaos_run(REF, 7, rounds, True)

    # the reference's contract on the port's faulty run
    st_ = pc.engine.stats
    assert st_.submitted == st_.requests_flushed + st_.dropped_dead
    assert len(lost) == st_.dropped_dead and lost
    assert len(served) + len(lost) == rounds
    assert pc.stats.repl_retries > 0
    assert pc.stats.repl_dropped > 0 or pc.stats.repl_duped > 0
    for node in NODES[1:]:
        assert stores_equal(pc.store_of("rt_kg", NODES[0]),
                            pc.store_of("rt_kg", node)), node
    writes = sum(len(plan.writers_for(r)) for r in range(rounds))
    assert float(pc.store_of("rt_kg", "edge").values[0, 0]) == writes
    assert pc.stats.merge_dispatches > 0 and pc.stats.merge_fallback == 0

    # faulty run and its fault-free twin: byte-identical, vv included
    assert (served, lost) == (served_t, lost_t)
    for node in NODES:
        for kg in ("rt_kg", "rt_probekg"):
            if kg in tc.nodes[node].stores:
                for x, y in zip(pc.store_of(kg, node), tc.store_of(kg, node)):
                    assert torch.equal(x, y), (node, kg)

    # and the reference's faulty run, with every counter
    assert (served, lost, t_end) == (served_r, lost_r, t_end_r)
    _same_clusters(rc, pc, rm, pm, "chaos seed 7")


@pytest.mark.parametrize("rounds", [8, 12, 20])
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 8])
def test_chaos_schedule_matches_reference(seed, rounds):
    a = ref_rt.chaos_schedule(seed, rounds, NODES, victim="edge2")
    b = rt.chaos_schedule(seed, rounds, NODES, victim="edge2")
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert [dataclasses.astuple(e) for e in a.events] == \
        [dataclasses.astuple(e) for e in b.events]
    assert a.quiet_rounds == b.quiet_rounds
    for r in range(rounds):
        assert a.writers_for(r) == b.writers_for(r)


def test_chaos_schedule_needs_eight_rounds():
    with pytest.raises(ValueError):
        rt.chaos_schedule(0, 7, NODES, victim="edge2")


# ---------------------------------------------------------------------------
# tests/test_substrate.py's health and straggler cases
# ---------------------------------------------------------------------------

def _straggler(P):
    pol = P.rt.StragglerPolicy(max_staleness_rounds=2, quorum_frac=0.5)
    pods = ["p0", "p1", "p2", "p3"]
    for p in pods[:3]:
        pol.report(p, 5)
    return (pol.can_proceed(5, pods), pol.laggards(5, pods),
            pol.too_stale("p3", 5), pol.too_stale("p0", 5),
            pol.can_proceed(6, pods))


def _health(P):
    hm = P.rt.HealthMonitor(timeout_s=10.0, lag_steps=5)
    hm.beat("a", step=100, t=0.0)
    hm.beat("b", step=90, t=0.0)
    out = [hm.stragglers(), hm.dead_nodes(now=11.0), hm.dead_nodes(now=9.0),
           hm.fleet_step(), hm.verdict_detail("a", 11.0),
           hm.unreachable("a", "b", 5.0)]
    hm.resurrect("a")
    out += [hm.dead_nodes(now=11.0), hm.verdict("a", 11.0)]
    return out


def test_straggler_policy_matches_reference():
    got = _straggler(PORT)
    assert got == _straggler(REF)
    assert got[:4] == (True, ["p3"], True, False)


def test_health_monitor_matches_reference():
    got = _health(PORT)
    assert got == _health(REF)
    assert got[0] == ["b"] and got[1] == ["a", "b"]


# ---------------------------------------------------------------------------
# the port's FaasServer with a node killed mid-serving
# ---------------------------------------------------------------------------

@enoki_function(name="rt_bump", keygroups=["rt_fskg"], codec_width=4)
def port_bump(kv, x):
    cur, found = kv.get("c")
    new = torch.where(found, cur[0] + 1.0, 1.0)
    zero = torch.zeros((), device=x.device)
    kv.set("c", torch.stack([new, zero, zero, zero]))
    return torch.stack([new])


def test_faas_server_node_death_mid_serving_reroutes_or_fails_fast():
    """tests/test_faas_server.py's case on the port: in-flight and queued
    requests complete at the survivor or surface as RequestLost, nothing
    hangs, and a restore catches the dead replica up byte for byte."""
    from repro_torch.launch.faas_server import FaasServer, RequestLost
    c = _cluster(PORT)
    c.deploy(get_function("rt_bump"), ["edge", "edge2"])
    c.invoke("rt_bump", "edge", np.zeros(4, np.float32))
    c.flush_replication()
    m = rt.ElasticMembership(c)
    inj = rt.FailureInjector(c, membership=m)
    for b in (1, 8, 64):
        c.invoke_batch("rt_bump", "edge", [np.zeros(4, np.float32)] * b)
    n = 16
    t0 = time.perf_counter()
    with FaasServer(c, window_ms=5.0, time_scale=200.0,
                    membership=m) as srv:
        futs = [srv.submit("rt_bump", np.zeros(4, np.float32))
                for _ in range(n)]
        inj.kill_node("edge2")
        served = lost = 0
        for f in futs:
            try:
                f.result(timeout=30.0)
                served += 1
            except RequestLost:
                lost += 1
    assert time.perf_counter() - t0 < 30.0
    assert all(f.done() for f in futs)
    assert served + lost == n
    assert srv.stats.served == served and srv.stats.lost == lost
    assert served == n and lost == 0
    c.flush_replication(1e12)
    assert m.state["edge2"] == "dead"
    assert m.restore("edge2") == ["rt_fskg"]
    c.flush_replication()
    for x, y in zip(c.store_of("rt_fskg", "edge"),
                    c.store_of("rt_fskg", "edge2")):
        assert torch.equal(x, y)
    assert float(c.store_of("rt_fskg", "edge").values[0, 0]) == 1 + 73 + n
