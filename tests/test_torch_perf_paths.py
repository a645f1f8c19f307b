"""The port's warm-path guarantees on the CPU: the counterpart of
``tests/test_perf_paths.py``.

The reference promises that after ``engine.prewarm()`` a warm serving
loop compiles nothing (``analysis.jitprof.CompileCounter`` counts XLA
compile requests).  The port's counterpart of a compile is a new entry in
a step cache (``repro_torch.core.graphs.StepCache``): a CUDA graph capture
on the card, the first execution of a new key on the CPU, so the same
guarantee is checked here, with the same setup, and a new bucket or a
replaced arena is shown to count (the zero is not vacuous).  The warm
rounds' arenas and outputs equal the reference's bit for bit.

The reference's throughput floor (one batched dispatch >= 2.5x the
throughput of 64 sequential invokes) is held on the card only
(``tests/test_torch_cuda.py``): on the CPU the port's fold is eager.  Its
slow mesh test (MoE, flash-decode) waits for the port of those paths.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Cluster as RefCluster
from repro.core import enoki_function as ref_function
from repro.core import get_function as ref_get
from repro_torch import configs as tc
from repro_torch.analysis.jitprof import CompileCounter
from repro_torch.core import Cluster, enoki_function, get_function
from repro_torch.core.engine import DEFAULT_BUCKETS
from repro_torch.core import graphs
from repro_torch.core.graphs import StepCache
from repro_torch.core.store import arena_clone
from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.launch import serve
from repro_torch.models import model_zoo as zoo
from repro_torch.models import xlstm
from repro_torch.runtime import ElasticMembership
from torch_parity import assert_same_store, port_lockdep  # noqa: F401

NODES = {"edge": "edge", "edge2": "edge", "cloud": "cloud"}


@ref_function(name="tpp_warm_acc", keygroups=["tpp_warmkg"], codec_width=8)
def ref_warm_acc(kv, x):
    cur, _ = kv.get("acc")
    kv.set("acc", cur + x)
    return cur + x


@enoki_function(name="tpp_warm_acc", keygroups=["tpp_warmkg"],
                codec_width=8)
def warm_acc(kv, x):
    cur, _ = kv.get("acc")
    kv.set("acc", cur + x)
    return cur + x


def _port_cluster():
    c = Cluster(NODES, measure_compute=False, device="cpu")
    c.deploy(get_function("tpp_warm_acc"), list(NODES),
             example_input=np.ones((8,), np.float32))
    return c


def _round_all(c, x, buckets=DEFAULT_BUCKETS):
    outs = []
    for node in c.nodes:
        for b in buckets:
            outs.append([np.asarray(r.output) for r in
                         c.invoke_batch("tpp_warm_acc", node, [x] * b)])
    c.flush_replication(1e12)
    return outs


def test_zero_recompiles_warm_serving():
    """After ``prewarm()`` and one settling round, three warm rounds over
    every bucket on three nodes, replication flushed, make no new
    step-cache entry, and the staging-buffer set stays fixed."""
    c = _port_cluster()
    eng = c.engine
    assert eng.prewarm() > 0
    x = np.ones((8,), np.float32)
    _round_all(c, x)                # settling round: staging buffers land
    n_bufs = len(eng._staging.bufs)
    assert n_bufs == len(DEFAULT_BUCKETS)   # one per (bucket, input leaf)
    with CompileCounter() as cc:
        for _ in range(3):
            _round_all(c, x)
    assert cc.events == 0, f"{cc.events} new step entries in warm rounds"
    assert len(eng._staging.bufs) == n_bufs, "staging buffers not reused"
    # prewarm made every (node x bucket) entry: nothing was added since
    for nd in c.nodes.values():
        assert len(nd.batched_handlers["tpp_warm_acc"].steps) == \
            len(DEFAULT_BUCKETS)


@pytest.mark.parametrize("change", ["new_bucket", "replaced_arena"])
def test_a_new_geometry_counts(change):
    """The zero above is not vacuous: a bucket prewarm did not cover, or an
    arena replaced as a crash re-home replaces it, makes a new entry
    (counted once), and the next warm round is back to zero."""
    c = _port_cluster()
    x = np.ones((8,), np.float32)
    if change == "new_bucket":
        c.engine.prewarm(buckets=(1, 8))
        _round_all(c, x, (1, 8))
        with CompileCounter() as cc:
            _round_all(c, x, (1, 8, 64))
        assert cc.events == len(NODES)
        with CompileCounter() as again:
            _round_all(c, x, (1, 8, 64))
    else:
        c.engine.prewarm()
        _round_all(c, x)
        nd = c.nodes["edge2"]
        with nd.lock:
            nd.stores["tpp_warmkg"] = arena_clone(nd.stores["tpp_warmkg"])
        with CompileCounter() as cc:
            c.invoke_batch("tpp_warm_acc", "edge2", [x] * 8)
        assert cc.events == 1
        with CompileCounter() as again:
            _round_all(c, x)
        assert again.events == len(DEFAULT_BUCKETS) - 1   # the other buckets
        with CompileCounter() as again:
            _round_all(c, x)
    assert again.events == 0


def test_warm_serving_matches_reference():
    """The slice as a whole: prewarm, then warm rounds over every bucket on
    three nodes with replication flushed, through both packages with the
    same inputs: every replica's arena and every output bit for bit."""
    ref = RefCluster(NODES, measure_compute=False)
    ref.deploy(ref_get("tpp_warm_acc"), list(NODES),
               example_input=jnp.ones((8,), jnp.float32))
    port = _port_cluster()
    assert port.engine.prewarm() == ref.engine.prewarm() > 0
    rng = np.random.default_rng(0)
    for _ in range(2):
        x = rng.integers(-4, 5, 8).astype(np.float32)
        want = []
        for node in ref.nodes:
            for b in DEFAULT_BUCKETS:
                want.append([np.asarray(r.output) for r in
                             ref.invoke_batch("tpp_warm_acc", node, [x] * b)])
        ref.flush_replication(1e12)
        got = _round_all(port, x)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.stack(w), np.stack(g))
    for node in NODES:
        assert_same_store(ref.store_of("tpp_warmkg", node),
                          port.store_of("tpp_warmkg", node), node)
        assert int(ref.nodes[node].clock) == int(port.nodes[node].clock)


# ---------------------------------------------------------------------------
# the step cache itself
# ---------------------------------------------------------------------------

def _bump(state, params, inputs, scale):
    """A step that writes its state in place and returns a new tensor."""
    (acc,), (x,) = state, inputs
    acc.add_(x * scale)
    return acc.sum() + params[0]


def test_step_cache_keys_bound_and_count():
    """State is bound by address (a new arena is a new entry), inputs by
    shape; at most ``PER_SHAPE`` (2) entries of one shape stay, and an
    evicted one counts again when it comes back."""
    assert graphs.PER_SHAPE == 2
    steps = StepCache("bump", _bump)
    w, x = torch.ones(()), np.ones(4, np.float32)
    arenas = [torch.zeros(4) for _ in range(3)]

    def run(arena, scale=2.0):
        steps(state=(arena,), params=(w,), inputs=(x,), static=(scale,))

    with CompileCounter() as cc:
        for a in arenas[:2]:
            for _ in range(3):
                run(a)
    assert cc.events == 2 and len(steps) == 2
    assert all(float(a.sum()) == 24.0 for a in arenas[:2])
    with CompileCounter() as cc:
        run(arenas[2])              # evicts arenas[0]'s entry
        run(arenas[0])              # which counts again
        run(arenas[0], 3.0)         # a new static argument
    assert cc.events == 3 and len(steps) == 3 and steps.captures == 5


def test_prepare_leaves_the_state_untouched():
    """``prepare`` makes the entry without writing the live state; the
    next call is warm and writes it once; ``eager`` is uncounted."""
    steps = StepCache("bump", _bump)
    acc, w = torch.zeros(4), torch.zeros(())
    x = np.full(4, 2.0, np.float32)
    with CompileCounter() as cc:
        assert steps.prepare(state=(acc,), params=(w,), inputs=(x,),
                             static=(1.0,))
        assert not steps.prepare(state=(acc,), params=(w,), inputs=(x,),
                                 static=(1.0,))
    assert cc.events == 1 and float(acc.sum()) == 0.0
    with CompileCounter() as cc:
        out = steps(state=(acc,), params=(w,), inputs=(x,), static=(1.0,))
        same = steps.eager(state=(acc,), params=(w,), inputs=(x,),
                           static=(1.0,))
    assert cc.events == 0
    assert float(out) == 8.0 and float(same) == 16.0


def test_compile_counters_nest_and_detach():
    steps = StepCache("bump", _bump)
    w = torch.zeros(())
    with CompileCounter() as outer:
        steps(state=(torch.zeros(2),), params=(w,),
              inputs=(torch.ones(2),), static=(1.0,))
        with CompileCounter() as inner:
            steps(state=(torch.zeros(2),), params=(w,),
                  inputs=(torch.ones(2),), static=(1.0,))
    steps(state=(torch.zeros(2),), params=(w,), inputs=(torch.ones(2),),
          static=(1.0,))
    assert (outer.events, inner.events) == (2, 1)


# ---------------------------------------------------------------------------
# decode and the sLSTM scan through their step caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", ["internlm2-1.8b", "xlstm-350m"])
def test_decode_step_is_one_entry_per_cache(arch_id):
    """The pod-step is one entry per (weights, cache): warm steps add none,
    a cache that ``migrate_sessions`` replaces adds one, and every step's
    tokens and cache equal ``step.eager``'s on a copy of the cache."""
    arch = tc.reduced(tc.get_arch(arch_id))
    params = zoo.init_params(arch, seed=0, dtype=torch.float32,
                             device="cpu")
    if arch.family == "ssm":
        blocks = params["blocks"]
        for cell in (blocks["mlstm"]["cell"], blocks["slstm"]["cell"]):
            cell["norm"].fill_(1.0)
    live = tree_map(lambda v: torch.stack([v] * 2),
                    zoo.init_cache(arch, 2, 24, device="cpu"))
    step = serve.make_decode_step(arch, n_pods=2, device="cpu",
                                  compute_dtype=torch.float32)
    token = torch.from_numpy(np.random.default_rng(0).integers(
        0, arch.vocab_size, (2, 2, 1)).astype(np.int32))
    twin = tree_map(torch.clone, live)
    with CompileCounter() as cc:
        for _ in range(4):
            want, twin = step.eager(params, twin, token)
            token, live = step(params, live, token)
            assert torch.equal(token, want)
    assert cc.events == 1
    for x, y in zip(tree_flatten(live)[0], tree_flatten(twin)[0]):
        assert torch.equal(x, y)
    migrate = serve.make_migrate_sessions_step(device="cpu")
    backup = serve.make_replicate_sessions_step(device="cpu")(live)
    restored = migrate(live, backup, torch.tensor([True, False]))
    with CompileCounter() as cc:
        step(params, restored, token)
        step(params, restored, token)
    assert cc.events == 1


@pytest.mark.parametrize("S", [128, 100])
def test_slstm_scan_in_blocks_is_the_loop(S):
    """``slstm_scan`` in its blocks (S=128: two of 64; S=100: 64, then the
    36-step tail as 32 and 4) equals ``slstm_loop`` over the whole
    sequence bit for bit: hs and the final carry."""
    assert [n for _, n in xlstm.slstm_blocks(S)] == \
        {128: [64, 64], 100: [64, 32, 4]}[S]
    arch = tc.reduced(tc.get_arch("xlstm-350m"))
    gen = torch.Generator().manual_seed(0)
    p = xlstm.slstm_init(gen, arch)
    rng = np.random.default_rng(S)
    B, d = 2, arch.d_model
    wx = torch.from_numpy(rng.normal(size=(B, S, 4 * d)).astype(np.float32))
    init = xlstm.slstm_cache_init(arch, B, torch.float32, device="cpu")
    carry = (init["c"], init["n"], init["m"], init["h"])
    h = arch.xlstm.num_heads
    want_hs, want_c = xlstm.slstm_loop(wx, p["r"], p["b"], carry, h)
    got_hs, got_c = xlstm.slstm_scan(wx, p["r"], p["b"], carry, h)
    assert torch.equal(got_hs, want_hs)
    for x, y in zip(got_c, want_c):
        assert torch.equal(x, y)


def test_step_cache_bounds_its_entries():
    """Ever new shapes (a prompt length a request) keep at most
    ``MAX_ENTRIES`` (64) entries, the least recently used going first."""
    assert graphs.MAX_ENTRIES == 64
    steps = StepCache("bump", _bump)
    w = torch.zeros(())
    arenas = {n: torch.zeros(n) for n in range(1, 68)}

    def run(n):
        steps(state=(arenas[n],), params=(w,),
              inputs=(np.ones(n, np.float32),), static=(1.0,))

    for n in range(1, 68):
        run(n)
    assert len(steps) == 64 and steps.captures == 67
    with CompileCounter() as cc:
        run(67)                     # the newest stays
        run(1)                      # the oldest went
    assert cc.events == 1 and len(steps) == 64


def test_restore_makes_its_fold_entries_before_serving():
    """A restore's catch-up puts a new arena in place: the membership makes
    its fold entries (every bucket of the restored node) before the node
    is routable again, so the warm round after it makes none; the crash
    itself, with replicas left on two nodes, makes none."""
    c = _port_cluster()
    c.engine.prewarm()
    x = np.ones((8,), np.float32)
    _round_all(c, x)
    m = ElasticMembership(c)
    with CompileCounter() as crash:
        m.crash("edge2")
    with CompileCounter() as restore:
        assert m.restore("edge2") == ["tpp_warmkg"]
    with CompileCounter() as warm:
        _round_all(c, x)
    assert (crash.events, restore.events, warm.events) == \
        (0, len(DEFAULT_BUCKETS), 0)


@enoki_function(name="tpp_fill", keygroups=["tpp_fillkg"], codec_width=8)
def tpp_fill(kv, x):
    for i in range(40):
        kv.set(f"f{i}", x + float(i))
    return x[:1]


def test_heavy_fold_runs_in_blocks():
    """A handler of 40 kv ops folds in blocks of 16 requests (a captured
    graph unrolls its requests), the clock carried from block to block:
    the arena, the clock and ys equal the fold of the whole batch at once,
    bit for bit; the 64 and 256 buckets share the one 16-request entry."""
    from repro_torch.core.faas import fold_block
    assert [fold_block(n) for n in (0, 1, 3, 40, 64, 2000)] == \
        [1024, 1024, 256, 16, 16, 1]
    c = Cluster({"edge": "edge"}, measure_compute=False, device="cpu")
    c.deploy(get_function("tpp_fill"), ["edge"],
             example_input=np.zeros(8, np.float32))
    bh = c.nodes["edge"].batched_handlers["tpp_fill"]
    assert bh.block == 16
    store = c.store_of("tpp_fillkg", "edge")
    clock = c.nodes["edge"].clock
    rng = np.random.default_rng(3)
    for b, n in ((64, 61), (256, 256), (8, 5)):
        xs = rng.integers(-4, 5, (b, 8)).astype(np.float32)
        valid = torch.arange(b) < n
        twin = arena_clone(store)
        _, clk, ys, _ = bh(store, clock, xs, valid)
        _, eclk, eys, _ = bh.eager(twin, clock, xs, valid)
        for x, y in zip(store, twin):
            assert torch.equal(x, y)
        assert torch.equal(clk, eclk) and torch.equal(ys, eys)
        clock = clk
    assert bh.steps.captures == 2 and len(bh.steps) == 2     # 16 and 8
