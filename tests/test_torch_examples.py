"""The example twins (``examples/torch_*.py``) against the reference's own
examples, on the CPU.

The reference side is the example file itself, loaded with ``importlib``:
its handlers register in the reference's registry, and its ``main`` runs
with two names of its module replaced — ``Cluster``, whose clusters are
built with ``measure_compute=False`` (so no measured wall time enters the
virtual timeline), and ``print``, which keeps every line and the locals
of ``main`` at that line (``Reference.at``).  The twin's
``run(device="cpu", measure_compute=False)`` drives the same scenario
through the port, and what both show is compared bit for bit
(``torch_parity.assert_same_record``): every result's timeline, node,
output and kv ops, every arena (keys, values, lengths, versions, vv),
clock and stats counter.

serve_wallclock, whose counts follow the wall clock, is held on what does
not.  serve_sessions is held in float32 on its tokens and caches, and in
bfloat16 on the first step's logits (the reference's prefill/decode bound)
and the staleness.

``test_main_prints_the_reference_lines`` runs each twin's ``main`` on the
CPU and compares its lines with the reference example's, numbers that
depend on wall time (or, for serve_sessions, on the weights) masked.
"""
import contextlib
import dataclasses
import functools
import importlib.util
import io
import pathlib
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.models import model_zoo as ref_zoo
from repro_torch import configs as tc
from repro_torch.core.carry import params_from_numpy
from torch_parity import assert_same_record, record, ref_numpy, to_np
from torch_parity import port_lockdep  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


@functools.lru_cache(maxsize=None)
def load(name):
    """An example file as a module of its own (loaded once a process)."""
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Reference:
    lines: list           # what ``main`` printed, line by line
    frames: list          # (text of one print call, locals of main there)

    def at(self, prefix):
        """The locals of ``main`` at its print that starts with
        ``prefix`` (leading newlines ignored)."""
        hits = [f for text, f in self.frames
                if text.lstrip("\n").startswith(prefix)]
        assert len(hits) == 1, (prefix, len(hits))
        return hits[0]

    def all_at(self, prefix):
        return [f for text, f in self.frames
                if text.lstrip("\n").startswith(prefix)]


@functools.lru_cache(maxsize=None)
def reference(name) -> Reference:
    """Run the reference example ``name``'s ``main`` (once a process) with
    its clusters built with ``measure_compute=False``."""
    mod = load(name)
    out, frames = io.StringIO(), []

    def capture(*args, sep=" ", end="\n", **_):
        text = sep.join(map(str, args))
        out.write(text + end)
        frames.append((text, dict(sys._getframe(1).f_locals)))

    patched = {"print": capture}
    if hasattr(mod, "Cluster"):
        patched["Cluster"] = functools.partial(mod.Cluster,
                                               measure_compute=False)
    saved = {k: getattr(mod, k, None) for k in patched}
    for k, v in patched.items():
        setattr(mod, k, v)
    try:
        mod.main()
    finally:
        for k, v in saved.items():
            if v is None:
                delattr(mod, k)
            else:
                setattr(mod, k, v)
    return Reference(out.getvalue().splitlines(), frames)


def twin_lines(name) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        load(name).main(["--device", "cpu"])
    return buf.getvalue().splitlines()


# ---------------------------------------------------------------------------
# quickstart: Listing 1, the replicated keygroup, the cloud store
# ---------------------------------------------------------------------------

def test_quickstart_matches_reference():
    ref = reference("quickstart")
    got = load("torch_quickstart").run(device="cpu", measure_compute=False)
    calls = [f["res"] for f in ref.all_at("  call ")]
    last = ref.at("same call with the store in the cloud")
    want = {"calls": record(calls),
            "replicas": {f["node"]: float(np.asarray(f["val"])[0])
                         for f in ref.all_at("replica on ")},
            "cloud": record(last["res"]), "cloud_ms": last["res"].response_ms,
            "cluster": record(last["cluster"]),
            "cloud_cluster": record(last["cluster2"]),
            "merge_dispatches": last["cluster"].stats.merge_dispatches
            + last["cluster2"].stats.merge_dispatches}
    assert_same_record(want, got, "quickstart")
    assert [float(c["output"][0]) for c in got["calls"]] == [1, 2, 3, 4, 5]
    assert got["replicas"] == {"edge": 5.0, "edge2": 5.0}
    assert got["merge_dispatches"] > 0
    assert got["cloud_ms"] > 100.0       # two kv ops, each a 50 ms RTT


# ---------------------------------------------------------------------------
# batched_invoke: sequential vs one batch, flush, windows and pump
# ---------------------------------------------------------------------------

def test_batched_invoke_matches_reference():
    ref = reference("batched_invoke")
    got = load("torch_batched_invoke").run(device="cpu",
                                           measure_compute=False)
    end = ref.at("windowed response_ms")
    flushed = ref.at("flush() served")["results"]
    want = {"sequential": record(end["seq"]), "batched": record(end["bat"]),
            "flushed": record(flushed), "pumped": record(end["served"]),
            "pump_windows": end["st"].windows_flushed - end["before"],
            "engine_stats": record(end["st"]),
            "clusters": [record(end[k]) for k in
                         ("cluster", "cluster2", "cluster3")],
            "merge_dispatches": sum(end[k].stats.merge_dispatches for k in
                                    ("cluster", "cluster2", "cluster3"))}
    got = {k: got[k] for k in want}
    assert_same_record(want, got, "batched_invoke")
    assert got["sequential"][-1]["output"][0] == \
        got["batched"][-1]["output"][0] == 512.0
    assert len(got["flushed"]) == 32
    assert len(got["pumped"]) == 64 and got["pump_windows"] == 8
    assert got["engine_stats"]["deadline_flushes"] == 8
    first = min(got["pumped"])
    assert got["pumped"][first]["response_ms"] == pytest.approx(9.0, abs=0.01)


# ---------------------------------------------------------------------------
# smart_city: the BeFaaS app under both policies
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def smart_city_twin():
    return load("torch_smart_city").run(device="cpu", measure_compute=False)


@pytest.mark.parametrize("policy", ["REPLICATED", "CLOUD_CENTRAL"])
def test_smart_city_matches_reference(policy):
    """Both policies draw from ONE generator, as the example's loop does,
    so each case reads the same two runs: every function's latencies and
    count, and the cluster (the four stateful arenas, the clocks and the
    stats), bit for bit."""
    ref = reference("smart_city")
    label = {"REPLICATED": "edge (Enoki)", "CLOUD_CENTRAL": "cloud store"}
    frame = ref.at(f"store = {label[policy]}:")
    assert frame["policy"].name == policy
    got = smart_city_twin()[getattr(tc.ReplicationPolicy, policy).value]
    assert_same_record(frame["lat"], got["latencies"], policy)
    assert_same_record(record(frame["c"]), got["cluster"], policy)
    assert set(got["arenas"]) == \
        set(load("torch_smart_city").STATEFUL.values())
    for kg, replicas in got["arenas"].items():
        assert replicas, f"no replica of {kg}"
    assert sum(map(len, got["latencies"].values())) == 60


# ---------------------------------------------------------------------------
# serve_wallclock: held on what does not follow the wall clock
# ---------------------------------------------------------------------------

def test_serve_wallclock_matches_reference():
    """Every future resolves; both edges' ``total`` after the replication
    flush equals the reference run's in every part; the hedge fires with
    ``hedge_after_ms`` and never without it, and lowers the median."""
    ref = reference("serve_wallclock")
    got = load("torch_serve_wallclock").run(device="cpu",
                                            measure_compute=False)
    parts = {"open_loop": ref.at("open loop"),
             "closed_loop": ref.at("closed loop"),
             "unhedged": ref.at("straggler no"),
             "hedged": ref.at("straggler with"),
             "asyncio": ref.at("asyncio closed loop")}
    for name, frame in parts.items():
        c = frame["cluster"]
        c.flush_replication()
        want = {n: float(np.asarray(ref_numpy(c.store_of("wc_kg", n))[1])
                         [_slot(c, n)][0]) for n in ("edge", "edge2")}
        assert got[name]["totals"] == want, name
        n = 64 if name in ("hedged", "unhedged") else 128
        assert got[name]["requests"] == got[name]["resolved"] == n, name
    assert got["hedged"]["hedges_fired"] > 0
    assert got["unhedged"]["hedges_fired"] == 0
    assert got["hedged"]["p50_ms"] < got["unhedged"]["p50_ms"]
    assert got["merge_dispatches"] > 0


def _slot(cluster, node):
    from repro.core.versioning import fnv1a
    keys = np.asarray(cluster.store_of("wc_kg", node).keys)
    return int(np.flatnonzero(keys == fnv1a("total"))[0])


# ---------------------------------------------------------------------------
# serve_sessions: tokens and caches in float32, logits and staleness in bf16
# ---------------------------------------------------------------------------

ARCH = "internlm2-1.8b"


def _rel(got, want) -> float:
    got, want = to_np(got).astype(np.float32), to_np(want).astype(np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


def ref_sessions(dtype, n_pods=2, batch=2, max_len=64, R=4, steps=10):
    """``examples/serve_sessions.py``'s scenario in ``dtype`` (weights,
    cache and compute), recording what the example does not keep: every
    session's token and the logits of each step, and the sessions right
    after the migrate."""
    arch = ref_reduced(ref_get_arch(ARCH))
    params = ref_zoo.init_params(arch, jax.random.PRNGKey(0), dtype=dtype)
    sparams = jax.tree.map(lambda l: jnp.stack([l] * n_pods), params)
    step = jax.jit(jax.vmap(lambda p, c, t: ref_zoo.decode_step(
        arch, p, c, t, compute_dtype=dtype)))
    live = jax.tree.map(lambda l: jnp.stack([l] * n_pods),
                        ref_zoo.init_cache(arch, batch, max_len, dtype=dtype))
    backup = live
    token = jnp.ones((n_pods, batch, 1), jnp.int32)
    tokens, logits_seen = [], []
    for t in range(steps):
        logits, live = step(sparams, live, token)
        logits_seen.append(np.asarray(logits[..., -1, :], np.float32))
        token = jnp.argmax(logits[..., -1, :], axis=-1)[..., None] \
            .astype(jnp.int32)
        tokens.append(np.asarray(token)[..., 0])
        if (t + 1) % R == 0:
            backup = jax.tree.map(lambda x: jnp.roll(x, 1, axis=0), live)
    dead = jnp.asarray([True, False])
    restored = jax.tree.map(
        lambda x, y: jnp.where(dead.reshape((n_pods,) + (1,) * (x.ndim - 1)),
                               y, x), live, backup)
    return {"params": jax.device_get(params), "tokens": np.stack(tokens),
            "logits": logits_seen,
            "staleness": int(live["length"][0]) - int(restored["length"][0]),
            "migrated": jax.device_get(restored)}


def test_serve_sessions_float32_tokens_and_caches():
    ref = ref_sessions(jnp.float32)
    arch = tc.reduced(tc.get_arch(ARCH))
    params = params_from_numpy(arch, ref["params"], device="cpu")
    got = load("torch_serve_sessions").run(device="cpu", params=params,
                                           dtype=torch.float32, logits=True)
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])
    assert _rel(got["logits"][0], ref["logits"][0]) < 1e-4
    assert got["staleness"] == ref["staleness"] == 2 <= got["R"]
    assert got["migrated"].keys() == ref["migrated"].keys()
    for key, want in ref["migrated"].items():
        if key == "length":
            np.testing.assert_array_equal(got["migrated"][key], want)
        else:
            assert _rel(got["migrated"][key], want) < 1e-5, key


def test_serve_sessions_bfloat16_logits_and_staleness():
    """The example's dtype: a flipped bf16 argmax changes every later
    token, so the first step's logits are held to the reference's
    prefill/decode bound (``tests/test_arch_smoke.py``), and the
    staleness equals the reference's."""
    ref = ref_sessions(jnp.bfloat16)
    arch = tc.reduced(tc.get_arch(ARCH))
    params = params_from_numpy(arch, ref["params"], device="cpu")
    got = load("torch_serve_sessions").run(device="cpu", params=params,
                                           dtype=torch.bfloat16, logits=True)
    assert _rel(got["logits"][0], ref["logits"][0]) < 5e-2
    assert got["staleness"] == ref["staleness"] == 2
    assert got["tokens"].shape == ref["tokens"].shape == (10, 2, 2)


# ---------------------------------------------------------------------------
# each twin's main prints the reference example's lines
# ---------------------------------------------------------------------------

_FLOAT = r" *\d+\.\d+"
#: numbers that follow the wall clock (or the weights) in each example's
#: lines, with the padding of their format: the twin's ``main`` measures
#: compute, the reference run here does not, and serve_sessions' twin
#: decodes with the port's own weights
MASKS = {
    "quickstart": [_FLOAT + " ms"],
    "batched_invoke": [r" *\d+ ops/s", r"\(" + _FLOAT + r"x\)"],
    "smart_city": [_FLOAT + " ms"],
    "serve_wallclock": [r" *\d+ ms wall", r" *\d+ ops/s", r" *\d+ pumps",
                        _FLOAT, r"won: \d+/\d+"],
    "serve_sessions": [r"\[[\d, ]+\]"],
}


def masked(lines, patterns):
    out = []
    for line in lines:
        for p in patterns:
            line = re.sub(p, "#", line)
        out.append(line)
    return out


@pytest.mark.parametrize("name", sorted(MASKS))
def test_main_prints_the_reference_lines(name):
    want = reference(name).lines
    got = twin_lines(f"torch_{name}")
    assert masked(got, MASKS[name]) == masked(want, MASKS[name])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
@pytest.mark.parametrize("name", sorted(MASKS))
def test_main_defaults_to_the_card(name):
    """With no ``--device`` a twin runs on the card; without one it raises
    (``resolve_device``) and never falls back to the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(f"torch_{name}").main([])
