"""The port's tracer (``repro_torch.core.spans``): off it records and
opens nothing; on (``recording()``, or a running ``torch.profiler``) it
keeps nested records with their counts, on kineto's clock; a reduced
internlm2 and a reduced zamba2 prefill record one span a sub-layer and
compute the same bits with tracing on and off; a replication counts the
bytes it moves; a CUDA graph's capture records nothing (``cuda``).  A
few seconds on the CPU."""
import collections

import pytest
import torch

from repro_torch.configs import (AttnImpl, ShapeConfig, StepKind, get_arch,
                                 reduced)
from repro_torch.core import spans
from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.launch import serve
from repro_torch.models import model_zoo as zoo
from repro_torch.models.transformer import plan


@pytest.fixture(autouse=True)
def empty_buffer():
    spans.clear()
    yield
    spans.clear()


def test_off_records_and_opens_nothing(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    called = []
    with spans.span("a", n=lambda: called.append(1)) as rec:
        torch.ones(3).sum()
    assert rec is None and not opened and not called
    assert spans.records() == []


def test_recording_nests_records_with_their_counts():
    with spans.recording():
        with spans.span("outer", items=3) as outer:
            with spans.span("inner", nbytes=lambda: 2 * 8):
                torch.ones(4).sum()
            with spans.span("inner"):
                pass
    with spans.span("after"):
        pass
    got = spans.records()
    assert [r.name for r in got] == ["inner", "inner", "outer"]
    assert got[2] is outer and outer.parent is None
    assert got[0].parent is outer and got[1].parent is outer
    assert outer.counts == {"items": 3} and got[0].counts == {"nbytes": 16}
    assert got[1].counts == {}
    assert outer.start_ns <= got[0].start_ns <= got[0].end_ns <= \
        got[1].start_ns <= got[1].end_ns <= outer.end_ns
    # the CPU has no events: a record's device time is its host time
    assert all(r.events is None and r.device_ms() == r.host_ms >= 0
               for r in got)


def test_records_keep_the_newest_and_count_the_dropped(monkeypatch):
    monkeypatch.setattr(spans, "CAP", 4)
    monkeypatch.setattr(spans, "_buffer", collections.deque(maxlen=4))
    with spans.recording():
        for i in range(6):
            with spans.span(f"s{i}"):
                pass
    assert [r.name for r in spans.records()] == ["s2", "s3", "s4", "s5"]
    assert spans.dropped == 2


def test_a_profiler_turns_recording_on_on_its_clock():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(20):             # the first ranges open slowly
            with spans.span("warm"):
                pass
        spans.clear()
        with spans.span("test.outer"):
            for i in range(3):
                with spans.span(f"test.inner{i}"):
                    torch.ones(1000).cumsum(0)
    got = spans.records()
    assert len(got) == 4
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(spans.PREFIX + "test.")}
    for rec in got:
        e = ranges[spans.PREFIX + rec.name]
        assert abs(e.start_ns() - rec.start_ns) < 50_000, rec.name
        assert abs(e.start_ns() + e.duration_ns() - rec.end_ns) < 50_000, \
            rec.name


@pytest.mark.parametrize("arch_id", ["internlm2-1.8b", "zamba2-7b"])
def test_prefill_records_one_span_a_sub_layer(arch_id):
    arch = reduced(get_arch(arch_id))
    shape = ShapeConfig("t", 24, 2, StepKind.PREFILL)
    step = serve.make_prefill_step(arch, shape, impl=AttnImpl.FLASH,
                                   device="cpu")
    params = zoo.init_params(arch, seed=1, dtype=torch.bfloat16,
                             device="cpu")
    tokens = torch.randint(0, arch.vocab_size, (2, 24),
                           generator=torch.Generator().manual_seed(2))
    off_logits, off_cache = step(params, {"tokens": tokens})
    assert spans.records() == []
    with spans.recording():
        logits, cache = step(params, {"tokens": tokens})
    p = plan(arch)
    if p["kind"] == "dense":
        blocks, mamba = p["layers"], 0
    else:                   # the shared block after each group
        blocks, mamba = p["groups"], arch.num_layers
    got = spans.records()
    top = [r for r in got if r.name == "serve.prefill"]
    assert len(top) == 1 and top[0].parent is None
    # the head: forward_seq's final norm and logits, and the step's copy
    # of the last position's
    want = {"model.attention": blocks, "model.mlp": blocks,
            "model.mamba": mamba, "model.head": 2}
    assert collections.Counter(r.name for r in got if r.parent is top[0]) \
        == {k: n for k, n in want.items() if n}
    assert len(got) == 2 * blocks + mamba + 3
    assert torch.equal(logits, off_logits)
    for a, b in zip(tree_flatten(cache)[0], tree_flatten(off_cache)[0]):
        assert torch.equal(a, b)


def test_replication_counts_the_bytes_it_moves():
    arch = reduced(get_arch("zamba2-7b"))
    one = zoo.init_cache(arch, 2, 16, device="cpu")
    live = tree_map(lambda x: torch.stack([x, x + 1]), one)   # two pods
    replicate = serve.make_replicate_sessions_step(device="cpu")
    with spans.recording():
        backup = replicate(live)
    (rec,) = spans.records()
    leaves = tree_flatten(live)[0]
    assert rec.name == "serve.replicate"
    assert rec.counts == {"bytes": 2 * sum(x.nbytes for x in leaves)}
    for a, b in zip(tree_flatten(backup)[0], leaves):
        assert torch.equal(a, torch.roll(b, 1, 0))


@pytest.mark.cuda
def test_a_graph_capture_records_nothing():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    from repro_torch.core.graphs import StepCache

    def body(state, params, inputs):
        with spans.span("test.body"):
            return state * 2 + inputs

    dev = torch.device("cuda")
    x = torch.arange(8.0, device=dev)
    steps = StepCache("spans-test", body)
    ones = torch.ones(8, device=dev)     # kept: its address is the key's
    first = steps(state=ones, inputs=x)
    state = torch.full((8,), 3.0, device=dev)
    with spans.recording():
        # a new state address of a shape the cache holds: a capture with
        # no warm-up, then replays
        outs = [steps(state=state, inputs=x) for _ in range(3)]
    torch.cuda.synchronize()
    assert steps.captures == 2 and steps.replays == 4
    assert spans.records() == []
    assert torch.equal(first, ones * 2 + x)
    for out in outs:
        assert torch.equal(out, state * 2 + x)
    with spans.recording():         # the eager body still records
        steps.eager(state=state, inputs=x)
    torch.cuda.synchronize()
    (rec,) = spans.records()
    assert rec.events is not None and rec.device_ms() >= 0
