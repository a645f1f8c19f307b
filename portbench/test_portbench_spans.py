"""The readers of the program's own spans and counters
(``repro_torch.core.spans``) on the tiny cells' traced stretches on the
CPU: every one that applies to a cell reads a number, the five prefill
metrics add up to the ``serve.prefill`` spans' time a prefill, the
replication's bytes are those of the live sessions read and written
once; and on a program without the tracer every reader reads None.  A
few seconds on one CPU."""
from __future__ import annotations

import sys

import pytest
import torch

from portbench import program, spec
from portbench.testing import tiny

PREFILL = ["attention_ms.prefill", "mlp_ms.prefill", "mamba_ms.prefill",
           "head_ms.prefill", "rest_ms.prefill"]
SPANS = PREFILL + ["replicate_gb", "replicate_bw"]
CELLS = ["internlm2-1.8b.prefill_32k", "zamba2-7b.prefill_4k",
         "internlm2-1.8b.decode_1k_replicated",
         "zamba2-7b.decode_2k_replicated"]


def _traced(name: str):
    """The cell's mix after its traced stretch, the tracer's buffer
    holding the stretch's records alone."""
    from repro_torch.core import spans
    cell, arch = tiny(name)
    prog = program.Program(cell.config, cell.sizes, "cpu", arch)
    mix = spec.kind(cell.traffic["kind"])(cell, 5, prog, torch.device("cpu"))
    mix.setup(True)
    spans.clear()
    mix.run_stretch()
    return cell, mix, spans.records()


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    from repro_torch.core import spans
    spans.clear()


@pytest.mark.parametrize("name", CELLS)
def test_every_span_metric_reads_its_cell(name):
    cell, mix, records = _traced(name)
    mine = [m["name"] for m in cell.per_layer if m["name"] in SPANS]
    got = {m: spec.reader(m).read(mix) for m in mine}
    assert mine and all(isinstance(v, float) and v > 0
                        for v in got.values()), got
    if mix.p["kind"] == "prefill":
        prefills = [r for r in records if r.name == "serve.prefill"]
        assert len(prefills) == mix.p["trace_prefills"]
        assert sum(got.values()) == pytest.approx(
            sum(r.device_ms() for r in prefills) / len(prefills), rel=1e-9)
        assert ("mamba_ms.prefill" in got) == ("zamba2" in name)
    else:
        nbytes = sum(x.nbytes for _, x in program.leaves(mix.live))
        calls = [r for r in records if r.name == "serve.replicate"]
        assert len(calls) == mix.trace.spans["replicate"] == 2
        assert got["replicate_gb"] == 2 * nbytes / 1e9
        assert 0 < got["replicate_bw"] < 100


def test_a_program_without_the_tracer_reads_none(monkeypatch):
    import repro_torch.core
    _, mix, _ = _traced("zamba2-7b.prefill_4k")
    monkeypatch.delattr(repro_torch.core, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.core.spans", None)
    for m in SPANS:
        assert spec.reader(m).read(mix) is None, m
