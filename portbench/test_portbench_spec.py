"""The benchmark's files against its contract: every cell of
``BENCHMARK.json`` resolves by name to its configuration, mix, limits and
metric readers; names, units and bounds are well formed; nothing the
harness or the references load is jax or the JAX package.  CPU only, a
few seconds (one subprocess)."""
from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

from portbench import drive, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = spec.cell(name)
    assert issubclass(spec.kind(cell.traffic["kind"]), drive.Mix)
    ref = cell.reference
    assert set(ref.INIT) == set(ref.param_shapes(cell.sizes))
    assert cell.limits and all(v >= 0 for v in cell.limits.values())
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]).read)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer


@pytest.mark.parametrize("name", CELLS)
def test_program_runs_the_configuration(name):
    """The program's registry architecture has the sizes the
    configuration's reference runs (checked by ``Program``), and the
    weights the benchmark makes are exactly the program's parameter
    leaves, shapes and dtypes."""
    from portbench.program import Program
    cell = spec.cell(name)
    prog = Program(cell.config, cell.sizes, "cpu")
    assert prog.arch.name == cell.config["program"]["arch"]
    assert prog.param_shapes() == cell.reference.param_shapes(cell.sizes)


def test_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert spec.applies(e2e[m["moves"]], cell), (m["name"], cell)
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(0 < len(x) <= 200 and "\n" not in x for x in layers)


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + \
        [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert isinstance(BENCH["run_seconds"], int) and \
        1 <= BENCH["run_seconds"] <= 51
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
    for c in BENCH["configs"]:
        cfg = spec.load_json(spec.ROOT / c["file"])
        assert c["file"].startswith("portbench/")
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert isinstance(cfg["assumed"], dict)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_nothing_loads_jax_or_the_jax_package():
    """Every module the harness, its readers and the references load,
    compared by top-level name; and the references load nothing of the
    program."""
    code = """
import sys
from portbench import drive, program, run, spec, trace, weights, work
from portbench.reference import common, dense, hybrid
refs = sorted(m for m in sys.modules if m.split(".")[0] == "repro_torch")
bench = spec.benchmark()
for m in bench["per_layer"]:
    spec.reader(m["name"])
for w in bench["workloads"]:
    spec.kind(spec.cell(w["name"]).traffic["kind"])
from repro_torch.launch import serve
from repro_torch.models import model_zoo
print(refs)
print(sorted({m.split(".")[0] for m in sys.modules}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=spec.ROOT, timeout=120,
                         env={"PYTHONPATH": f"{spec.ROOT / 'src'}:{spec.ROOT}",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    refs, tops = out.stdout.strip().splitlines()[-2:]
    assert refs == "[]"
    tops = eval(tops)
    assert not {"jax", "jaxlib", "flax", "repro"} & set(tops), tops
    assert "repro_torch" in tops


class _Event:
    """A kineto event as ``trace.read`` reads it."""

    def __init__(self, name, cuda, start, dur, corr=0, thread=1):
        from torch.autograd import DeviceType
        self._n, self._s, self._d, self._c, self._t = (name, start, dur,
                                                       corr, thread)
        self._dev = DeviceType.CUDA if cuda else DeviceType.CPU

    def name(self):
        return self._n

    def device_type(self):
        return self._dev

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def correlation_id(self):
        return self._c

    def start_thread_id(self):
        return self._t

    def end_thread_id(self):
        return self._t

    def is_async(self):
        return False


def test_trace_reading():
    """Device ops charged to the span that launched them, a call at a
    time; the window from the first op the stretch launched; busy time as
    the union of overlapping ops; the longest idle gap by host span."""
    from types import SimpleNamespace

    from portbench import trace
    ev = [
        _Event("kernel_before", True, 0, 50, corr=99),    # launched earlier
        _Event("portbench.decode_step", False, 40, 20),
        _Event("cudaGraphLaunch", False, 45, 5, corr=1),
        _Event("portbench.replicate", False, 70, 10),
        _Event("cudaLaunchKernel", False, 72, 2, corr=2),
        _Event("portbench.decode_step", False, 90, 40),
        _Event("cudaGraphLaunch", False, 125, 5, corr=3),
        _Event("k_a", True, 60, 30, corr=1),
        _Event("k_b", True, 70, 10, corr=1),
        _Event("roll", True, 100, 20, corr=2),
        _Event("k_a", True, 150, 30, corr=3),
        _Event("k_b", True, 180, 20, corr=3),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: ev)))
    t = trace.read(prof)
    assert t.window_s == pytest.approx(140e-9)          # 60 .. 200
    assert t.busy_s == pytest.approx((30 + 20 + 50) * 1e-9)
    assert t.per_call["decode_step"] == [2, 2]
    assert t.span_ops("replicate") == (1, pytest.approx(20e-9))
    assert t.spans == {"decode_step": 2, "replicate": 1}
    assert t.matching("k_") == (4, pytest.approx(90e-9))
    assert t.gaps[0] == ("decode_step", pytest.approx(30e-9))
