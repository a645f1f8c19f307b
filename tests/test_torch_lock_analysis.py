"""The port's concurrency-contract lint against the reference's.

* Every source case of ``tests/test_lock_analysis.py`` runs through both
  packages' ``check_source``: the same rules fire, except the dispatch
  rule's roots (``jax.vmap`` under the queue lock is the reference's
  dispatch, ``torch.zeros`` the port's) and the port's own dispatch names
  (the kernel wrappers, a step cache's replay).
* The port's tree lints clean with the port's tables, its lock table
  names the port's own classes and attributes, and the generated block of
  ``docs/torch_lock_order.md`` is in sync.
* The port's block equals the reference's but for the module path and the
  one deliberate edge ``membership.lock -> health.lock``.
* A mutant engine with a ``torch`` call under ``self._qlock`` is flagged.
"""
from __future__ import annotations

import ast
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest

from repro.analysis import lock_order as ref_order
from repro.analysis.lockcheck import check_source as ref_check
from repro_torch.analysis import lock_order as port_order
from repro_torch.analysis.lockcheck import check_paths, check_source

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"

# (name, source, the reference's rules, the port's rules)
CASES = [
    ("inverted_acquisition", """
        class BatchedInvocationEngine:
            def bad(self):
                with self._qlock:
                    with self._cycle_lock:
                        pass
    """, ["order"], ["order"]),
    ("inversion_through_call_graph", """
        class BatchedInvocationEngine:
            def helper(self):
                with self._cycle_lock:
                    pass
            def bad(self):
                with self._qlock:
                    self.helper()
    """, ["order"], ["order"]),
    ("dispatch_exec_under_qlock", """
        class BatchedInvocationEngine:
            def bad(self, xs):
                with self._qlock:
                    return self._exec_group(xs)
    """, ["dispatch-under-qlock"], ["dispatch-under-qlock"]),
    ("dispatch_jax_under_qlock", """
        import jax
        class BatchedInvocationEngine:
            def bad(self, xs):
                with self._qlock:
                    return jax.vmap(lambda x: x)(xs)
    """, ["dispatch-under-qlock"], []),
    ("dispatch_torch_under_qlock", """
        import torch
        class BatchedInvocationEngine:
            def bad(self, xs):
                with self._qlock:
                    return torch.zeros(1)
    """, [], ["dispatch-under-qlock"]),
    ("dispatch_kernel_under_qlock", """
        class BatchedInvocationEngine:
            def bad(self, acc, snaps):
                with self._qlock:
                    enoki_merge_rows(acc, snaps)
                    self.steps.replay()
    """, [], ["dispatch-under-qlock", "dispatch-under-qlock"]),
    ("raw_stats_increment", """
        class Router:
            def bad(self):
                self.stats.requests += 1
    """, ["stats-raw-increment"], ["stats-raw-increment"]),
    ("blocking_under_cycle_lock", """
        import time
        class BatchedInvocationEngine:
            def bad(self):
                with self._cycle_lock:
                    time.sleep(0.1)
    """, ["blocking-under-lock"], ["blocking-under-lock"]),
    ("future_result_under_router_lock", """
        class Router:
            def bad(self, fut):
                with self._lock:
                    return fut.result(timeout=1.0)
    """, ["blocking-under-lock"], ["blocking-under-lock"]),
    ("condition_self_wait_is_exempt", """
        class FaasServer:
            def ok(self):
                with self._cond:
                    self._cond.wait(0.1)
    """, [], []),
    ("guarded_field_without_lock", """
        class FaasServer:
            def bad(self):
                self._submit_gen += 1
            def ok(self):
                with self._cond:
                    self._submit_gen += 1
    """, ["guarded-field"], ["guarded-field"]),
    ("unlocked_shared_counter", """
        class Cluster:
            def bad(self):
                self.hits += 1
    """, ["shared-counter"], ["shared-counter"]),
    ("acquire_under_leaf_via_inc", """
        class AtomicStats:
            def inc(self, name, n=1):
                with self._lock:
                    setattr(self, name, getattr(self, name) + n)
        class BatchedInvocationEngine:
            def _exec_chunk(self, cycle, rkey):
                with cycle.lock:
                    if rkey in cycle.repl:
                        self.stats.inc("x")
    """, ["order"], ["order"]),
    ("line_suppression_silences_rule", """
        import time
        class BatchedInvocationEngine:
            def ok(self):
                with self._cycle_lock:
                    time.sleep(0.1)   # lockcheck: ok[blocking-under-lock]
    """, [], []),
    ("suppression_is_rule_specific", """
        import time
        class BatchedInvocationEngine:
            def bad(self):
                with self._cycle_lock:
                    time.sleep(0.1)   # lockcheck: ok[order]
    """, ["blocking-under-lock"], ["blocking-under-lock"]),
    ("single_threaded_class_annotation", """
        class Cluster:   # lockcheck: single-threaded
            def ok(self):
                self.hits += 1
    """, [], []),
]


@pytest.mark.parametrize("name,src,ref_rules,port_rules", CASES,
                         ids=[c[0] for c in CASES])
def test_case_rules_against_the_reference(name, src, ref_rules, port_rules):
    src = textwrap.dedent(src)
    assert [f.rule for f in ref_check(src)] == ref_rules
    assert [f.rule for f in check_source(src)] == port_rules


def test_port_tree_is_clean():
    findings = check_paths([str(PORT)])
    assert findings == [], "\n".join(str(f) for f in findings)


def test_lockcheck_cli_prints_ok():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lockcheck",
         "src/repro_torch"], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={"PYTHONPATH": str(REPO / "src"),
                          "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "lockcheck: OK" in proc.stdout


def test_docs_block_in_sync():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lock_order",
         "--check"], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert port_order.check_docs(REPO / "docs" / "torch_lock_order.md")
    assert port_order._default_doc_path() == \
        REPO / "docs" / "torch_lock_order.md"


def test_doc_block_equals_the_reference_but_path_and_health_edge(
        monkeypatch):
    edge = ("membership.lock", "health.lock", None)
    assert edge in port_order.ORDER_EDGES
    assert edge not in ref_order.ORDER_EDGES
    monkeypatch.setattr(port_order, "ORDER_EDGES", tuple(
        e for e in port_order.ORDER_EDGES if e != edge))
    want = ref_order.render_doc_block().replace(
        "src/repro/analysis/lock_order.py",
        "src/repro_torch/analysis/lock_order.py").replace(
        "python -m repro.analysis.lock_order",
        "python -m repro_torch.analysis.lock_order")
    assert port_order.render_doc_block() == want


def test_spec_has_every_table_and_function_of_the_reference():
    names = ["LOCKS", "LEAF_LOCKS", "ORDER_EDGES", "GUARDED_FIELDS",
             "THREADED_CLASSES", "LOCK_ATTRS", "CLASS_LOCK_ATTRS",
             "DISPATCH_CALL_NAMES", "DISPATCH_CALL_PREFIXES",
             "BLOCKING_CALL_NAMES", "allowed", "assert_dag", "check_docs",
             "sync_docs", "extract_doc_block", "render_doc_block", "main",
             "_default_doc_path", "_topo_nonleaf", "DOC_BEGIN", "DOC_END"]
    for n in names:
        assert hasattr(ref_order, n), n
        assert hasattr(port_order, n), n
    for n in ("LOCKS", "LEAF_LOCKS", "GUARDED_FIELDS", "THREADED_CLASSES",
              "LOCK_ATTRS", "CLASS_LOCK_ATTRS", "BLOCKING_CALL_NAMES",
              "DISPATCH_CALL_PREFIXES"):
        assert getattr(port_order, n) == getattr(ref_order, n), n
    assert port_order.DISPATCH_CALL_NAMES > ref_order.DISPATCH_CALL_NAMES
    assert port_order.TORCH_ROOTS == {"torch"}
    assert not hasattr(port_order, "JAX_ROOTS")
    port_order.assert_dag()


def _sources() -> str:
    return "\n".join(p.read_text() for p in sorted(PORT.rglob("*.py")))


def test_lock_tables_name_the_ports_own_classes_and_attributes():
    """Every class of ``CLASS_LOCK_ATTRS``, ``THREADED_CLASSES`` and the
    guarded fields exists in the port, every ``LOCK_ATTRS`` attribute is
    made there with the lock name it maps to, and so is every class's
    ``_lock``."""
    classes = {}
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ClassDef):
                classes[node.name] = ast.unparse(node)
    for cls in (set(port_order.CLASS_LOCK_ATTRS)
                | set(port_order.THREADED_CLASSES)
                | {c for c, _ in port_order.GUARDED_FIELDS}):
        assert cls in classes, cls
    src = _sources()
    for attr, lock in port_order.LOCK_ATTRS.items():
        made = re.search(rf"self\.{attr} = lockdep\.make_\w+\(\s*['\"]"
                         rf"{re.escape(lock)}['\"]", src)
        assert made, (attr, lock)
    for cls, lock in port_order.CLASS_LOCK_ATTRS.items():
        body = classes[cls]
        if "make_" not in body:          # a subclass: its base makes it
            base = re.search(rf"class {cls}\((\w+)\)", body).group(1)
            body = classes[base]
        assert re.search(rf"make_\w+\(['\"]{re.escape(lock)}['\"]", body), \
            (cls, lock)
    for (cls, attr), lock in port_order.GUARDED_FIELDS.items():
        assert f"self.{attr} += " in classes[cls], (cls, attr)


def test_mutant_torch_call_under_qlock_is_flagged():
    src = (PORT / "core" / "engine.py").read_text()
    lines = src.splitlines()
    i = next(n for n, line in enumerate(lines)
             if line.strip() == "with self._qlock:")
    indent = lines[i][:len(lines[i]) - len(lines[i].lstrip())] + "    "
    mutant = "\n".join(lines[:i + 1] + [indent + "torch.zeros(1)"]
                       + lines[i + 1:])
    assert check_source(src, "engine.py") == []
    found = [f for f in check_source(mutant, "engine.py")
             if f.rule == "dispatch-under-qlock"]
    assert [f.line for f in found] == [i + 2]
