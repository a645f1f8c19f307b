"""AST lock-discipline lint for the port's serving stack: the counterpart
of ``repro.analysis.lockcheck``, with the port's tables.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis.lockcheck src/repro_torch

Reads the ``LOCK_ORDER`` declaration (``repro_torch.analysis.lock_order``)
and walks every
module's ``with``-nesting plus an INTRAMODULE call-graph approximation.
Four rule families:

``order``
    Acquiring a lock that the declared partial order does not allow under
    the currently-held set — including anything under a leaf lock.  Held
    sets propagate through ``self.method()`` calls, module-level function
    calls, and method calls whose name is defined by exactly one class in
    the module (the call-graph approximation; cross-module calls are the
    runtime validator's job).
``dispatch-under-qlock``
    A device-dispatch call (``_exec_*``, the kernel wrappers, a step
    cache's capture or replay, ``torch.*`` chains, engine/cluster
    dispatch verbs; ``lock_order.DISPATCH_CALL_NAMES``) LEXICALLY inside a
    ``with self._qlock`` block — the queue lock must never be held across
    a dispatch.
``stats-raw-increment`` / ``guarded-field`` / ``shared-counter``
    Raw ``+=`` on an ``AtomicStats`` field (must use ``.inc``); raw
    ``+=`` on a declared guarded field outside its declared lock; raw
    ``+=`` on any attribute of a threaded class with no lock held at all.
``blocking-under-lock``
    ``sleep`` / ``Future.result`` / ``join`` / ``shutdown`` /
    ``Condition.wait`` lexically under a non-leaf lock.  ``x.wait()``
    while lexically holding ``with x:`` is the sanctioned
    condition-variable pattern and is exempt.

Suppressions (the reference's syntax, ``docs/concurrency_checks.md``)::

    ... # lockcheck: ok[rule-name] — reason
    class Foo:  # lockcheck: single-threaded — reason

Static analysis over-approximates: same-name nesting is assumed
reentrant (the runtime validator distinguishes instances), unresolvable
lock expressions are skipped, and only intramodule calls are followed.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import pathlib
import sys
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis import lock_order as spec

PRAGMA = "# lockcheck:"


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class _Held:
    """One lock on the abstract held stack.  ``inherited`` marks entries
    that arrived through the call graph — order checks use the full
    stack, the lexical rules (dispatch/blocking) only the local part."""
    __slots__ = ("name", "text", "inherited")

    def __init__(self, name: str, text: str, inherited: bool) -> None:
        self.name = name
        self.text = text
        self.inherited = inherited

    def as_inherited(self) -> "_Held":
        return _Held(self.name, self.text, True)


class _Module:
    def __init__(self, path: str, src: str, tree: ast.Module) -> None:
        self.path = path
        self.functions: Dict[str, ast.AST] = {}
        self.classes: Dict[str, Dict[str, ast.AST]] = {}
        self.method_owners: Dict[str, List[str]] = {}
        class_linenos: Dict[str, int] = {}
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            elif isinstance(node, ast.ClassDef):
                meths = {}
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        meths[sub.name] = sub
                        self.method_owners.setdefault(sub.name,
                                                      []).append(node.name)
                self.classes[node.name] = meths
                class_linenos[node.name] = node.lineno
        self.line_rules, self.st_lines = self._parse_pragmas(src)
        self.st_classes = {c for c, ln in class_linenos.items()
                           if ln in self.st_lines}

    @staticmethod
    def _parse_pragmas(src: str) -> Tuple[Dict[int, Set[str]], Set[int]]:
        line_rules: Dict[int, Set[str]] = {}
        st_lines: Set[int] = set()
        for i, line in enumerate(src.splitlines(), 1):
            if PRAGMA not in line:
                continue
            tail = line.split(PRAGMA, 1)[1].strip()
            if tail.startswith("single-threaded"):
                st_lines.add(i)
            elif tail.startswith("ok"):
                rest = tail[len("ok"):]
                if rest.startswith("[") and "]" in rest:
                    rules = rest[1:rest.index("]")]
                    line_rules.setdefault(i, set()).update(
                        r.strip() for r in rules.split(","))
                else:
                    line_rules.setdefault(i, set()).add("*")
        return line_rules, st_lines


class _Checker:
    def __init__(self, mod: _Module) -> None:
        self.mod = mod
        self.findings: List[Finding] = []
        self._emitted: Set[Tuple[int, str, str]] = set()
        self._memo: Set[Tuple[int, Tuple[str, ...]]] = set()
        self._pending: List[Tuple[ast.AST, Optional[str]]] = []

    # ------------------------------------------------------------- entry
    def run(self) -> List[Finding]:
        for fn in self.mod.functions.values():
            self._pending.append((fn, None))
        for cls, meths in self.mod.classes.items():
            for fn in meths.values():
                self._pending.append((fn, cls))
        done: Set[int] = set()
        while self._pending:
            fn, cls = self._pending.pop()
            if id(fn) in done:
                continue
            done.add(id(fn))
            self._check_fn(fn, cls, ())
        return self.findings

    def _check_fn(self, fn: ast.AST, cls: Optional[str],
                  held: Tuple[_Held, ...]) -> None:
        key = (id(fn), tuple(sorted(h.name for h in held)))
        if key in self._memo:
            return
        self._memo.add(key)
        self._stmts(fn.body, cls, held)

    # --------------------------------------------------------- statements
    def _stmts(self, body: Iterable[ast.stmt], cls: Optional[str],
               held: Tuple[_Held, ...]) -> None:
        for st in body:
            self._stmt(st, cls, held)

    def _stmt(self, st: ast.stmt, cls: Optional[str],
              held: Tuple[_Held, ...]) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: runs later, on whoever calls it — walk with an
            # empty held set, same class context (closures keep ``self``)
            self._pending.append((st, cls))
            return
        if isinstance(st, ast.ClassDef):
            return
        if isinstance(st, (ast.With, ast.AsyncWith)):
            new_held = held
            for item in st.items:
                self._exprs(item.context_expr, cls, new_held)
                name = self._resolve_lock(item.context_expr, cls)
                if name is None:
                    continue
                if any(h.name == name for h in new_held):
                    continue            # same-name: assumed reentrant
                for h in new_held:
                    if not spec.allowed(h.name, name):
                        self._emit(
                            st.lineno, "order",
                            f"acquires {name!r} while holding {h.name!r} "
                            f"(held: {[x.name for x in new_held]}) — not "
                            f"allowed by LOCK_ORDER")
                text = ast.unparse(item.context_expr)
                new_held = new_held + (_Held(name, text, False),)
            self._stmts(st.body, cls, new_held)
            return
        if isinstance(st, ast.AugAssign):
            self._augassign(st, cls, held)
            self._exprs(st.value, cls, held)
            return
        for _, value in ast.iter_fields(st):
            if isinstance(value, list):
                for v in value:
                    if isinstance(v, ast.stmt):
                        self._stmt(v, cls, held)
                    elif isinstance(v, ast.excepthandler):
                        self._stmts(v.body, cls, held)
                    elif isinstance(v, ast.expr):
                        self._exprs(v, cls, held)
            elif isinstance(value, ast.expr):
                self._exprs(value, cls, held)

    # -------------------------------------------------------- expressions
    def _exprs(self, expr: ast.expr, cls: Optional[str],
               held: Tuple[_Held, ...]) -> None:
        stack: List[ast.AST] = [expr]
        while stack:
            node = stack.pop()
            if isinstance(node, ast.Lambda):
                continue                # runs later, unknown held set
            if isinstance(node, ast.Call):
                self._call(node, cls, held)
            stack.extend(ast.iter_child_nodes(node))

    @staticmethod
    def _dotted(func: ast.expr) -> Tuple[Optional[str], List[str]]:
        """(root name, attribute chain) of a call target, or (None, [])
        when the root is not a plain name."""
        attrs: List[str] = []
        node = func
        while isinstance(node, ast.Attribute):
            attrs.append(node.attr)
            node = node.value
        attrs.reverse()
        if isinstance(node, ast.Name):
            return node.id, attrs
        return None, attrs

    def _call(self, node: ast.Call, cls: Optional[str],
              held: Tuple[_Held, ...]) -> None:
        root, attrs = self._dotted(node.func)
        callee = attrs[-1] if attrs else root
        lex = [h for h in held if not h.inherited]

        if callee is not None and lex:
            # dispatch under the queue lock (lexical only)
            if any(h.name == "engine.qlock" for h in lex):
                if (callee.startswith(spec.DISPATCH_CALL_PREFIXES)
                        or callee in spec.DISPATCH_CALL_NAMES
                        or (root in spec.TORCH_ROOTS and attrs)):
                    self._emit(node.lineno, "dispatch-under-qlock",
                               f"{ast.unparse(node.func)}() dispatches "
                               f"while engine.qlock is held")
            # blocking call under a non-leaf lock (lexical only)
            if callee in spec.BLOCKING_CALL_NAMES:
                nonleaf = [h for h in lex if h.name not in spec.LEAF_LOCKS]
                if nonleaf and not self._is_cond_self_wait(node, callee,
                                                          lex):
                    self._emit(node.lineno, "blocking-under-lock",
                               f"{ast.unparse(node.func)}() blocks while "
                               f"holding {[h.name for h in nonleaf]}")

        # order propagation through the intramodule call graph
        for target, tcls in self._resolve_call(node, cls):
            inherited = tuple(h.as_inherited() for h in held)
            self._check_fn(target, tcls, inherited)

    @staticmethod
    def _is_cond_self_wait(node: ast.Call, callee: str,
                           lex: List[_Held]) -> bool:
        if callee not in ("wait", "wait_for"):
            return False
        if not isinstance(node.func, ast.Attribute):
            return False
        recv = ast.unparse(node.func.value)
        return any(h.text == recv for h in lex)

    def _resolve_call(self, node: ast.Call, cls: Optional[str]
                      ) -> List[Tuple[ast.AST, Optional[str]]]:
        f = node.func
        if isinstance(f, ast.Name):
            t = self.mod.functions.get(f.id)
            return [(t, None)] if t is not None else []
        if isinstance(f, ast.Attribute):
            meth = f.attr
            if isinstance(f.value, ast.Name) and f.value.id == "self" and cls:
                t = self.mod.classes.get(cls, {}).get(meth)
                return [(t, cls)] if t is not None else []
            # non-self receiver: follow only when exactly one class in
            # this module defines the method AND the caller's own class
            # doesn't (else ``self.router.submit`` would bind to the
            # caller's unrelated ``submit``)
            if cls is not None and meth in self.mod.classes.get(cls, {}):
                return []
            owners = self.mod.method_owners.get(meth, [])
            if len(owners) == 1 and meth not in self.mod.functions:
                ocls = owners[0]
                return [(self.mod.classes[ocls][meth], ocls)]
        return []

    # --------------------------------------------------------- aug-assign
    def _augassign(self, st: ast.AugAssign, cls: Optional[str],
                   held: Tuple[_Held, ...]) -> None:
        t = st.target
        if not isinstance(t, ast.Attribute):
            return
        recv = t.value
        stats_recv = ((isinstance(recv, ast.Attribute)
                       and recv.attr == "stats")
                      or (isinstance(recv, ast.Name) and recv.id == "stats"))
        if stats_recv:
            self._emit(st.lineno, "stats-raw-increment",
                       f"raw '+=' on stats field {ast.unparse(t)!r} — "
                       f"use AtomicStats.inc")
            return
        if not (isinstance(recv, ast.Name) and recv.id == "self" and cls):
            return
        guard = spec.GUARDED_FIELDS.get((cls, t.attr))
        if guard is not None:
            if not any(h.name == guard for h in held):
                self._emit(st.lineno, "guarded-field",
                           f"self.{t.attr} += requires {guard!r} held "
                           f"(held: {[h.name for h in held]})")
            return
        if (cls in spec.THREADED_CLASSES
                and cls not in self.mod.st_classes
                and not held
                and st.lineno not in self.mod.st_lines):
            self._emit(st.lineno, "shared-counter",
                       f"unlocked '+=' on self.{t.attr} in threaded class "
                       f"{cls} — guard it, use AtomicStats.inc, or "
                       f"annotate '# lockcheck: single-threaded'")

    # ------------------------------------------------------ lock resolving
    def _resolve_lock(self, expr: ast.expr,
                      cls: Optional[str]) -> Optional[str]:
        if not isinstance(expr, ast.Attribute):
            return None
        attr = expr.attr
        name = spec.LOCK_ATTRS.get(attr)
        if name is not None:
            return name
        if attr == "_lock":
            return spec.CLASS_LOCK_ATTRS.get(cls) if cls else None
        if attr == "lock":
            recv = expr.value
            hint = None
            if isinstance(recv, ast.Name):
                hint = recv.id
            elif isinstance(recv, ast.Attribute):
                hint = recv.attr
            if hint is not None:
                if hint == "q" or "queue" in hint:
                    return "cluster.delivery_lock"
                if "cycle" in hint:
                    return "engine.cycle_state_lock"
            return "cluster.node_lock"
        return None

    # -------------------------------------------------------------- emit
    def _emit(self, line: int, rule: str, message: str) -> None:
        suppressed = self.mod.line_rules.get(line, set())
        if rule in suppressed or "*" in suppressed:
            return
        key = (line, rule, message)
        if key in self._emitted:
            return
        self._emitted.add(key)
        self.findings.append(Finding(self.mod.path, line, rule, message))


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------


def check_source(src: str, path: str = "<string>") -> List[Finding]:
    tree = ast.parse(src, filename=path)
    mod = _Module(path, src, tree)
    findings = _Checker(mod).run()
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def iter_py_files(paths: Iterable[str]) -> List[pathlib.Path]:
    out: List[pathlib.Path] = []
    for p in paths:
        pp = pathlib.Path(p)
        if pp.is_dir():
            out.extend(sorted(pp.rglob("*.py")))
        elif pp.suffix == ".py":
            out.append(pp)
    return out


def check_paths(paths: Iterable[str]) -> List[Finding]:
    findings: List[Finding] = []
    for f in iter_py_files(paths):
        findings.extend(check_source(f.read_text(), str(f)))
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="AST lock-discipline lint (LOCK_ORDER contract)")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to lint (default: "
                         "src/repro_torch)")
    args = ap.parse_args(argv)
    findings = check_paths(args.paths)
    for f in findings:
        print(f)
    n_files = len(iter_py_files(args.paths))
    if findings:
        print(f"lockcheck: {len(findings)} finding(s) in {n_files} files",
              file=sys.stderr)
        return 1
    print(f"lockcheck: OK ({n_files} files clean)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
