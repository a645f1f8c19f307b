"""Runtime lock-order validator (lockdep debug mode).

The serving-stack locks are constructed through the factories below
(``make_lock`` / ``make_rlock`` / ``make_condition``).  Disabled — the
default — they return plain ``threading`` primitives: zero overhead, no
behaviour change.  Enabled (``lockdep.enable()``, done by the conftest
fixture across the concurrency test suites), they return ordered
wrappers that on every acquire:

1. check the declared partial order (``lock_order.allowed``) against the
   calling thread's held-lock stack and raise ``LockOrderViolation`` on
   an out-of-order acquisition (also recorded, so a violation swallowed
   by an executor still fails the test at teardown);
2. record the (held -> acquired) name edge into a process-wide
   acquisition graph.  ``verify()`` reports recorded violations plus any
   cycle in that graph — the cross-THREAD check: two threads may each be
   locally consistent while jointly forming an A->B / B->A deadlock.

Locks whose names are not in ``lock_order.LOCKS`` are record-only: no
order is asserted, but their edges still feed the cycle check.

Reentrancy is by identity: re-acquiring the SAME object (RLocks do) is
fine; nesting two *distinct* instances of the same name (two store-node
locks, say) has no defined order and is a violation.

``enable()`` must run before the instrumented objects are constructed —
already-built plain locks stay plain.  The conftest fixture enables
lockdep before each test body, so clusters/servers built inside the test
get wrapped locks.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis import lock_order

__all__ = [
    "LockOrderViolation", "LockdepReport", "enable", "disable", "enabled",
    "verify", "make_lock", "make_rlock", "make_condition",
    "OrderedLock", "OrderedRLock", "OrderedCondition",
]

_MAX_VIOLATIONS = 200

_state_lock = threading.Lock()          # guards _edges/_violations
_enabled = False
_raise_on_violation = True
_edges: Set[Tuple[str, str]] = set()
_violations: List[str] = []
_tls = threading.local()


class LockOrderViolation(AssertionError):
    """An acquisition that breaks the declared LOCK_ORDER."""


class _Entry:
    __slots__ = ("name", "obj")

    def __init__(self, name: str, obj) -> None:
        self.name = name
        self.obj = obj


def _stack() -> List[_Entry]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _report(msg: str) -> None:
    with _state_lock:
        if len(_violations) < _MAX_VIOLATIONS:
            _violations.append(msg)
    if _raise_on_violation:
        raise LockOrderViolation(msg)


def _check_order(obj) -> None:
    if not _enabled:
        return
    stack = _stack()
    for e in stack:
        if e.obj is obj:
            return                      # reentrant: same instance
    held = [e.name for e in stack]
    for e in stack:
        if e.name == obj.name:
            _report(f"lockdep: nested two instances of {obj.name!r} "
                    f"(thread {threading.current_thread().name}, "
                    f"held: {held})")
        elif not lock_order.allowed(e.name, obj.name):
            _report(f"lockdep: acquired {obj.name!r} while holding "
                    f"{e.name!r} — violates LOCK_ORDER "
                    f"(thread {threading.current_thread().name}, "
                    f"held: {held})")
        if e.name != obj.name:
            key = (e.name, obj.name)
            if key not in _edges:       # racy fast-path read is fine:
                with _state_lock:       # the slow path re-adds idempotently
                    _edges.add(key)


def _push(obj) -> None:
    _stack().append(_Entry(obj.name, obj))


def _pop(obj) -> None:
    st = _stack()
    for i in range(len(st) - 1, -1, -1):
        if st[i].obj is obj:
            del st[i]
            return


class _OrderedBase:
    __slots__ = ("name", "_lock")

    def __init__(self, name: str, lock) -> None:
        self.name = name
        self._lock = lock

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        _check_order(self)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            _push(self)
        return ok

    def release(self) -> None:
        self._lock.release()
        _pop(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name}>"


class OrderedLock(_OrderedBase):
    def __init__(self, name: str) -> None:
        super().__init__(name, threading.Lock())

    def locked(self) -> bool:
        return self._lock.locked()


class OrderedRLock(_OrderedBase):
    def __init__(self, name: str) -> None:
        super().__init__(name, threading.RLock())


class OrderedCondition:
    """An ordered ``threading.Condition``.  ``wait`` releases the
    underlying lock, so the held entry is popped for the duration of the
    wait and re-pushed on wake — a waiter is NOT holding the cond for
    ordering purposes."""

    __slots__ = ("name", "_cond")

    def __init__(self, name: str) -> None:
        self.name = name
        self._cond = threading.Condition()

    def acquire(self, *args, **kw) -> bool:
        _check_order(self)
        ok = self._cond.acquire(*args, **kw)
        if ok:
            _push(self)
        return ok

    def release(self) -> None:
        self._cond.release()
        _pop(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def _drop_entries(self) -> int:
        st = _stack()
        n = 0
        for i in range(len(st) - 1, -1, -1):
            if st[i].obj is self:
                del st[i]
                n += 1
        return n

    def wait(self, timeout: Optional[float] = None) -> bool:
        n = self._drop_entries()
        try:
            return self._cond.wait(timeout)
        finally:
            for _ in range(n):
                _push(self)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        n = self._drop_entries()
        try:
            return self._cond.wait_for(predicate, timeout)
        finally:
            for _ in range(n):
                _push(self)

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()

    def __repr__(self) -> str:
        return f"<OrderedCondition {self.name}>"


# --------------------------------------------------------------------------
# factories — what the serving stack actually calls
# --------------------------------------------------------------------------


def make_lock(name: str):
    return OrderedLock(name) if _enabled else threading.Lock()


def make_rlock(name: str):
    return OrderedRLock(name) if _enabled else threading.RLock()


def make_condition(name: str):
    return OrderedCondition(name) if _enabled else threading.Condition()


# --------------------------------------------------------------------------
# session control
# --------------------------------------------------------------------------


@dataclasses.dataclass
class LockdepReport:
    violations: List[str]
    edges: Set[Tuple[str, str]]

    def problems(self) -> List[str]:
        out = list(self.violations)
        cyc = _find_cycle(self.edges)
        if cyc:
            out.append("lockdep: acquisition-graph cycle: "
                       + " -> ".join(cyc))
        return out


def enable(raise_on_violation: bool = True) -> None:
    """Start a lockdep session: clear recorded state, instrument every
    lock the factories build from here on."""
    global _enabled, _raise_on_violation
    with _state_lock:
        _edges.clear()
        _violations.clear()
    _raise_on_violation = raise_on_violation
    _enabled = True


def disable() -> LockdepReport:
    """End the session; wrapped locks keep working but stop checking."""
    global _enabled
    _enabled = False
    with _state_lock:
        return LockdepReport(list(_violations), set(_edges))


def enabled() -> bool:
    return _enabled


def verify() -> List[str]:
    """Everything wrong so far: recorded order violations plus any cycle
    in the cross-thread acquisition graph."""
    with _state_lock:
        report = LockdepReport(list(_violations), set(_edges))
    return report.problems()


def _find_cycle(edges: Set[Tuple[str, str]]) -> Optional[List[str]]:
    adj: Dict[str, List[str]] = {}
    for a, b in edges:
        if a != b:
            adj.setdefault(a, []).append(b)
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}
    parent: Dict[str, str] = {}

    for root in sorted(adj):
        if color.get(root, WHITE) != WHITE:
            continue
        stack = [(root, iter(sorted(adj.get(root, ()))))]
        color[root] = GRAY
        while stack:
            node, it = stack[-1]
            advanced = False
            for nxt in it:
                c = color.get(nxt, WHITE)
                if c == GRAY:           # back edge: walk parents for path
                    path = [nxt, node]
                    cur = node
                    while cur != nxt and cur in parent:
                        cur = parent[cur]
                        path.append(cur)
                    path.reverse()
                    return path
                if c == WHITE:
                    color[nxt] = GRAY
                    parent[nxt] = node
                    stack.append((nxt, iter(sorted(adj.get(nxt, ())))))
                    advanced = True
                    break
            if not advanced:
                color[node] = BLACK
                stack.pop()
    return None
