"""Spans: the program's own record of where a call spends its time.

``span(name, **counts)`` wraps a stretch of the program (a prefill, a
model sub-layer, a replication) in a context:

* **off** (the default) it records nothing and opens nothing: one check
  of whether recording is on;
* **on** -- while a ``torch.profiler`` runs, or inside ``recording()`` --
  it opens ``torch.profiler.record_function("repro_torch." + name)``, so
  the span sits in any kineto trace, and keeps a ``Record``: its name,
  the record it is nested in, its host start and end (``time.time_ns()``,
  the clock kineto stamps its events with) and its ``counts``; where CUDA
  is in use, a pair of timing events on the current stream around it.

A span never synchronises: a record's device time is read from its
events once the caller has synchronised (``Record.device_ms``).  While
the current stream captures a CUDA graph a span records nothing, so a
captured step holds no event of it.  Records go into one bounded buffer,
the oldest dropped first (``dropped`` counts them); ``records()`` reads
it and ``clear()`` empties it.

A count is a number, or a function of no arguments that gives it, called
only while recording (a sum over a tree of tensors costs nothing off).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import List, Optional

import torch

#: the kineto range's prefix
PREFIX = "repro_torch."
#: records the buffer keeps
CAP = 1 << 16

_buffer: collections.deque = collections.deque(maxlen=CAP)
_lock = threading.Lock()
_held = 0                       # open ``recording()`` contexts
_open = threading.local()       # this thread's stack of open records
_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
dropped = 0


@dataclasses.dataclass(eq=False)
class Record:
    """One span's record.  Host times in ``time.time_ns()``'s ns."""

    name: str
    parent: Optional["Record"]
    start_ns: int
    end_ns: int = 0
    counts: dict = dataclasses.field(default_factory=dict)
    events: Optional[tuple] = None      # (start, end) CUDA timing events

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def device_ms(self) -> float:
        """The device time between the span's events, in ms, once the
        device has run past the end event (the caller synchronises; this
        never does).  Without events (the CPU, which runs each op before
        it returns) the host time."""
        if self.events is None:
            return self.host_ms
        return self.events[0].elapsed_time(self.events[1])


class _Span:
    __slots__ = ("name", "counts", "range", "record")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts

    def __enter__(self) -> Record:
        stack = _stack()
        counts = {k: v() if callable(v) else v
                  for k, v in self.counts.items()}
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        events = None
        if torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        self.record = Record(self.name, stack[-1] if stack else None,
                             time.time_ns(), counts=counts, events=events)
        stack.append(self.record)
        return self.record

    def __exit__(self, *exc) -> None:
        rec = self.record
        rec.end_ns = time.time_ns()
        if rec.events is not None:
            rec.events[1].record()
        _stack().pop()
        self.range.__exit__(*exc)
        _keep(rec)


def span(name: str, **counts):
    """The context of one call into the stretch ``name``: a ``Record``
    while recording is on (``as`` gives it), else a context that does
    nothing (``as`` gives None)."""
    if not (_held or _profiling()):
        return _OFF
    if torch.cuda.is_initialized() and \
            torch.cuda.is_current_stream_capturing():
        return _OFF
    return _Span(name, counts)


@contextlib.contextmanager
def recording():
    """Record every span opened inside, with no profiler running."""
    global _held
    with _lock:
        _held += 1
    try:
        yield
    finally:
        with _lock:
            _held -= 1


def records() -> List[Record]:
    """The buffer's records, oldest first, each added as its span
    closed (so a parent follows its children)."""
    with _lock:
        return list(_buffer)


def clear() -> None:
    global dropped
    with _lock:
        _buffer.clear()
        dropped = 0


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


def _keep(rec: Record) -> None:
    global dropped
    with _lock:
        if len(_buffer) == CAP:
            dropped += 1
        _buffer.append(rec)
