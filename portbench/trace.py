"""The benchmark's spans and its reading of a device trace.

Spans: the harness wraps each call into a layer of the program (a pod's
prefill, a decode step, a replication, a delivery of tokens to the
host) in ``span(name)``, a ``torch.profiler.record_function``
range named ``portbench.<name>``, which costs nothing while no profiler
runs.

The reading (``read``) goes through the finished profiler's kineto events
one by one, as the program's ``chip_smoke.py`` ``_trace_events`` does (a
``key_averages()`` first builds a tree of every host op: tens of seconds
for a stretch of many small ops).  Each device operation (kernel, copy,
set) is charged to the span whose host call launched it, through the
CUDA correlation id that links the launch to the operation (a CUDA graph's
kernels carry its ``cudaGraphLaunch``'s).  Device busy time is the union
of the operations' intervals, so operations that overlap on several
streams count once.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Tuple

import torch

PREFIX = "portbench."


def span(name: str):
    """The context of one call into a layer, ``portbench.<name>``."""
    return torch.profiler.record_function(PREFIX + name)


@dataclasses.dataclass
class Trace:
    """What a profiled stretch held.  Times in seconds; ``window_s`` runs
    from the start of the first device operation the stretch launched to
    the end of the last one (before it the device runs what was launched
    earlier or waits for the stretch's first launch, after it it sits
    idle: neither is the stretch's), and ``busy_s`` is the union of the
    operations' intervals inside it."""

    window_s: float
    busy_s: float
    ops: Dict[str, List[float]]          # device op name -> [count, s]
    by_span: Dict[str, Dict[str, List[float]]]  # span -> name -> [count, s]
    gaps: List[Tuple[str, float]]        # the longest idle gaps, by span
    spans: Dict[str, int]                # span -> host calls in the stretch
    per_call: Dict[str, List[int]]       # span -> device ops of each call

    def span_ops(self, span_name: str) -> Tuple[int, float]:
        """(device operations, their summed seconds) launched inside
        ``span_name``."""
        rows = self.by_span.get(span_name, {})
        return (int(sum(r[0] for r in rows.values())),
                sum(r[1] for r in rows.values()))

    def matching(self, *needles: str) -> Tuple[int, float]:
        """(count, seconds) of the device operations whose name holds any
        of ``needles``."""
        n, s = 0, 0.0
        for name, (c, t) in self.ops.items():
            if any(x in name for x in needles):
                n, s = n + int(c), s + t
        return n, s

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:10]
        return {"device_ops": [[k[:120], v[1]] for k, v in top],
                "idle_gaps": [[k, s] for k, s in self.gaps[:10]]}


class Profiled:
    """A stretch under ``torch.profiler``: ``start()``, the work, then
    ``stop()`` once the device has finished it (the caller synchronises
    first), which reads the trace."""

    def __init__(self):
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self) -> Trace:
        self.prof.stop()
        trace = read(self.prof)
        self.prof = None
        return trace


def warm_profiler() -> None:
    """Start and stop the profiler once, so its first start (CUPTI's
    initialisation) falls in set-up."""
    p = Profiled()
    p.start()
    torch.cuda.synchronize()
    p.stop()


def read(prof) -> Trace:
    from torch.autograd import DeviceType
    no = lambda: False                  # noqa: E731 (a method torch lacks)
    device: list = []                   # (start, end, name, correlation)
    launches: list = []                 # (thread, start, correlation)
    spans: list = []                    # (thread, start, end, name)
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", no)():
            continue
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", no)() or e.is_async() or \
                    e.start_thread_id() != e.end_thread_id():
                continue
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                           name, e.correlation_id()))
        elif name.startswith(PREFIX):
            spans.append((e.start_thread_id(), e.start_ns(),
                          e.start_ns() + e.duration_ns(),
                          name[len(PREFIX):]))
        elif name.startswith("cuda") or name.startswith("cu"):
            launches.append((e.start_thread_id(), e.start_ns(),
                             e.correlation_id()))
    spans.sort(key=lambda x: (x[1], -x[2]))
    starts = [s[1] for s in spans]

    def innermost(thread, t) -> int:
        """The index of the innermost span open on ``thread`` at ``t``
        (-1: none)."""
        best, width = -1, None
        for i in range(bisect.bisect_right(starts, t)):
            th, s0, s1, _ = spans[i]
            if th == thread and s0 <= t <= s1 and (width is None
                                                   or s1 - s0 < width):
                best, width = i, s1 - s0
        return best

    call = {corr: innermost(th, t) for th, t, corr in launches}
    ops: Dict[str, List[float]] = {}
    by_span: Dict[str, Dict[str, List[float]]] = {}
    in_call = [0] * len(spans)
    for s0, s1, name, corr in device:
        i = call.get(corr, -1)
        if i >= 0:
            in_call[i] += 1
        for table in (ops, by_span.setdefault(spans[i][3] if i >= 0
                                              else "", {})):
            row = table.setdefault(name, [0, 0.0])
            row[0] += 1
            row[1] += (s1 - s0) / 1e9
    first = min((d[0] for d in device if call.get(d[3], -1) >= 0),
                default=None)
    device = sorted(d for d in device if first is not None and d[1] > first)
    busy, idle = 0.0, []
    start = end = None
    for s0, s1, _, _ in device:
        s0 = max(s0, first)
        if end is None or s0 > end:
            if end is not None:
                busy += (end - start) / 1e9
                idle.append((s0 - end, end))
            start, end = s0, s1
        else:
            end = max(end, s1)
    if end is not None:
        busy += (end - start) / 1e9
    gaps = []
    for length, at in sorted(idle, reverse=True)[:10]:
        # the innermost span the host was in when the device went idle
        inside = [x for x in spans if x[1] <= at <= x[2]]
        where = min(inside, key=lambda x: x[2] - x[1])[3] if inside else ""
        gaps.append((where or "harness", length / 1e9))
    calls: Dict[str, int] = {}
    per_call: Dict[str, List[int]] = {}
    for (_, _, _, nm), n in zip(spans, in_call):
        calls[nm] = calls.get(nm, 0) + 1
        per_call.setdefault(nm, []).append(n)
    window = (max(d[1] for d in device) - first) / 1e9 if device else 0.0
    return Trace(window_s=window, busy_s=busy, ops=ops,
                 by_span=by_span, gaps=gaps, spans=calls, per_call=per_call)
