"""Compile accounting for the warm-path guarantees; the counterpart of
``repro.analysis.jitprof``.

The reference promises that a warm serving loop never retraces: every
(bucket x keygroup-geometry) shape runs once at deploy time
(``engine.prewarm``) and the staging buffers and padding masks are
persistent; ``CompileCounter`` counts XLA compile requests while active so
a test can wrap warm flush cycles and assert the count stays ZERO.

The port's counterpart of a compile is a new entry in one of its step
caches (``repro_torch.core.graphs.StepCache``): on CUDA a graph capture,
on the CPU the first execution of a new key.  ``CompileCounter`` counts
those while it is active; it registers itself with the step caches on
entry and removes itself on exit, so no listener outlives the block.
"""
from __future__ import annotations

from repro_torch.core import graphs


class CompileCounter:
    """Context manager counting step-cache entries made while active.

    ``events`` is monotone within the block; ``events == 0`` on exit means
    every step inside replayed (on the CPU: re-ran) an existing entry.
    Entries made by any thread count, as the reference's process-wide
    listener counts every compile."""

    def __init__(self):
        self.events = 0

    def __enter__(self) -> "CompileCounter":
        graphs.add_counter(self)
        return self

    def __exit__(self, *exc) -> bool:
        graphs.remove_counter(self)
        return False
