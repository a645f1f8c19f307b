"""``kernels_a_step.decode``: the device operations (kernels, copies)
launched inside one call of the harness's ``decode_step`` span (the
captured pod-step's graph and its token copies), the median over the
traced stretch's steps: every step replays the same graph, so the count
repeats exactly, and an operation the profiler drops moves no median.
A count.  Unit kernels."""
import statistics


def read(run):
    t = run.trace
    counts = t.per_call.get("decode_step") if t else None
    return float(statistics.median(counts)) if counts else None
