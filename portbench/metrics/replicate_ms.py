"""``replicate_ms``: the device time of one session replication
(``launch/serve.py`` ``replicate_sessions``, every R decode steps): the
device operations launched inside the harness's ``replicate`` span in
the traced stretch, summed, over the span's calls.  Unit ms."""


def read(run):
    t = run.trace
    calls = t.spans.get("replicate", 0) if t else 0
    n, seconds = t.span_ops("replicate") if calls else (0, 0.0)
    return seconds / calls * 1e3 if n else None
