"""``replicate_gb``: the bytes one session replication moves (``launch/
serve.py`` ``replicate_sessions``, every R decode steps): the ``bytes``
the program counts on its ``serve.replicate`` records
(``repro_torch.core.spans``: every leaf of the live sessions read once
and written once), over the traced stretch's calls, in 1e9 bytes.  None
where the program records no such span.  Unit GB."""


def read(run):
    try:
        from repro_torch.core import spans
    except ImportError:
        return None
    calls = [r for r in spans.records() if r.name == "serve.replicate"]
    if not calls:
        return None
    return sum(r.counts["bytes"] for r in calls) / len(calls) / 1e9
