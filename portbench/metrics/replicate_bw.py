"""``replicate_bw``: the session replication's bandwidth as a share of
the H100's 3.35 TB/s of HBM: the ``bytes`` the program counts on its
``serve.replicate`` records (``repro_torch.core.spans``) over their
device time (each record's CUDA events), summed over the traced
stretch's calls.  None where the program records no such span.
Unit %."""
from portbench import work


def read(run):
    try:
        from repro_torch.core import spans
    except ImportError:
        return None
    calls = [r for r in spans.records() if r.name == "serve.replicate"]
    if not calls:
        return None
    seconds = sum(r.device_ms() for r in calls) / 1e3
    nbytes = sum(r.counts["bytes"] for r in calls)
    return 100.0 * nbytes / seconds / work.HBM_BYTES_PER_S
