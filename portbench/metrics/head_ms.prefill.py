"""``head_ms.prefill``: the device time of the head (final norm, the (B, S,
V) logits, and the serving step's copy of the last position's) in the
traced stretch's pod prefills: the program's own ``model.head`` records
(``repro_torch.core.spans``) nested in its ``serve.prefill`` ones, each
timed by its CUDA events, summed, over the prefills.  None where the
program records no such span.  Unit ms."""


def read(run):
    try:
        from repro_torch.core import spans
    except ImportError:
        return None
    records = spans.records()
    prefills = sum(r.name == "serve.prefill" for r in records)
    mine = [r.device_ms() for r in records if r.name == "model.head"
            and r.parent is not None and r.parent.name == "serve.prefill"]
    return sum(mine) / prefills if prefills and mine else None
