"""``mamba_ms.prefill``: the device time of the Mamba-2 layers (norm,
``mamba2_seq`` with the SSD kernels, residual add) in the traced
stretch's pod prefills: the program's own ``model.mamba`` records
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
    mine = [r.device_ms() for r in records if r.name == "model.mamba"
            and r.parent is not None and r.parent.name == "serve.prefill"]
    return sum(mine) / prefills if prefills and mine else None
