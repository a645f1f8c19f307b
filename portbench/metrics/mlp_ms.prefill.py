"""``mlp_ms.prefill``: the device time of the MLP sub-layers (norm, gated
MLP, residual add; zamba2's shared block at each of its applications) in
the traced stretch's pod prefills: the program's own ``model.mlp``
records (``repro_torch.core.spans``) nested in its ``serve.prefill``
ones, each timed by its CUDA events, summed, over the prefills.  None
where the program records no such span.  Unit ms."""


def read(run):
    try:
        from repro_torch.core import spans
    except ImportError:
        return None
    records = spans.records()
    prefills = sum(r.name == "serve.prefill" for r in records)
    mine = [r.device_ms() for r in records if r.name == "model.mlp"
            and r.parent is not None and r.parent.name == "serve.prefill"]
    return sum(mine) / prefills if prefills and mine else None
