"""``rest_ms.prefill``: the device time of a pod prefill outside its
model sub-layers: the self time of the program's ``serve.prefill``
records (``repro_torch.core.spans``), their CUDA events' time less that
of the spans nested in them (``model.attention``, ``model.mlp``,
``model.mamba``, ``model.head``): the embedding, the stacking of each
layer's K/V and states into the cache, casts.  Summed over the traced
stretch's prefills, over the prefills, so the five prefill metrics add up
to ``serve.prefill``'s time.  None where the program records no such
span.  Unit ms."""


def read(run):
    try:
        from repro_torch.core import spans
    except ImportError:
        return None
    records = spans.records()
    prefills = [r for r in records if r.name == "serve.prefill"]
    if not prefills:
        return None
    inner = sum(r.device_ms() for r in records
                if r.parent is not None and r.parent.name == "serve.prefill")
    return (sum(r.device_ms() for r in prefills) - inner) / len(prefills)
