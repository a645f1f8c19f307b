"""Small cells for the CPU tests: a cell of ``BENCHMARK.json`` with the
program's reduced architecture (``repro_torch.configs.reduced``), a mix
cut to a few positions, so a whole run takes seconds on the CPU, and
limits of that size's own."""
from __future__ import annotations

import dataclasses

# a mix's cut for the CPU
TINY = {"prefill": dict(sessions=2, prompt=48, pool=2),
        "decode": dict(sessions=4, prompt=24, turn=60, cache=90,
                       replicate_every=4, trace_steps=8)}

# The limits at this size, set as the cells' are: above the largest that
# sound runs of the program read over seeds 1-8 on the CPU, below the
# smallest the fp8 control read (lower / upper in the comments).  Exact
# limits (``give_ups``, ``backup_diff``, ``length_diff``) stay the cell's.
LIMITS = {
    "internlm2-1.8b.prefill_32k": dict(logits_err=0.03,    # 0.0125 / 0.0806
                                       cache_err=0.03),    # 0.0102 / 0.0940
    "zamba2-7b.prefill_4k": dict(logits_err=0.04,          # 0.0161 / 0.0934
                                 cache_err=0.08),          # 0.0406 / 0.1506
    # 0.0416 / 0.2240
    "internlm2-1.8b.decode_1k_replicated": dict(token_gap=0.10),
    # 0.0398 / 0.1957
    "zamba2-7b.decode_2k_replicated": dict(token_gap=0.10),
}


def tiny(name: str, **traffic):
    """(cell, arch): the cell ``name`` at the reduced architecture."""
    from repro_torch.configs import get_arch, reduced

    from portbench import spec
    from portbench.program import _as_run
    cell = spec.cell(name)
    arch = reduced(get_arch(cell.config["program"]["arch"]))
    if arch.sliding_window:     # a ring as long as the tiny cache, as the
        arch = dataclasses.replace(arch, sliding_window=128)  # cells' is
    ref = dict(cell.config["reference"], sizes=_as_run(arch))
    cell = dataclasses.replace(
        cell, config=dict(cell.config, reference=ref),
        traffic={**cell.traffic, **TINY[cell.traffic["kind"]], **traffic},
        limits={**cell.limits, **LIMITS[name]})
    return cell, arch
