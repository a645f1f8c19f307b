"""``flash_roofline.prefill``: the flash attention kernel's share of its
roofline in the traced stretch's prefills: each ``flash_fwd*`` launch's
least time (``portbench.work.flash_work`` at the cell's shapes: causal,
the configuration's window, bf16, at 989 TFLOP/s and 3.35 TB/s) summed,
over the launches' device time.  Unit %."""
from portbench import work


def read(run):
    t = run.trace
    n, seconds = t.matching("flash_fwd") if t else (0, 0.0)
    if not n:
        return None
    s = run.sizes
    flops, nbytes = work.flash_work(
        run.p["sessions"], int(s["heads"]), int(s["kv_heads"]),
        run.p["prompt"], run.p["prompt"], int(s["head_dim"]), 2, True,
        int(s.get("window") or 0))
    return 100.0 * n * work.bound_s(flops, nbytes,
                                    work.BF16_FLOPS_PER_S) / seconds
