"""``mfu.prefill``: the model FLOPs of the traced stretch's pod prefills
(``portbench.work.prefill_flops``: from the configuration's shapes) over
the stretch's span on the device (its first operation's start to its
last one's end), as a share of the H100's 989 TFLOP/s of dense bf16.
Unit %."""
from portbench import work


def read(run):
    t = run.trace
    if t is None or not run.stretch.get("prefills"):
        return None
    flops = work.prefill_flops(run.module, run.sizes, run.p["prompt"],
                               run.p["sessions"] * run.stretch["prefills"])
    return 100.0 * flops / t.window_s / work.BF16_FLOPS_PER_S
