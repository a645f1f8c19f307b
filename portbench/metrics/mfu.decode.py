"""``mfu.decode``: the model FLOPs of the traced stretch's decode steps
(``portbench.work.decode_flops``: every session's token at its position)
over the stretch's span on the device (its first operation's start to
its last one's end), as a share of the H100's 989 TFLOP/s of dense
bf16.  Unit %."""
from portbench import work


def read(run):
    t = run.trace
    if t is None or not run.stretch.get("positions"):
        return None
    flops = work.decode_flops(run.module, run.sizes,
                              run.stretch["positions"])
    return 100.0 * flops / t.window_s / work.BF16_FLOPS_PER_S
