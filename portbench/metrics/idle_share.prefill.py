"""The device's idle share over the traced stretch: 1 - (the union of
the device operations' intervals) / (the stretch's span on the device,
from its first operation's start to its last one's end).  Unit %."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
