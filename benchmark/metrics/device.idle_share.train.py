"""The device's idle share, in percent, over the traced window: 1 - the
seconds in which some operation ran on the card (profiler trace) / the
window. The profiler slows the host, so this bounds the untraced run's
from above."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
