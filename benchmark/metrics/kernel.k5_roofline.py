"""kernel.k5_roofline: K5 (ragged paged attention) as a share, in percent,
of its roofline: the frozen bound of the prefill chunks and decode steps
whose tokens reached the client in the traced window (`counts/`), over
the device time of the `ragged_*` kernels in it."""

from benchmark.harness.readers import is_ragged, peak, traced_work


def read(run):
    if run.trace is None or peak(run) is None:
        return None
    k5_s = run.trace.seconds_by(is_ragged)
    if k5_s <= 0:
        return None
    return 100.0 * traced_work(run)["k5_bound_s"] / k5_s
