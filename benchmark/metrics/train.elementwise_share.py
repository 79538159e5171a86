"""train.elementwise_share: the device time of the step's elementwise and
reduction kernels (the grouping by kernel name of `harness/trace.py`) over
the device's busy time in the traced window, in percent."""


def read(run):
    if run.trace is None or run.cell.kind != "train":
        return None
    busy = run.trace.busy_s()
    groups = run.trace.by_group()
    return 100.0 * (groups.get("elementwise", 0.0) + groups.get("reduce", 0.0)) / busy if busy else None
