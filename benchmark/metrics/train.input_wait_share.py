"""train.input_wait_share: the seconds `LMTrainer.train` spent waiting on
its batch iterator (making the packed batch, pinning it and queueing its
copy) over the window, in percent."""


def read(run):
    if run.cell.kind != "train" or run.window_s <= 0:
        return None
    return 100.0 * run.input_wait_s / run.window_s
