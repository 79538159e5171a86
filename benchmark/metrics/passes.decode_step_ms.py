"""passes.decode_step_ms: the device time of the decode-block graphs'
kernels in the traced window over their steps (replays x K): one decode
step of every lane, on the card."""

from benchmark.harness.readers import decode_replays


def read(run):
    if run.trace is None:
        return None
    replays = decode_replays(run)
    if replays is None:
        return None
    steps = replays["count"] * run.cell.config["engine"]["decode_block_steps"]
    return 1e3 * replays["device_s"] / steps
