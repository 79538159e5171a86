"""train.mfu: the frozen model FLOPs of the steps the traced window ran
(6 x matrix-product weights x tokens, and causal attention's forward and
backward; recomputation not counted) over the window at the chip's bf16
peak, in percent. The steps are counted on the card: one K2 dq launch a
layer a step."""

from benchmark.counts.model import train_step_flops
from benchmark.harness.readers import peak


def read(run):
    pk = peak(run)
    if run.trace is None or pk is None or run.cell.kind != "train":
        return None
    layers = run.cell.config["model"]["n_layers"]
    steps = run.trace.count_by(lambda name: "flash_bwd_dq" in name) / layers
    if steps <= 0 or run.trace.window_s <= 0:
        return None
    t = run.cell.traffic
    flops = steps * train_step_flops(run.cell.config, int(t["batch"]), int(t["seq"]))
    return 100.0 * flops / (run.trace.window_s * pk["bf16_flops"])
