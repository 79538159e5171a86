"""kernel.flash_roofline: the flash kernels (K1 forward, K2's dkv and dq)
as a share, in percent, of their roofline: each launch's frozen bound at
the step's shapes (`counts/attention.py`) summed over the launches in the
traced window, over those kernels' device time."""

from benchmark.counts.attention import flash_bwd, flash_fwd
from benchmark.counts.model import sizes
from benchmark.harness.readers import peak


def read(run):
    pk = peak(run)
    if run.trace is None or pk is None or run.cell.kind != "train":
        return None
    s, t = sizes(run.cell.config), run.cell.traffic
    shape = (int(t["batch"]), s["hq"], s["hkv"], int(t["seq"]), s["head_dim"])
    bwd = flash_bwd(*shape)
    costs = {"flash_fwd": flash_fwd(*shape), "flash_bwd_dkv": bwd["dkv"], "flash_bwd_dq": bwd["dq"]}
    bound = time = 0.0
    for name, (flops, nbytes) in costs.items():
        n = run.trace.count_by(lambda k, name=name: name in k)
        bound += n * max(flops / pk["bf16_flops"], nbytes / pk["hbm_bytes_per_s"])
        time += run.trace.seconds_by(lambda k, name=name: name in k)
    return 100.0 * bound / time if time > 0 else None
