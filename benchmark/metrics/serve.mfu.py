"""serve.mfu: the model FLOPs of every prompt and output token processed
in the traced window (frozen count: the matrix products' weights and the
head, and attention at each token's own context) over the window at the
chip's bf16 peak, in percent."""

from benchmark.harness.readers import peak, traced_work


def read(run):
    pk = peak(run)
    if run.trace is None or pk is None or run.trace.window_s <= 0:
        return None
    return 100.0 * traced_work(run)["model_flops"] / (run.trace.window_s * pk["bf16_flops"])
