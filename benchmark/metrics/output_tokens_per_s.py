"""output_tokens_per_s: every output token that reached a client inside
the window, over the window's length."""

from benchmark.harness.readers import tokens_between


def read(run):
    if run.cell.kind != "serve":
        return None
    return tokens_between(run, run.t0, run.t1) / run.window_s
