"""ttft_p95_s: the 95th percentile, over every request the window sent,
of the time from its due time on the arrival schedule to its first token
at the client; a failed request counts as missing (infinite)."""

from benchmark.harness.readers import p95, sent_in_window, ttft_s


def read(run):
    if run.cell.traffic["kind"] != "open_loop":
        return None
    return p95(ttft_s(run, r) for r in sent_in_window(run))
