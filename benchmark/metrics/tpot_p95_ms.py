"""tpot_p95_ms: the 95th percentile over the window's requests of
(last token - first token) / (tokens - 1) at the client: the decode rate a
streaming user sees (tokens drain in blocks, so single gaps are not it)."""

from benchmark.harness.readers import p95, sent_in_window, tpot_ms


def read(run):
    if run.cell.traffic["kind"] != "open_loop":
        return None
    return p95(v for v in (tpot_ms(r) for r in sent_in_window(run)) if v is not None)
