"""What the metric readers (`benchmark/metrics/*.py`) share: percentiles,
the window's requests and tokens, the frozen work done inside a traced
window, and the grouping of a trace's kernels into graph replays.

A served request's work is placed in time by when its tokens reached the
client: its prompt's prefill at its first token, one decode step at each
later token. A K-step decode block's tokens reach the client together
when the block's copy lands, so the work inside a window is exact up to
the blocks cut by its two ends.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from ..counts import model as model_counts
from ..counts.peaks import PEAKS


def p95(values: Iterable[float]) -> Optional[float]:
    v = list(values)
    return float(np.percentile(v, 95)) if v else None


def sent_in_window(run: Any) -> List[Any]:
    """The requests a window sent (the backlog's abandoned ones included:
    they were sent; an open loop sends all of its schedule in its window)."""
    return [r for r in run.records if r.sent and run.t0 <= r.sent <= run.t1]


def ttft_s(run: Any, rec: Any) -> float:
    """From the request's due time (open loop) or its sending (backlog) to
    its first token at the client; a failed request is missing (inf)."""
    start = rec.due if rec.due is not None else rec.sent
    if rec.first is None or rec.error is not None:
        return math.inf
    return rec.first - start


def tpot_ms(rec: Any) -> Optional[float]:
    if rec.error is not None or len(rec.times) < 2:
        return None
    return 1e3 * (rec.last - rec.first) / (len(rec.times) - 1)


def tokens_between(run: Any, a: float, b: float) -> int:
    return sum(1 for r in run.records for t in r.times if a <= t <= b)


def peak(run: Any) -> Optional[Dict[str, float]]:
    return PEAKS.get(run.device_name)


def traced_work(run: Any) -> Dict[str, float]:
    """The frozen work whose tokens reached the client inside the traced
    window: model FLOPs, and K5's operations and bytes with its roofline
    bound at the run's chip (prefill chunks each at their own bound, decode
    steps at theirs)."""
    tr = run.trace
    cfg = run.cell.config
    chunk = cfg["engine"]["chunk_pages"] * cfg["engine"]["page_size"]
    pk = peak(run)
    total = {"model_flops": 0.0, "k5_bound_s": 0.0}
    dec_f = dec_b = 0.0
    for r in run.records:
        if not r.times:
            continue
        n_prompt = len(r.prompt)
        positions = [n_prompt + i - 1 for i, t in enumerate(r.times) if i > 0 and tr.p0 <= t <= tr.p1]
        prefill = tr.p0 <= r.times[0] <= tr.p1
        if not positions and not prefill:
            continue
        w = model_counts.serve_work(cfg, n_prompt, r.cached, positions, chunk, prefill)
        total["model_flops"] += w["model_flops"]
        dec_f += w["k5_decode_flops"]
        dec_b += w["k5_decode_bytes"]
        if pk is not None:
            for f, b in w["k5_prefill_chunk_bound"]:
                total["k5_bound_s"] += max(f / pk["bf16_flops"], b / pk["hbm_bytes_per_s"])
    if pk is not None:
        # the decode steps of a block run in one launch a layer: their bound
        # adds as operations and bytes, not step by step
        total["k5_bound_s"] += max(dec_f / pk["bf16_flops"], dec_b / pk["hbm_bytes_per_s"])
    return total


def is_ragged(name: str) -> bool:
    return "ragged" in name


def decode_replays(run: Any) -> Optional[Dict[str, float]]:
    """The trace's decode-block replays: {"count", "device_s"}. A replay is
    the kernels of one `cudaGraphLaunch` (one correlation id); a decode
    block runs K steps of every layer, so more ragged launches than the
    model has layers, where a mixed tick runs one a layer. None when the
    trace groups no kernels by launch."""
    layers = run.cell.config["model"]["n_layers"]
    groups = run.trace.launches()
    if len(groups) <= 1:
        return None
    count, device_s = 0, 0.0
    for ops in groups.values():
        ragged = sum(1 for op in ops if is_ragged(op.name) and "combine" not in op.name)
        if ragged > layers:
            count += 1
            device_s += sum(op.dur_ns for op in ops) / 1e9
    return {"count": count, "device_s": device_s} if count else None
