"""Training forensics plane: per-rank step-level timelines.

Port of `ray_tpu/train/steplog.py`. The StepLog records typed per-phase
STEP MARKS with both clocks on SAMPLED steps only (every
``cfg.step_log_sample_every``-th step pays one device synchronisation;
every other step keeps the queue running ahead), each sampled step
sealed by an ``other`` mark whose duration is the remainder — so the
buckets sum EXACTLY to the measured step wall time, by construction.

Marks live in a bounded per-process ring plus a bounded per-(run, rank,
step) summary index. ``ingest`` folds per-step records from a gang's
report plane (the reserved metrics key ``_steplog``) into the ring,
deduplicating; ``summarize_steps``, ``skew_matrix``, ``dominant_bucket``
and ``render_waterfall`` are the derived views. The gang controller
(`train/controller.py`) ingests each rank's records and feeds the stall
watchdog's per-rank buckets; the federation into the control plane's
``_steps`` table comes with ROADMAP A6b (federation).

Phases are TYPED: every ``mark`` names a phase registered in
``STEP_PHASES``; components may register more with
``register_step_phase``.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

# ----------------------------------------------------------- phase registry
#
# phase -> one-line doc. Components may register additional phases at
# import time with register_step_phase.

STEP_PHASES: Dict[str, str] = {
    "data_wait": "host blocked in next(batch_iter) — the input pipeline",
    "h2d": "host->device batch materialization (copy + ready)",
    "fwd_bwd_compute": "forward+backward device compute (device time "
                       "minus the dp_sync estimate)",
    "dp_sync": "data-parallel gradient sync share of device time "
               "(wire-byte estimate; the sync runs inside the step's "
               "device work and cannot be host-timed)",
    "optimizer_update": "optimizer update (inside the step's one device "
                        "interval; 0 unless a backend splits it out)",
    "ckpt_save": "checkpoint save blocking the step loop",
    "report": "metrics conversion + the report callback",
    "other": "remainder: step wall time minus every measured bucket "
             "(the SEAL mark of a sampled step)",
}

# The phase that SEALS a sampled step: its mark carries the measured
# wall_s attr and its duration is the unattributed remainder, so
# sum(buckets) == wall_s holds exactly once it lands.
SEAL_PHASE = "other"


def register_step_phase(phase: str, doc: str = "") -> None:
    """Register an additional typed step phase (idempotent)."""
    STEP_PHASES.setdefault(phase, doc)


def step_phases() -> Dict[str, str]:
    """The registered phase catalog (copy)."""
    return dict(STEP_PHASES)


def _default_node() -> Optional[str]:
    from ..util import logs

    return logs._node_hex


def _phase_order(buckets: Dict[str, Any]) -> List[str]:
    """Registered phases first (registration order), then any extras."""
    out = [p for p in STEP_PHASES if p in buckets]
    out.extend(p for p in buckets if p not in STEP_PHASES)
    return out


class StepLog:
    """Per-process step recorder: a bounded mark ring plus a bounded
    per-(run, rank, step) summary index (OrderedDict, oldest-evicted).

    One mark per (run, rank, step, phase): a duplicate mark is dropped
    (returns None) — that is what makes controller-side ``ingest`` safe
    when an in-process gang shares this very ring with its trainer."""

    def __init__(self, mark_capacity: int = 4096,
                 step_capacity: int = 1024):
        self._marks: "deque[Dict[str, Any]]" = deque(maxlen=mark_capacity)
        self._steps: "OrderedDict[Tuple[str, int, int], Dict[str, Any]]" = (
            OrderedDict()
        )
        self._step_capacity = step_capacity
        self._lock = threading.Lock()
        self._seq = 0

    def mark(self, phase: str, dur_s: Any, *,
             run: str, rank: int, step: int,
             node: Optional[str] = None,
             ts: Optional[float] = None,
             **attrs: Any) -> Optional[Dict[str, Any]]:
        """Record one typed phase duration of one sampled step. `phase`
        is a registered STEP_PHASES name (unknown phases are still
        recorded). Returns None when this (run, rank, step, phase) was
        already marked."""
        if node is None:
            node = _default_node()
        with self._lock:
            sid = (str(run), int(rank), int(step))
            summary = self._steps.get(sid)
            if summary is not None and phase in summary["buckets"]:
                return None
            self._seq += 1
            rec: Dict[str, Any] = {
                "seq": self._seq,
                "run": sid[0],
                "rank": sid[1],
                "step": sid[2],
                "phase": phase,
                "dur_s": dur_s,
                "ts": time.time() if ts is None else ts,
                "mono": time.perf_counter(),
                "node": node,
            }
            if attrs:
                rec["attrs"] = attrs
            self._marks.append(rec)
            self._index_locked(rec)
        return rec

    def _index_locked(self, rec: Dict[str, Any]) -> None:
        sid = (rec["run"], rec["rank"], rec["step"])
        summary = self._steps.get(sid)
        if summary is None:
            summary = {
                "run": sid[0],
                "rank": sid[1],
                "step": sid[2],
                "node": rec.get("node"),
                "ts": rec["ts"],
                "buckets": {},
                "wall_s": None,
                "sealed": False,
            }
            self._steps[sid] = summary
            while len(self._steps) > self._step_capacity:
                self._steps.popitem(last=False)
        summary["buckets"][rec["phase"]] = rec["dur_s"]
        if rec["phase"] == SEAL_PHASE:
            attrs = rec.get("attrs") or {}
            # the exact-sum invariant: the seal either carries the
            # measured wall or wall IS the bucket sum by definition
            summary["wall_s"] = attrs.get(
                "wall_s", sum(summary["buckets"].values())
            )
            summary["sealed"] = True

    # --------------------------------------------------------------- ingest

    def ingest(self, records: Optional[List[Dict[str, Any]]]
               ) -> List[Dict[str, Any]]:
        """Fold per-step records from the gang report plane into this
        ring (the controller side of the `_steplog` metrics key). Each
        record is {"run", "rank", "step", "buckets", "wall_s", ...};
        records whose step this ring already holds (an in-process gang
        shares the trainer's singleton) dedup away. Returns the records
        that were new."""
        accepted: List[Dict[str, Any]] = []
        for rec in records or ():
            try:
                run = str(rec["run"])
                rank = int(rec["rank"])
                step = int(rec["step"])
                buckets = dict(rec.get("buckets") or {})
            except (KeyError, TypeError, ValueError):
                continue
            node = rec.get("node")
            ts = rec.get("ts")
            wall = rec.get("wall_s")
            for phase in _phase_order(buckets):
                if phase == SEAL_PHASE:
                    continue
                self.mark(phase, buckets[phase], run=run, rank=rank,
                          step=step, node=node, ts=ts)
            seal = self.mark(
                SEAL_PHASE, buckets.get(SEAL_PHASE, 0.0),
                run=run, rank=rank, step=step, node=node, ts=ts,
                wall_s=wall if wall is not None
                else sum(buckets.values()),
            )
            if seal is not None:
                accepted.append(rec)
        return accepted

    # --------------------------------------------------------------- queries

    def timeline(self, run: str, rank: Optional[int] = None
                 ) -> List[Dict[str, Any]]:
        """Every buffered mark of one run (optionally one rank),
        oldest first."""
        with self._lock:
            return [
                m for m in self._marks
                if m["run"] == run and (rank is None or m["rank"] == rank)
            ]

    def steps(self, run: Optional[str] = None,
              limit: int = 200) -> List[Dict[str, Any]]:
        """Sampled-step summaries, oldest first (insertion order)."""
        with self._lock:
            out = [
                dict(s, buckets=dict(s["buckets"]))
                for s in self._steps.values()
                if run is None or s["run"] == run
            ]
        return out[-limit:]

    def since(self, seq: int, max_n: int = 1000) -> List[Dict[str, Any]]:
        """The OLDEST max_n marks with seq greater than `seq` — a cursor
        walk that never skips marks (same contract as EventLog.since)."""
        with self._lock:
            return [m for m in self._marks if m["seq"] > seq][:max_n]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "seq": self._seq,
                "buffered_marks": len(self._marks),
                "indexed_steps": len(self._steps),
            }

    def clear(self) -> None:
        with self._lock:
            self._marks.clear()
            self._steps.clear()


# ------------------------------------------------------- module singleton

_steplog: Optional[StepLog] = None
_steplog_lock = threading.Lock()


def log() -> StepLog:
    global _steplog
    with _steplog_lock:
        if _steplog is None:
            from ..core.config import cfg

            _steplog = StepLog(
                mark_capacity=cfg.train_step_log_marks,
                step_capacity=cfg.train_step_log_steps,
            )
        return _steplog


def enabled() -> bool:
    from ..core.config import cfg

    return bool(cfg.train_step_log)


def sample_every() -> int:
    from ..core.config import cfg

    return int(cfg.step_log_sample_every)


def mark(phase: str, dur_s: Any, *,
         run: str, rank: int, step: int, **attrs: Any) -> None:
    """Fast-path module-level mark: a no-op when the recorder is off
    (the unsampled-step hot loop never even reaches this — sampling is
    gated in the trainer — but call sites stay cheap either way)."""
    if not enabled():
        return
    slog = log()
    slog.mark(phase, dur_s, run=run, rank=rank, step=step, **attrs)


# ------------------------------------------------------- derived views


def summarize_steps(marks: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Build per-(run, rank, step) summaries from a flat mark list (marks
    that arrive without their summary index, e.g. other nodes')."""
    scratch = StepLog(mark_capacity=len(marks) + 1,
                      step_capacity=len(marks) + 1)
    for m in sorted(marks, key=lambda m: (m.get("ts", 0.0),
                                          m.get("seq", 0))):
        try:
            scratch.mark(
                m.get("phase", SEAL_PHASE), m.get("dur_s", 0.0),
                run=m.get("run", "?"), rank=m.get("rank", 0),
                step=m.get("step", 0), node=m.get("node"),
                ts=m.get("ts"), **(m.get("attrs") or {}),
            )
        except (TypeError, ValueError):
            continue
    return scratch.steps(limit=len(marks) + 1)


def dominant_bucket(per_rank: Dict[int, Dict[str, Any]],
                    straggler_rank: int) -> Tuple[Optional[str], float]:
    """The bucket that explains the straggler's excess: argmax over its
    buckets of (straggler duration - fastest other rank's duration).
    With a single rank this degenerates to its biggest bucket."""
    sb = per_rank[straggler_rank]["buckets"]
    others = [
        per_rank[r]["buckets"] for r in per_rank if r != straggler_rank
    ]
    best: Optional[str] = None
    best_excess = float("-inf")
    for phase in _phase_order(sb):
        dur = sb[phase]
        floor = min((o.get(phase, 0.0) for o in others), default=0.0)
        excess = dur - floor
        if excess > best_excess:
            best, best_excess = phase, excess
    return best, max(best_excess, 0.0)


def skew_matrix(summaries: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Cross-rank skew per sampled step: group SEALED summaries by
    (run, step) and name each step's straggler rank, its wall-time
    spread over the fastest rank, and the dominant bucket of the
    excess — the structured form behind a straggler attribution and the
    waterfall's footer."""
    by_run_step: Dict[Tuple[str, int], Dict[int, Dict[str, Any]]] = {}
    for s in summaries:
        if not s.get("sealed"):
            continue
        key = (s["run"], s["step"])
        by_run_step.setdefault(key, {})[s["rank"]] = s
    out: List[Dict[str, Any]] = []
    for (run, step), per_rank in sorted(by_run_step.items()):
        walls = {r: per_rank[r].get("wall_s") or 0.0 for r in per_rank}
        straggler = max(walls, key=lambda r: walls[r])
        spread = max(walls.values()) - min(walls.values())
        dom, excess = dominant_bucket(per_rank, straggler)
        out.append({
            "run": run,
            "step": step,
            "ranks": sorted(per_rank),
            "wall_s": {r: walls[r] for r in sorted(walls)},
            "buckets": {
                r: dict(per_rank[r]["buckets"]) for r in sorted(per_rank)
            },
            "spread_s": spread,
            "straggler_rank": straggler,
            "dominant_bucket": dom,
            "dominant_excess_s": excess,
        })
    return out


_BUCKET_GLYPHS = {
    "data_wait": "d",
    "h2d": "h",
    "fwd_bwd_compute": "f",
    "dp_sync": "s",
    "optimizer_update": "u",
    "ckpt_save": "c",
    "report": "r",
    "other": ".",
}


def _bar(buckets: Dict[str, Any], wall: float, width: int = 32) -> str:
    if wall <= 0:
        return " " * width
    parts: List[str] = []
    acc = 0.0
    filled = 0
    for phase in _phase_order(buckets):
        dur = buckets.get(phase) or 0.0
        if dur <= 0:
            continue
        acc += dur
        end = min(width, int(round(acc / wall * width)))
        parts.append(_BUCKET_GLYPHS.get(phase, "?") * max(end - filled, 0))
        filled = end
    return "".join(parts).ljust(width)


def render_waterfall(summaries: List[Dict[str, Any]]) -> str:
    """Per-rank text waterfall of sampled steps: one segmented bar per
    (step, rank) whose glyph widths are the bucket shares of step wall
    time, a Σ column proving the exact-sum invariant, and a skew footer
    naming each multi-rank step's straggler + dominant bucket."""
    sealed = [s for s in summaries if s.get("sealed")]
    if not sealed:
        return "(no sampled steps)"
    runs = sorted({s["run"] for s in sealed})
    lines: List[str] = []
    for run in runs:
        mine = [s for s in sealed if s["run"] == run]
        ranks = sorted({s["rank"] for s in mine})
        lines.append(
            f"run {run} · {len(mine)} sampled step(s)"
            f" · rank(s) {','.join(str(r) for r in ranks)}"
        )
        present = sorted(
            {p for s in mine for p in s["buckets"]},
            key=lambda p: list(STEP_PHASES).index(p)
            if p in STEP_PHASES else len(STEP_PHASES),
        )
        lines.append(
            "  legend: " + " ".join(
                f"{_BUCKET_GLYPHS.get(p, '?')}={p}" for p in present
            )
        )
        for s in sorted(mine, key=lambda s: (s["step"], s["rank"])):
            wall = s.get("wall_s") or 0.0
            total = sum(s["buckets"].values())
            tops = sorted(
                ((p, v) for p, v in s["buckets"].items() if v > 0),
                key=lambda pv: pv[1], reverse=True,
            )[:3]
            top_txt = " ".join(f"{p}={v:.4f}" for p, v in tops)
            lines.append(
                f"  step {s['step']:>6} rank {s['rank']:>3}"
                f" |{_bar(s['buckets'], wall)}|"
                f" wall {wall:.4f}s Σ {total:.4f}s  {top_txt}".rstrip()
            )
        for row in skew_matrix(mine):
            if len(row["ranks"]) < 2:
                continue
            lines.append(
                f"  step {row['step']:>6} skew: straggler rank "
                f"{row['straggler_rank']} (+{row['spread_s']:.4f}s vs "
                f"fastest), dominant {row['dominant_bucket']} "
                f"(+{row['dominant_excess_s']:.4f}s)"
            )
    return "\n".join(lines)
