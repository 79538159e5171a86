"""Goodput accounting: where did the run's wall time actually go?

Port of `ray_tpu/util/goodput.py` (host-only Python, copied). The gang
controller (`train/controller.py`, `TrainController`) drives the
partition of each run it supervises, as in the JAX package; on one
process it is driven by whoever owns the run.

Fine-tuning comparisons on preemptible fleets show that step time alone
hides exactly the costs such a fleet pays: restarts, checkpoint traffic, input stalls. This module turns the
signals the runtime already has — controller phase transitions, worker
reports, preemption notices, the stall watchdog — into a wall-time
partition over named buckets:

- ``init``          gang start, placement, process/compile bring-up
- ``compile``       explicitly-reported compile / capture time (split out of
                    init when the trainer reports ``compile_s``)
- ``step_compute``  productive training steps — the GOODPUT
- ``dp_sync``       data-parallel gradient sync share of the step
                    windows (reported ``dp_sync_s``, the train/steplog
                    wire-byte estimate)
- ``input_wait``    host input pipeline stalls (reported ``input_wait_s``)
- ``ckpt_save``     checkpoint saves, incl. the emergency-save window
                    after a preemption notice
- ``ckpt_restore``  restore + restart backoff after a failure
- ``preempt_restart`` gang teardown/re-mesh after an announced preemption
- ``stall``         time the stall watchdog held the run stalled
- ``other``         anything not attributed (closed runs: ~0)

Invariant: the accountant is a STATE MACHINE over one wall clock —
``begin(bucket)`` closes the previous bucket at now and opens the next,
and ``transfer`` only moves seconds between buckets — so the bucket sums
always equal the run's wall time to float precision. That is what lets
the acceptance check "buckets sum to wall time within ±5%" hold by
construction rather than by luck.

Every ``report()`` publishes ``raytpu_train_goodput_seconds{run,bucket}``
and ``raytpu_train_goodput_fraction{run}`` so the scrape and the report
show the same numbers. The serve-side analogue is
``serve_slo_report()`` over the ``ServeSLOMonitor`` window ledger.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

BUCKETS = (
    "init", "compile", "step_compute", "dp_sync", "input_wait",
    "ckpt_save", "ckpt_restore", "preempt_restart", "stall", "other",
)

# the productive share — everything else is badput
PRODUCTIVE_BUCKETS = ("step_compute",)


class GoodputAccountant:
    """Partition a run's wall clock into the BUCKETS above."""

    def __init__(self, run_name: str):
        self.run_name = run_name
        self._lock = threading.Lock()
        self._seconds: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        self._current: Optional[str] = None
        self._current_since = 0.0
        self._started_mono: Optional[float] = None
        self._started_wall: Optional[float] = None
        self._ended_mono: Optional[float] = None

    # ------------------------------------------------------------ transitions

    @property
    def current(self) -> Optional[str]:
        return self._current

    def begin(self, bucket: str) -> None:
        """Close the open bucket at now, open `bucket` (first call also
        starts the run clock). Unknown buckets land in `other` rather
        than raising — accounting must never kill a training run."""
        if bucket not in self._seconds:
            bucket = "other"
        now = time.monotonic()
        with self._lock:
            if self._started_mono is None:
                self._started_mono = now
                self._started_wall = time.time()
            if self._current is not None:
                self._seconds[self._current] += max(
                    0.0, now - self._current_since
                )
            self._current = bucket
            self._current_since = now

    def transfer(self, src: str, dst: str, seconds: float) -> None:
        """Re-attribute already-accounted seconds (e.g. a worker report
        says 0.3s of the last window was input wait). Clamped to what
        `src` actually holds, so the wall-time invariant survives a
        misreporting trainer."""
        if src not in self._seconds or dst not in self._seconds:
            return
        with self._lock:
            moved = max(0.0, min(float(seconds), self._seconds[src]))
            self._seconds[src] -= moved
            self._seconds[dst] += moved

    def finish(self) -> None:
        """End the run clock (idempotent)."""
        now = time.monotonic()
        with self._lock:
            if self._started_mono is None or self._ended_mono is not None:
                return
            if self._current is not None:
                self._seconds[self._current] += max(
                    0.0, now - self._current_since
                )
                self._current = None
            self._ended_mono = now

    # --------------------------------------------------------------- reading

    def wall_time_s(self) -> float:
        with self._lock:
            if self._started_mono is None:
                return 0.0
            end = self._ended_mono if self._ended_mono is not None \
                else time.monotonic()
            return max(0.0, end - self._started_mono)

    def report(self, publish: bool = True) -> Dict[str, Any]:
        """The goodput report: bucket seconds (open bucket counted up to
        now), wall time, goodput fraction. With publish=True (default)
        the same numbers land on the run-labeled gauges."""
        now = time.monotonic()
        with self._lock:
            buckets = dict(self._seconds)
            if self._current is not None and self._ended_mono is None:
                buckets[self._current] += max(0.0, now - self._current_since)
            if self._started_mono is None:
                wall = 0.0
            else:
                end = self._ended_mono if self._ended_mono is not None else now
                wall = max(0.0, end - self._started_mono)
            started_wall = self._started_wall
        goodput_s = sum(buckets[b] for b in PRODUCTIVE_BUCKETS)
        out = {
            "run": self.run_name,
            "started_at": started_wall,
            "wall_time_s": round(wall, 6),
            "buckets": {b: round(s, 6) for b, s in buckets.items()},
            "goodput_s": round(goodput_s, 6),
            "badput_s": round(max(0.0, wall - goodput_s), 6),
            "goodput_fraction": round(goodput_s / wall, 6) if wall > 0 else 0.0,
            # the streaming-data acceptance number: share of wall time
            # the gang spent waiting on its input pipeline
            "input_wait_fraction": (
                round(buckets["input_wait"] / wall, 6) if wall > 0 else 0.0
            ),
        }
        if publish:
            self._publish(out)
        return out

    def _publish(self, report: Dict[str, Any]) -> None:
        from .metrics import get_or_create_gauge

        try:
            gauge = get_or_create_gauge(
                "raytpu_train_goodput_seconds",
                "Wall-time attribution of a training run by bucket "
                "(step_compute is the goodput; buckets sum to wall time).",
                tag_keys=("run", "bucket"),
            )
            for bucket, seconds in report["buckets"].items():
                gauge.set(float(seconds),
                          tags={"run": self.run_name, "bucket": bucket})
            get_or_create_gauge(
                "raytpu_train_goodput_fraction",
                "Productive (step_compute) share of a training run's "
                "wall time.",
                tag_keys=("run",),
            ).set(float(report["goodput_fraction"]),
                  tags={"run": self.run_name})
        except Exception:  # noqa: BLE001 - accounting must not kill training
            pass

    # ------------------------------------------------------- report plumbing

    # metrics keys a worker report may carry, mapped to (src, dst)
    # re-attributions of the window they were measured in
    _REPORT_TRANSFERS = {
        "input_wait_s": ("step_compute", "input_wait"),
        "ckpt_save_s": ("step_compute", "ckpt_save"),
        # the steplog-estimated gradient-sync share of the window: sync
        # seconds stop being silently folded into step_compute (still
        # summing to wall time — transfer only moves seconds)
        "dp_sync_s": ("step_compute", "dp_sync"),
        "compile_s": ("init", "compile"),
    }

    def observe_report_metrics(self, metrics: Any) -> None:
        """Fold a rank-0 report's self-measured phase seconds into the
        partition (trainers that report input_wait_s / ckpt_save_s /
        compile_s get them split out of the enclosing bucket)."""
        if not isinstance(metrics, dict):
            return
        for key, (src, dst) in self._REPORT_TRANSFERS.items():
            value = metrics.get(key)
            if isinstance(value, (int, float)) and value > 0:
                self.transfer(src, dst, float(value))


# ------------------------------------------------------------ serve analogue


def serve_slo_report() -> Dict[str, Any]:
    """Serve-side SLO attainment (the serving analogue of the train
    goodput report), read off the ServeSLOMonitor window ledger: for
    each configured SLO, windows evaluated vs violated and the
    attainment fraction (also exported as
    raytpu_serve_slo_attainment{slo})."""
    from .watchdog import serve_slo_monitor

    slos = serve_slo_monitor().attainment_report()
    return {
        "slos": slos,
        "attainment": (
            min(s["attainment"] for s in slos.values()) if slos else 1.0
        ),
    }
