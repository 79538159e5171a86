"""Watchdogs over the telemetry plane: training stalls, stragglers,
serve SLO burn.

Port of `ray_tpu/util/watchdog.py` for one process (host-only Python,
copied: the port imports nothing of the JAX package). The monitor's
background loop skips a check while the GCS head is unreachable
(`core.runtime.head_outage_s`): an outage stalls the samples' federation,
and a window computed then would burn SLOs on missing data.

Two detectors, both fed by signals earlier PRs already emit:

- ``StallWatchdog``: the TrainController streams per-worker step
  reports (rank, wall timestamp) into it. A gang with NO report inside
  ``train_stall_window_s``, or a worker whose report gap regresses past
  ``train_stall_factor`` x its EWMA step time, flips the
  ``raytpu_train_stalled`` gauge to 1 and emits a WARNING event naming
  the straggler rank (MegaScale-style per-step straggler detection —
  silent slowdowns surface before they become outages). Recovery flips
  the gauge back and emits an INFO event.
- ``ServeSLOMonitor``: periodically evaluates the span-derived latency
  histograms (raytpu_serve_ttft_seconds, raytpu_serve_queue_seconds)
  over the window since its last check; a window whose p99 exceeds the
  configured SLO increments ``raytpu_serve_slo_burn_total{slo=...}``
  and emits a WARNING event.

Both are pure consumers of the metrics/events plane: no RPC, no
threads of their own unless started.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .events import emit
from .metrics import get_or_create_counter, get_or_create_gauge, registry


def _stalled_gauge():
    return get_or_create_gauge(
        "raytpu_train_stalled",
        "1 while the training stall watchdog considers the run stalled "
        "(no progress in the window, or an EWMA step-time regression).",
        tag_keys=("run",),
    )


class StallWatchdog:
    """Training stall + straggler detection from gang step timestamps.

    Feed it with ``observe_report(rank, ts)`` for every worker report
    the controller drains, and call ``check()`` each poll cycle. All
    thresholds come from config (``train_stall_*`` flags) unless
    overridden."""

    def __init__(self, run_name: str, num_workers: int, *,
                 window_s: Optional[float] = None,
                 factor: Optional[float] = None,
                 alpha: Optional[float] = None,
                 min_s: Optional[float] = None):
        from ..core.config import cfg

        self.run_name = run_name
        self.num_workers = num_workers
        self.window_s = cfg.train_stall_window_s if window_s is None else window_s
        self.factor = cfg.train_stall_factor if factor is None else factor
        self.alpha = cfg.train_stall_ewma_alpha if alpha is None else alpha
        self.min_s = cfg.train_stall_min_s if min_s is None else min_s
        now = time.time()
        self._started = now
        self._lock = threading.Lock()
        self._last_ts: Dict[int, float] = {}   # rank -> last report wall ts
        # monotonic plumbing (the wall-skew fix): _mono is the WORKER's
        # perf_counter carried in its report (valid for per-rank
        # intervals; never comparable across hosts), _rx the controller-
        # local perf_counter at receipt (the one shared monotonic basis
        # every rank's lag can be measured on)
        self._mono: Dict[int, float] = {}
        self._rx: Dict[int, float] = {}
        self._ewma: Dict[int, float] = {}      # rank -> EWMA step interval
        self._reports: Dict[int, int] = {}
        self._done: set = set()  # finished ranks are not stragglers
        # rank -> latest sampled-step phase buckets (train/steplog):
        # lets a stall warning name WHERE the straggler's time goes
        self._buckets: Dict[int, Dict[str, float]] = {}
        self.stalled = False
        self.stall_reason = ""
        self.straggler: Optional[int] = None
        self.straggler_bucket: Optional[str] = None
        _stalled_gauge().set(0, tags={"run": run_name})

    # ------------------------------------------------------------- feeding

    def observe_report(self, rank: int, ts: Optional[float] = None,
                       mono: Optional[float] = None) -> None:
        """One drained worker report. `mono` is the WORKER's monotonic
        clock at report time (reserved metrics key `_mono`): when
        carried, step intervals and straggler lags run on monotonic
        clocks, so cross-host wall-clock skew cannot misrank stragglers.
        Without it (legacy feeds, unit drives) the wall path applies."""
        ts = time.time() if ts is None else float(ts)
        rx = time.perf_counter()
        with self._lock:
            prev = self._last_ts.get(rank)
            prev_mono = self._mono.get(rank)
            if mono is not None:
                mono = float(mono)
                # per-rank interval on the rank's OWN monotonic clock
                # (a worker restart resets it; negative deltas skipped)
                if prev_mono is not None and mono > prev_mono:
                    interval = mono - prev_mono
                    ewma = self._ewma.get(rank)
                    self._ewma[rank] = (
                        interval if ewma is None
                        else self.alpha * interval + (1 - self.alpha) * ewma
                    )
                self._mono[rank] = max(mono, prev_mono or mono)
                self._rx[rank] = rx
            elif prev is not None and ts > prev:
                interval = ts - prev
                ewma = self._ewma.get(rank)
                self._ewma[rank] = (
                    interval if ewma is None
                    else self.alpha * interval + (1 - self.alpha) * ewma
                )
            self._last_ts[rank] = max(ts, prev or 0.0)
            self._reports[rank] = self._reports.get(rank, 0) + 1

    def observe_step_buckets(self, rank: int,
                             buckets: Optional[Dict[str, Any]]) -> None:
        """Latest sampled-step phase decomposition of one rank (the
        `_steplog` records the controller drains): kept so the stall
        warning names the straggler's dominant bucket, not just the
        rank."""
        if not isinstance(buckets, dict):
            return
        clean = {
            str(phase): dur for phase, dur in buckets.items()
            if isinstance(dur, (int, float))
        }
        if clean:
            with self._lock:
                self._buckets[rank] = clean

    def dominant_bucket(self, rank: int
                        ) -> Optional[Tuple[str, float]]:
        """(phase, excess_s) that best explains this rank's step time
        vs its peers: the bucket where its latest sampled step exceeds
        the fastest other rank's the most. With no peer samples it
        degenerates to the rank's largest bucket. None before any
        sampled step arrived."""
        with self._lock:
            mine = self._buckets.get(rank)
            others = [
                dict(b) for r, b in self._buckets.items() if r != rank
            ]
        if not mine:
            return None
        best: Optional[str] = None
        best_excess = -math.inf
        for phase, dur in mine.items():
            floor = min((o.get(phase, 0.0) for o in others), default=0.0)
            excess = dur - floor
            if excess > best_excess:
                best, best_excess = phase, excess
        if best is None:
            return None
        return best, max(best_excess, 0.0)

    def mark_done(self, rank: int) -> None:
        """A worker finished its loop cleanly: silence from it is
        completion, not a stall."""
        with self._lock:
            self._done.add(rank)

    # ----------------------------------------------------------- evaluation

    def straggler_ranking(self, now: Optional[float] = None
                          ) -> List[Tuple[int, float]]:
        """Ranks ordered most-behind first: (rank, seconds since its
        last report). A rank whose reports carry the monotonic clock is
        measured on the controller's RECEIPT perf_counter — the one
        monotonic basis every rank shares — so a gang host with a
        skewed wall clock can no longer be misranked as (or hide as)
        the straggler. Ranks without monotonic feeds (legacy planes,
        unit drives) fall back to wall timestamps; workers that never
        reported rank by time since watchdog start."""
        now = time.time() if now is None else now
        rx_now = time.perf_counter()
        with self._lock:
            lags = []
            for rank in range(self.num_workers):
                if rank in self._done:
                    continue
                rx = self._rx.get(rank)
                if rx is not None:
                    lags.append((rank, rx_now - rx))
                else:
                    lags.append(
                        (rank, now - self._last_ts.get(rank, self._started))
                    )
        return sorted(lags, key=lambda rl: -rl[1])

    def check(self, now: Optional[float] = None) -> bool:
        """Evaluate the stall conditions; flip gauge + events on state
        transitions. Returns the current stalled verdict."""
        if self.window_s <= 0:
            return False
        now = time.time() if now is None else now
        ranking = self.straggler_ranking(now)
        if not ranking:  # every rank finished: nothing left to stall
            self._transition(False, None, "")
            return False
        straggler = ranking[0][0]
        reason = ""
        # (1) no progress anywhere (among unfinished ranks) in the
        # window: the SMALLEST per-rank lag (each measured on that
        # rank's correct clock basis) is how long the gang's freshest
        # rank has been silent
        with self._lock:
            reported = {
                r for r, n in self._reports.items()
                if n and r not in self._done
            }
        gang_gap = min(
            (lag for rank, lag in ranking if rank in reported),
            default=now - self._started,
        )
        if gang_gap > self.window_s:
            reason = (
                f"no worker reported for {gang_gap:.1f}s "
                f"(window {self.window_s:.1f}s); slowest is rank {straggler}"
            )
        else:
            # (2) EWMA regression of one worker against its own history
            with self._lock:
                ewmas = dict(self._ewma)
            for rank, lag in ranking:
                ewma = ewmas.get(rank)
                if ewma is None:
                    continue
                threshold = max(self.min_s, self.factor * ewma)
                if lag > threshold:
                    straggler = rank
                    reason = (
                        f"rank {rank} step gap {lag:.2f}s exceeds "
                        f"{self.factor:.1f}x its EWMA step time "
                        f"({ewma:.3f}s)"
                    )
                    break
        self._transition(bool(reason), straggler, reason)
        return self.stalled

    def _transition(self, stalled: bool, straggler: Optional[int],
                    reason: str) -> None:
        dom = (
            self.dominant_bucket(straggler)
            if stalled and straggler is not None else None
        )
        if stalled == self.stalled:
            self.straggler = straggler if stalled else None
            self.straggler_bucket = dom[0] if dom else None
            self.stall_reason = reason
            return
        self.stalled = stalled
        self.straggler = straggler if stalled else None
        self.straggler_bucket = dom[0] if dom else None
        self.stall_reason = reason
        _stalled_gauge().set(1.0 if stalled else 0.0,
                             tags={"run": self.run_name})
        if stalled:
            where = (
                f", dominant bucket {dom[0]} (+{dom[1]:.3f}s vs fastest "
                f"peer)" if dom else ""
            )
            emit("WARNING", "watchdog",
                 f"run {self.run_name} STALLED: {reason} "
                 f"(straggler rank {straggler}{where})",
                 kind="watchdog.stall",
                 run=self.run_name, straggler_rank=straggler,
                 dominant_bucket=dom[0] if dom else None)
        else:
            emit("INFO", "watchdog",
                 f"run {self.run_name} recovered from stall",
                 kind="watchdog.recovered", run=self.run_name)

    def close(self) -> None:
        """Run over: clear the stalled gauge so a finished run never
        reads as permanently stalled."""
        self._transition(False, None, "")
        _stalled_gauge().set(0, tags={"run": self.run_name})


# --------------------------------------------------------------- serve SLO


def _histogram_quantile(buckets: List[Tuple[float, int]], total: int,
                        q: float) -> float:
    """Estimate a quantile from cumulative-ized histogram bucket deltas
    (Prometheus-style linear interpolation within the landing bucket;
    +Inf landings return inf — above every finite boundary)."""
    if total <= 0:
        return 0.0
    target = q * total
    cumulative = 0
    prev_bound = 0.0
    for bound, count in buckets:
        if count:
            if cumulative + count >= target:
                frac = (target - cumulative) / count
                return prev_bound + frac * (bound - prev_bound)
            cumulative += count
        prev_bound = bound
    return math.inf  # landed in the +Inf overflow bucket


def _dominant_ttft_bucket(breakdowns: List[Dict[str, float]]):
    """(bucket, share) of the largest TTFT component across a window of
    per-request decompositions, or None with no samples. Buckets are the
    engine's exact-sum split: queue_wait + preempt_wait + prefill_compute
    == TTFT, so the shares answer WHERE the window's latency went."""
    totals = {"queue_wait": 0.0, "preempt_wait": 0.0,
              "prefill_compute": 0.0}
    for b in breakdowns:
        for key in totals:
            totals[key] += float(b.get(key + "_s", 0.0) or 0.0)
    spent = sum(totals.values())
    if spent <= 0:
        return None
    dominant = max(totals, key=totals.get)
    return dominant, totals[dominant] / spent


class ServeSLOMonitor:
    """p99 burn detection over the span-derived serve histograms.

    Each ``check()`` diffs the histograms against the previous check
    (so the p99 is of the WINDOW, not all time) and burns the SLO
    counter when the window's p99 exceeds the configured objective."""

    def __init__(self):
        self._lock = threading.Lock()
        # histogram name -> previous cumulative (bucket counts, total)
        self._prev: Dict[str, Tuple[List[int], int]] = {}
        # slo -> {"windows", "violated", "requests", "last_p99_s"} — the
        # attainment ledger the serve goodput report reads
        self._attainment: Dict[str, Dict[str, Any]] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _slos(self) -> List[Tuple[str, str, float]]:
        from ..core.config import cfg

        return [
            ("ttft_p99", "raytpu_serve_ttft_seconds",
             float(cfg.serve_slo_ttft_p99_s)),
            ("queue_p99", "raytpu_serve_queue_seconds",
             float(cfg.serve_slo_queue_p99_s)),
        ]

    def _window_delta(self, name: str, hist) -> Tuple[List[Tuple[float, int]], int]:
        """Aggregate the histogram across its tag series and diff
        against the last check's cumulative counts."""
        bounds = list(hist.boundaries)
        counts = [0] * (len(bounds) + 1)
        total = 0
        for _tags, data in hist.collect():
            for i, (_b, c) in enumerate(data["buckets"]):
                counts[i] += c
            total += data["count"]
        # overflow bucket = total - finite-bucket sum
        counts[len(bounds)] = total - sum(counts[: len(bounds)])
        with self._lock:
            prev_counts, prev_total = self._prev.get(
                name, ([0] * len(counts), 0)
            )
            self._prev[name] = (list(counts), total)
        delta = [c - p for c, p in zip(counts, prev_counts)]
        finite = list(zip(bounds, delta[: len(bounds)]))
        # the +Inf overflow rides as a trailing (inf, n) entry
        finite.append((math.inf, max(0, delta[len(bounds)])))
        return finite, max(0, total - prev_total)

    def check(self) -> Dict[str, float]:
        """One evaluation round. Returns {slo: window_p99} for every SLO
        that had samples this window (enabled or not — callers/tests can
        inspect); burns counters/events only for enabled, violated SLOs."""
        out: Dict[str, float] = {}
        for slo, hist_name, objective in self._slos():
            hist = registry().get(hist_name)
            if hist is None or getattr(hist, "kind", "") != "histogram":
                continue
            buckets, n = self._window_delta(hist_name, hist)
            if n <= 0:
                continue
            p99 = _histogram_quantile(buckets, n, 0.99)
            out[slo] = p99
            violated = objective > 0 and p99 > objective
            with self._lock:
                led = self._attainment.setdefault(slo, {
                    "windows": 0, "violated": 0, "requests": 0,
                    "objective_s": objective, "last_p99_s": 0.0,
                })
                led["windows"] += 1
                led["requests"] += n
                led["violated"] += 1 if violated else 0
                led["objective_s"] = objective
                led["last_p99_s"] = p99
                attained = 1.0 - led["violated"] / led["windows"]
            get_or_create_gauge(
                "raytpu_serve_slo_attainment",
                "Fraction of evaluation windows whose p99 met the "
                "configured SLO objective (the serve-side goodput).",
                tag_keys=("slo",),
            ).set(attained, tags={"slo": slo})
            if violated:
                get_or_create_counter(
                    "raytpu_serve_slo_burn_total",
                    "SLO-violating windows observed by the serve SLO "
                    "monitor (p99 over objective).",
                    tag_keys=("slo",),
                ).inc(tags={"slo": slo})
                emit("WARNING", "watchdog",
                     f"serve SLO burn: {slo} = "
                     f"{'inf' if math.isinf(p99) else f'{p99:.3f}s'} over "
                     f"objective {objective:.3f}s "
                     f"({n} request(s) this window)",
                     kind="watchdog.slo_burn",
                     slo=slo, objective=objective, samples=n)
        out.update(self._check_tenants())
        return out

    def _check_tenants(self) -> Dict[str, float]:
        """Per-tenant TTFT attainment pass: drains the tenancy TTFT
        window (raw samples reported by the engines, attributed at
        first-token time) and evaluates each tenant against its own
        objective (TenantSpec.ttft_slo_s, falling back to the global
        serve_slo_ttft_p99_s). Ledger entries ride the same
        ``_attainment`` map — keyed ``ttft_p99:<tenant>`` — so the
        controller's burn-delta scan (and hence the SLO autoscaler)
        sees tenant-attributed burn with no extra plumbing."""
        from ..serve import tenancy

        samples = tenancy.drain_ttft_window()
        breakdowns = tenancy.drain_ttft_breakdown()
        queue_waits = tenancy.drain_queue_wait_window()
        out: Dict[str, float] = {}
        for tenant, ttfts in samples.items():
            if not ttfts:
                continue
            objective = tenancy.ttft_objective(tenant)
            ordered = sorted(ttfts)
            p99 = ordered[min(len(ordered) - 1,
                              int(0.99 * len(ordered)))]
            slo = f"ttft_p99:{tenant}"
            out[slo] = p99
            violated = objective > 0 and p99 > objective
            with self._lock:
                led = self._attainment.setdefault(slo, {
                    "windows": 0, "violated": 0, "requests": 0,
                    "objective_s": objective, "last_p99_s": 0.0,
                })
                led["windows"] += 1
                led["requests"] += len(ttfts)
                led["violated"] += 1 if violated else 0
                led["objective_s"] = objective
                led["last_p99_s"] = p99
                attained = 1.0 - led["violated"] / led["windows"]
            get_or_create_gauge(
                "raytpu_serve_tenant_slo_attainment",
                "Fraction of evaluation windows whose per-tenant TTFT "
                "p99 met the tenant's objective.",
                tag_keys=("tenant",),
            ).set(attained, tags={"tenant": tenant})
            get_or_create_gauge(
                "raytpu_serve_tenant_ttft_p99_seconds",
                "Window TTFT p99 per tenant, as observed by the serve "
                "SLO monitor.",
                tag_keys=("tenant",),
            ).set(p99, tags={"tenant": tenant})
            if violated:
                get_or_create_counter(
                    "raytpu_serve_slo_burn_total",
                    "SLO-violating windows observed by the serve SLO "
                    "monitor (p99 over objective).",
                    tag_keys=("slo",),
                ).inc(tags={"slo": slo})
                # the forensics decomposition turns "tenant X burned"
                # into "…and it burned in the QUEUE, not the engine"
                dom = _dominant_ttft_bucket(breakdowns.get(tenant, []))
                dom_txt = (
                    f"; dominant bucket: {dom[0]} ({dom[1]:.0%} of TTFT)"
                    if dom else ""
                )
                extra = {"dominant_bucket": dom[0]} if dom else {}
                emit("WARNING", "watchdog",
                     f"serve SLO burn: tenant {tenant!r} ttft p99 = "
                     f"{p99:.3f}s over objective {objective:.3f}s "
                     f"({len(ttfts)} request(s) this window){dom_txt}",
                     kind="watchdog.slo_burn",
                     slo=slo, objective=objective, samples=len(ttfts),
                     **extra)
        out.update(self._check_tenant_queue_waits(queue_waits))
        return out

    def _check_tenant_queue_waits(
        self, queue_waits: Dict[str, List[float]]
    ) -> Dict[str, float]:
        """Per-tenant queue-wait p99 ledger (``queue_wait_p99:<tenant>``
        in attainment_report): the queue-wait share of each request's
        TTFT as decomposed by the engine, evaluated against the global
        queue objective. Burn here with TTFT attained means admission
        latency is being earned back by prefill headroom — a capacity
        signal, not a latency incident, so no burn counter/event."""
        from ..core.config import cfg

        objective = float(cfg.serve_slo_queue_p99_s)
        out: Dict[str, float] = {}
        for tenant, waits in queue_waits.items():
            if not waits:
                continue
            ordered = sorted(waits)
            p99 = ordered[min(len(ordered) - 1, int(0.99 * len(ordered)))]
            slo = f"queue_wait_p99:{tenant}"
            out[slo] = p99
            violated = objective > 0 and p99 > objective
            with self._lock:
                led = self._attainment.setdefault(slo, {
                    "windows": 0, "violated": 0, "requests": 0,
                    "objective_s": objective, "last_p99_s": 0.0,
                })
                led["windows"] += 1
                led["requests"] += len(waits)
                led["violated"] += 1 if violated else 0
                led["objective_s"] = objective
                led["last_p99_s"] = p99
            get_or_create_gauge(
                "raytpu_serve_tenant_queue_wait_p99_seconds",
                "Window queue-wait p99 per tenant (the queue_wait bucket "
                "of the engine's TTFT decomposition).",
                tag_keys=("tenant",),
            ).set(p99, tags={"tenant": tenant})
        return out

    def attainment_report(self) -> Dict[str, Dict[str, Any]]:
        """Per-SLO window attainment ledger (the serve analogue of the
        train goodput report): windows evaluated, windows violated,
        requests covered, attainment fraction."""
        with self._lock:
            out = {}
            for slo, led in self._attainment.items():
                windows = led["windows"]
                out[slo] = {
                    **led,
                    "attainment": (
                        1.0 - led["violated"] / windows if windows else 1.0
                    ),
                }
            return out

    # -------------------------------------------------------- background run

    def start(self, period_s: Optional[float] = None) -> None:
        """Start the periodic evaluator (idempotent)."""
        from ..core.config import cfg

        if self._thread is not None:
            return
        period = cfg.serve_slo_check_period_s if period_s is None else period_s
        if period <= 0:
            return

        stop = self._stop

        def loop():
            from ..core.runtime import head_outage_s

            while not stop.wait(period):
                if head_outage_s() > 0.0:
                    # head outage stalls sample federation: a window's
                    # p99 computed now would burn SLOs (and drive the
                    # autoscaler) on missing data, not real latency
                    continue
                try:
                    self.check()
                except Exception:  # noqa: BLE001 - the monitor must not die
                    pass

        self._thread = threading.Thread(
            target=loop, daemon=True, name="serve-slo-monitor"
        )
        self._thread.start()

    def stop(self) -> None:
        """Stop the periodic evaluator and join its thread; a later
        start() runs a fresh one."""
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10)
        self._stop = threading.Event()


_slo_monitor: Optional[ServeSLOMonitor] = None
_slo_lock = threading.Lock()


def serve_slo_monitor() -> ServeSLOMonitor:
    global _slo_monitor
    with _slo_lock:
        if _slo_monitor is None:
            _slo_monitor = ServeSLOMonitor()
        return _slo_monitor


def ensure_serve_slo_monitor() -> Optional[ServeSLOMonitor]:
    """Start the singleton monitor when any serve SLO is configured
    (called from the serve router on first deployment; a no-op without
    configured objectives keeps idle deployments thread-free)."""
    from ..core.config import cfg

    from ..serve import tenancy

    tenant_slo = tenancy.any_tenant_slo()
    if (cfg.serve_slo_ttft_p99_s <= 0 and cfg.serve_slo_queue_p99_s <= 0
            and not tenant_slo):
        return None
    monitor = serve_slo_monitor()
    monitor.start()
    return monitor
