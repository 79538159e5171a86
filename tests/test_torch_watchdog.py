"""ray_tpu_torch's watchdogs, SLO-driven autoscaling, goodput and
postmortem bundles against ray_tpu's on the CPU.

`StallWatchdog`, `ServeSLOMonitor` (its window check, attainment ledger,
burn counter and events), `_histogram_quantile`, `_dominant_ttft_bucket`,
the goodput partition and `reconstruct_timeline` run on the same inputs
and the same `now` in both packages and must give the same outputs. The
three SLO-autoscaler drills of `tests/test_slo_autoscaler.py` run on a toy
deployment of the port's Serve.
"""

import json
import math
import threading
import time

import pytest

from ray_tpu.core.config import cfg as jcfg
from ray_tpu.serve import tenancy as jtenancy
from ray_tpu.util import events as jevents
from ray_tpu.util import goodput as jgoodput
from ray_tpu.util import metrics as jmetrics
from ray_tpu.util import postmortem as jpostmortem
from ray_tpu.util import watchdog as jwatchdog
import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.core.config import cfg as tcfg
from ray_tpu_torch.serve import tenancy as ttenancy
from ray_tpu_torch.util import events as tevents
from ray_tpu_torch.util import goodput as tgoodput
from ray_tpu_torch.util import metrics as tmetrics
from ray_tpu_torch.util import postmortem as tpostmortem
from ray_tpu_torch.util import state as tstate
from ray_tpu_torch.util import watchdog as twatchdog

PKGS = {
    "jax": dict(cfg=jcfg, tenancy=jtenancy, events=jevents, goodput=jgoodput,
                metrics=jmetrics, watchdog=jwatchdog, postmortem=jpostmortem),
    "torch": dict(cfg=tcfg, tenancy=ttenancy, events=tevents, goodput=tgoodput,
                  metrics=tmetrics, watchdog=twatchdog, postmortem=tpostmortem),
}
_TTFT_BOUNDS = (0.005, 0.025, 0.1, 0.5, 2.0, 10.0)


@pytest.fixture(autouse=True)
def _clean():
    for p in PKGS.values():
        p["tenancy"].reset()
        p["metrics"].registry().clear()
    yield
    for p in PKGS.values():
        p["tenancy"].reset()
        p["cfg"].reset()


def _values(metrics, name):
    metric = metrics.registry().get(name)
    return {} if metric is None else {
        tuple(sorted(tags.items())): v for tags, v in metric.collect()}


def _messages(events, t0, source="watchdog"):
    return [(e["severity"], e.get("kind"), e["message"])
            for e in events.events().list(source=source, since_ts=t0, limit=500)]


# --------------------------------------------------------------- watchdog


def test_stall_watchdog_transitions_match_jax():
    """The deterministic drill of JAX's unit test on both watchdogs: EWMA
    regression names the straggler, recovery clears, the no-progress
    window catches a silent gang, close() clears the gauge."""
    seen = []
    for name, p in PKGS.items():
        t_start = time.time()
        wd = p["watchdog"].StallWatchdog("unit_run", 2, window_s=10.0, factor=3.0,
                                         alpha=0.5, min_s=0.5)
        t0 = 1000.0
        obs = []
        for i in range(6):
            wd.observe_report(0, t0 + 0.2 * i)
            wd.observe_report(1, t0 + 0.2 * i)
        obs.append(wd.check(t0 + 0.2 * 5 + 0.1))
        for i in range(6, 10):
            wd.observe_report(0, t0 + 0.2 * i)
        wd.observe_step_buckets(1, {"fwd_bwd_compute": 0.4, "data_wait": 0.9})
        wd.observe_step_buckets(0, {"fwd_bwd_compute": 0.4, "data_wait": 0.1})
        obs += [wd.check(t0 + 0.2 * 9 + 0.8), wd.straggler, wd.straggler_bucket,
                wd.stall_reason, _values(p["metrics"], "raytpu_train_stalled")]
        wd.observe_report(1, t0 + 0.2 * 9 + 0.9)
        wd.observe_report(0, t0 + 0.2 * 9 + 0.9)
        obs += [wd.check(t0 + 0.2 * 9 + 1.0), _values(p["metrics"], "raytpu_train_stalled")]
        obs += [wd.check(t0 + 1000.0), wd.stall_reason]
        wd.mark_done(0)
        wd.mark_done(1)
        obs.append(wd.check(t0 + 2000.0))
        wd.close()
        obs += [_values(p["metrics"], "raytpu_train_stalled"), _messages(p["events"], t_start)]
        seen.append(obs)
    assert seen[0] == seen[1]
    obs = seen[1]
    assert obs[:4] == [False, True, 1, "data_wait"]
    assert obs[5] == {(("run", "unit_run"),): 1.0} and obs[6] is False
    assert obs[8] is True and "no worker reported" in obs[9] and obs[10] is False
    assert any("STALLED" in m and "rank 1" in m for _, _, m in obs[-1])


def test_histogram_quantile_and_dominant_bucket_match_jax():
    cases = [
        ([(0.1, 0), (0.5, 10), (1.0, 0), (math.inf, 0)], 10, 0.99),
        ([(0.1, 5), (0.5, 5), (1.0, 0), (math.inf, 0)], 10, 0.5),
        ([(0.1, 1), (0.5, 0), (1.0, 0), (math.inf, 3)], 4, 0.99),
        ([(0.1, 0)], 0, 0.99),
    ]
    for buckets, total, q in cases:
        assert (twatchdog._histogram_quantile(buckets, total, q)
                == jwatchdog._histogram_quantile(buckets, total, q))
    windows = [
        [{"queue_wait_s": 4.0, "preempt_wait_s": 0.5, "prefill_compute_s": 0.5}],
        [{"queue_wait_s": 0.1, "preempt_wait_s": 0.0, "prefill_compute_s": 0.3},
         {"queue_wait_s": 0.0, "preempt_wait_s": 0.6, "prefill_compute_s": 0.1}],
        [{"ttft_s": 0.2}],
        [],
    ]
    for window in windows:
        assert (twatchdog._dominant_ttft_bucket(window)
                == jwatchdog._dominant_ttft_bucket(window))
    assert twatchdog._dominant_ttft_bucket(windows[0]) == ("queue_wait", pytest.approx(0.8))


def test_serve_slo_monitor_check_and_attainment_match_jax():
    """Histogram windows (a burning one, a healthy one) and per-tenant TTFT
    and queue-wait windows on both monitors: check() outputs, the
    attainment ledger, the burn counter, the gauges and the burn events
    (the dominant TTFT bucket named) are equal."""
    seen = []
    for name, p in PKGS.items():
        t0 = time.time()
        p["cfg"].set(serve_slo_ttft_p99_s=0.1, serve_slo_queue_p99_s=0.2)
        hist = p["metrics"].get_or_create_histogram(
            "raytpu_serve_ttft_seconds", "ttft", boundaries=_TTFT_BOUNDS)
        monitor = p["watchdog"].ServeSLOMonitor()
        outs = [monitor.check()]
        for _ in range(50):
            hist.observe(1.5)
        for _ in range(10):
            p["tenancy"].observe_ttft("t-slow", 5.0)
            p["tenancy"].observe_ttft_breakdown("t-slow", {
                "ttft_s": 5.0, "queue_wait_s": 4.0, "preempt_wait_s": 0.5,
                "prefill_compute_s": 0.5})
        outs.append(monitor.check())
        for _ in range(200):
            hist.observe(0.01)
        outs.append(monitor.check())
        seen.append((outs, monitor.attainment_report(),
                     _values(p["metrics"], "raytpu_serve_slo_burn_total"),
                     _values(p["metrics"], "raytpu_serve_slo_attainment"),
                     _values(p["metrics"], "raytpu_serve_tenant_slo_attainment"),
                     _values(p["metrics"], "raytpu_serve_tenant_queue_wait_p99_seconds"),
                     _messages(p["events"], t0)))
    assert seen[0] == seen[1]
    outs, ledger, burns, attained, *_, messages = seen[1]
    assert outs[0] == {} and outs[1]["ttft_p99"] > 0.1 and outs[1]["ttft_p99:t-slow"] == 5.0
    assert "ttft_p99:t-slow" not in outs[2]
    assert ledger["ttft_p99"]["windows"] == 2 and ledger["ttft_p99"]["attainment"] == 0.5
    assert burns == {(("slo", "ttft_p99"),): 1.0, (("slo", "ttft_p99:t-slow"),): 1.0}
    assert any("dominant bucket: queue_wait (80% of TTFT)" in m for _, _, m in messages)


def test_per_tenant_ttft_windows_feed_slo_monitor():
    seen = []
    for name, p in PKGS.items():
        tenancy = p["tenancy"]
        tenancy.set_tenant("gold", ttft_slo_s=0.000001)  # everything violates
        tenancy.observe_ttft("gold", 0.5)
        tenancy.observe_ttft("gold", 0.7)
        tenancy.observe_ttft("casual", 0.5)  # no objective → never violates
        monitor = p["watchdog"].ServeSLOMonitor()
        out = monitor.check()
        report = monitor.attainment_report()
        seen.append((out, report, monitor.check(), tenancy.any_tenant_slo()))
    assert seen[0] == seen[1]
    out, report, again, any_slo = seen[1]
    assert out["ttft_p99:gold"] >= 0.5
    assert report["ttft_p99:gold"]["violated"] == 1
    assert report["ttft_p99:gold"]["attainment"] == 0.0
    assert report["ttft_p99:casual"]["violated"] == 0
    assert "ttft_p99:gold" not in again and any_slo


def test_monitor_thread_starts_only_with_an_objective_and_stops_joined():
    assert twatchdog.ensure_serve_slo_monitor() is None
    tcfg.set(serve_slo_ttft_p99_s=0.5, serve_slo_check_period_s=0.01)
    monitor = twatchdog.ensure_serve_slo_monitor()
    try:
        assert monitor is twatchdog.serve_slo_monitor() and monitor._thread.is_alive()
        hist = tmetrics.get_or_create_histogram(
            "raytpu_serve_ttft_seconds", "ttft", boundaries=_TTFT_BOUNDS)
        for _ in range(8):
            hist.observe(5.0)
        deadline = time.monotonic() + 10
        while not _values(tmetrics, "raytpu_serve_slo_burn_total"):
            assert time.monotonic() < deadline, "the monitor thread never burned"
            time.sleep(0.01)
    finally:
        thread = monitor._thread
        monitor.stop()
    assert not thread.is_alive()


# ------------------------------------------------------ goodput, postmortem


def test_goodput_partition_and_serve_report_match_jax(monkeypatch):
    """The goodput state machine on one fake clock in both packages: the
    same bucket seconds, fractions and published gauges; serve_slo_report
    over the same ledger."""
    clock = [100.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0 + clock[0])
    seen = []
    for name, p in PKGS.items():
        clock[0] = 100.0
        acct = p["goodput"].GoodputAccountant("acct-drill")
        for bucket, dt in (("init", 0.03), ("step_compute", 0.05), ("ckpt_save", 0.02),
                           ("step_compute", 0.03), ("bogus", 0.01)):
            acct.begin(bucket)
            clock[0] += dt
        acct.finish()
        acct.transfer("step_compute", "input_wait", 0.01)
        acct.transfer("init", "compile", 999.0)
        acct.observe_report_metrics({"ckpt_save_s": 0.005, "compile_s": 1.0})
        report = acct.report()
        monkeypatch.setattr(p["watchdog"], "_slo_monitor", p["watchdog"].ServeSLOMonitor())
        p["watchdog"]._slo_monitor._attainment["ttft_p99"] = {
            "windows": 4, "violated": 1, "requests": 40, "objective_s": 0.1,
            "last_p99_s": 0.05}
        seen.append((report, _values(p["metrics"], "raytpu_train_goodput_seconds"),
                     _values(p["metrics"], "raytpu_train_goodput_fraction"),
                     p["goodput"].serve_slo_report()))
    assert seen[0] == seen[1]
    report, _, _, slo = seen[1]
    assert abs(sum(report["buckets"].values()) - report["wall_time_s"]) < 1e-6
    assert report["buckets"]["other"] == pytest.approx(0.01)
    assert report["buckets"]["init"] == 0.0 and report["buckets"]["compile"] == pytest.approx(0.03)
    assert slo["attainment"] == 0.75


def _pieces():
    spans = [
        {"trace_id": "7f01", "span_id": "a1", "parent_id": None, "name": "serve.route",
         "lane": "router", "node": "n1", "start_ts": 10.0, "end_ts": 10.5, "status": "OK",
         "attrs": {"request_id": "req-1"}},
        {"trace_id": "7f01", "span_id": "b2", "parent_id": "a1", "name": "engine.request",
         "lane": "engine:paged", "node": "n1", "start_ts": 10.1, "end_ts": 10.4,
         "status": "OK", "attrs": {"request_id": "req-1", "ttft_s": 0.05}},
    ]
    events = [
        {"seq": 1, "ts": 10.2, "mono": 5.0, "severity": "WARNING", "source": "watchdog",
         "kind": "watchdog.slo_burn", "message": "burn", "node": "n1",
         "extra": {"slo": "ttft_p99", "objective": 0.1, "skip": [1, 2]}},
        {"seq": 2, "ts": "bad"},
    ]
    return events, spans


def test_reconstruct_timeline_matches_jax():
    events, spans = _pieces()
    ours = json.loads(tpostmortem.reconstruct_timeline(events, spans))
    theirs = json.loads(jpostmortem.reconstruct_timeline(events, spans))
    assert ours == theirs
    assert {e["ph"] for e in ours["traceEvents"]} >= {"X", "i"}


def test_bundle_round_trip_and_state_postmortem(tmp_path):
    """build_bundle / load_bundle round-trip given pieces, equal to JAX's
    members; state.postmortem on a live runtime bundles its events, spans
    (with the engine request ids) and metrics."""
    events, spans = _pieces()
    pieces = {"note": "drill", "created_at": 1_700_000_000.0, "events": events,
              "spans": spans, "metrics": "raytpu_x 1\n", "node_stats": {}, "nodes": [],
              "profiles": [], "summary": {"nodes": 1}}
    bundles = []
    for name, p in PKGS.items():
        out = str(tmp_path / f"{name}.tgz")
        manifest = p["postmortem"].build_bundle(out, note="drill", pieces=dict(pieces))
        bundles.append((manifest, p["postmortem"].load_bundle(out)))
    assert bundles[0] == bundles[1]
    manifest, bundle = bundles[1]
    assert manifest["counts"] == {"events": 2, "spans": 2, "nodes": 0, "profiles": 0}
    assert bundle["spans.jsonl"] == spans and bundle["metrics_cluster.prom"] == "raytpu_x 1\n"

    ray_tpu_torch.init(num_cpus=2)
    try:
        @ray_tpu_torch.remote
        def work(x):
            return x * 2

        assert ray_tpu_torch.get([work.remote(i) for i in range(3)], timeout=30) == [0, 2, 4]
        tevents.events().emit("INFO", "test", "bundle smoke", kind="node.discovered")
        out = str(tmp_path / "live.tgz")
        manifest = tstate.postmortem(out, note="smoke drill")
        bundle = tpostmortem.load_bundle(out)
    finally:
        ray_tpu_torch.shutdown()
    assert manifest["note"] == "smoke drill" and not manifest["errors"]
    assert manifest["counts"]["events"] > 0 and manifest["counts"]["spans"] > 0
    assert bundle["manifest.json"]["counts"] == manifest["counts"]
    phases = {e.get("ph") for e in bundle["timeline.json"]["traceEvents"]}
    assert "X" in phases and "i" in phases
    assert "raytpu_tasks_finished_total" in bundle["metrics_cluster.prom"]


# ------------------------------------------------------------ SLO autoscaler


@pytest.fixture
def rt(monkeypatch):
    # a fresh monitor: its window cursors must not carry a cleared registry's counts
    monkeypatch.setattr(twatchdog, "_slo_monitor", None)
    runtime = ray_tpu_torch.init(num_cpus=8)
    tcfg.set(serve_slo_ttft_p99_s=0.1, autoscale_burn_windows=1,
             autoscale_pressure_floor=0.25)
    yield runtime
    serve.shutdown()
    ray_tpu_torch.shutdown()
    twatchdog.serve_slo_monitor().stop()
    tcfg.reset()


def _burn_one_window(n: int = 32) -> None:
    """Feed the TTFT histogram n samples far over the 0.1 s objective and
    run one monitor evaluation: exactly one new violated window."""
    hist = tmetrics.get_or_create_histogram(
        "raytpu_serve_ttft_seconds",
        "Time to first generated token, from engine request spans.",
        boundaries=_TTFT_BOUNDS)
    for _ in range(n):
        hist.observe(5.0)
    report = twatchdog.serve_slo_monitor().check()
    assert report.get("ttft_p99", 0.0) > 0.1


def _wait(predicate, timeout=20.0, msg=""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    pytest.fail(msg or "condition not reached in time")


def test_slo_burn_scales_up_then_idle_drains_down(rt):
    release = threading.Event()

    @serve.deployment
    class Sticky:
        def __call__(self, x):
            release.wait(timeout=60)
            return x

    auto = serve.AutoscalingConfig(
        min_replicas=1, max_replicas=3,
        # 2 in flight = desired 0.5 replicas: only the SLO term asks for a
        # second one (and 0.5 demand clears the 0.25 floor)
        target_ongoing_requests=4.0, scale_down_delay_s=1.0, slo_driven=True,
    )
    t0 = time.time()
    handle = serve.run(Sticky.options(name="sticky", autoscaling=auto).bind())
    assert twatchdog.serve_slo_monitor()._thread is not None  # the router started it
    twatchdog.serve_slo_monitor().check()
    time.sleep(0.6)
    assert serve.status()["sticky"]["target_replicas"] == 1
    refs = [handle.remote(i) for i in range(2)]
    _wait(lambda: serve.status()["sticky"]["ongoing"] >= 2,
          msg=f"demand never registered: {serve.status()}")
    _burn_one_window()
    _wait(lambda: serve.status()["sticky"]["target_replicas"] >= 2,
          msg=f"burn never scaled up: {serve.status()}")
    _wait(lambda: serve.status()["sticky"]["live_replicas"] >= 2,
          msg=f"second replica never started: {serve.status()}")
    release.set()
    ray_tpu_torch.get(refs, timeout=60)
    _wait(lambda: serve.status()["sticky"]["target_replicas"] == 1,
          timeout=30, msg=f"never scaled back down: {serve.status()}")
    _wait(lambda: serve.status()["sticky"]["live_replicas"] == 1
          and serve.status()["sticky"]["draining_replicas"] == 0,
          timeout=30, msg=f"drain never completed: {serve.status()}")
    log = tevents.events().list(kind="serve.autoscale", since_ts=t0, limit=100)
    ups = [e for e in log if e["extra"]["direction"] == "up"]
    downs = [e for e in log if e["extra"]["direction"] == "down"]
    assert ups and ups[0]["extra"]["reason"] == "slo_burn", log
    assert ups[0]["extra"]["burn_windows"] >= 1
    assert ups[0]["extra"]["target_replicas"] == 2
    assert downs and downs[-1]["extra"]["target_replicas"] == 1
    scaled = tevents.events().list(kind="serve.scaled", since_ts=t0, limit=100)
    assert {e["extra"]["direction"] for e in scaled} >= {"up", "down"}
    assert tevents.events().list(kind="serve.drain", since_ts=t0, limit=100)
    attained = {t.get("slo"): v for t, v in
                tmetrics.registry().get("raytpu_serve_slo_attainment").collect()}
    assert attained.get("ttft_p99", 1.0) < 1.0


def test_burn_resets_scale_down_damper(rt):
    """A burning deployment must never shed capacity: burn windows during
    the scale-down delay push the damper forward."""

    @serve.deployment
    class Quick:
        def __call__(self, x):
            return x

    auto = serve.AutoscalingConfig(min_replicas=1, max_replicas=3, target_ongoing_requests=1.0,
                                   scale_down_delay_s=0.4, slo_driven=True)
    serve.run(Quick.options(name="quick", autoscaling=auto).bind())
    twatchdog.serve_slo_monitor().check()
    time.sleep(0.6)
    from ray_tpu_torch.serve import api as serve_api

    serve_api._controller._states["quick"].target_replicas = 2  # as if a burn scaled it up
    for _ in range(4):
        _burn_one_window()
        time.sleep(0.3)
        assert serve.status()["quick"]["target_replicas"] == 2, "a burning deployment shed capacity"
    _wait(lambda: serve.status()["quick"]["target_replicas"] == 1,
          timeout=30, msg=f"idle scale-down never landed: {serve.status()}")


def test_pressure_floor_gates_burn_scale_up(rt):
    """An SLO burn with no demand behind it does not scale up."""

    @serve.deployment
    class Idle:
        def __call__(self, x):
            return x

    auto = serve.AutoscalingConfig(min_replicas=1, max_replicas=3, target_ongoing_requests=4.0,
                                   scale_down_delay_s=1.0, slo_driven=True)
    serve.run(Idle.options(name="idle", autoscaling=auto).bind())
    twatchdog.serve_slo_monitor().check()
    time.sleep(0.6)
    _burn_one_window()
    time.sleep(1.0)  # several reconcile passes
    assert serve.status()["idle"]["target_replicas"] == 1, serve.status()
