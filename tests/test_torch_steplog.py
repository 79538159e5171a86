"""ray_tpu_torch.train.steplog, the port's LMTrainer instrumentation and
ray_tpu_torch.util (logs, events, metrics) against the JAX package on
the CPU.

The same marks and records go to both packages' step logs: the derived
views (`summarize_steps`, `skew_matrix`, `dominant_bucket`,
`render_waterfall`) must be equal, exactly (host-side Python on the same
floats). The same series in both metrics registries give the same
Prometheus text; the same events give the same segment files. The
exact-sum invariant of the trainer's sampled steps is held as JAX's test
holds it: float addition only (rel 1e-9, abs 1e-12).
"""

import logging
import os
import time
import urllib.request

import numpy as np
import pytest

from ray_tpu.train import steplog as jsteplog
from ray_tpu.util import events as jevents
from ray_tpu.util import logs as jlogs
from ray_tpu.util import metrics as jmetrics
from ray_tpu_torch.core.config import cfg
from ray_tpu_torch.models import get_config
from ray_tpu_torch.train import LMTrainer, steplog
from ray_tpu_torch.util import events as tevents
from ray_tpu_torch.util import logs as tlogs
from ray_tpu_torch.util import metrics as tmetrics


@pytest.fixture(autouse=True)
def _clean_steplog():
    steplog.log().clear()
    yield
    steplog.log().clear()
    cfg.reset()


def _record(run, rank, step, *, data_wait=0.002, fwd_bwd=0.01, ts=1000.0):
    """A sampled-step record shaped like the trainer's `_steplog` entries,
    with its node named: an unnamed one takes the process's node id, which
    earlier tests in the same worker may have set in either package."""
    buckets = {
        "data_wait": data_wait, "h2d": 0.001, "fwd_bwd_compute": fwd_bwd,
        "dp_sync": 0.0, "optimizer_update": 0.0, "ckpt_save": 0.0,
        "report": 0.001, "other": 0.0005,
    }
    return {"run": run, "rank": rank, "step": step, "node": "n0", "ts": ts + step,
            "wall_s": sum(buckets.values()), "buckets": buckets}


def _records():
    return [
        _record("skew", 0, 5), _record("skew", 1, 5, data_wait=0.450),
        _record("skew", 2, 5, fwd_bwd=0.2), _record("skew", 0, 6),
        _record("skew", 1, 6, fwd_bwd=0.03), _record("other-run", 0, 1, data_wait=0.1),
    ]


def _strip(summaries):
    """Summaries without their recording-time fields."""
    return [{k: v for k, v in s.items() if k not in ("mono", "seq")} for s in summaries]


def test_step_log_views_match_jax():
    """The same records ingested by both packages' StepLog, and the same
    flat marks summarized: equal summaries, skew rows, dominant buckets and
    waterfall text."""
    mine, ref = steplog.StepLog(), jsteplog.StepLog()
    assert len(mine.ingest(_records())) == len(ref.ingest(_records())) == 6
    assert mine.ingest(_records()) == ref.ingest(_records()) == []  # dedup
    assert _strip(mine.steps()) == _strip(ref.steps())
    marks = [dict(m, seq=i) for i, m in enumerate(ref.since(0))]
    assert _strip(steplog.summarize_steps(marks)) == _strip(jsteplog.summarize_steps(marks))
    summaries = ref.steps()
    assert steplog.skew_matrix(summaries) == jsteplog.skew_matrix(summaries)
    rows = steplog.skew_matrix(mine.steps(run="skew"))
    assert rows[0]["straggler_rank"] == 1 and rows[0]["dominant_bucket"] == "data_wait"
    per_rank = {s["rank"]: s for s in summaries if s["run"] == "skew" and s["step"] == 5}
    for rank in per_rank:
        assert steplog.dominant_bucket(per_rank, rank) == jsteplog.dominant_bucket(per_rank, rank)
    text = steplog.render_waterfall(mine.steps())
    assert text == jsteplog.render_waterfall(ref.steps())
    assert "skew: straggler rank 1" in text and "dominant data_wait" in text
    assert steplog.render_waterfall([]) == jsteplog.render_waterfall([]) == "(no sampled steps)"
    assert steplog.STEP_PHASES.keys() == jsteplog.STEP_PHASES.keys()
    assert steplog.SEAL_PHASE == jsteplog.SEAL_PHASE


def test_ring_eviction_cursor_and_seal_match_jax():
    """Marks past the ring and index capacities evict oldest-first; the
    since() cursor walks the same seqs; a seal without wall_s takes the
    bucket sum; a duplicate mark is dropped."""
    out = []
    for mod in (steplog, jsteplog):
        sl = mod.StepLog(mark_capacity=8, step_capacity=4)
        for i in range(20):
            sl.mark("data_wait", 0.01, run="r", rank=0, step=i, node="n0", ts=float(i))
        sl.mark("other", 0.02, run="r", rank=0, step=19, node="n0", ts=19.0)
        dup = sl.mark("other", 0.5, run="r", rank=0, step=19, node="n0", ts=19.0)
        out.append((sl.stats(), _strip(sl.steps()), [m["seq"] for m in sl.since(0, max_n=3)],
                    [m["step"] for m in sl.timeline("r")], dup))
    assert out[0] == out[1]
    assert out[0][1][-1]["wall_s"] == pytest.approx(0.03)


def test_sampled_steps_exact_sum_sampling_gate_and_off_switch():
    """tests/test_steplog.py's drill on the port's trainer: every sealed
    summary's buckets sum EXACTLY to the recorded step wall time. One
    trainer drives three phases: sample_every=1, sample_every=4, recorder
    off."""
    cfg.set(step_log_sample_every=1)
    config = get_config("gpt2-tiny")
    trainer = LMTrainer(config, learning_rate=1e-3, total_steps=24, device="cpu")

    def batches(seed):
        rng = np.random.default_rng(seed)
        return [{"tokens": rng.integers(0, config.vocab_size, (8, 17)).astype(np.int32)}
                for _ in range(8)]

    trainer.train(batches(0), num_steps=8, report_every=4, run_name="exact-run")
    summaries = steplog.log().steps(run="exact-run")
    assert len(summaries) == 8  # sample_every=1: every step decomposed
    for s in summaries:
        assert s["sealed"], s
        assert set(s["buckets"]) == set(steplog.STEP_PHASES)
        assert all(v >= 0.0 for v in s["buckets"].values()), s["buckets"]
        assert sum(s["buckets"].values()) == pytest.approx(s["wall_s"], rel=1e-9, abs=1e-12)
        assert s["buckets"]["fwd_bwd_compute"] > 0.0
    # one replica: dp_sync is the wire-byte estimate (0 s), flagged estimated
    dp_marks = [m for m in steplog.log().timeline("exact-run") if m["phase"] == "dp_sync"]
    assert dp_marks and all(m["attrs"]["estimated"] and m["dur_s"] == 0.0 for m in dp_marks)

    cfg.set(step_log_sample_every=4)
    trainer.train(batches(1), num_steps=8, report_every=4, run_name="sampled-run")
    assert len(steplog.log().steps(run="sampled-run")) == 2  # loop steps 0 and 4 of 8

    cfg.set(train_step_log=False)
    before = steplog.log().stats()["seq"]
    trainer.train(batches(2), num_steps=8, report_every=4, run_name="dark-run")
    assert steplog.log().stats()["seq"] == before
    assert steplog.log().steps(run="dark-run") == []


def test_reports_carry_each_sampled_step_once():
    """The sampled-step records ride the reports' reserved `_steplog` key:
    sample_every=2 over 6 steps with reports every 3 gives records of steps
    1, 3, 5 (state steps after the sampled loop steps 0, 2, 4), each once."""
    cfg.set(step_log_sample_every=2)
    config = get_config("gpt2-tiny")
    trainer = LMTrainer(config, learning_rate=1e-3, total_steps=6, device="cpu")
    rng = np.random.default_rng(3)
    reports = []
    trainer.train([{"tokens": rng.integers(0, 256, (4, 9))} for _ in range(6)], num_steps=6,
                  report_every=3, report_fn=reports.append, run_name="payload")
    carried = [rec["step"] for r in reports for rec in r.get("_steplog", [])]
    assert carried == [1, 3, 5]
    assert all("_mono" in r for r in reports)


# ------------------------------------------------------------- util.metrics


def _series(mod, reg, prefix):
    counter = mod.Counter(f"{prefix}_requests_total", 'help with "quotes"\nand a newline',
                          ("route",))
    counter.inc(tags={"route": 'a"b\\c'})
    counter.inc(2.5, tags={"route": "x"})
    gauge = mod.Gauge(f"{prefix}_depth", "queue depth")
    gauge.set(7)
    cb = mod.Gauge(f"{prefix}_sampled", "callback", ("k",), fn=lambda: [({"k": "v"}, 3.0)])
    hist = mod.Histogram(f"{prefix}_seconds", "latency", boundaries=(0.1, 1.0), tag_keys=("op",))
    for v in (0.05, 0.5, 5.0):
        hist.observe(v, tags={"op": "step"})
    for m in (counter, gauge, cb, hist):
        reg.register(m)
    return reg.prometheus_text()


def test_prometheus_text_and_merge_match_jax():
    """The same series in both packages' registries: equal Prometheus
    text (label and help escaping, tagged histograms, callback gauges);
    the multi-node merge is equal too; the get_or_create accessors return
    the registered series."""
    mine = _series(tmetrics, tmetrics.MetricsRegistry(), "torchtest")
    ref = _series(jmetrics, jmetrics.MetricsRegistry(), "torchtest")
    assert mine == ref
    parts = {"node-a": mine, "node-b": ref.replace(" 7.0", " 8.0")}
    assert tmetrics.merge_cluster_expositions(parts) == jmetrics.merge_cluster_expositions(parts)
    first = tmetrics.get_or_create_counter("torchtest_once_total", "d", ("k",))
    assert tmetrics.get_or_create_counter("torchtest_once_total") is first
    assert tmetrics.get_or_create_histogram("torchtest_h", boundaries=(1.0,)) is \
        tmetrics.get_or_create_histogram("torchtest_h")
    assert tmetrics.STEP_SECONDS_BOUNDARIES == jmetrics.STEP_SECONDS_BOUNDARIES


def test_metrics_server_serves_the_registry():
    """start_metrics_server on localhost: /metrics is this registry's text,
    /metrics/cluster the same series labelled node_id="local"."""
    tmetrics.get_or_create_gauge("torchtest_served", "served gauge").set(4)
    port = tmetrics.start_metrics_server()
    body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
    assert "torchtest_served 4.0" in body
    merged = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics/cluster",
                                    timeout=10).read().decode()
    assert 'torchtest_served{node_id="local"} 4.0' in merged


# -------------------------------------------------------------- util.events


def test_event_segments_match_jax(tmp_path):
    """The same 200 events through both packages' EventLog with small
    segments: the same rotated file names, and read_segments replays the
    same retained events, in order, past a torn tail line."""
    out = {}
    for name, mod in (("jax", jevents), ("torch", tevents)):
        seg = str(tmp_path / name)
        log = mod.EventLog()
        log.configure_segments(seg, max_bytes=512, keep=3)
        for i in range(200):
            log.emit("warn", "test", f"event {i}", kind="ckpt.saved", node="n0", n=i)
        with open(os.path.join(seg, "events.jsonl"), "a") as f:
            f.write('{"torn": ')  # a crash mid-append
        replay = mod.read_segments(seg)
        out[name] = (sorted(os.listdir(seg)),
                     [(e["seq"], e["severity"], e["kind"], e["message"], e["extra"]) for e in replay],
                     [(e["seq"], e["message"]) for e in log.list(kind="ckpt.saved", limit=5)],
                     log.stats()["seq"])
        log.configure_segments(None)
    assert out["torch"] == out["jax"]
    assert out["torch"][1][-1][-1] == {"n": 199} and out["torch"][1][-1][1] == "WARNING"
    assert tevents.event_kinds() == jevents.event_kinds()


def test_event_sink_and_cursor(tmp_path):
    """A JSONL sink gets every event; since() walks oldest-first and never
    skips; unknown severities degrade to INFO."""
    log = tevents.EventLog(capacity=50, sink_path=str(tmp_path / "sink.jsonl"))
    for i in range(60):
        log.emit("nonsense", "test", f"e{i}", kind="train.finished")
    assert len((tmp_path / "sink.jsonl").read_text().splitlines()) == 60
    assert [e["seq"] for e in log.since(10, max_n=3)] == [11, 12, 13]
    assert log.list(limit=1)[0]["severity"] == "INFO"
    assert log.stats() == {"seq": 60, "buffered": 50, "segments_dir": None}


# ---------------------------------------------------------------- util.logs


def test_log_capture_tags_origin_like_jax():
    """The ring buffer handler prefixes the node and the attribution as
    JAX's does; the package logger's INFO reaches the capture."""
    lines = {}
    for name, mod, logger in (("jax", jlogs, "ray_tpu.test"), ("torch", tlogs, "ray_tpu_torch.test")):
        handler = mod.RingBufferHandler(capacity=3)
        handler.setFormatter(logging.Formatter("%(levelname)s %(message)s"))
        prev = mod._node_hex
        mod.set_node_id("abcdef0123456789")
        try:
            with mod.attribution("task:1234"):
                for i in range(5):
                    handler.emit(logging.LogRecord(logger, logging.INFO, __file__, 1, f"m{i}",
                                                   None, None))
        finally:
            mod.set_node_id(prev)
        lines[name] = handler.tail(10)
    assert lines["torch"] == lines["jax"] == [
        f"[node:abcdef01] [task:1234] INFO m{i}" for i in (2, 3, 4)]
    tlogs.install()
    logging.getLogger("ray_tpu_torch.test").info("captured at %s", time.time())
    assert any("captured at" in line for line in tlogs.tail(5))
