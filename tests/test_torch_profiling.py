"""ray_tpu_torch's profiling plane on the CPU, against ray_tpu's contract:
typed device-trace guards, the torch.profiler trace round trip,
`capture_local_profile`, wall-clock alignment of the trace's events, the
ProfileStore's capacity, the in-process `profile_capture` over logical
nodes, and `trace_dump`'s merged device tracks. Without a card the trace
records host activity only, as it does for a `device="cpu"` caller.
"""

import gzip
import json
import threading
import time

import pytest
import torch

import ray_tpu_torch
from ray_tpu.util import profiling as jprofiling
from ray_tpu_torch.core.config import cfg
from ray_tpu_torch.core.exceptions import ProfilingError
from ray_tpu_torch.util import profiling, state
from ray_tpu_torch.util.metrics import registry


@pytest.fixture
def rt3():
    """Three logical nodes: the in-process capture target."""
    registry().clear()
    runtime = ray_tpu_torch.init(num_cpus=4, num_nodes=3)
    yield runtime
    ray_tpu_torch.shutdown()
    registry().clear()


def _busy():
    x = torch.ones((128, 128))
    return lambda: x @ x


def test_stop_without_active_trace_is_typed():
    with pytest.raises(ProfilingError, match="no active device trace"):
        profiling.stop_device_trace()


def test_double_start_is_typed(tmp_path):
    profiling.start_device_trace(str(tmp_path / "a"))
    try:
        with pytest.raises(ProfilingError, match="already active"):
            profiling.start_device_trace(str(tmp_path / "b"))
    finally:
        profiling.stop_device_trace()
    with pytest.raises(ProfilingError):
        profiling.stop_device_trace()


def test_a_cuda_trace_without_a_card_is_typed(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ProfilingError, match="no CUDA device"):
        profiling.start_device_trace(str(tmp_path / "a"), device="cuda")
    assert not profiling.device_trace_active()


def test_device_trace_roundtrip_cpu(tmp_path):
    work = _busy()
    logdir = tmp_path / "trace"
    with profiling.device_trace(str(logdir), device="cpu"):
        work()
    (found,) = list(logdir.rglob("*.trace.json.gz"))
    data = json.loads(gzip.decompress(found.read_bytes()))
    assert any(e.get("name") == "aten::mm" for e in data["traceEvents"])
    assert not profiling.device_trace_active()


def test_profiler_server_is_not_available():
    with pytest.raises(NotImplementedError, match="profiler server"):
        profiling.start_profiler_server(9876)
    assert profiling.profiler_server_port() is None
    assert profiling.node_snapshot()["server_port"] is None


def test_capture_local_profile_roundtrip():
    res = profiling.capture_local_profile(0.2, workload=_busy())
    meta, artifacts = res["meta"], res["artifacts"]
    assert set(meta) == set(jprofiling.capture_local_profile(0.05, device=False)["meta"])
    assert meta["device"] == "ok" and meta["host"] == "ok"
    assert meta["bytes"] == sum(len(b) for b in artifacts.values()) > 0
    assert any(n.endswith(".trace.json.gz") for n in artifacts)
    assert "host sampling profile" in artifacts["host_profile.txt"].decode()
    snap = profiling.node_snapshot()
    assert snap["active_capture"] is None and snap["last_capture"]["bytes"] == meta["bytes"]


def test_a_busy_capture_degrades_without_raising(tmp_path):
    profiling.start_device_trace(str(tmp_path / "held"))
    try:
        res = profiling.capture_local_profile(0.05, host=False)
    finally:
        profiling.stop_device_trace()
    assert res["meta"]["device"].startswith("error:") and res["artifacts"] == {}


def test_device_trace_events_align_to_wall_clock():
    """The trace's events land on the wall clock through its own base
    time: a region recorded between two time.time() readings lies between
    them (within a millisecond)."""
    work = _busy()
    marks = {}

    def workload():
        work()
        if "a" not in marks:
            marks["a"] = time.time()
            with profiling.annotate("aligned_region"):
                time.sleep(0.02)
            marks["b"] = time.time()

    res = profiling.capture_local_profile(0.2, workload=workload, host=False)
    events = profiling.load_device_trace_events(
        res["artifacts"], started_at=res["meta"]["started_at"],
        lane_prefix="device:test", max_events=500)
    assert 0 < len(events) <= 500
    assert all(e["pid"].startswith("device:test") for e in events)
    (region,) = [e for e in events if e["name"] == "aligned_region"]
    assert marks["a"] - 1e-3 <= region["ts"] / 1e6 <= marks["b"]
    assert region["dur"] / 1e6 >= 0.019
    for e in events:
        assert abs(e["ts"] / 1e6 - res["meta"]["started_at"]) < 60.0


def test_a_trace_without_its_base_time_is_refused():
    raw = gzip.compress(json.dumps({"traceEvents": [{"ph": "X", "ts": 1.0}]}).encode())
    with pytest.raises(ProfilingError, match="baseTimeNanoseconds"):
        profiling.load_device_trace_events({"x.trace.json.gz": raw}, started_at=0.0)


def test_profile_store_capacity_evicts_oldest():
    store = profiling.ProfileStore(capacity=2)
    for i in range(3):
        store.add({"profile_id": f"p{i}", "started_at": float(i)}, {("n", "a"): b"x" * i})
    assert [r["profile_id"] for r in store.list()] == ["p1", "p2"]
    assert store.get("p0") is None and store.artifact("p0", "n", "a") is None
    assert store.artifacts_for("p2") == {"n/a": b"xx"}


def test_fanout_capture_in_process_runtime(rt3):
    """One state.profile() call covers every logical node, registers the
    capture, and serves metas + artifact bytes through the state API."""
    work = _busy()
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            work()

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    try:
        record = state.profile(duration_s=0.3)
    finally:
        stop.set()
        t.join(timeout=5)
    assert len(record["nodes"]) == 3 and record["total_bytes"] > 0
    assert record["profile_id"] in [p["profile_id"] for p in state.list_profiles()]
    full = state.get_profile(record["profile_id"])
    holders = [(nh, m) for nh, m in full["nodes"].items() if not m.get("artifacts_at")]
    (node_hex, meta), = holders
    assert node_hex == rt3.scheduler.head_node().node_id.hex()
    assert meta["device"] == "ok" and meta["host"] == "ok"
    assert len(state.profile_artifact(record["profile_id"], node_hex,
                                      meta["artifact_names"][0])) > 0
    assert all(m["artifacts_at"] == node_hex for m in full["nodes"].values()
               if m.get("artifacts_at"))
    with pytest.raises(ValueError):
        state.get_profile("no-such-profile")
    report = state.status_report(verbose=True)
    assert "profiler:" in report and "last capture" in report


def test_capture_selector_and_unknown_selector(rt3):
    head_hex = rt3.scheduler.head_node().node_id.hex()
    record = state.profile(nodes=[head_hex[:8]], duration_s=0.1, device=False)
    assert list(record["nodes"]) == [head_hex]
    with pytest.raises(ValueError, match="selector"):
        state.profile(nodes=["ffff-no-such-node"], duration_s=0.1)


def test_trace_dump_merges_device_tracks(rt3):
    """trace_dump(profile_id=...) is valid Perfetto JSON holding BOTH the
    runtime's spans and the capture's tracks."""
    @ray_tpu_torch.remote
    def traced():
        time.sleep(0.01)
        return 1

    ray_tpu_torch.get([traced.remote() for _ in range(3)])
    work = _busy()
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            work()

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    try:
        record = state.profile(duration_s=0.2)
    finally:
        stop.set()
        t.join(timeout=5)
    cfg.set(profile_merge_max_events=500)
    try:
        trace = json.loads(state.trace_dump(profile_id=record["profile_id"]))
    finally:
        cfg.reset("profile_merge_max_events")
    events = trace["traceEvents"]
    device = [e for e in events if str(e.get("pid", "")).startswith("device:")]
    spans = [e for e in events if not str(e.get("pid", "")).startswith("device:")]
    assert device and len(device) <= 500
    assert any(e["name"] == "task.execute" for e in spans)
    with pytest.raises(ValueError, match="no registered profile"):
        state.trace_dump(profile_id="bogus")
