"""ray_tpu_torch's health checks and memory monitor against ray_tpu's on
the CPU.

Counterpart of `tests/test_health.py` (its GCS snapshot case belongs to
clusters, ROADMAP A6): the same probe sequences through both packages'
`HealthCheckManager` give the same dead targets at the same rounds; a
process actor whose worker is SIGKILLed while idle is restarted by the
health manager with no method call in between, in both packages, with
the same restart count and fresh state; the memory monitor kills the
newest busy worker under `retriable_fifo` and its retriable task still
completes, and `group_by_owner` picks from the largest env group. Waits
are bounded polls on restart counts and results, never timing
assertions. The fixture shuts both runtimes down and asserts that no
worker and no health or monitor thread is left.
"""

import os
import signal
import threading
import time

import pytest

import ray_tpu
import ray_tpu_torch
import torch_process_udfs as U
from ray_tpu.core import health as jhealth
from ray_tpu.core import worker_pool as jpool
from ray_tpu.core.config import cfg as jcfg
from ray_tpu_torch.core import health as thealth
from ray_tpu_torch.core import worker_pool as tpool
from ray_tpu_torch.core.config import cfg as tcfg

PKGS = {"jax": ray_tpu, "torch": ray_tpu_torch}
HEALTH = {"jax": jhealth, "torch": thealth}
POOLS = {"jax": jpool, "torch": tpool}
TIMEOUT = 60


@pytest.fixture(autouse=True)
def _nothing_left():
    before = U.live_children()
    yield
    for pkg in PKGS.values():
        pkg.shutdown()
    jcfg.reset()
    tcfg.reset()
    assert U.wait_no_children(before) == []
    left = [t.name for t in threading.enumerate()
            if t.name in ("ray_tpu_torch-health-check", "ray_tpu_torch-memory-monitor")]
    assert left == []


# ------------------------------------------------------------- health checks


def test_health_threshold_and_single_callback():
    out = {}
    for name, mod in HEALTH.items():
        hc = mod.HealthCheckManager(period_s=999, failure_threshold=3)
        alive = {"v": True}
        deaths = []
        hc.register("t1", lambda: alive["v"], deaths.append)
        rounds = [hc.check_once()]
        alive["v"] = False
        rounds += [hc.check_once() for _ in range(4)]
        out[name] = rounds, deaths, dict(hc.stats)
    assert out["jax"] == out["torch"] == ([[], [], [], ["t1"], []], ["t1"],
                                          {"probes": 4, "deaths": 1})


def test_health_recovery_resets_counter():
    out = {}
    for name, mod in HEALTH.items():
        hc = mod.HealthCheckManager(period_s=999, failure_threshold=2)
        seq = [False, True, False, False, True]
        state = {"i": 0}
        deaths = []

        def probe(seq=seq, state=state):
            return seq[state["i"]]

        hc.register("t", probe, deaths.append)
        rounds = []
        for i in range(len(seq)):
            state["i"] = i
            rounds.append(hc.check_once())
        out[name] = rounds, deaths
    assert out["jax"] == out["torch"] == ([[], [], [], ["t"], []], ["t"])


def test_raising_probe_counts_as_down_and_unregister_stops_it():
    out = {}
    for name, mod in HEALTH.items():
        hc = mod.HealthCheckManager(period_s=999, failure_threshold=1)
        deaths = []

        def bad():
            raise OSError("probe transport")

        hc.register("bad", bad, deaths.append)
        hc.register("gone", lambda: False, deaths.append)
        hc.unregister("gone")
        out[name] = hc.check_once(), deaths
    assert out["jax"] == out["torch"] == (["bad"], ["bad"])


def test_killed_process_actor_detected_and_restarted_without_calls():
    """A process actor's worker is SIGKILLed while idle; only the health
    manager can notice. It restarts the actor (fresh state) with no
    method call in between."""
    out = {}
    for name, pkg in PKGS.items():
        pkg.init(num_cpus=4, detect_accelerators=False,
                 _system_config={"health_check_period_s": 0.05})
        try:
            svc = pkg.remote(U.Counter).options(executor="process", max_restarts=2).remote(0)
            first = pkg.get(svc.incr.remote(), timeout=TIMEOUT)
            pid = pkg.get(svc.__ray_pid__.remote(), timeout=TIMEOUT)
            os.kill(pid, signal.SIGKILL)
            deadline = time.monotonic() + TIMEOUT
            while pkg.list_actors()[0]["restarts"] == 0 and time.monotonic() < deadline:
                time.sleep(0.02)  # a poll of the actor table: no method call
            restarts = pkg.list_actors()[0]["restarts"]
            new_pid = pkg.get(svc.__ray_pid__.remote(), timeout=TIMEOUT)
            out[name] = first, restarts, new_pid != pid, pkg.get(svc.incr.remote(), timeout=TIMEOUT)
        finally:
            pkg.shutdown()
    assert out["jax"] == out["torch"] == (1, 1, True, 1)


def test_runtime_starts_and_joins_its_health_threads():
    ray_tpu_torch.init(num_cpus=2, detect_accelerators=False)
    names = {t.name for t in threading.enumerate()}
    assert {"ray_tpu_torch-health-check", "ray_tpu_torch-memory-monitor"} <= names
    ray_tpu_torch.shutdown()  # the fixture asserts both threads are gone


# ------------------------------------------------------------ memory monitor


def test_memory_monitor_kills_newest_busy_worker():
    out = {}
    for name, pkg in PKGS.items():
        pkg.init(num_cpus=4, detect_accelerators=False)
        try:
            usage = {"v": 0.0}
            mon = HEALTH[name].MemoryMonitor(threshold=0.9, interval_s=0,
                                             policy="retriable_fifo", usage_fn=lambda: usage["v"])
            below = mon.check_once()
            ref = pkg.remote(U.sleep_double).options(
                executor="process", max_retries=1, retry_exceptions=True).remote(21, 2.0)
            pool = POOLS[name].get_worker_pool()
            deadline = time.monotonic() + TIMEOUT
            while time.monotonic() < deadline:
                with pool._lock:
                    if pool._busy:
                        break
                time.sleep(0.02)
            usage["v"] = 0.97
            killed = mon.check_once()
            out[name] = below, killed, dict(mon.stats), pkg.get(ref, timeout=TIMEOUT)
        finally:
            pkg.shutdown()
    assert out["jax"] == out["torch"] == (False, True, {"checks": 2, "kills": 1}, 42)


class _FakeWorker:
    def __init__(self, pid, env_key, last_used):
        self.pid, self.env_key, self.last_used = pid, env_key, last_used
        self.killed = False

    def kill(self):
        self.killed = True


class _FakePool:
    def __init__(self, busy):
        self._lock = threading.Lock()
        self._busy = busy


@pytest.mark.parametrize("policy", ["retriable_fifo", "group_by_owner"])
def test_memory_monitor_policies_pick_the_same_victim(monkeypatch, policy):
    out = {}
    for name, mod in HEALTH.items():
        busy = [_FakeWorker(1, "a", 5.0), _FakeWorker(2, "b", 9.0),
                _FakeWorker(3, "a", 7.0), _FakeWorker(4, "a", 1.0)]
        monkeypatch.setattr(POOLS[name], "_pool", _FakePool(busy))
        mon = mod.MemoryMonitor(0.5, 0, policy=policy, usage_fn=lambda: 0.99)
        assert mon.check_once() is True
        out[name] = [w.pid for w in busy if w.killed]
    # fifo: the newest busy worker; group_by_owner: the newest of env "a"
    assert out["jax"] == out["torch"] == ([2] if policy == "retriable_fifo" else [3])


def test_memory_monitor_without_workers_kills_nothing():
    mon = thealth.MemoryMonitor(0.5, 0, usage_fn=lambda: 0.99)
    assert tpool.peek_worker_pool() is None
    assert mon.check_once() is False and mon.stats == {"checks": 1, "kills": 0}


def test_memory_monitor_bad_policy_rejected():
    for mod in HEALTH.values():
        with pytest.raises(ValueError, match="unknown oom policy"):
            mod.MemoryMonitor(0.9, 1.0, policy="lottery")


def test_memory_usage_fraction_reads_meminfo():
    for mod in HEALTH.values():
        assert 0.0 <= mod.read_memory_usage_fraction() <= 1.0


def test_cluster_probes_raise_naming_a6():
    """probe_agent is ported (cluster mode, ROADMAP A6a): a local node is
    alive, a remote one whose agent does not answer is not. The SIGTERM
    preemption handler is ported (ROADMAP A6b, part 3): SIGTERM calls the
    context's begin_preemption with JAX's reason, window and fate."""
    from ray_tpu_torch.core.ids import NodeID
    from ray_tpu_torch.core.scheduler import Node, RemoteNode

    assert thealth.probe_agent(Node(NodeID.from_random(), {"CPU": 1.0})) is True
    gone = RemoteNode(NodeID.from_random(), {"CPU": 1.0}, "127.0.0.1:1")
    gone.client._timeout = 0.5
    assert thealth.probe_agent(gone) is False
    calls = {"torch": [], "jax": []}

    class _Ctx:
        def __init__(self, name):
            self.name = name

        def begin_preemption(self, reason, warning_s=None, fate=None):
            calls[self.name].append((reason, warning_s, fate))

    prev = signal.getsignal(signal.SIGTERM)
    try:
        for name, mod in (("torch", thealth), ("jax", jhealth)):
            mod.install_preemption_signal_handler(_Ctx(name), warning_s=3.0)
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert calls["torch"] == calls["jax"] == [("SIGTERM (preemption notice)", 3.0, "shutdown")]


def test_flags_match_jax():
    names = ("native_store", "shm_min_bytes", "worker_idle_timeout_s", "max_process_workers",
             "health_check_period_s", "health_check_failures", "memory_monitor_interval_s",
             "memory_usage_threshold", "oom_policy")
    assert {n: getattr(tcfg, n) for n in names} == {n: getattr(jcfg, n) for n in names}
