"""The port's chaos injection (`ray_tpu_torch/core/chaos.py`): every case
of `tests/test_chaos.py` run on the port, the two RPC-chaos cases and the
200-request chaos drill of `tests/test_serve_resilience.py`, the
`RAY_TPU_CHAOS` grammar parsed by both packages into equal configs, and
the refusal of `kill_head` (the head's drill comes with ROADMAP A6b,
head restart).
"""

import dataclasses

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.core import chaos
from ray_tpu_torch.core.chaos import ChaosInjectedError
from ray_tpu_torch.core.exceptions import BackPressureError, RequestTimeoutError, unwrap_error


@pytest.fixture
def rt():
    runtime = ray_tpu_torch.init(num_cpus=4, detect_accelerators=False)
    yield runtime
    chaos.clear_chaos()
    ray_tpu_torch.shutdown()


def test_injected_failure_surfaces_as_task_error(rt):
    chaos.set_chaos(failure_prob=1.0, name_filter="victim")

    @ray_tpu_torch.remote(name="victim")
    def victim():
        return 1

    with pytest.raises(ray_tpu_torch.TaskError, match="chaos"):
        ray_tpu_torch.get(victim.remote(), timeout=30)


def test_name_filter_spares_other_tasks(rt):
    chaos.set_chaos(failure_prob=1.0, name_filter="victim")

    @ray_tpu_torch.remote(name="innocent")
    def innocent():
        return 42

    assert ray_tpu_torch.get(innocent.remote(), timeout=30) == 42


def test_retries_recover_from_bounded_chaos(rt):
    # exactly 2 injections, then clean: max_retries=3 must succeed
    chaos.set_chaos(failure_prob=1.0, max_injections=2, name_filter="flaky")

    @ray_tpu_torch.remote(name="flaky", max_retries=3, retry_exceptions=True)
    def flaky():
        return "survived"

    assert ray_tpu_torch.get(flaky.remote(), timeout=30) == "survived"
    assert chaos.num_injected() == 2


def test_chaos_env_parsing(monkeypatch):
    monkeypatch.setenv("RAY_TPU_CHAOS", "failure_prob=0.5,delay_s=0.01,max_injections=3,name_filter=x")
    chaos.load_from_env()
    try:
        cfg = chaos._state.config
        assert cfg.failure_prob == 0.5
        assert cfg.delay_s == 0.01
        assert cfg.max_injections == 3
        assert cfg.name_filter == "x"
        assert cfg.kill_node is False
    finally:
        chaos.clear_chaos()


def test_kill_node_env_parsing(monkeypatch):
    monkeypatch.setenv("RAY_TPU_CHAOS", "kill_node=1,name_filter=boom,max_injections=1")
    chaos.load_from_env()
    try:
        cfg = chaos._state.config
        assert cfg.kill_node is True
        assert cfg.name_filter == "boom"
        assert cfg.max_injections == 1
    finally:
        chaos.clear_chaos()


def test_kill_node_hard_exits_matching_task(monkeypatch):
    """kill_node escalates an injection to process death (os._exit):
    filtered by task name, bounded by max_injections."""
    exits = []
    monkeypatch.setattr(chaos.os, "_exit", lambda code: exits.append(code))
    chaos.set_chaos(kill_node=True, name_filter="die", max_injections=1)
    try:
        chaos.maybe_inject("innocent")
        assert exits == []
        chaos.maybe_inject("die-here")
        assert exits == [137]
        assert chaos.num_injected() == 1
        chaos.maybe_inject("die-here")  # budget spent: no second kill
        assert exits == [137]
    finally:
        chaos.clear_chaos()


def _chaos_trainer_run(pkg, chaos_mod, train_pkg):
    chaos_mod.set_chaos(failure_prob=1.0, max_injections=1, name_filter="TrainWorker.run")

    def loop(config):
        train_pkg.report({"ok": 1})
        return "done"

    trainer = train_pkg.Trainer(
        loop, scaling_config=train_pkg.ScalingConfig(num_workers=1),
        run_config=train_pkg.RunConfig(failure=train_pkg.FailureConfig(max_failures=2)),
        train_loop_config={})
    result = trainer.fit()
    return result.status.value, result.num_restarts, chaos_mod.num_injected()


def test_chaos_under_training_controller_restart(rt):
    """The run finishes under a failure injection aimed at the gang's
    `TrainWorker.run` calls, with the same restarts and injections as
    JAX's (its workers are named actors, `<run>-worker-<i>`, so the filter
    matches no call in either package)."""
    import ray_tpu
    from ray_tpu import train as jtrain
    from ray_tpu.core import chaos as jchaos
    from ray_tpu_torch import train

    got = _chaos_trainer_run(ray_tpu_torch, chaos, train)
    ray_tpu.init(num_cpus=4, detect_accelerators=False)
    try:
        want = _chaos_trainer_run(ray_tpu, jchaos, jtrain)
    finally:
        jchaos.clear_chaos()
        ray_tpu.shutdown()
    assert got[0] == "FINISHED"
    assert got == want


# ---------------------------------------------------------------- rpc chaos


def test_rpc_chaos_error_injection_is_retried():
    from ray_tpu_torch.core.rpc import RpcClient, RpcServer

    calls = {"n": 0}

    def handler():
        calls["n"] += 1
        return calls["n"]

    server = RpcServer({"hit": handler})
    try:
        chaos.set_chaos(rpc_error_prob=1.0, max_injections=2, seed=1)
        client = RpcClient(server.url, retries=4, retry_wait_s=0.01)
        # two injected transport errors before the send, then the real
        # call: the handler runs once (injections never reach the wire)
        assert client.call("hit") == 1
        assert calls["n"] == 1
        assert chaos.num_injected() == 2
        client.close()
    finally:
        chaos.clear_chaos()
        server.stop()


def test_rpc_chaos_connection_drop_reconnects():
    from ray_tpu_torch.core.rpc import RpcClient, RpcServer

    server = RpcServer({"val": lambda: 7})
    try:
        client = RpcClient(server.url, retries=2, retry_wait_s=0.01)
        assert client.call("val") == 7  # warm the persistent connection
        chaos.set_chaos(rpc_drop_prob=1.0, max_injections=1, seed=2)
        assert client.call("val") == 7  # dropped, reconnected, served
        assert chaos.num_injected() == 1
        client.close()
    finally:
        chaos.clear_chaos()
        server.stop()


# ---------------------------------------------------------- the serve drill


def test_chaos_drill_200_requests_no_hangs():
    """With call-failure injection armed and a replica killed mid-run, a
    200-request load completes with no hung request: each succeeds (after
    a failover, maybe) or fails fast with a typed error."""
    ray_tpu_torch.init(num_cpus=8, detect_accelerators=False)
    try:
        @serve.deployment(num_replicas=3, max_ongoing_requests=8)
        class Drill:
            def __call__(self, payload):
                import time

                time.sleep(0.01)
                return payload * 2

        handle = serve.run(Drill.options(name="drill").bind())
        import time

        deadline = time.time() + 15
        while time.time() < deadline:
            if serve.status()["drill"]["live_replicas"] == 3:
                break
            time.sleep(0.05)
        # chaos on replica CALLS only (".call" spares the health probes):
        # ~15% of calls fail like real faults, at most 30
        chaos.set_chaos(failure_prob=0.15, max_injections=30, name_filter=".call", seed=7)
        caller = handle.options(timeout_s=30, max_retries=6)
        refs = [caller.remote(i) for i in range(100)]
        from ray_tpu_torch.serve import api as serve_api

        state = serve_api._controller._states["drill"]
        ray_tpu_torch.kill(state.replicas[1])
        refs += [caller.remote(i) for i in range(100, 200)]
        ok, typed_fail, hung = 0, 0, []
        for i, ref in enumerate(refs):
            try:
                assert ray_tpu_torch.get(ref, timeout=60) == i * 2
                ok += 1
            except ray_tpu_torch.GetTimeoutError:
                hung.append(i)
            except Exception as e:  # noqa: BLE001 - the drill's classification
                cause = unwrap_error(e)
                assert isinstance(cause, (RequestTimeoutError, BackPressureError,
                                          ChaosInjectedError)), \
                    f"request {i} failed with untyped {cause!r}"
                typed_fail += 1
        assert not hung, f"hung requests: {hung}"
        assert ok >= 190, (ok, typed_fail)
        assert chaos.num_injected() > 0, "the drill never injected a fault"
        chaos.clear_chaos()
        # the killed replica is replaced and the deployment still serves
        assert ray_tpu_torch.get(handle.remote(7), timeout=30) == 14
    finally:
        chaos.clear_chaos()
        serve.shutdown()
        ray_tpu_torch.shutdown()


# ----------------------------------------------------- parity and refusals


@pytest.mark.parametrize("raw", [
    "failure_prob=0.5,delay_s=0.01,max_injections=3,name_filter=x",
    "kill_node=1,name_filter=chaos-kill,max_injections=1",
    "preempt_node=true,preempt_warning_s=2.5,name_filter=trig,max_injections=1,seed=9",
    "rpc_error_prob=0.25,rpc_delay_s=0.002,rpc_drop_prob=0.1,seed=3",
    "kill_node=off,preempt_node=yes,unknown_key=4,delay_s=1e-3",
])
def test_env_grammar_matches_jax(monkeypatch, raw):
    """The same RAY_TPU_CHAOS string arms equal configs in both packages."""
    from ray_tpu.core import chaos as jchaos

    monkeypatch.setenv("RAY_TPU_CHAOS", raw)
    try:
        jchaos.load_from_env()
        chaos.load_from_env()
        assert dataclasses.asdict(chaos._state.config) == dataclasses.asdict(jchaos._state.config)
    finally:
        jchaos.clear_chaos()
        chaos.clear_chaos()


def test_kill_head_is_refused(monkeypatch):
    """kill_head fires from the head's GCS snapshot loop, which is not
    ported: arming it raises, from set_chaos and from the environment."""
    with pytest.raises(NotImplementedError, match=r"A6b \(head restart\)"):
        chaos.set_chaos(kill_head=True, delay_s=1.0)
    monkeypatch.setenv("RAY_TPU_CHAOS", "kill_head=1,delay_s=2")
    with pytest.raises(NotImplementedError, match=r"A6b \(head restart\)"):
        chaos.load_from_env()
    assert chaos._state.config is None
