"""The port's capacity plane against the JAX package.

The capstone of `tests/test_capacity.py` runs on the port: a training gang
and a serve deployment share one autoscaled spot fleet whose nodes exist
only because `CapacityAutoscaler` aggregated their demand; an announced
preemption then hits a node that hosts a gang bundle. Replacement capacity
is launched before the node dies (`preempt.announced` <=
`autoscaler.replace` <= `node.dead`), training finishes with
`max_failures=0` (only `num_preempt_restarts` spent), and serve surfaces
only typed errors. The planner's pure parts are then held against JAX's on
the same demand lists and node types: `_plan_launches`, `_fit_bundles`,
`DemandLedger.by_origin`, `can_provision`, and `SpotNodeProvider._plan_for`
over seeded schedules, value for value.
"""

import threading
import time

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.core import capacity as jcap
from ray_tpu_torch.core import capacity as tcap
from ray_tpu_torch.core.exceptions import RayTpuError
from ray_tpu_torch.util.events import events


def _first(evs, kind, **match):
    for e in evs:
        if e.get("kind") != kind:
            continue
        extra = e.get("extra") or {}
        if all(extra.get(k) == v for k, v in match.items()):
            return e
    raise AssertionError(f"no {kind} event matching {match} in "
                         f"{[(e.get('kind'), e.get('extra')) for e in evs]}")


def test_spot_fleet_capstone(tmp_path):
    """Train + serve on an autoscaled spot fleet survive an announced
    preemption: replacement first, death second, no failure budget spent,
    one postmortem bundle that tells it in order."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.train import (FailureConfig, RunConfig, RunStatus, ScalingConfig,
                                     TrainController)
    from ray_tpu_torch.util import state
    from ray_tpu_torch.util.metrics import registry
    from ray_tpu_torch.util.postmortem import load_bundle

    rt = ray_tpu_torch.init(num_cpus=1, detect_accelerators=False)
    scaler = None
    try:
        events().clear()
        provider = tcap.SpotNodeProvider(tcap.FakeNodeProvider(rt.scheduler), warning_s=3.0)
        # distinct custom resources keep the two workloads on their own node
        # types, so demand aggregation (not luck) decides the fleet
        scaler = tcap.CapacityAutoscaler(
            rt.scheduler, provider,
            [tcap.NodeType("spot-train", {"CPU": 1.0, "trainer": 1.0}, capacity_class="spot"),
             tcap.NodeType("spot-serve", {"CPU": 2.0, "serve_slot": 2.0},
                           capacity_class="spot")],
            poll_interval_s=0.05, idle_timeout_s=60.0, runtime=rt)
        scaler.start()

        @serve.deployment(num_replicas=2,
                          resources_per_replica={"CPU": 1.0, "serve_slot": 1.0})
        class Echo:
            def __call__(self, x):
                return f"ok-{x}"

        handle = serve.run(Echo.bind(), name="fleet-echo")
        assert ray_tpu_torch.get(handle.remote(0), timeout=60) == "ok-0"

        def train_fn(config):
            from ray_tpu_torch import train

            ctx = train.get_context()
            ckpt = train.get_checkpoint()
            start = int(ckpt["step"]) + 1 if ckpt is not None else 0
            for step in range(start, 30):
                time.sleep(0.02)
                if ctx.world_rank != 0:
                    if train.is_preempted():
                        return "preempted"
                    continue
                if train.should_checkpoint():
                    train.report({"step": step}, checkpoint={"step": step}, checkpoint_step=step)
                elif train.is_preempted():
                    return "preempted"
                elif step % 10 == 9:
                    train.report({"step": step}, checkpoint={"step": step}, checkpoint_step=step)
                else:
                    train.report({"step": step})
            return "done"

        controller = TrainController(
            train_fn,
            ScalingConfig(num_workers=2, resources_per_worker={"CPU": 1.0, "trainer": 1.0}),
            RunConfig(name="spot-fleet", storage_path=str(tmp_path / "trial"),
                      failure=FailureConfig(max_failures=0)),
            train_config={}, restart_backoff_s=0.0)
        box = {}
        thread = threading.Thread(target=lambda: box.update(result=controller.run()),
                                  daemon=True)
        thread.start()

        serve_errors = []
        stop_serving = threading.Event()

        def client_loop():
            i = 1
            while not stop_serving.is_set():
                try:
                    out = ray_tpu_torch.get(handle.remote(i), timeout=30)
                    assert out == f"ok-{i}"
                except Exception as exc:  # noqa: BLE001 - recorded for the typed-error check
                    serve_errors.append(exc)
                i += 1
                time.sleep(0.05)

        client = threading.Thread(target=client_loop, daemon=True)
        client.start()

        deadline = time.monotonic() + 60
        while not controller.metrics_history and time.monotonic() < deadline:
            time.sleep(0.02)
        assert controller.metrics_history, "gang never started reporting"
        assert scaler.stats["scale_ups"] >= 3  # 2 train + 1 serve node

        victim = next(n for n in rt.scheduler.nodes()
                      if n.labels.get("node_type") == "spot-train"
                      and rt.scheduler.resident_bundles(n.node_id.hex()))
        provider.preempt_after(victim, 0.01, warning_s=3.0)

        thread.join(timeout=120)
        stop_serving.set()
        client.join(timeout=30)
        assert not thread.is_alive(), "controller never finished"

        result = box["result"]
        assert result.status == RunStatus.FINISHED, result.error
        assert result.num_preempt_restarts == 1
        assert provider.num_preemptions() == 1
        assert scaler.stats["replacements"] >= 1

        deadline = time.monotonic() + 15
        while victim.alive and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not victim.alive, "preempted node never died"

        untyped = [e for e in serve_errors if not isinstance(e, RayTpuError)]
        assert untyped == [], untyped
        status = serve.status()["fleet-echo"]
        assert status["live_replicas"] == 2, status

        out = str(tmp_path / "fleet.tgz")
        state.postmortem(out, note="spot-fleet capstone")
        evs = load_bundle(out)["events.jsonl"]
        vh = victim.node_id.hex()
        announced = _first(evs, "preempt.announced")
        assert announced["node"] == vh
        replace = _first(evs, "autoscaler.replace", replaces=vh)
        dead = _first(evs, "node.dead")
        assert dead["node"] == vh
        assert announced["ts"] <= replace["ts"] <= dead["ts"], [announced, replace, dead]
        assert replace["extra"]["origin"] == "replace"
        assert replace["extra"]["node_type"] == "spot-train"
        assert replace["extra"]["capacity_class"] == "spot"
        origins = {(e.get("extra") or {}).get("origin")
                   for e in evs if e.get("kind") == "autoscaler.scale_up"}
        assert "pg" in origins, origins
        assert "task" in origins, origins

        goodput = result.goodput
        assert goodput is not None and goodput["wall_time_s"] > 0
        total = sum(goodput["buckets"].values())
        assert abs(total - goodput["wall_time_s"]) <= 0.05 * goodput["wall_time_s"]
        assert goodput["buckets"]["step_compute"] > 0
        assert goodput["buckets"]["ckpt_save"] > 0
        assert goodput["buckets"]["preempt_restart"] > 0

        text = registry().prometheus_text()
        assert "raytpu_autoscaler_managed_nodes" in text
        assert 'raytpu_autoscaler_scale_total{direction="up"}' in text
        for line in text.splitlines():
            if line.startswith("raytpu_autoscaler_preempt_replacements_total"):
                assert float(line.rsplit(" ", 1)[1]) >= 1.0
                break
        else:
            raise AssertionError("replacement counter missing:\n" + text)
        # the status plane reports the running autoscaler
        summary = state.summary()
        assert summary["autoscaler"]["scale_ups"] == scaler.stats["scale_ups"]
        assert "Autoscaler:" in state.status_report()
        serve.shutdown()
    finally:
        if scaler is not None:
            scaler.stop()
        ray_tpu_torch.shutdown()
    assert state.autoscaler_summary() is None  # a stopped autoscaler leaves the registry


# ------------------------------------------------------- parity of the planner

NODE_TYPES = [
    ("cpu4", {"CPU": 4.0}, 3, "on_demand"),
    ("gpu1", {"CPU": 1.0, "GPU": 1.0}, 2, "on_demand"),
    ("spot-train", {"CPU": 1.0, "trainer": 1.0}, 10, "spot"),
    ("spot-serve", {"CPU": 2.0, "serve_slot": 2.0}, 10, "spot"),
]

DEMANDS = [
    ([{"CPU": 4.0}], "task", False),
    ([{"CPU": 1.0, "trainer": 1.0}, {"CPU": 1.0, "trainer": 1.0}], "pg", True),
    ([{"CPU": 1.0, "serve_slot": 1.0}] * 3, "serve", False),
    ([{"GPU": 1.0}, {"GPU": 1.0}, {"GPU": 1.0}], "pg", True),  # 3 > gpu1's max_workers
    ([{"CPU": 2.0}, {"CPU": 1.0}, {"CPU": 3.0}], "train", True),
    ([{"CPU": 64.0}], "task", False),  # no type fits
    ([{"trainer": 1.0}], "replace", True),
    ([{"CPU": 0.5}] * 9, "task", False),
]


class _NoScheduler:
    def nodes(self):
        return []


def _plan(mod, demands, class_limits=None, budget=None, counts=None):
    types = [mod.NodeType(n, dict(r), max_workers=m, capacity_class=c)
             for n, r, m, c in NODE_TYPES]
    scaler = mod.CapacityAutoscaler(_NoScheduler(), mod.FakeNodeProvider(None), types,
                                    class_limits=class_limits, resource_budget=budget)
    if counts:
        scaler._per_type_count.update(counts)
        for t in types:
            scaler._per_class_count[t.capacity_class] = (
                scaler._per_class_count.get(t.capacity_class, 0) + counts.get(t.name, 0))
    launches, blocked = scaler._plan_launches(
        [mod.Demand(bundles=[dict(b) for b in bs], origin=o, gang=g) for bs, o, g in demands])
    return ([(t.name, d.origin, d.bundles) for t, d in launches],
            [(d.origin, d.bundles) for d in blocked],
            {tuple(sorted(r.items())): scaler.can_provision(dict(r))
             for bs, _, _ in demands for r in bs})


@pytest.mark.parametrize("settings", [
    {},
    {"class_limits": {"spot": 2}},
    {"class_limits": {"on_demand": 1, "spot": 0}},
    {"budget": {"CPU": 9.0, "GPU": 1.0}},
    {"counts": {"cpu4": 2, "spot-train": 9}},
], ids=["plain", "spot-limit", "class-limits", "budget", "running-counts"])
def test_plan_launches_matches_jax(settings):
    assert _plan(tcap, DEMANDS, **settings) == _plan(jcap, DEMANDS, **settings)


@pytest.mark.parametrize("bundles,pools", [
    ([{"CPU": 1.0}] * 4, [{"CPU": 2.0}, {"CPU": 2.0}]),
    ([{"CPU": 1.0}] * 5, [{"CPU": 2.0}, {"CPU": 2.0}]),
    ([{"CPU": 3.0}, {"CPU": 1.0, "GPU": 1.0}], [{"CPU": 2.0, "GPU": 1.0}, {"CPU": 3.0}]),
    ([{"trainer": 1.0, "CPU": 1.0}], [{"CPU": 8.0}]),
    ([], [{"CPU": 1.0}]),
    ([{"CPU": 0.5}] * 3 + [{"CPU": 1.5}], [{"CPU": 1.0}, {"CPU": 2.0}]),
])
def test_fit_bundles_matches_jax(bundles, pools):
    tpools = [dict(p) for p in pools]
    jpools = [dict(p) for p in pools]
    assert tcap._fit_bundles(bundles, tpools) == jcap._fit_bundles(bundles, jpools)
    assert tpools == jpools  # the pools are consumed the same way


def test_by_origin_matches_jax():
    def demands(mod):
        return [mod.Demand(bundles=[{"CPU": 1.0}], origin=o)
                for o in ("task", "pg", "pg", "train", "serve", "replace", "custom")]

    assert tcap.DemandLedger.by_origin(demands(tcap)) == jcap.DemandLedger.by_origin(demands(jcap))
    assert tcap.DEMAND_ORIGINS == jcap.DEMAND_ORIGINS
    assert tcap.CAPACITY_CLASSES == jcap.CAPACITY_CLASSES


@pytest.mark.parametrize("schedule,mean,seed", [
    ([None, 5.0, (2.0, 0.5), [1.0, 0.25]], 0.0, 0),
    ([], 7.5, 3),
    ([(1.0, 1.0), None], 2.0, 11),
], ids=["explicit", "seeded", "mixed"])
def test_spot_plan_for_matches_jax(schedule, mean, seed):
    """A seeded schedule gives the same lifetimes and warnings in both
    packages (the explicit entries, then random.Random(seed)'s
    exponential draws)."""
    tp = tcap.SpotNodeProvider(tcap.FakeNodeProvider(None), schedule=schedule,
                               mean_lifetime_s=mean, seed=seed)
    jp = jcap.SpotNodeProvider(jcap.FakeNodeProvider(None), schedule=schedule,
                               mean_lifetime_s=mean, seed=seed)
    assert [tp._plan_for(i) for i in range(12)] == [jp._plan_for(i) for i in range(12)]


def test_ledger_collects_like_jax():
    """The same pending task, unplaceable gang and sources give the same
    demand list in both packages (a train source whose bundles equal a
    queued group's is dropped; a raising source is skipped)."""
    out = {}
    for name, pkg, cap in (("jax", ray_tpu, jcap), ("torch", ray_tpu_torch, tcap)):
        rt = pkg.init(num_cpus=1, detect_accelerators=False)
        try:
            rt.scheduler.fail_fast_infeasible = False
            ref = pkg.remote(num_cpus=3)(_never).remote()
            pg = pkg.api.placement_group([{"CPU": 2.0}, {"CPU": 2.0}], strategy="SPREAD",
                                         name="gang")
            cap.register_demand_source("train:x", lambda: [
                {"bundles": [{"CPU": 2.0}, {"CPU": 2.0}], "origin": "train", "gang": True}])
            cap.register_demand_source("serve:y", lambda: [
                {"bundles": [{"serve_slot": 1.0}], "origin": "serve", "detail": "1 replica"}])
            cap.register_demand_source("broken", _raise)
            deadline = time.monotonic() + 10
            while not rt.scheduler.pending_task_demand() and time.monotonic() < deadline:
                time.sleep(0.02)
            demands = cap.DemandLedger(rt.scheduler).collect()
            out[name] = (sorted((d.origin, str(d.bundles), d.gang, d.detail) for d in demands),
                         sorted(map(str, rt.scheduler.pending_demand())))
            pkg.api.remove_placement_group(pg)
            del ref
        finally:
            for src in ("train:x", "serve:y", "broken"):
                cap.unregister_demand_source(src)
            pkg.shutdown()
    assert out["jax"] == out["torch"]
    assert {o for o, *_ in out["torch"][0]} == {"task", "pg", "serve"}


def _never():
    return None


def _raise():
    raise RuntimeError("broken source")
