"""ray_tpu_torch's actor/task runtime against ray_tpu's on the CPU.

Each test runs one program through both packages' runtimes
(`init(num_cpus=4, detect_accelerators=False)`, `num_nodes=4` for
placement) and compares what comes out: values, the types of errors and
of their causes, orders and placements. Outcomes are exact (no
tolerance: the programs compute on integers, and a spilled tensor must
restore bit for bit). Waits are bounded by timeouts and decided by
events and barriers, never by wall-clock thresholds; each test shuts both
runtimes down, and the port's shutdown joins its threads.
"""

import threading

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.core import runtime as jruntime
from ray_tpu_torch.core import runtime as truntime
from ray_tpu.util import tracing as jtracing
from ray_tpu_torch.core.resources import detect_gpu_resources
from ray_tpu_torch.util import tracing as ttracing

PKGS = {"jax": ray_tpu, "torch": ray_tpu_torch}
TIMEOUT = 30


def _cause_chain(exc):
    """Type names of an error and its TaskError causes, outermost first."""
    out = []
    while exc is not None and len(out) < 8:
        out.append(type(exc).__name__)
        exc = getattr(exc, "cause", None)
    return out


def _both(program, **init):
    """Run `program(pkg)` under each package's runtime; returns
    {name: outcome}."""
    out = {}
    for name, pkg in PKGS.items():
        pkg.init(**{"num_cpus": 4, "detect_accelerators": False, **init})
        try:
            out[name] = program(pkg)
        finally:
            pkg.shutdown()
    return out


def _same(program, **init):
    out = _both(program, **init)
    assert out["jax"] == out["torch"], out
    return out["torch"]


@pytest.fixture(autouse=True)
def _no_runtime_left():
    yield
    for pkg in PKGS.values():
        pkg.shutdown()
    assert not truntime.is_initialized() and not jruntime.is_initialized()


# ------------------------------------------------------------------ objects


def test_put_get_values():
    def program(rt):
        values = [1, "s", {"a": [1, 2]}, (3, 4), np.arange(5), torch.arange(6)]
        refs = [rt.put(v) for v in values]
        got = rt.get(refs, timeout=TIMEOUT)
        return [repr(g) for g in got], rt.get(refs[0]) == 1

    _same(program)


def test_tasks_with_ref_args_and_nested_tasks():
    def program(rt):
        @rt.remote
        def inc(x):
            return x + 1

        @rt.remote
        def outer(x):
            # a task that submits and waits on tasks of its own
            return rt.get([inc.remote(x), inc.remote(inc.remote(x))], timeout=TIMEOUT)

        a = inc.remote(rt.put(10))
        b = inc.remote(a)
        return rt.get([a, b], timeout=TIMEOUT), rt.get(outer.remote(b), timeout=TIMEOUT)

    assert _same(program) == ([11, 12], [13, 14])


def test_num_returns():
    def program(rt):
        @rt.remote(num_returns=3)
        def three(x):
            return x, x * 2, x * 3

        @rt.remote(num_returns=2)
        def wrong():
            return 1, 2, 3

        refs = three.remote(7)
        out = [rt.get(r, timeout=TIMEOUT) for r in refs]
        try:
            rt.get(wrong.remote(), timeout=TIMEOUT)
        except Exception as exc:  # noqa: BLE001 - compared by type
            return out, _cause_chain(exc)

    assert _same(program) == ([7, 14, 21], ["TaskError", "ValueError"])


def test_error_types_propagate_through_dependencies():
    def program(rt):
        @rt.remote
        def boom():
            raise KeyError("k")

        @rt.remote
        def use(x):
            return x

        bad = boom.remote()
        errs = []
        for ref in (bad, use.remote(bad), use.remote(use.remote(bad))):
            try:
                rt.get(ref, timeout=TIMEOUT)
            except Exception as exc:  # noqa: BLE001 - compared by type
                errs.append(_cause_chain(exc))
        return errs

    errs = _same(program)
    assert errs[0] == ["TaskError", "KeyError"]
    assert errs[1][-1] == errs[2][-1] == "KeyError"


@pytest.mark.parametrize("max_retries,failures", [(2, 2), (1, 2)])
def test_retries(max_retries, failures):
    def program(rt):
        calls = []

        @rt.remote(max_retries=max_retries, retry_exceptions=True)
        def flaky():
            calls.append(1)
            if len(calls) <= failures:
                raise RuntimeError("transient")
            return len(calls)

        try:
            return rt.get(flaky.remote(), timeout=TIMEOUT), len(calls)
        except Exception as exc:  # noqa: BLE001 - compared by type
            return _cause_chain(exc), len(calls)

    out = _same(program)
    assert out == ((3, 3) if max_retries >= failures else (["TaskError", "RuntimeError"], 2))


def test_wait_split_and_get_timeout():
    def program(rt):
        release = threading.Event()

        @rt.remote
        def blocked():
            release.wait(TIMEOUT)
            return "late"

        slow = blocked.remote()
        a, b = rt.put("a"), rt.put("b")
        ready, rest = rt.wait([slow, a, b], num_returns=2, timeout=TIMEOUT)
        split = ([r == a or r == b for r in ready], [r == slow for r in rest])
        try:
            rt.get(slow, timeout=0.05)
            timed_out = None
        except Exception as exc:  # noqa: BLE001 - compared by type
            timed_out = type(exc).__name__
        none_ready = rt.wait([slow], num_returns=1, timeout=0.05)
        release.set()
        return split, timed_out, (len(none_ready[0]), len(none_ready[1])), rt.get(slow, timeout=TIMEOUT)

    assert _same(program) == (([True, True], [True]), "GetTimeoutError", (0, 1), "late")


def test_resource_limited_concurrency():
    """4 CPUs, tasks of 2: pairs meet at a barrier of 2 (they must run
    together), and no more than 2 ever run at once."""
    def program(rt):
        barrier = threading.Barrier(2, timeout=TIMEOUT)
        lock = threading.Lock()
        state = {"now": 0, "max": 0}

        @rt.remote(num_cpus=2)
        def pair():
            with lock:
                state["now"] += 1
                state["max"] = max(state["max"], state["now"])
            barrier.wait()
            with lock:
                state["now"] -= 1
            return True

        out = rt.get([pair.remote() for _ in range(4)], timeout=TIMEOUT)
        return out, state["max"], rt.available_resources()["CPU"]

    assert _same(program) == ([True] * 4, 2, 4.0)


# ------------------------------------------------------------------ actors


class _Log:
    def __init__(self, start=0):
        self.items = [start]

    def add(self, x):
        self.items.append(x)
        return len(self.items)

    def all(self):
        return list(self.items)

    def meet(self, barrier):
        barrier.wait()
        return True


def test_actor_ordering():
    def program(rt):
        log = rt.remote(_Log).remote()
        refs = [log.add.remote(i) for i in range(20)]
        return rt.get(refs, timeout=TIMEOUT), rt.get(log.all.remote(), timeout=TIMEOUT)

    assert _same(program) == (list(range(2, 22)), [0] + list(range(20)))


def test_actor_max_concurrency():
    """Two calls that must meet at a barrier complete only if the actor
    runs them at once."""
    def program(rt):
        barrier = threading.Barrier(2, timeout=TIMEOUT)
        log = rt.remote(_Log).options(max_concurrency=2).remote()
        return rt.get([log.meet.remote(barrier), log.meet.remote(barrier)], timeout=TIMEOUT)

    assert _same(program) == [True, True]


def test_named_actor_and_kill():
    def program(rt):
        log = rt.remote(_Log).options(name="logger").remote(5)
        same = rt.get_actor("logger")
        rt.get(same.add.remote(1), timeout=TIMEOUT)
        try:
            rt.remote(_Log).options(name="logger").remote()
            dup = None
        except Exception as exc:  # noqa: BLE001 - compared by type
            dup = type(exc).__name__
        items = rt.get(log.all.remote(), timeout=TIMEOUT)
        rt.kill(log)
        try:
            rt.get(log.add.remote(2), timeout=TIMEOUT)
            after = None
        except Exception as exc:  # noqa: BLE001 - compared by type
            after = type(exc).__name__
        try:
            rt.get_actor("logger")
            lookup = None
        except ValueError as exc:
            lookup = type(exc).__name__
        return items, dup, after, lookup

    assert _same(program) == ([5, 1], "ValueError", "ActorDiedError", "ValueError")


def test_actor_restart():
    def program(rt):
        log = rt.remote(_Log).options(max_restarts=1).remote(9)
        rt.get(log.add.remote(1), timeout=TIMEOUT)
        rt.kill(log, no_restart=False)
        # calls queued before the restart fail with the death; once the
        # restarted instance runs, it has run the constructor again
        for _ in range(1000):
            try:
                first = rt.get(log.all.remote(), timeout=TIMEOUT)
                break
            except Exception as exc:  # noqa: BLE001 - compared by type
                assert type(exc).__name__ == "ActorDiedError"
        rt.kill(log, no_restart=False)  # restarts exhausted: dies
        try:
            rt.get(log.all.remote(), timeout=TIMEOUT)
            second = None
        except Exception as exc:  # noqa: BLE001 - compared by type
            second = type(exc).__name__
        return first, second

    assert _same(program) == ([9], "ActorDiedError")


def test_actor_init_failure():
    class Broken:
        def __init__(self):
            raise RuntimeError("no card")

        def ping(self):
            return 1

    def program(rt):
        a = rt.remote(Broken).options(name="broken").remote()
        try:
            rt.get(a.ping.remote(), timeout=TIMEOUT)
        except Exception as exc:  # noqa: BLE001 - compared by type
            err = (type(exc).__name__, "__init__ raised: no card" in str(exc))
        names = [x["name"] for x in rt.list_actors()]
        try:
            rt.get_actor("broken")
            released = False
        except ValueError:
            released = True
        return err, names, released

    assert _same(program) == (("ActorDiedError", True), ["broken"], True)


# ---------------------------------------------------------------- streaming


def test_streaming_task_order_and_mid_stream_error():
    def program(rt):
        @rt.remote(num_returns="streaming")
        def gen(n, fail_at):
            for i in range(n):
                if i == fail_at:
                    raise ValueError("mid-stream")
                yield i * i

        ok = [rt.get(r, timeout=TIMEOUT) for r in gen.remote(5, -1)]
        got, err = [], None
        stream = gen.remote(5, 3)
        try:
            for ref in stream:
                got.append(rt.get(ref, timeout=TIMEOUT))
        except Exception as exc:  # noqa: BLE001 - compared by type
            err = _cause_chain(exc)
        return ok, got, err, stream.completed()

    assert _same(program) == ([0, 1, 4, 9, 16], [0, 1, 4], ["TaskError", "ValueError"], True)


class _Streamer:
    def count(self, n, gate=None):
        for i in range(n):
            if gate is not None and i == 2:
                gate.wait(TIMEOUT)
            yield i


def test_actor_method_streams_and_actor_death():
    def program(rt):
        s = rt.remote(_Streamer).options(max_concurrency=2).remote()
        whole = [rt.get(r, timeout=TIMEOUT)
                 for r in s.count.options(num_returns="streaming").remote(4)]
        gate = threading.Event()
        stream = s.count.options(num_returns="streaming").remote(6, gate)
        got = [rt.get(stream.next_ready(timeout=TIMEOUT), timeout=TIMEOUT) for _ in range(2)]
        rt.kill(s)
        err = None
        try:
            for ref in stream:
                got.append(rt.get(ref, timeout=TIMEOUT))
        except Exception as exc:  # noqa: BLE001 - compared by type
            err = type(exc).__name__
        gate.set()  # lets the killed actor's thread finish
        return whole, got, err

    assert _same(program) == ([0, 1, 2, 3], [0, 1], "ActorDiedError")


# ---------------------------------------------------------------- placement


def _node_index(rt, ref):
    """Index of the node that ran a task, in `nodes()` order."""
    run = {"jax": jruntime, "torch": truntime}["jax" if rt is ray_tpu else "torch"]
    hexes = [n["node_id"] for n in rt.nodes()]
    rt.get(ref, timeout=TIMEOUT)
    return hexes.index(run.get_runtime().node_of_task(ref.task_id().hex()))


def test_placement_groups_pack_strict_spread_and_infeasible():
    def program(rt):
        from_pkg = ray_tpu.core.scheduler if rt is ray_tpu else ray_tpu_torch.core.scheduler
        hexes = [n["node_id"] for n in rt.nodes()]
        pack = rt.placement_group([{"CPU": 1}] * 3, strategy="PACK")
        spread = rt.placement_group([{"CPU": 1}] * 4, strategy="STRICT_SPREAD")
        pack_nodes = {b.node.node_id.hex() for b in pack.bundles}
        spread_nodes = {b.node.node_id.hex() for b in spread.bundles}
        try:
            rt.placement_group([{"CPU": 1}] * 5, strategy="STRICT_SPREAD")
            infeasible = None
        except Exception as exc:  # noqa: BLE001 - compared by type
            infeasible = type(exc).__name__

        @rt.remote
        def where():
            return "ran"

        strategy = from_pkg.PlacementGroupSchedulingStrategy(spread, 2)
        ref = where.options(scheduling_strategy=strategy).remote()
        placed = hexes[_node_index(rt, ref)] == spread.bundles[2].node.node_id.hex()
        rt.remove_placement_group(pack)
        rt.remove_placement_group(spread)
        return (len(pack_nodes), len(spread_nodes), infeasible, placed,
                rt.available_resources()["CPU"])

    assert _same(program, num_nodes=4) == (1, 4, "PlacementGroupUnschedulableError", True, 16.0)


def test_node_affinity_and_labels():
    def program(rt):
        sched = ray_tpu.core.scheduler if rt is ray_tpu else ray_tpu_torch.core.scheduler
        run = jruntime if rt is ray_tpu else truntime
        nodes = run.get_runtime().scheduler.nodes()

        @rt.remote
        def where():
            return "ran"

        pinned = [
            _node_index(rt, where.options(
                scheduling_strategy=sched.NodeAffinitySchedulingStrategy(nodes[i].node_id)
            ).remote())
            for i in (3, 1)
        ]
        hexes = [n["node_id"] for n in rt.nodes()]
        want = [hexes.index(nodes[i].node_id.hex()) for i in (3, 1)]
        ok = rt.get(where.options(scheduling_strategy=sched.NodeLabelSchedulingStrategy(
            hard={"zone": ["a"]})).remote(), timeout=TIMEOUT)
        try:
            rt.get(where.options(scheduling_strategy=sched.NodeLabelSchedulingStrategy(
                hard={"zone": ["b"]})).remote(), timeout=TIMEOUT)
            bad = None
        except Exception as exc:  # noqa: BLE001 - compared by type
            bad = type(exc).__name__
        return pinned == want, ok, bad

    assert _same(program, num_nodes=4, labels={"zone": "a"}) == (True, "ran", "OutOfResourcesError")


# -------------------------------------------------------------------- store


def test_store_tiers_and_cpu_tensor_spill_restores_bitwise(tmp_path):
    """Small values stay INLINE, a large CPU tensor is HOST; past the
    capacity the least recently used HOST object spills to disk and
    restores bit for bit."""
    def program(rt):
        run = jruntime if rt is ray_tpu else truntime
        store = run.get_runtime().object_store
        gen = torch.Generator().manual_seed(0)
        big = [torch.randn(64, 1024, generator=gen) for _ in range(3)]  # 256 KiB each
        small = rt.put(3)
        refs = [rt.put(t) for t in big]
        tiers = [store.entry(r.object_id).tier.value for r in [small] + refs]
        back = [rt.get(r, timeout=TIMEOUT) for r in refs]
        same = [torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(big, back)]
        return tiers, same, store.stats["spills"] >= 1, store.stats["restores"] >= 1

    spill = str(tmp_path / "spill")
    out = _same(program, object_store_capacity=600 * 1024, spill_dir=spill)
    assert out[0][0] == "inline" and "spilled" in out[0] and out[1] == [True] * 3 and out[2] and out[3]


def test_object_gc_and_lineage_reconstruction():
    """A task result whose last ref died is released; a ref rebuilt from
    its id re-executes the task (lineage)."""
    def program(rt):
        run = jruntime if rt is ray_tpu else truntime
        store = run.get_runtime().object_store
        calls = []

        @rt.remote
        def make():
            calls.append(1)
            return np.arange(4)

        ref = make.remote()
        first = rt.get(ref, timeout=TIMEOUT).tolist()
        oid = ref.object_id
        del ref
        lost = store.entry(oid).state.value
        again = run.ObjectRef(oid, run.get_runtime())
        return first, lost, rt.get(again, timeout=TIMEOUT).tolist(), len(calls)

    assert _same(program) == ([0, 1, 2, 3], "lost", [0, 1, 2, 3], 2)


# ------------------------------------------------------------ GPU resources


def test_num_gpus_maps_to_num_tpus():
    """`GPU` in the port where JAX has `TPU`: the same counts, the same
    accounting while a task holds one, the same infeasible error."""
    def program(rt, key, kw):
        @rt.remote(**{kw: 1})
        def hold():
            return rt.available_resources()[key]

        total = rt.cluster_resources()[key]
        return total, rt.get(hold.remote(), timeout=TIMEOUT)

    jax_side, torch_side = {}, {}
    for pkg, out, key, kw in ((ray_tpu, jax_side, "TPU", "num_tpus"),
                              (ray_tpu_torch, torch_side, "GPU", "num_gpus")):
        pkg.init(num_cpus=4, detect_accelerators=False, **{kw: 2})
        try:
            out["run"] = program(pkg, key, kw)
        finally:
            pkg.shutdown()
    assert jax_side == torch_side == {"run": (2.0, 1.0)}


def test_num_gpus_task_without_a_card_is_infeasible():
    def program(rt, kw):
        @rt.remote(**{kw: 1})
        def needs_card():
            return "ran"

        try:
            rt.get(needs_card.remote(), timeout=TIMEOUT)
        except Exception as exc:  # noqa: BLE001 - compared by type
            return type(exc).__name__
        return "ran"

    outs = []
    for pkg, kw in ((ray_tpu, "num_tpus"), (ray_tpu_torch, "num_gpus")):
        pkg.init(num_cpus=4, detect_accelerators=False)
        try:
            outs.append(program(pkg, kw))
        finally:
            pkg.shutdown()
    assert outs == ["OutOfResourcesError", "OutOfResourcesError"]


def test_default_init_detects_no_gpu_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert detect_gpu_resources() == {}
    ray_tpu_torch.init(num_cpus=2)
    try:
        assert "GPU" not in ray_tpu_torch.cluster_resources()
    finally:
        ray_tpu_torch.shutdown()


def test_cluster_and_process_modes_raise_not_implemented():
    # cluster mode is ported (ROADMAP A6a, tests/test_torch_cluster*.py):
    # both modes at once are refused, and joining a head that does not
    # answer raises HeadUnavailableError once the client's retry window
    # closes, leaving no runtime behind
    from ray_tpu_torch.core.exceptions import HeadUnavailableError

    with pytest.raises(ValueError, match="not both"):
        ray_tpu_torch.init(num_cpus=2, head=True, address="127.0.0.1:1")
    with pytest.raises(HeadUnavailableError):
        ray_tpu_torch.init(num_cpus=2, detect_accelerators=False, address="127.0.0.1:1",
                           _system_config={"gcs_client_retry_s": 0.3})
    assert not ray_tpu_torch.is_initialized()
    from ray_tpu_torch.core.config import cfg

    cfg.reset("gcs_client_retry_s")
    ray_tpu_torch.init(num_cpus=2, detect_accelerators=False)
    try:
        # process executors are ported (ROADMAP A5): a lambda is refused at
        # submission (the standard pickle sends a function by reference),
        # and a thread actor refuses a runtime_env, as JAX's does
        f = ray_tpu_torch.remote(lambda: 1)
        with pytest.raises(TypeError, match="module level"):
            f.options(executor="process").remote()
        with pytest.raises(ValueError, match="executor='process'"):
            ray_tpu_torch.remote(_Log).options(runtime_env={"env_vars": {"A": "1"}}).remote()
        # placement-group rescheduling is ported (ROADMAP A6b, part 2):
        # max_reschedules builds a group that carries its budget
        pg = ray_tpu_torch.placement_group([{"CPU": 1}], max_reschedules=2)
        assert pg.ready(timeout=TIMEOUT)
        assert (pg.state, pg.max_reschedules, pg.reschedules_used) == ("RESERVED", 2, 0)
        ray_tpu_torch.remove_placement_group(pg)
        assert pg.state == "REMOVED"
    finally:
        ray_tpu_torch.shutdown()


def test_shutdown_joins_runtime_threads():
    before = {t.ident for t in threading.enumerate()}

    def program(rt):
        log = rt.remote(_Log).options(max_concurrency=2).remote()

        @rt.remote
        def f(x):
            return x

        return rt.get([f.remote(1), log.add.remote(1)], timeout=TIMEOUT)

    ray_tpu_torch.init(num_cpus=4, detect_accelerators=False)
    try:
        program(ray_tpu_torch)
    finally:
        ray_tpu_torch.shutdown()
    left = [t.name for t in threading.enumerate()
            if t.ident not in before and t.name.startswith(("ray_tpu_torch", "actor-"))]
    assert left == []


# ------------------------------------------------------------------ tracing


def test_tracing_spans_of_a_task_and_an_actor_call_match_jax():
    """A traced region around a task and an actor call records the same
    spans in both packages, parented the same way across the thread hops;
    the chrome-trace export of one span set is the same JSON."""
    def program(rt):
        tracing = jtracing if rt is ray_tpu else ttracing
        tracer = tracing.tracer()
        tracer.clear()

        @rt.remote
        def f(x):
            return x

        with tracing.span("root", lane="driver") as root:
            rt.get(f.remote(1), timeout=TIMEOUT)
            log = rt.remote(_Log).remote()
            rt.get(log.add.remote(1), timeout=TIMEOUT)
        want = {"root", "task.submit", "task.queue", "task.execute", "task.result",
                "actor.call", "actor.execute"}
        for _ in range(1000):  # execute spans end just after their result is sealed
            spans = tracer.spans(trace_id=root.trace_id)
            if want <= {s["name"] for s in spans}:
                break
            threading.Event().wait(0.01)
        by_id = {s["span_id"]: s for s in spans}
        return sorted((s["name"], by_id[s["parent_id"]]["name"] if s["parent_id"] in by_id else None)
                      for s in spans)

    assert _same(program) == [
        ("actor.call", "root"), ("actor.execute", "actor.call"), ("root", None),
        ("task.execute", "task.submit"), ("task.queue", "task.submit"),
        ("task.result", "task.execute"), ("task.submit", "root"),
    ]
    spans = [
        {"trace_id": "t" * 16, "span_id": "a" * 16, "parent_id": None, "name": "serve.route",
         "start_ts": 10.0, "end_ts": 10.5, "status": "OK", "lane": "driver",
         "attrs": {"deployment": "llm", "replica": "r1", "n": 3}},
        {"trace_id": "t" * 16, "span_id": "b" * 16, "parent_id": "a" * 16,
         "name": "actor.execute", "start_ts": 10.1, "end_ts": 10.4, "status": "ERROR",
         "lane": "actor:llm", "attrs": {"error": "x", "obj": object()}},
    ]
    assert ttracing.export_chrome_trace(spans) == jtracing.export_chrome_trace(spans)


def test_port_actor_shutdown_hook_runs_when_an_incarnation_stops():
    """The port calls an instance's `__ray_shutdown__` when its actor stops
    (a restart, a kill, the runtime's shutdown), so a replica frees its
    card memory whoever still references it; JAX's actors have no hook."""
    stopped = []

    class Holder:
        def __init__(self, tag):
            self.tag = tag

        def ping(self):
            return self.tag

        def __ray_shutdown__(self):
            stopped.append(self.tag)

    ray_tpu_torch.init(num_cpus=2, detect_accelerators=False)
    try:
        a = ray_tpu_torch.remote(Holder).options(max_restarts=1).remote("a")
        b = ray_tpu_torch.remote(Holder).remote("b")
        assert ray_tpu_torch.get([a.ping.remote(), b.ping.remote()], timeout=TIMEOUT) == ["a", "b"]
        ray_tpu_torch.kill(a, no_restart=False)  # restart: the first incarnation stops
        for _ in range(1000):
            try:
                ray_tpu_torch.get(a.ping.remote(), timeout=TIMEOUT)
                break
            except ray_tpu_torch.ActorDiedError:
                pass
        ray_tpu_torch.kill(b)
        ray_tpu_torch.get(a.ping.remote(), timeout=TIMEOUT)
    finally:
        ray_tpu_torch.shutdown()  # stops the second incarnation of a and joins b
    assert sorted(stopped) == ["a", "a", "b"]
