"""ray_tpu_torch's process actors and runtime envs against ray_tpu's on
the CPU.

Counterpart of `tests/test_worker_pool.py`'s actor and runtime-env cases
(its pool and task cases are in `tests/test_torch_worker_pool.py`):
process actors (state, pids, a crash and its restart, a final kill) and
runtime envs (env_vars, working_dir, py_modules, their validation). Each
test runs one program through both packages (`_both`) and compares
values, error types and counts exactly; the workers run the functions
and classes of the root module `torch_process_udfs.py`. No timing
assertions. The fixture shuts both runtimes down and asserts that no
worker process and no health, monitor or reaper thread is left.
"""

import os
import threading

import pytest

import ray_tpu
import ray_tpu_torch
import torch_process_udfs as U
from ray_tpu_torch.core import worker_pool as tpool
from ray_tpu_torch.core.config import cfg as tcfg

PKGS = {"jax": ray_tpu, "torch": ray_tpu_torch}
TIMEOUT = 60
_THREADS = ("health-check", "memory-monitor", "worker-reaper")


def _both(program, **init):
    """Run `program(name, pkg)` under each package's runtime; returns
    {name: outcome}."""
    out = {}
    for name, pkg in PKGS.items():
        pkg.init(**{"num_cpus": 4, "detect_accelerators": False, **init})
        try:
            out[name] = program(name, pkg)
        finally:
            pkg.shutdown()
    return out


def _same(program, **init):
    out = _both(program, **init)
    assert out["jax"] == out["torch"], out
    return out["torch"]


@pytest.fixture(autouse=True)
def _nothing_left():
    before = U.live_children()
    yield
    for pkg in PKGS.values():
        pkg.shutdown()
    tcfg.reset()
    assert U.wait_no_children(before) == []
    assert tpool.peek_worker_pool() is None
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("ray_tpu_torch") and t.name.endswith(_THREADS)]
    assert left == []


def _cause_types(exc):
    out = []
    while exc is not None and len(out) < 6:
        out.append(type(exc).__name__)
        exc = getattr(exc, "cause", None)
    return out


# ------------------------------------------------------------ process actors


def test_process_actor_state_and_pid():
    def program(name, pkg):
        a = pkg.remote(U.Counter).options(executor="process").remote(10)
        got = [pkg.get(a.incr.remote(), timeout=TIMEOUT), pkg.get(a.incr.remote(5), timeout=TIMEOUT)]
        child = pkg.get(a.pid.remote(), timeout=TIMEOUT)
        return got, child != os.getpid(), pkg.get(a.__ray_pid__.remote()) == child

    assert _same(program) == ([11, 16], True, True)


def test_thread_actor_pid_is_parent():
    def program(name, pkg):
        a = pkg.remote(U.Counter).remote()
        return pkg.get(a.__ray_pid__.remote(), timeout=TIMEOUT) == os.getpid()

    assert _same(program) is True


def test_process_actor_crash_restarts():
    def program(name, pkg):
        a = pkg.remote(U.Counter).options(executor="process", max_restarts=1).remote(0)
        first = pkg.get(a.incr.remote(), timeout=TIMEOUT)
        with pytest.raises(pkg.ActorDiedError):
            pkg.get(a.die.remote(), timeout=TIMEOUT)
        # the call after the crash waits for the restarted incarnation
        # (or fails with the death while the restart is under way)
        for _ in range(50):
            try:
                after = pkg.get(a.incr.remote(), timeout=TIMEOUT)
                break
            except pkg.ActorDiedError:
                continue
        restarts = [x["restarts"] for x in pkg.list_actors()]
        return first, after, restarts

    assert _same(program) == (1, 1, [1])


def test_process_actor_kill_is_final():
    def program(name, pkg):
        a = pkg.remote(U.Counter).options(executor="process", max_restarts=2).remote(0)
        pid = pkg.get(a.pid.remote(), timeout=TIMEOUT)
        pkg.kill(a)
        with pytest.raises(pkg.ActorDiedError):
            pkg.get(a.incr.remote(), timeout=TIMEOUT)
        others = set(U.live_children()) - {pid}
        return [x["state"] for x in pkg.list_actors()], pid in U.wait_no_children(others)

    assert _same(program) == (["DEAD"], False)


# -------------------------------------------------------------- runtime envs


def test_working_dir_runtime_env(tmp_path):
    (tmp_path / "localmod.py").write_text("MAGIC = 'from-working-dir'\n")
    other = tmp_path / "other"
    other.mkdir()

    def program(name, pkg):
        probe = pkg.remote(U.import_attr).options(
            executor="process", runtime_env={"working_dir": str(tmp_path)})
        first = pkg.get(probe.remote("localmod", "MAGIC"), timeout=TIMEOUT)
        # workers are keyed by working_dir: another dir gets a fresh worker
        where = pkg.get(pkg.remote(U.cwd).options(
            executor="process", runtime_env={"working_dir": str(other)}).remote(), timeout=TIMEOUT)
        # thread tasks refuse working_dir (the cwd is process-global)
        with pytest.raises(ValueError, match="process") as thread_err:
            pkg.remote(U.cwd).options(runtime_env={"working_dir": str(tmp_path)}).remote()
        with pytest.raises(ValueError, match="not a directory"):
            pkg.remote(U.cwd).options(
                executor="process", runtime_env={"working_dir": "/definitely/missing"}).remote()
        return first, where, str(thread_err.value)

    assert _same(program)[:2] == ((str(tmp_path), "from-working-dir"), str(other))


def test_working_dir_reasserted_on_reuse(tmp_path):
    wd = tmp_path / "wd"
    wd.mkdir()

    def program(name, pkg):
        opts = dict(executor="process", runtime_env={"working_dir": str(wd)})
        away = pkg.get(pkg.remote(U.chdir_away).options(**opts).remote(str(tmp_path)),
                       timeout=TIMEOUT)
        back = pkg.get(pkg.remote(U.cwd).options(**opts).remote(), timeout=TIMEOUT)
        return away, back

    assert _same(program) == (str(tmp_path), str(wd))


def test_thread_task_env_vars_are_scoped():
    def program(name, pkg):
        f = pkg.remote(U.read_env).options(runtime_env={"env_vars": {"RT_SCOPED": "on"}})
        return pkg.get(f.remote("RT_SCOPED"), timeout=TIMEOUT), os.environ.get("RT_SCOPED")

    assert _same(program) == ("on", None)


def test_process_actor_runtime_env(tmp_path):
    wd = tmp_path / "actor_wd"
    wd.mkdir()
    (wd / "cfgmod.py").write_text("NAME = 'actor-env'\n")

    def program(name, pkg):
        svc = pkg.remote(U.EnvProbe).options(
            executor="process",
            runtime_env={"env_vars": {"MY_TOKEN": "s3cr3t"}, "working_dir": str(wd)},
        ).remote()
        got = pkg.get(svc.probe.remote("cfgmod", "NAME", "MY_TOKEN"), timeout=TIMEOUT)
        with pytest.raises(ValueError, match="process"):  # thread actors refuse it
            pkg.remote(U.Counter).options(runtime_env={"env_vars": {"X": "1"}}).remote()
        return got, "MY_TOKEN" in os.environ

    assert _same(program) == ((str(wd), "s3cr3t", "actor-env"), False)


def test_process_actor_py_modules(tmp_path):
    lib = tmp_path / "lib"
    lib.mkdir()
    (lib / "shippedmod.py").write_text("VALUE = 123\n")

    def program(name, pkg):
        a = pkg.remote(U.EnvProbe).options(
            executor="process", runtime_env={"py_modules": [str(lib)]}).remote()
        task = pkg.remote(U.import_attr).options(
            executor="process", runtime_env={"py_modules": [str(lib)]})
        return (pkg.get(a.probe.remote("shippedmod", "VALUE", "NONE"), timeout=TIMEOUT)[1:],
                pkg.get(task.remote("shippedmod", "VALUE"), timeout=TIMEOUT)[1])

    assert _same(program) == ((None, 123), 123)


def test_runtime_env_validation_matches():
    from ray_tpu.core import runtime_env as jrenv
    from ray_tpu_torch.core import runtime_env as trenv

    for mod in (jrenv, trenv):
        assert mod.normalize(None) is None
        with pytest.raises(ValueError, match="unsupported runtime_env keys"):
            mod.normalize({"pip": ["x"]})
        with pytest.raises(TypeError, match="Dict"):
            mod.normalize({"env_vars": {"A": 1}})
    env = {"env_vars": {"A": "1"}, "py_modules": ["m"], "working_dir": "."}
    assert jrenv.normalize(env) == trenv.normalize(env)
