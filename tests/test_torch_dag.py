"""ray_tpu_torch's channels and compiled graphs against ray_tpu's on the CPU.

Counterpart of `tests/test_dag.py` and `tests/test_shm_channel.py`. The
in-process `Channel` and the shared-memory `ShmChannel` go through the
same write / read / close sequences in both packages (versions, back
pressure, several readers, closing, the capacity guard); compiled graphs
of thread actors, of process actors and of both (every edge then a
shared-memory channel) give the same outputs, errors and call counts. A
channel file written by JAX's `ShmChannel` is read by the port's, and the
other way round: the header, the acknowledgements and the payload are
laid out alike. Beyond JAX: a CUDA tensor is refused before anything is
written (a CPU build checks it with a tensor that reports `is_cuda`).
The actors run the classes of the root module `torch_process_udfs.py`.
"""

import os
import threading

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
import torch_process_udfs as U
from ray_tpu import experimental as jexp
from ray_tpu.experimental import shm_channel as jshm
from ray_tpu_torch import experimental as texp
from ray_tpu_torch.experimental import shm_channel as tshm

PKGS = {"jax": ray_tpu, "torch": ray_tpu_torch}
EXP = {"jax": jexp, "torch": texp}
SHM = {"jax": jshm, "torch": tshm}
TIMEOUT = 60


@pytest.fixture(autouse=True)
def _nothing_left():
    before = U.live_children()
    yield
    for pkg in PKGS.values():
        pkg.shutdown()
    assert U.wait_no_children(before) == []


def _both(program, **init):
    out = {}
    for name, pkg in PKGS.items():
        pkg.init(**{"num_cpus": 8, "detect_accelerators": False, **init})
        try:
            out[name] = program(name, pkg, EXP[name])
        finally:
            pkg.shutdown()
    return out


def _same(program, **init):
    out = _both(program, **init)
    assert out["jax"] == out["torch"], out
    return out["torch"]


def _outcome(fn):
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 - the type is the outcome
        return type(exc).__name__


# ------------------------------------------------------------------ channels


@pytest.mark.parametrize("name", ["jax", "torch"])
def test_channel_version_semantics_and_backpressure(name):
    exp = EXP[name]
    ch = exp.Channel(num_readers=1)
    r = exp.ChannelReader(ch)
    ch.write("a")
    seq = [_outcome(lambda: ch.write("b", timeout=0.05))]  # "a" unread: the writer waits
    seq.append(r.read())
    seq.append(_outcome(lambda: r.read(timeout=0.05)))  # nothing new
    ch.write("b")
    seq.append(r.read())
    assert seq == ["TimeoutError", "a", "TimeoutError", "b"]


@pytest.mark.parametrize("name", ["jax", "torch"])
def test_channel_multi_reader_each_sees_each_version(name):
    exp = EXP[name]
    ch = exp.Channel(num_readers=2)
    r1, r2 = exp.ChannelReader(ch), exp.ChannelReader(ch)
    ch.write("x")
    assert r1.read() == "x"
    assert _outcome(lambda: ch.write("y", timeout=0.05)) == "TimeoutError"  # r2 owes a read
    assert r2.read() == "x"
    ch.write("y")
    assert (r1.read(), r2.read()) == ("y", "y")


@pytest.mark.parametrize("name", ["jax", "torch"])
def test_channel_close_unblocks(name):
    exp = EXP[name]
    ch = exp.Channel(num_readers=1)
    r = exp.ChannelReader(ch)
    errs = []
    started = threading.Event()

    def blocked_read():
        started.set()
        try:
            r.read(timeout=30)
        except exp.ChannelClosedError as e:
            errs.append(e)

    t = threading.Thread(target=blocked_read)
    t.start()
    started.wait(10)
    ch.close()
    t.join(timeout=10)
    assert errs and not t.is_alive()
    with pytest.raises(exp.ChannelClosedError):
        ch.write(1)


def test_in_process_channel_passes_a_tensor_itself():
    ch = texp.Channel()
    r = texp.ChannelReader(ch)
    x = torch.arange(4)
    ch.write(x)
    assert r.read() is x


# ----------------------------------------------------------- shm channels


def _shm_program(mod):
    out = []
    ch = mod.ShmChannel(capacity=1 << 16, num_readers=2)
    try:
        ch.write({"a": 1})
        out.append(ch.read(0))
        out.append(_outcome(lambda: ch.write("v2", timeout=0.2)))  # reader 1 lagging
        out.append(ch.read(1))
        ch.write([1, 2, 3], timeout=5)
        out += [ch.read(0), ch.read(1)]
        out.append(_outcome(lambda: ch.read(0, timeout=0.1)))
        out.append(_outcome(lambda: ch.write(np.zeros(1 << 14), timeout=1)))  # > capacity
        ch.close()
        out.append(_outcome(lambda: ch.read(0, timeout=1)))
        out.append(_outcome(lambda: ch.write(2, timeout=1)))
    finally:
        ch.unlink()
    return out


def test_shm_channel_sequences_match_jax():
    assert _shm_program(jshm) == _shm_program(tshm) == [
        {"a": 1}, "TimeoutError", {"a": 1}, [1, 2, 3], [1, 2, 3], "TimeoutError",
        "ValueError", "ChannelClosedError", "ChannelClosedError"]


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_one_channel_file_across_packages(writer, reader, tmp_path):
    """The header, the acknowledgement slots and the payload are laid out
    alike: one package writes a channel file, the other reads it."""
    path = str(tmp_path / "chan")
    w = SHM[writer].ShmChannel(capacity=1 << 16, num_readers=2, path=path)
    r = SHM[reader].ShmChannel(capacity=1 << 16, num_readers=2, path=path, _create=False)
    try:
        payload = {"tokens": np.arange(1000, dtype=np.int32), "tag": "x"}
        w.write(payload)
        got = [r.read(0), r.read(1)]
        for g in got:
            np.testing.assert_array_equal(g["tokens"], payload["tokens"])
            assert g["tag"] == "x"
        w.write("second", timeout=5)  # both acks landed from the other package
        assert r.read(1) == "second" and r.read(0) == "second"
        w.close()
        with pytest.raises(SHM[reader].ChannelClosedError):
            r.read(0, timeout=1)
    finally:
        r.release()
        w.unlink()


def test_shm_channel_refuses_a_cuda_tensor_before_writing():
    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    ch = tshm.ShmChannel(capacity=1 << 16)
    try:
        with pytest.raises(TypeError, match=r"\.cpu\(\)"):
            ch.write({"x": torch.zeros(4).as_subclass(FakeCuda)})
        assert ch._version() == 0  # nothing was published
        ch.write(torch.zeros(4))  # a CPU tensor crosses
        assert ch.read(0).tolist() == [0.0] * 4
    finally:
        ch.close()
        ch.unlink()


def test_stale_channel_files_reaped(tmp_path, monkeypatch):
    monkeypatch.setattr(tshm, "_shm_dir", lambda: str(tmp_path))
    monkeypatch.setattr(tshm, "_reaped_once", False)
    abandoned = tmp_path / "ray_tpu_torch_chan_999999999_x"  # no lease holder
    abandoned.write_bytes(b"\x00" * 64)
    jax_named = tmp_path / "ray_tpu_chan_999999999_x"  # JAX's: not the port's to reap
    jax_named.write_bytes(b"\x00" * 64)
    live = tshm.ShmChannel(capacity=1024, num_readers=1)
    monkeypatch.setattr(tshm, "_reaped_once", False)
    chan = tshm.ShmChannel(capacity=1024, num_readers=1)
    try:
        assert not abandoned.exists() and jax_named.exists()
        assert os.path.exists(live.path)
        tshm._reap_stale_channels(str(tmp_path))
        assert os.path.exists(live.path) and os.path.exists(chan.path)
    finally:
        for ch in (chan, live):
            ch.close()
            ch.unlink()


def test_cross_process_actor_pipeline():
    """Channel endpoints ride into a process actor; values stream from this
    process to the actor and back through shared memory, in order."""

    def program(name, pkg, exp):
        shm = SHM[name]
        inbound = shm.ShmChannel(capacity=1 << 20, num_readers=1)
        outbound = shm.ShmChannel(capacity=1 << 20, num_readers=1)
        try:
            stage = pkg.remote(U.Stage).options(executor="process").remote(
                inbound.reader(0), outbound)
            result = stage.pump.remote(5)
            got = []
            for i in range(5):
                inbound.write(np.full(1000, i, dtype=np.int64))
                out = outbound.read(0, timeout=30)
                got.append((int(out[0]), out.shape))
            return got, pkg.get(result, timeout=TIMEOUT)
        finally:
            for ch in (inbound, outbound):
                ch.close()
                ch.unlink()

    assert _same(program) == ([(2 * i, (1000,)) for i in range(5)], "done")


# ---------------------------------------------------------------------- DAGs


def test_linear_dag_pipeline_and_actor_state():
    def program(name, pkg, exp):
        a, b = pkg.remote(U.Adder).remote(1), pkg.remote(U.Adder).remote(10)
        with exp.InputNode() as inp:
            y = b.add.bind(a.add.bind(inp))
        dag = y.experimental_compile()
        try:
            futs = [dag.execute(i) for i in range(5)]
            outs = [f.get(timeout=30) for f in futs]
        finally:
            dag.teardown()
        # the loop ran inside one __ray_apply__ call; the state persisted
        return outs, pkg.get(a.ncalls.remote(), timeout=TIMEOUT), \
            _outcome(lambda: dag.execute(2))

    assert _same(program) == ([11 + i for i in range(5)], 5, "RuntimeError")


def test_dag_fan_out_join_and_const_args():
    def program(name, pkg, exp):
        a, b, c, j = (pkg.remote(U.Adder).remote(k) for k in (1, 2, 3, 0))
        with exp.InputNode() as inp:
            x = a.add.bind(inp)
            y, z = b.add.bind(x), c.add.bind(x)
            out = j.add2.bind(y, 100)
        fan = exp.MultiOutputNode([y, z]).experimental_compile()
        try:
            fanned = [fan.execute(10).get(timeout=30), fan.execute(0).get(timeout=30)]
        finally:
            fan.teardown()
        d = pkg.remote(U.Adder).remote(0)
        with exp.InputNode() as inp2:
            joined = d.add2.bind(a.add.bind(inp2), 100)
        dag = joined.experimental_compile()
        try:
            return fanned, dag.execute(1).get(timeout=30), out.method_name
        finally:
            dag.teardown()

    assert _same(program) == ([[13, 14], [3, 4]], 102, "add2")


def test_dag_error_propagates_and_pipeline_survives():
    def program(name, pkg, exp):
        a, b = pkg.remote(U.Adder).remote(1), pkg.remote(U.Adder).remote(2)
        with exp.InputNode() as inp:
            y = b.add.bind(a.boom.bind(inp))
        dag = y.experimental_compile()
        try:
            return [_outcome(lambda i=i: dag.execute(i).get(timeout=30)) for i in (7, 8, 9)]
        finally:
            dag.teardown()

    assert _same(program) == [9, "ValueError", 11]


def test_dag_rejects_same_actor_twice_and_multiple_inputs():
    def program(name, pkg, exp):
        a = pkg.remote(U.Adder).remote(1)
        with exp.InputNode() as inp:
            y = a.add.bind(a.add.bind(inp))
        first = _outcome(y.experimental_compile)
        b, c = pkg.remote(U.Adder).remote(1), pkg.remote(U.Adder).remote(2)
        i1, i2 = exp.InputNode(), exp.InputNode()
        second = _outcome(exp.MultiOutputNode([b.add.bind(i1), c.add.bind(i2)]).experimental_compile)
        return first, second

    assert _same(program) == ("ValueError", "ValueError")


def test_compiled_dag_with_process_actors():
    def program(name, pkg, exp):
        a = pkg.remote(U.Adder).options(executor="process").remote(0)
        b = pkg.remote(U.Adder).options(executor="process").remote(10)
        with exp.InputNode() as inp:
            out = b.add.bind(a.add.bind(inp))
        dag = out.experimental_compile()
        try:
            futs = [dag.execute(i, timeout=30) for i in range(5)]
            return dag._use_shm, [f.get(timeout=TIMEOUT) for f in futs]
        finally:
            dag.teardown()

    assert _same(program) == (True, [10, 11, 12, 13, 14])


def test_compiled_dag_mixed_executors_and_errors():
    def program(name, pkg, exp):
        r = pkg.remote(U.Adder).options(executor="process").remote(1)
        l = pkg.remote(U.Adder).remote(0)
        with exp.InputNode() as inp:
            out = l.unwrap.bind(r.pid_and.bind(inp))
        dag = out.experimental_compile()
        try:
            pid, v = dag.execute(41, timeout=30).get(timeout=TIMEOUT)
        finally:
            dag.teardown()
        bad = pkg.remote(U.Adder).options(executor="process").remote(0)
        with exp.InputNode() as inp2:
            out2 = bad.boom.bind(inp2)
        dag2 = out2.experimental_compile()
        try:
            seq = [_outcome(lambda i=i: dag2.execute(i, timeout=30).get(timeout=TIMEOUT))
                   for i in (1, 2, 3)]
        finally:
            dag2.teardown()
        return dag._use_shm, v, pid != os.getpid(), seq

    assert _same(program) == (True, 42, True, [1, "ValueError", 3])


def test_experimental_exports_match_jax():
    names = {"Channel", "ChannelClosedError", "ChannelReader", "CompiledDAG", "DAGNode",
             "InputNode", "MultiOutputNode"}
    assert names <= set(dir(jexp)) and names <= set(dir(texp))
    assert texp.SHM_CHANNEL_CAPACITY == jexp.dag.SHM_CHANNEL_CAPACITY == 4 << 20
