"""ray_tpu_torch's gang trainer against ray_tpu's on the CPU.

Each test runs one program through both packages' runtimes
(`init(num_cpus=8, detect_accelerators=False)`): `Trainer.fit` on
thread-actor ranks, its `Result` (status, reports, checkpoint step, error,
restarts, profiling; goodput's buckets by name), fail-fast, a restart
from a session checkpoint, elastic sizing, each rank's
`get_dataset_shard` block sequence (afresh on a restart, with the failed
attempt's split closed), and `LMTrainer` on gpt2-tiny in a one-rank gang
fed by `get_dataset_shard`, the port's from JAX's initial state carried
with `train_state_from_numpy`: losses and grad norms at atol = rtol =
1e-4, as tests/test_torch_trainer.py holds the trainer. Waits are events,
joins and conditions with timeouts, never sleeps compared to a threshold.
"""

import builtins
import pickle
import threading
import time

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import data as jdata
from ray_tpu import train as jtrain
from ray_tpu.core import runtime as jruntime
from ray_tpu.data import lm as jlm
from ray_tpu.models import get_config as jget_config
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.train import steplog as jsteplog
from ray_tpu_torch import data as tdata
from ray_tpu_torch import train as ttrain
from ray_tpu_torch.core import runtime as truntime
from ray_tpu_torch.data import lm as tlm
from ray_tpu_torch.models import get_config
from ray_tpu_torch.train import steplog as tsteplog

STEP_TOL = dict(atol=1e-4, rtol=1e-4)
TIMEOUT = 30
PKGS = {"jax": (ray_tpu, jtrain, jdata), "torch": (ray_tpu_torch, ttrain, tdata)}


def _both(program, **init):
    """Run `program(rt, train, data)` under each package's runtime;
    returns {name: outcome}."""
    out = {}
    for name, (rt, train, data) in PKGS.items():
        rt.init(**{"num_cpus": 8, "detect_accelerators": False, **init})
        try:
            out[name] = program(rt, train, data)
        finally:
            rt.shutdown()
    return out


def _same(program, **init):
    out = _both(program, **init)
    assert out["jax"] == out["torch"], out
    return out["torch"]


@pytest.fixture(autouse=True)
def _no_runtime_left():
    yield
    for rt, _, _ in PKGS.values():
        rt.shutdown()
    assert not truntime.is_initialized() and not jruntime.is_initialized()


def _fields(result):
    """A Result's fields, the time-valued goodput reduced to its bucket
    names."""
    return dict(status=result.status.value, metrics=result.metrics,
                history=result.metrics_history, checkpoint_step=result.checkpoint_step,
                error=result.error, restarts=result.num_restarts,
                preempt_restarts=result.num_preempt_restarts, profiling=result.profiling,
                goodput=sorted(result.goodput["buckets"]) if result.goodput else None)


def _pumps_alive():
    """Split pumps still running once every pump thread had 10 s to end."""
    pumps = [t for t in threading.enumerate() if t.name == "data-split-pump"]
    for t in pumps:
        t.join(timeout=10)
    return [t for t in pumps if t.is_alive()]


# ------------------------------------------------------------------ Trainer


def test_trainer_reports_and_result_fields_match_jax():
    def program(rt, train, data):
        def loop(config):
            ctx = train.get_context()
            for i in range(3):
                train.report({"step": i, "rank": ctx.world_rank, "world": ctx.world_size,
                              "lr": config["lr"]})
            train.report({"mfu": 0.25, "step_flops": 1e9, "step_time_s": 0.5, "step": 3})
            return "done"

        result = train.Trainer(loop, scaling_config=train.ScalingConfig(num_workers=2),
                               run_config=train.RunConfig(name="t1"),
                               train_loop_config={"lr": 0.1}).fit()
        return _fields(result)

    out = _same(program)
    assert out["status"] == "FINISHED" and len(out["history"]) == 4  # rank-0 reports only
    assert out["profiling"] == {"mfu": 0.25, "step_flops": 1e9, "step_time_s": 0.5}


def test_trainer_fails_fast_like_jax():
    """Rank 0 reports and raises; rank 1 reports and returns. Only rank 0
    fails, after its report, so the Result holds that report whatever the
    order in which the controller polls the ranks."""

    def program(rt, train, data):
        def loop(config):
            train.report({"step": 0})
            if train.get_context().world_rank == 0:
                raise RuntimeError("worker exploded")

        result = train.Trainer(
            loop, scaling_config=train.ScalingConfig(num_workers=2),
            run_config=train.RunConfig(name="t2", failure=train.FailureConfig(max_failures=0)),
            train_loop_config={}).fit()
        return _fields(result)

    out = _same(program)
    assert out["status"] == "ERRORED" and "worker exploded" in out["error"]


def test_trainer_restarts_from_a_session_checkpoint_like_jax(tmp_path):
    """Attempt 0 reports a checkpoint and raises; attempt 1 restores it
    through get_checkpoint() and finishes. The controller hands the resume
    step to the next attempt in train_loop_config."""

    def program(rt, train, data):
        attempts = []

        def loop(config):
            attempts.append(config.get("resume_from_step"))
            if len(attempts) == 1:
                train.report({"loss": 1.0}, checkpoint={"w": np.arange(4), "step": 10})
                raise RuntimeError("first attempt dies")
            ck = train.get_checkpoint()
            train.report({"resumed": ck["step"], "w_sum": int(ck["w"].sum())})
            return "ok"

        name = "t3-" + ("jax" if rt is ray_tpu else "torch")
        result = train.Trainer(
            loop, scaling_config=train.ScalingConfig(num_workers=1),
            run_config=train.RunConfig(name=name, storage_path=str(tmp_path / name),
                                       failure=train.FailureConfig(max_failures=2)),
            train_loop_config={}).fit()
        return _fields(result), attempts, train.list_checkpoints(str(tmp_path / name))

    fields, attempts, ckpts = _same(program)
    assert fields["restarts"] == 1 and fields["checkpoint_step"] == 0
    assert fields["metrics"] == {"resumed": 10, "w_sum": 6}
    assert attempts == [None, 0] and ckpts == ["ckpt_00000000.pkl"]


def test_session_checkpoints_use_pickle_not_cloudpickle(tmp_path):
    """The known difference by design (ROADMAP §C): a lambda in a session
    checkpoint pickles in JAX's session (cloudpickle) and not in the
    port's (the standard pickle)."""

    def program(rt, train, data):
        def loop(config):
            try:
                train.report({"step": 1}, checkpoint={"fn": lambda x: x})
                return "pickled"
            except (pickle.PicklingError, AttributeError):  # by Python version
                return "unpicklable"

        gang = train.WorkerGroup(1, {"CPU": 1.0}, run_name="pk", trial_dir=str(tmp_path))
        gang.start()
        try:
            return gang.finish(gang.run_async(loop, {}), timeout=TIMEOUT)
        finally:
            gang.shutdown()

    out = _both(program)
    assert out == {"jax": ["pickled"], "torch": ["unpicklable"]}


def test_elastic_gang_sizes_to_free_capacity_like_jax():
    """With 5 of 8 CPUs held, a gang of up to 4 (at least 1) starts with 3
    ranks; its rank 0 frees the CPUs, waits until the runtime shows them
    free, checkpoints and fails (its other ranks return, so no other
    rank's failure can end the attempt before rank 0's report); the
    restart grows the gang to 4."""

    def program(rt, train, data):
        @rt.remote
        class Blocker:
            def ping(self):
                return "ok"

        blockers = [Blocker.options(num_cpus=1).remote() for _ in range(5)]
        rt.get([b.ping.remote() for b in blockers], timeout=TIMEOUT)

        def train_fn(config=None):
            ctx = train.get_context()
            if ctx.world_size < 4:
                if ctx.world_rank != 0:
                    return
                for b in blockers:
                    rt.kill(b)
                deadline = time.monotonic() + TIMEOUT
                while rt.available_resources().get("CPU", 0) < 5:  # 8 - this gang's 3
                    assert time.monotonic() < deadline, "killed actors kept their CPUs"
                    time.sleep(0.01)
                train.report({"loss": 1.0}, checkpoint_step=5)
                raise RuntimeError("partial-capacity attempt dies")
            train.report({"loss": 0.5}, checkpoint_step=10)

        controller = train.TrainController(
            train_fn, train.ScalingConfig(num_workers=4, min_workers=1),
            train.RunConfig(name="elastic", failure=train.FailureConfig(max_failures=2)))
        result = controller.run()
        return controller.world_sizes, _fields(result)

    sizes, fields = _same(program)
    assert sizes == [3, 4] and fields["checkpoint_step"] == 10 and fields["restarts"] == 1


# ------------------------------------------------------------ dataset shards


def test_get_dataset_shard_sequences_match_jax():
    """Two ranks, equal=True: each rank's block sequence; an unknown name
    raises KeyError naming the available shards."""

    def program(rt, train, data):
        seen = {}

        def loop(config=None):
            ctx = train.get_context()
            seen[ctx.world_rank] = [b["item"].tolist()
                                    for b in train.get_dataset_shard("train").iter_blocks()]
            try:
                train.get_dataset_shard("eval")
            except KeyError as e:
                seen["missing"] = str(e)

        result = train.Trainer(loop, scaling_config=train.ScalingConfig(num_workers=2),
                               datasets={"train": data.range(130, num_blocks=13)}).fit()
        return result.status.value, seen, len(_pumps_alive())

    status, seen, alive = _same(program)
    assert status == "FINISHED" and alive == 0
    assert len(seen[0]) == len(seen[1]) == 6  # 6 full rounds; block 13 dropped
    assert "available: ['train']" in seen["missing"]


def test_restarted_gang_reads_its_split_afresh_like_jax():
    """Attempt 0 reads one block and fails; the restart's split starts
    again at the first block, and the failed attempt's pump has ended."""

    def program(rt, train, data):
        firsts, pumps = [], []

        def loop(config=None):
            blocks = train.get_dataset_shard("train").iter_blocks()
            firsts.append(next(blocks)["item"].tolist())
            if len(firsts) == 1:
                pumps.extend(t for t in threading.enumerate() if t.name == "data-split-pump")
                raise RuntimeError("attempt 0 dies")
            rest = [b["item"].tolist() for b in blocks]
            train.report({"blocks": 1 + len(rest)})

        result = train.Trainer(
            loop, scaling_config=train.ScalingConfig(num_workers=1),
            run_config=train.RunConfig(name="refeed", failure=train.FailureConfig(max_failures=1)),
            datasets={"train": data.range(200, num_blocks=20)}).fit()
        for t in pumps:
            t.join(timeout=10)
        return (_fields(result)["metrics"], result.num_restarts, firsts,
                [t.is_alive() for t in pumps], len(_pumps_alive()))

    metrics, restarts, firsts, first_pump_alive, alive = _same(program)
    assert restarts == 1 and metrics == {"blocks": 20}
    assert firsts == [list(range(10))] * 2 and first_pump_alive == [False] and alive == 0


def test_gpu_gang_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    ray_tpu_torch.init(num_cpus=2, detect_accelerators=False)
    trainer = ttrain.Trainer(lambda: None, scaling_config=ttrain.ScalingConfig(use_gpu=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.fit()
    assert ttrain.ScalingConfig(use_gpu=True).worker_resources() == {"GPU": 1.0}
    for train in (jtrain, ttrain):
        with pytest.raises(RuntimeError, match="no active train session"):
            train.report({"x": 1})


# ------------------------------------------------------- LMTrainer in a gang


B, S, STEPS = 8, 16, 6


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """3 .npy token shards of 2 batches each (8 windows of S + 1 tokens
    per batch), made from a seed."""
    root = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(5)
    vocab = get_config("gpt2-tiny").vocab_size
    for i in range(3):
        np.save(root / f"s{i}.npy", rng.integers(0, vocab, 2 * B * (S + 1), dtype=np.int32))
    return str(root)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_lm_trainer_in_a_one_rank_gang_matches_jax(shards):
    """Each package's LMTrainer in its own one-rank gang, fed by
    lm_batch_iterator(get_dataset_shard("train")) over the same shards and
    reporting through session.report by default: 6 steps from the same
    initial state (JAX's, carried into the port)."""
    jtrainer = jtrain.LMTrainer(jget_config("gpt2-tiny"), mesh_spec=JMeshSpec(fsdp=8),
                                learning_rate=1e-3, total_steps=10)
    initial = jax.tree.map(np.asarray, jtrainer.state)

    def program(rt, train, data):
        def loop(config=None):
            if rt is ray_tpu:
                trainer = jtrainer
                batches = jlm.lm_batch_iterator(train.get_dataset_shard("train"), S, B)
            else:
                trainer = ttrain.LMTrainer(get_config("gpt2-tiny"), learning_rate=1e-3,
                                           total_steps=10, device="cpu")
                trainer.state = ttrain.train_state_from_numpy(initial, trainer.config,
                                                              device="cpu")
                batches = tlm.lm_batch_iterator(train.get_dataset_shard("train"), S, B,
                                                device="cpu")
            trainer.train(batches, num_steps=STEPS, report_every=1)

        result = train.Trainer(loop, scaling_config=train.ScalingConfig(num_workers=1),
                               run_config=train.RunConfig(name="gang-lm"),
                               datasets={"train": data.read_npy(shards)}).fit()
        steplog = jsteplog if rt is ray_tpu else tsteplog
        sampled = [(s["run"], s["rank"], s["step"]) for s in steplog.log().steps(run="gang-lm")]
        return result, sampled

    out = _both(program)
    jres, tres = out["jax"][0], out["torch"][0]
    assert jres.status.value == tres.status.value == "FINISHED" and tres.error is None
    assert len(jres.metrics_history) == len(tres.metrics_history) == STEPS
    for jr, tr in zip(jres.metrics_history, tres.metrics_history):
        assert jr["step"] == tr["step"]
        assert set(jr) == set(tr)
        for key in ("loss", "grad_norm", "num_tokens"):
            np.testing.assert_allclose(jr[key], tr[key], **STEP_TOL, err_msg=key)
    assert [r["step"] for r in tres.metrics_history] == list(builtins.range(1, STEPS + 1))
    # the sampled step's record carries the gang's run name and rank
    assert out["jax"][1] == out["torch"][1] == [("gang-lm", 0, 1)]
