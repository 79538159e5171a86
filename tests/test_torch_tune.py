"""The port's Tune against the JAX package.

Ports of `tests/test_tune.py` and `tests/test_tune_checkpoint.py` on the
port's runtime (trials are thread actors; nested trainables, as JAX's tests
write them, need no pickling), plus parity on the same inputs: variants
and `Domain.sample` bit for bit, ASHA / median-stopping / PBT decisions on
scripted result streams (PBT's exploits and perturbed configs included),
the refusal of a PBT mutation that the standard pickle cannot save, and
`torch_tune_trainables.gpt2_pbt` (the card phase's trainable) through a
PBT exploit on gpt2-tiny on the CPU.
"""

import numpy as np
import pytest

import ray_tpu.tune as jtune
import ray_tpu_torch
import torch_tune_trainables
from ray_tpu_torch import tune
from ray_tpu_torch.train import session as train_session
from ray_tpu_torch.tune import TuneConfig, Tuner
from ray_tpu_torch.tune.schedulers import Exploit, PopulationBasedTraining


@pytest.fixture(autouse=True)
def rt():
    runtime = ray_tpu_torch.init(num_cpus=8, detect_accelerators=False)
    yield runtime
    ray_tpu_torch.shutdown()


# ------------------------------------------------------- parity with JAX's


def _space(mod):
    return {
        "a": mod.grid_search([1, 2, 3]),
        "b": mod.uniform(-1.0, 2.0),
        "c": mod.loguniform(1e-5, 1e-1),
        "d": mod.randint(3, 17),
        "e": mod.choice(["x", "y", "z"]),
        "f": {"grid_search": ["p", "q"]},
        "g": "fixed",
    }


@pytest.mark.parametrize("seed,num_samples", [(0, 1), (7, 3), (123, 5)])
def test_generate_variants_match_jax_bitwise(seed, num_samples):
    mine = list(tune.generate_variants(_space(tune), num_samples, seed))
    ref = list(jtune.generate_variants(_space(jtune), num_samples, seed))
    assert len(mine) == len(ref) == 6 * num_samples
    assert mine == ref
    assert [{k: type(v) for k, v in c.items()} for c in mine] == \
        [{k: type(v) for k, v in c.items()} for c in ref]


def test_domain_samples_match_jax_bitwise():
    for name, args in (("uniform", (0.5, 3.0)), ("loguniform", (1e-6, 1.0)),
                       ("randint", (-4, 9)), ("choice", ([3, "a", 2.5],))):
        mine_rng, ref_rng = np.random.default_rng(11), np.random.default_rng(11)
        mine = [getattr(tune, name)(*args).sample(mine_rng) for _ in range(50)]
        ref = [getattr(jtune, name)(*args).sample(ref_rng) for _ in range(50)]
        assert mine == ref, name


def _stream(seed, trials=6, steps=12):
    """A scripted result stream: trials report in a shuffled order each
    round, with noisy metrics (one trial sometimes omits the metric)."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(1, steps + 1):
        for i in rng.permutation(trials):
            result = {"training_iteration": t}
            if not (i == 0 and t % 5 == 0):
                result["score"] = float(rng.normal(i * 0.3, 1.0))
            out.append((f"trial_{i}", result))
    return out


def _verdicts(sched, stream):
    out = []
    for tid, result in stream:
        v = sched.on_result(tid, dict(result))
        out.append((v.donor_trial, v.new_config) if hasattr(v, "donor_trial") else v)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_asha_and_median_stopping_decisions_match_jax(seed):
    stream = _stream(seed)
    for mode in ("max", "min"):
        kw = dict(metric="score", mode=mode, grace_period=2, reduction_factor=3, max_t=12)
        mine = _verdicts(tune.ASHAScheduler(**kw), stream)
        ref = _verdicts(jtune.ASHAScheduler(**kw), stream)
        assert mine == ref and "STOP" in mine
        kw = dict(metric="score", mode=mode, grace_period=3)
        mine = _verdicts(tune.MedianStoppingRule(**kw), stream)
        ref = _verdicts(jtune.MedianStoppingRule(**kw), stream)
        assert mine == ref and "STOP" in mine


def double_lr():
    """A module-level PBT mutation (the port's Tuner saves it by reference)."""
    return 2e-3


def _pbt_run(mod, seed, mutations):
    sched = mod.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=3,
        hyperparam_mutations=mutations, quantile_fraction=0.34,
        resample_probability=0.3, seed=seed)
    for i in range(6):
        sched.on_trial_config(f"trial_{i}", {"lr": [1e-3, 5e-3, 1e-2][i % 3],
                                             "bs": [16, 32, 64][i % 3], "wd": 0.1 * i})
    verdicts = _verdicts(sched, _stream(seed))
    return verdicts, sched.num_exploits, sched._configs


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_pbt_exploits_and_perturbed_configs_match_jax(seed):
    mutations = {"lr": double_lr, "bs": [16, 32, 64, 128], "wd": [0.0, 0.1, 0.2, 0.3, 0.4, 0.5]}
    mine = _pbt_run(tune, seed, mutations)
    ref = _pbt_run(jtune, seed, mutations)
    assert mine == ref
    verdicts, exploits, _ = mine
    assert exploits >= 3 and sum(isinstance(v, tuple) for v in verdicts) == exploits
    # _perturb: 0.8x / 1.2x, ints rounded, other values untouched
    import random

    import ray_tpu.tune.schedulers as jsched
    import ray_tpu_torch.tune.schedulers as tsched

    for value in (10, 3.5, "x", 7):
        assert [tsched._perturb(value, random.Random(s)) for s in range(8)] == \
            [jsched._perturb(value, random.Random(s)) for s in range(8)]


def test_pbt_mutation_that_pickle_cannot_save_is_refused_at_build(tmp_path):
    """The experiment state (TuneConfig and scheduler) is saved with the
    standard pickle: a lambda mutation fails when the Tuner is built, not
    in fit's `finally` after the trials ran. A module-level one is fine."""
    def build(mutation):
        pbt = PopulationBasedTraining(metric="s", hyperparam_mutations={"lr": mutation})
        return Tuner(lambda config: None, param_space={"lr": 1.0},
                     tune_config=TuneConfig(scheduler=pbt, storage_path=str(tmp_path)))

    with pytest.raises(TypeError, match="standard pickle"):
        build(lambda: 1e-3)

    def nested():
        return 1e-3

    with pytest.raises(TypeError, match="module level"):
        build(nested)
    build(double_lr)
    build([1e-3, 1e-2])


def test_lambda_and_nested_trainables_run_on_thread_actors():
    """The trainable is never pickled: a lambda or a nested function that
    closes over local state runs as a trial."""
    local = {"offset": 100}

    def nested(config):
        tune.report({"score": config["x"] + local["offset"]})

    for trainable in (nested, lambda config: tune.report({"score": config["x"]})):
        grid = Tuner(trainable, param_space={"x": tune.grid_search([1, 2])},
                     tune_config=TuneConfig(metric="score", mode="max")).fit()
        assert all(t.status == tune.TrialStatus.TERMINATED for t in grid)
    assert grid.get_best_result().last_result["score"] == 2


# ------------------------------------------------ tests/test_tune.py, ported


def test_generate_variants_grid_and_random():
    space = {
        "a": tune.grid_search([1, 2, 3]),
        "b": tune.uniform(0.0, 1.0),
        "c": "fixed",
    }
    variants = list(tune.generate_variants(space, num_samples=2, seed=0))
    assert len(variants) == 6  # 3 grid × 2 samples
    assert {v["a"] for v in variants} == {1, 2, 3}
    assert all(0.0 <= v["b"] <= 1.0 for v in variants)
    assert all(v["c"] == "fixed" for v in variants)


def test_domains_sample_in_range():
    rng = np.random.default_rng(0)
    assert 1e-4 <= tune.loguniform(1e-4, 1e-1).sample(rng) <= 1e-1
    assert tune.randint(3, 7).sample(rng) in (3, 4, 5, 6)
    assert tune.choice(["x", "y"]).sample(rng) in ("x", "y")


def test_asha_stops_bad_trials_unit():
    sched = tune.ASHAScheduler(
        metric="score", mode="max", grace_period=2, reduction_factor=2, max_t=16
    )
    assert sched.on_result("good1", {"training_iteration": 2, "score": 10}) == "CONTINUE"
    assert sched.on_result("good2", {"training_iteration": 2, "score": 10}) == "CONTINUE"
    assert sched.on_result("bad", {"training_iteration": 2, "score": 1}) == "STOP"
    assert sched.on_result("bad", {"training_iteration": 3, "score": 99}) == "STOP"


def test_tuner_end_to_end_sweep():
    def trainable(config):
        # quadratic: best at x=3
        score = -((config["x"] - 3.0) ** 2)
        for i in range(3):
            tune.report({"score": score + 0.01 * i})
        return score

    tuner = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([0.0, 1.0, 3.0, 5.0])},
        tune_config=tune.TuneConfig(num_samples=1, metric="score", mode="max"),
    )
    results = tuner.fit()
    assert len(results) == 4
    best = results.get_best_result()
    assert best.config["x"] == 3.0
    assert all(t.status == tune.TrialStatus.TERMINATED for t in results)


def test_tuner_with_asha_stops_some():
    def trainable(config):
        for i in range(1, 9):
            tune.report({"loss": config["badness"] * i})

    sched = tune.ASHAScheduler(
        metric="loss", mode="min", grace_period=2, reduction_factor=2, max_t=8
    )
    tuner = tune.Tuner(
        trainable,
        param_space={"badness": tune.grid_search([1.0, 2.0, 5.0, 10.0])},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", scheduler=sched, max_concurrent=4
        ),
    )
    results = tuner.fit()
    best = results.get_best_result()
    assert best.config["badness"] == 1.0
    stopped = [t for t in results if t.status == tune.TrialStatus.STOPPED]
    assert stopped, "ASHA never stopped anything"


def test_tuner_handles_erroring_trial():
    def trainable(config):
        if config["x"] == 1:
            raise RuntimeError("bad trial")
        tune.report({"score": config["x"]})

    tuner = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([0, 1, 2])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
    )
    results = tuner.fit()
    statuses = {t.config["x"]: t.status for t in results}
    assert statuses[1] == tune.TrialStatus.ERRORED
    assert results.get_best_result().config["x"] == 2


# -------------------------------------- tests/test_tune_checkpoint.py, ported


def _counting_trainable(config):
    """Counts up, checkpointing each step; resumes where it left off and
    crashes once at step 3 unless it already restarted."""
    ckpt = train_session.get_checkpoint()
    start = ckpt["step"] + 1 if ckpt else 0
    for step in range(start, 6):
        if step == 3 and ckpt is None:
            raise RuntimeError("injected trial crash")
        train_session.report(
            {"step": step, "resumed": ckpt is not None},
            checkpoint={"step": step},
        )


def test_trial_crash_resumes_from_checkpoint(tmp_path):
    tuner = Tuner(
        _counting_trainable,
        param_space={"x": [1]},
        tune_config=TuneConfig(
            metric="step", mode="max", max_failures=1,
            storage_path=str(tmp_path),
        ),
    )
    grid = tuner.fit()
    best = grid.get_best_result()
    assert best.status.value == "TERMINATED"
    assert best.last_result["step"] == 5
    assert best.last_result["resumed"] is True
    assert best.num_failures == 1
    steps = [r["step"] for r in best.history]
    assert steps[-3:] == [3, 4, 5]


def test_no_retry_budget_errors_out(tmp_path):
    def always_crash(config):
        raise RuntimeError("nope")

    grid = Tuner(
        always_crash,
        param_space={"x": [1]},
        tune_config=TuneConfig(storage_path=str(tmp_path)),
    ).fit()
    trial = list(grid)[0]
    assert trial.status.value == "ERRORED"
    assert "nope" in trial.error


def test_tuner_restore_skips_finished_reruns_unfinished(tmp_path):
    calls_file = tmp_path / "calls.txt"

    def trainable(config):
        with open(calls_file, "a") as f:
            f.write(f"{config['idx']}\n")
        if config["idx"] == 1 and not train_session.get_checkpoint():
            train_session.report({"score": 0}, checkpoint={"seen": True})
            raise RuntimeError("die once")
        train_session.report({"score": config["idx"] * 10})

    cfg = TuneConfig(metric="score", mode="max", storage_path=str(tmp_path))
    grid = Tuner(
        trainable, param_space={"idx": {"grid_search": [0, 1]}}, tune_config=cfg
    ).fit()
    statuses = {t.trial_id: t.status.value for t in grid}
    assert statuses["trial_00000"] == "TERMINATED"
    assert statuses["trial_00001"] == "ERRORED"

    restored = Tuner.restore(str(tmp_path), trainable)
    grid2 = restored.fit()
    statuses = {t.trial_id: t.status.value for t in grid2}
    assert statuses["trial_00001"] == "TERMINATED"
    runs = [int(x) for x in calls_file.read_text().split()]
    assert runs.count(0) == 1


def test_pbt_exploits_and_mutates(tmp_path):
    """Weak trials must adopt (and perturb) strong trials' configs, and
    resume from the donor's checkpoint."""

    def trainable(config):
        import time as _time

        ckpt = train_session.get_checkpoint() or {"acc": 0.0, "steps": 0}
        acc, start = ckpt["acc"], ckpt["steps"]
        for step in range(start, start + 12):
            acc += config["lr"]  # higher lr == strictly better here
            train_session.report(
                {"acc": acc, "lr": config["lr"]},
                checkpoint={"acc": acc, "steps": step + 1},
            )
            _time.sleep(0.05)  # let controller polls interleave the population

    pbt = PopulationBasedTraining(
        metric="acc",
        mode="max",
        perturbation_interval=3,
        hyperparam_mutations={"lr": [0.1, 0.5, 1.0, 2.0]},
        quantile_fraction=0.34,
        seed=7,
    )
    grid = Tuner(
        trainable,
        param_space={"lr": {"grid_search": [0.1, 0.5, 2.0]}},
        tune_config=TuneConfig(
            metric="acc", mode="max", scheduler=pbt, max_concurrent=3,
            storage_path=str(tmp_path),
        ),
    ).fit()
    assert pbt.num_exploits >= 1
    exploited = [t for t in grid if t.num_exploits > 0]
    assert exploited, "no trial ever exploited"
    for t in exploited:
        assert t.config["lr"] != 0.1
        assert t.last_result["acc"] > 0.1 * 12 + 1e-9


def test_pbt_scheduler_unit():
    pbt = PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=2,
        hyperparam_mutations={"lr": [1, 2, 4]}, quantile_fraction=0.5, seed=0,
    )
    pbt.on_trial_config("a", {"lr": 4})
    pbt.on_trial_config("b", {"lr": 1})
    assert pbt.on_result("a", {"score": 10, "training_iteration": 2}) == "CONTINUE"
    verdict = pbt.on_result("b", {"score": 1, "training_iteration": 2})
    assert isinstance(verdict, Exploit)
    assert verdict.donor_trial == "a"
    assert "lr" in verdict.new_config


def _gang_epoch_trainable(config):
    """A Tune trial that drives a TrainController gang per epoch,
    checkpointing through the tune session and crashing once mid-trial."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig, Trainer

    ckpt = train_session.get_checkpoint()
    start = ckpt["epoch"] + 1 if ckpt else 0
    for epoch in range(start, 4):
        if epoch == 2 and ckpt is None:
            raise RuntimeError("injected mid-training crash")

        def loop(cfg, _epoch=epoch):
            from ray_tpu_torch import train

            for i in range(2):
                train.report({"inner_step": i, "epoch": _epoch})

        result = Trainer(
            loop,
            scaling_config=ScalingConfig(num_workers=2),
            run_config=RunConfig(name=f"inner-{config['lr']}-{epoch}"),
            train_loop_config={},
        ).fit()
        assert result.status.value == "FINISHED", result.error
        assert result.metrics["epoch"] == epoch
        train_session.report(
            {"epoch": epoch, "loss": 1.0 / (epoch + 1) * config["lr"],
             "resumed": ckpt is not None},
            checkpoint={"epoch": epoch},
        )


def test_tuner_drives_train_controller_with_restore(tmp_path):
    tuner = Tuner(
        _gang_epoch_trainable,
        param_space={"lr": tune.grid_search([1.0, 2.0])},
        tune_config=TuneConfig(
            metric="loss", mode="min", max_failures=1,
            storage_path=str(tmp_path),
        ),
    )
    grid = tuner.fit()
    assert len(grid) == 2
    for trial in grid:
        assert trial.status.value == "TERMINATED", trial.error
        assert trial.last_result["epoch"] == 3
        assert trial.last_result["resumed"] is True
        assert trial.num_failures == 1
    best = grid.get_best_result()
    assert best.config["lr"] == 1.0


# ----------------------------------------------- the card phase's trainable


def test_gpt2_pbt_trainable_exploits_with_the_donors_state(tmp_path):
    """`torch_tune_trainables.gpt2_pbt` at gpt2-tiny on the CPU, as the
    card phase runs GPT-2 124M: two trials, PBT over the learning rate; the
    weak trial exploits, its restored state's fingerprint equals one the
    donor saved at that step (and none of its own), its first incarnation
    stops at the exploit, and every trial ends TERMINATED."""
    torch_tune_trainables.reset_steps()
    steps, every = 8, 2
    pbt = PopulationBasedTraining(metric="loss", mode="min", perturbation_interval=4,
                                  hyperparam_mutations={"lr": [1e-5, 3e-3, 1e-2, 3e-2]},
                                  quantile_fraction=0.5, seed=0)
    grid = Tuner(
        torch_tune_trainables.gpt2_pbt,
        param_space={"lr": tune.grid_search([1e-2, 1e-5]), "model": "gpt2-tiny", "seed": 0,
                     "batch": 2, "seq": 32, "steps": steps, "ckpt_every": every,
                     "device": "cpu", "pause_s": 0.1},
        tune_config=TuneConfig(metric="loss", mode="min", scheduler=pbt, max_concurrent=2,
                               storage_path=str(tmp_path)),
    ).fit()
    trials = list(grid)
    assert [t.status.value for t in trials] == ["TERMINATED", "TERMINATED"], \
        [t.error for t in trials]
    assert pbt.num_exploits >= 1
    saved = {t.trial_id: {(r["step"], tuple(map(tuple, r["fingerprint"])))
                          for r in t.history if "fingerprint" in r} for t in trials}
    restores = 0
    for t in trials:
        for r in t.history:
            if "restored_fingerprint" in r:
                key = (r["restored_step"], tuple(map(tuple, r["restored_fingerprint"])))
                others = set().union(*(v for k, v in saved.items() if k != t.trial_id))
                assert key in others and key not in saved[t.trial_id]
                restores += 1
    assert restores == sum(t.num_exploits for t in trials) >= 1
    taken = torch_tune_trainables.steps_taken()
    assert set(taken) == {t.trial_dir for t in trials}
    # each trial ran its 8 steps, and an exploited one its first
    # incarnation up to the exploit (at most a step past the verdict) and
    # the rest from the restored step
    assert all(steps <= n <= 2 * steps for n in taken.values())


def test_pbt_clone_drops_the_victims_manifests_unlike_jax(tmp_path):
    """A repaired fault of JAX's clone: it wipes the victim's checkpoints
    but not their manifests, so a victim manifest named like the donor's
    latest checkpoint fails the clone's verification and the restore
    quarantines it (JAX: None, the trial starts over). The port's clone
    removes the manifests too, and the victim restores the donor's state."""
    import ray_tpu.train.session as jsession
    import ray_tpu.tune.tuner as jtuner
    import ray_tpu_torch.train.session as tsession
    import ray_tpu_torch.tune.tuner as ttuner

    restored = {}
    for name, session_mod, tuner_mod in (("jax", jsession, jtuner), ("torch", tsession, ttuner)):
        trials = {}
        for role in ("donor", "victim"):
            trial_dir = str(tmp_path / name / role)
            session = session_mod.Session(session_mod.TrainContext(0, 1, role, trial_dir=trial_dir))
            for step in range(2):
                session.save_checkpoint({"who": role, "step": step})
            trials[role] = tuner_mod.Trial(trial_id=role, config={}, trial_dir=trial_dir)
        tuner_mod.Tuner._clone_checkpoint(None, trials["donor"], trials["victim"])
        restored[name] = session_mod.load_trial_checkpoint(trials["victim"].trial_dir)
    assert restored == {"jax": None, "torch": {"who": "donor", "step": 1}}
