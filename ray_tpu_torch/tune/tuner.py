"""Tuner: trial FSM + concurrent execution + scheduler-driven control.

Reference parity: tune/tune.py Tuner → TuneController (tune/execution/
tune_controller.py:68) event loop over the actor manager, with trial
checkpointing + experiment-state persistence (tune/execution/
experiment_state.py) and PBT exploit/explore (tune/schedulers/pbt.py:221).
Trials are TrainWorker actors (reused from ray_tpu_torch.train) reporting
through the session; the controller polls, feeds the scheduler, restarts
failed trials from their last checkpoint, and executes PBT exploits by
cloning a donor's checkpoint into the victim's trial dir.

Port of `ray_tpu/tune/tuner.py` over the port's thread actors. The
experiment state (`experiment_state.pkl`: the TuneConfig with its
scheduler, the param space, the trials' records) is written with the
standard `pickle`, where JAX's uses `cloudpickle`: a value in it that
pickles only by value (a lambda or a nested function as a PBT
`hyperparam_mutations` entry) is refused with a TypeError when the Tuner
is built, not after the trials ran. The trainable itself is never
pickled: a trial runs it on a thread actor of this process, so a nested
function or a lambda works as a trainable.

Two repairs of JAX's PBT exploit: the victim's loop is asked to stop
(`train.is_preempted()` turns True) and waited for before the donor's
checkpoint is cloned over its own, and the clone removes the victim's
checkpoint manifests with its checkpoints.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

from .. import api
from ..core.exceptions import ActorDiedError, GetTimeoutError, TaskError
from ..train.worker_group import TrainWorker
from .schedulers import CONTINUE, STOP, Exploit, FIFOScheduler, TrialScheduler
from .search import generate_variants

# how long a PBT exploit waits for the victim's loop to stop before it
# clones the donor's checkpoint over the victim's
EXPLOIT_STOP_TIMEOUT_S = 60.0

PICKLE_RULE = (
    "ray_tpu_torch saves the experiment state (the TuneConfig with its scheduler, and "
    "the param space) with the standard pickle, by reference (there is no cloudpickle), "
    "so every value there must be importable: define a PBT mutation function at module "
    "level in an importable module, not as a lambda or a nested function"
)


def check_state_picklable(tune_config: "TuneConfig", param_space: Dict[str, Any]) -> None:
    """Raise TypeError, naming the rule, unless the state `fit` saves pickles."""
    try:
        pickle.dumps((tune_config, param_space), protocol=pickle.HIGHEST_PROTOCOL)
    except (pickle.PicklingError, AttributeError, TypeError) as exc:
        raise TypeError(f"the Tuner's state cannot be pickled ({exc}): {PICKLE_RULE}") from None


class TrialStatus(enum.Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    TERMINATED = "TERMINATED"  # finished normally
    STOPPED = "STOPPED"  # early-stopped by the scheduler
    ERRORED = "ERRORED"


@dataclasses.dataclass
class Trial:
    trial_id: str
    config: Dict[str, Any]
    status: TrialStatus = TrialStatus.PENDING
    last_result: Dict[str, Any] = dataclasses.field(default_factory=dict)
    history: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    error: Optional[str] = None
    actor: Any = None
    result_ref: Any = None
    cursor: int = 0
    trial_dir: Optional[str] = None
    num_failures: int = 0
    num_exploits: int = 0


@dataclasses.dataclass
class TuneConfig:
    num_samples: int = 1
    max_concurrent: int = 4
    metric: Optional[str] = None
    mode: str = "max"
    scheduler: Optional[TrialScheduler] = None
    seed: int = 0
    resources_per_trial: Optional[Dict[str, float]] = None
    # storage for trial checkpoints + experiment state (enables restore);
    # None = a fresh temp dir per fit()
    storage_path: Optional[str] = None
    # restart a crashed trial from its last checkpoint up to this many times
    max_failures: int = 0


class ResultGrid:
    def __init__(self, trials: List[Trial], metric: Optional[str], mode: str):
        self.trials = trials
        self._metric = metric
        self._mode = mode

    def get_best_result(
        self, metric: Optional[str] = None, mode: Optional[str] = None
    ) -> Trial:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("no metric configured")
        scored = [t for t in self.trials if metric in t.last_result]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        key = lambda t: t.last_result[metric]  # noqa: E731
        return max(scored, key=key) if mode == "max" else min(scored, key=key)

    def __len__(self) -> int:
        return len(self.trials)

    def __iter__(self):
        return iter(self.trials)


class Tuner:
    """Tuner(trainable, param_space=..., tune_config=...).fit()"""

    def __init__(
        self,
        trainable: Callable[[Dict[str, Any]], Any],
        *,
        param_space: Dict[str, Any],
        tune_config: Optional[TuneConfig] = None,
        _trials: Optional[List[Trial]] = None,
    ):
        self.trainable = trainable
        self.param_space = param_space
        self.config = tune_config or TuneConfig()
        check_state_picklable(self.config, param_space)
        self._restored_trials = _trials

    @classmethod
    def restore(cls, path: str, trainable: Callable) -> "Tuner":
        """Resume an interrupted experiment from its storage dir: finished
        trials keep their results; unfinished ones re-run, resuming from
        their last checkpoint (reference: Tuner.restore +
        experiment_state.py)."""
        state_file = os.path.join(path, "experiment_state.pkl")
        with open(state_file, "rb") as f:
            state = pickle.load(f)
        cfg: TuneConfig = state["config"]
        cfg.storage_path = path
        trials: List[Trial] = []
        for rec in state["trials"]:
            trial = Trial(
                trial_id=rec["trial_id"],
                config=rec["config"],
                status=TrialStatus(rec["status"]),
                last_result=rec["last_result"],
                history=rec["history"],
                error=rec["error"],
                cursor=0,
                trial_dir=os.path.join(path, rec["trial_id"]),
                num_failures=rec["num_failures"],
            )
            if trial.status in (TrialStatus.PENDING, TrialStatus.RUNNING,
                                TrialStatus.ERRORED):
                # will re-run; the trainable resumes via tune.get_checkpoint()
                trial.status = TrialStatus.PENDING
                trial.history = []
                trial.last_result = {}
            trials.append(trial)
        return cls(
            trainable, param_space=state["param_space"], tune_config=cfg,
            _trials=trials,
        )

    # ------------------------------------------------------------------ fit

    def fit(self, poll_interval: float = 0.05) -> ResultGrid:
        cfg = self.config
        scheduler = cfg.scheduler or FIFOScheduler()
        exp_dir = cfg.storage_path or tempfile.mkdtemp(prefix="ray_tpu_tune_")
        cfg.storage_path = exp_dir
        os.makedirs(exp_dir, exist_ok=True)
        if self._restored_trials is not None:
            trials = self._restored_trials
        else:
            trials = [
                Trial(
                    trial_id=f"trial_{i:05d}",
                    config=variant,
                    trial_dir=os.path.join(exp_dir, f"trial_{i:05d}"),
                )
                for i, variant in enumerate(
                    generate_variants(self.param_space, cfg.num_samples, cfg.seed)
                )
            ]
        for t in trials:
            scheduler.on_trial_config(t.trial_id, t.config)
        pending = [t for t in trials if t.status == TrialStatus.PENDING]
        running: List[Trial] = []
        actor_cls = api.remote(TrainWorker)

        def launch(trial: Trial) -> None:
            trial.actor = actor_cls.options(
                max_concurrency=2,
                resources=cfg.resources_per_trial or {"CPU": 1.0},
                num_cpus=0,
                name=f"tune-{trial.trial_id}-{trial.num_failures}-{trial.num_exploits}",
            ).remote(0, 1, trial.trial_id, trial.trial_dir)
            trial.result_ref = trial.actor.run.remote(self.trainable, trial.config)
            trial.status = TrialStatus.RUNNING
            running.append(trial)

        MAX_POLL_TIMEOUTS = 3
        poll_timeouts: Dict[str, int] = {}
        try:
            self._run_loop(
                cfg, scheduler, trials, pending, running, launch,
                poll_interval, poll_timeouts, MAX_POLL_TIMEOUTS, exp_dir,
            )
        finally:
            self._save_state(exp_dir, trials)
            # Never abandon live trial actors, whatever escapes the loop.
            for trial in running:
                try:
                    api.kill(trial.actor)
                except Exception:
                    pass
        return ResultGrid(trials, cfg.metric, cfg.mode)

    def _save_state(self, exp_dir: str, trials: List[Trial]) -> None:
        state = {
            "config": self.config,
            "param_space": self.param_space,
            "trials": [
                {
                    "trial_id": t.trial_id,
                    "config": t.config,
                    "status": t.status.value,
                    "last_result": t.last_result,
                    "history": t.history,
                    "error": t.error,
                    "num_failures": t.num_failures,
                }
                for t in trials
            ],
        }
        tmp = os.path.join(exp_dir, "experiment_state.pkl.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, os.path.join(exp_dir, "experiment_state.pkl"))

    def _stop_incarnation(self, trial: Trial) -> None:
        """Ask the trial's running loop to stop (its session reads
        preempted: `train.is_preempted()`) and wait up to
        EXPLOIT_STOP_TIMEOUT_S for it to return. A trial is a thread actor,
        whose running loop a kill cannot end: unstopped, a victim's loop
        would train and checkpoint on beside its successor, and a
        checkpoint it lands after the clone would be the one the successor
        restores (JAX's Tuner has this race)."""
        try:
            api.get(trial.actor.poll.remote(trial.cursor, preempted=True),
                    timeout=EXPLOIT_STOP_TIMEOUT_S)
            api.wait([trial.result_ref], timeout=EXPLOIT_STOP_TIMEOUT_S)
        except (ActorDiedError, GetTimeoutError, TaskError):
            pass

    def _clone_checkpoint(self, donor: Trial, victim: Trial) -> None:
        """PBT exploit: victim adopts the donor's latest checkpoint.

        The victim's checkpoints go with their manifests. JAX's clone
        leaves the manifests: a victim manifest named like the donor's
        latest checkpoint then fails its verification, the restore
        quarantines the clone and the trial starts over."""
        from ..train.session import MANIFEST_SUFFIX, list_checkpoints

        if victim.trial_dir is None:
            return
        ckpts = list_checkpoints(donor.trial_dir)
        if not ckpts:
            return
        os.makedirs(victim.trial_dir, exist_ok=True)
        # wipe the victim's own checkpoints so the donor's is the latest
        for f in list_checkpoints(victim.trial_dir):
            for name in (f, f + MANIFEST_SUFFIX):
                try:
                    os.unlink(os.path.join(victim.trial_dir, name))
                except FileNotFoundError:
                    pass
        src = os.path.join(donor.trial_dir, ckpts[-1])
        shutil.copy(src, os.path.join(victim.trial_dir, ckpts[-1]))

    def _restart(
        self, trial: Trial, launch, running: List[Trial],
        poll_timeouts: Optional[Dict[str, int]] = None,
    ) -> None:
        try:
            api.kill(trial.actor)
        except Exception:
            pass
        if trial in running:
            running.remove(trial)
        trial.cursor = 0
        if poll_timeouts is not None:
            # fresh actor, fresh patience: the new incarnation gets the
            # full max_poll_timeouts budget
            poll_timeouts.pop(trial.trial_id, None)
        launch(trial)

    def _run_loop(
        self, cfg, scheduler, trials, pending, running, launch,
        poll_interval, poll_timeouts, max_poll_timeouts, exp_dir,
    ) -> None:
        trial_by_id = {t.trial_id: t for t in trials}
        last_saved = 0.0
        while pending or running:
            while pending and len(running) < cfg.max_concurrent:
                launch(pending.pop(0))

            for trial in list(running):
                try:
                    poll = api.get(trial.actor.poll.remote(trial.cursor), timeout=30)
                except GetTimeoutError:
                    # Trial is blocking its actor past the poll timeout;
                    # retry, and only declare it failed after repeats.
                    n = poll_timeouts.get(trial.trial_id, 0) + 1
                    poll_timeouts[trial.trial_id] = n
                    if n >= max_poll_timeouts:
                        self._fail_or_retry(
                            trial, f"poll timed out {n} times", launch, running,
                            poll_timeouts,
                        )
                    continue
                except (ActorDiedError, TaskError) as e:
                    self._fail_or_retry(trial, repr(e), launch, running, poll_timeouts)
                    continue
                poll_timeouts.pop(trial.trial_id, None)
                decision: Any = CONTINUE
                for metrics, _ckpt, _rank, _ts in poll["reports"]:
                    trial.cursor += 1
                    metrics.setdefault("training_iteration", trial.cursor)
                    trial.history.append(metrics)
                    trial.last_result = metrics
                    verdict = scheduler.on_result(trial.trial_id, metrics)
                    if verdict == STOP:
                        decision = STOP
                    elif isinstance(verdict, Exploit):
                        decision = verdict
                if decision == STOP:
                    trial.status = TrialStatus.STOPPED
                    api.kill(trial.actor)
                    running.remove(trial)
                elif isinstance(decision, Exploit):
                    donor = trial_by_id.get(decision.donor_trial)
                    if donor is not None:
                        trial.config = dict(decision.new_config)
                        trial.num_exploits += 1
                        self._stop_incarnation(trial)
                        self._clone_checkpoint(donor, trial)
                        scheduler.on_trial_config(trial.trial_id, trial.config)
                        self._restart(trial, launch, running, poll_timeouts)
                elif poll["done"]:
                    if poll["error"]:
                        self._fail_or_retry(
                            trial, poll["error"], launch, running, poll_timeouts
                        )
                    else:
                        trial.status = TrialStatus.TERMINATED
                        api.kill(trial.actor)
                        running.remove(trial)
            now = time.monotonic()
            if now - last_saved > 1.0:
                self._save_state(exp_dir, trials)
                last_saved = now
            if running:
                time.sleep(poll_interval)

    def _fail_or_retry(
        self, trial, error: str, launch, running,
        poll_timeouts: Optional[Dict[str, int]] = None,
    ) -> None:
        trial.num_failures += 1
        if trial.num_failures <= self.config.max_failures:
            # resume from the trial's last checkpoint (the trainable picks
            # it up via tune.get_checkpoint())
            self._restart(trial, launch, running, poll_timeouts)
            return
        trial.status = TrialStatus.ERRORED
        trial.error = error
        try:
            api.kill(trial.actor)
        except Exception:
            pass
        if trial in running:
            running.remove(trial)
