"""Trial schedulers: early stopping + population-based training.

Reference parity: tune/schedulers/async_hyperband.py:19 ASHAScheduler,
median_stopping_rule.py, pbt.py:221 PopulationBasedTraining. Decisions run
on every report: CONTINUE, STOP, or an Exploit directive (PBT) telling the
controller to restart the trial from a donor's checkpoint with a mutated
config.

Port of `ray_tpu/tune/schedulers.py`, stdlib only and unchanged: the same
result stream and seed give the same decisions.
"""

from __future__ import annotations

import collections
import dataclasses
import random
from typing import Any, Callable, Dict, List, Union

CONTINUE = "CONTINUE"
STOP = "STOP"


@dataclasses.dataclass
class Exploit:
    """PBT verdict: clone `donor_trial`'s checkpoint, adopt `new_config`,
    and continue training (reference pbt.py _exploit)."""

    donor_trial: str
    new_config: Dict[str, Any]


Verdict = Union[str, Exploit]


class TrialScheduler:
    def on_result(self, trial_id: str, result: Dict) -> Verdict:
        return CONTINUE

    def on_trial_config(self, trial_id: str, config: Dict) -> None:
        """Controller tells the scheduler each trial's (current) config."""


class FIFOScheduler(TrialScheduler):
    """No early stopping."""


class ASHAScheduler(TrialScheduler):
    """Async Successive Halving: at each rung (grace_period · rf^k steps of
    `time_attr`), stop a trial whose metric is outside the top 1/rf of
    completed rung peers."""

    def __init__(
        self,
        metric: str,
        mode: str = "max",
        time_attr: str = "training_iteration",
        grace_period: int = 1,
        reduction_factor: int = 4,
        max_t: int = 100,
    ):
        assert mode in ("max", "min")
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.rf = reduction_factor
        self.rungs: List[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(t)
            t *= reduction_factor
        # rung milestone -> recorded metric per trial
        self._rung_records: Dict[int, Dict[str, float]] = collections.defaultdict(dict)
        self._stopped: set = set()

    def on_result(self, trial_id: str, result: Dict) -> str:
        if trial_id in self._stopped:
            return STOP
        t = result.get(self.time_attr)
        value = result.get(self.metric)
        if t is None or value is None:
            return CONTINUE
        value = float(value)
        decision = CONTINUE
        for rung in self.rungs:
            if t < rung:
                break
            records = self._rung_records[rung]
            if trial_id not in records:
                records[trial_id] = value
                if not self._in_top_fraction(records, value):
                    decision = STOP
        if decision == STOP:
            self._stopped.add(trial_id)
        return decision

    def _in_top_fraction(self, records: Dict[str, float], value: float) -> bool:
        values = sorted(records.values(), reverse=(self.mode == "max"))
        k = max(1, len(values) // self.rf)
        cutoff = values[k - 1]
        return value >= cutoff if self.mode == "max" else value <= cutoff


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose latest metric is worse than the median of peers'
    running averages at the same step count."""

    def __init__(self, metric: str, mode: str = "max", grace_period: int = 1,
                 time_attr: str = "training_iteration"):
        self.metric = metric
        self.mode = mode
        self.grace = grace_period
        self.time_attr = time_attr
        self._history: Dict[str, List[float]] = collections.defaultdict(list)

    def on_result(self, trial_id: str, result: Dict) -> str:
        value = result.get(self.metric)
        if value is None:
            return CONTINUE
        self._history[trial_id].append(float(value))
        t = result.get(self.time_attr, len(self._history[trial_id]))
        if t < self.grace or len(self._history) < 3:
            return CONTINUE
        means = {
            tid: sum(vs) / len(vs) for tid, vs in self._history.items() if vs
        }
        peer_means = sorted(means.values())
        median = peer_means[len(peer_means) // 2]
        mine = means[trial_id]
        worse = mine < median if self.mode == "max" else mine > median
        return STOP if worse else CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference tune/schedulers/pbt.py:221): every
    `perturbation_interval` steps of `time_attr`, a trial in the bottom
    `quantile_fraction` of the population exploits a top-quantile donor —
    it clones the donor's checkpoint and config — then explores by
    mutating hyperparameters (resample with `resample_probability`, else
    perturb numeric values by 0.8x / 1.2x).
    """

    def __init__(
        self,
        metric: str,
        mode: str = "max",
        time_attr: str = "training_iteration",
        perturbation_interval: int = 4,
        hyperparam_mutations: Dict[str, Any] = None,
        quantile_fraction: float = 0.25,
        resample_probability: float = 0.25,
        seed: int = 0,
    ):
        assert mode in ("max", "min")
        assert hyperparam_mutations, "PBT requires hyperparam_mutations"
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = dict(hyperparam_mutations)
        self.quantile = quantile_fraction
        self.resample_prob = resample_probability
        self._rng = random.Random(seed)
        self._configs: Dict[str, Dict] = {}
        self._scores: Dict[str, float] = {}  # latest metric per trial
        self._last_perturb: Dict[str, int] = collections.defaultdict(int)
        self.num_exploits = 0

    def on_trial_config(self, trial_id: str, config: Dict) -> None:
        self._configs[trial_id] = dict(config)

    def on_result(self, trial_id: str, result: Dict) -> Verdict:
        value = result.get(self.metric)
        t = result.get(self.time_attr)
        if value is None or t is None:
            return CONTINUE
        self._scores[trial_id] = float(value)
        if t - self._last_perturb[trial_id] < self.interval:
            return CONTINUE
        self._last_perturb[trial_id] = t
        ranked = sorted(
            self._scores.items(), key=lambda kv: kv[1],
            reverse=(self.mode == "max"),
        )
        if len(ranked) < 2:
            return CONTINUE
        k = max(1, int(len(ranked) * self.quantile))
        top = [tid for tid, _ in ranked[:k]]
        bottom = {tid for tid, _ in ranked[-k:]}
        if trial_id not in bottom or trial_id in top:
            return CONTINUE
        donor = self._rng.choice(top)
        new_config = self._explore(self._configs.get(donor, {}))
        self._configs[trial_id] = dict(new_config)
        self.num_exploits += 1
        return Exploit(donor_trial=donor, new_config=new_config)

    def _explore(self, donor_config: Dict) -> Dict:
        out = dict(donor_config)
        for name, spec in self.mutations.items():
            resample = self._rng.random() < self.resample_prob
            if callable(spec):
                if resample or name not in out:
                    out[name] = spec()
                else:
                    out[name] = _perturb(out[name], self._rng)
            elif isinstance(spec, (list, tuple)):
                if resample or name not in out:
                    out[name] = self._rng.choice(list(spec))
                else:
                    choices = list(spec)
                    idx = choices.index(out[name]) if out[name] in choices else 0
                    idx = max(0, min(len(choices) - 1, idx + self._rng.choice([-1, 1])))
                    out[name] = choices[idx]
            else:
                raise TypeError(
                    f"mutation spec for {name!r} must be a callable or a "
                    f"list of choices, got {type(spec).__name__}"
                )
        return out


def _perturb(value, rng: "random.Random"):
    if isinstance(value, (int, float)):
        factor = rng.choice([0.8, 1.2])
        new = value * factor
        return int(round(new)) if isinstance(value, int) else new
    return value
