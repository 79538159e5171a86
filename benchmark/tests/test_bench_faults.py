"""A whole run on the CPU at a tiny size (the look for a card skipped),
once sound and once with the timed path broken underneath by each fault
a cell can have (`harness/faults.py`). Sound runs come out `correct`,
broken ones not."""

import time

import pytest
import torch

from benchmark.harness import runner, spec
from benchmark.harness.faults import half_batch, state_unchanged, token_altered
from benchmark.tests.tiny import tiny_root

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def _run(root, workload, patch=None, seconds=2.0):
    cell = spec.load_cell(workload, root)
    return runner.run_cell(cell, 2**31 + 99, seconds, False, CPU, time.perf_counter(),
                           patch=patch)


@pytest.mark.parametrize("workload", ["mistral7b.chat", "mistral7b.shared_prefix",
                                      "mistral7b.batch"])
def test_serving_sound_and_with_a_token_altered(root, workload):
    sound = _run(root, workload)
    assert sound["correct"], sound["_numbers"]
    assert sound["attempted"] > 0 and sound["failed"] == 0
    broken = _run(root, workload, token_altered)
    assert not broken["correct"]
    assert broken["checks"]["max_logit_gap"]["value"] > broken["checks"]["max_logit_gap"]["limit"]


@pytest.mark.parametrize("fault", [None, state_unchanged, half_batch],
                         ids=["sound", "state_unchanged", "half_batch"])
def test_training_sound_and_broken(root, fault):
    out = _run(root, "gpt2xl.train", fault, seconds=1.0)
    numbers = out["_numbers"]
    if fault is None:
        assert out["correct"], numbers
    else:
        assert not out["correct"], numbers
    if fault is state_unchanged:
        assert numbers["change_gap"] == pytest.approx(1.0) and numbers["grad_gap"] >= 0.99
