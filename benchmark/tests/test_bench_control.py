"""The control on the card, at each cell's own size: the plain reference
computed in fp8, below the bfloat16 the configuration states, put in the
program's place, must come out not correct, while the program on the same
run comes out correct. Needs a CUDA card (marker `cuda`; skips elsewhere):

    python -m pytest benchmark/tests/test_bench_control.py -m cuda

Each case is one whole run of the cell with a short window (minutes)."""

import time

import pytest
import torch

from benchmark.harness import runner, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
SECONDS = {"serve": 15.0, "train": 5.0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_where_the_program_passes(cuda, workload):
    cell = spec.load_cell(workload)
    out = runner.run_cell(cell, 2**31 + 404, SECONDS[cell.kind], False, cuda,
                          time.perf_counter(), control=True)
    numbers, limits = out["_numbers"], cell.config["check"]["limits"]
    assert out["correct"], numbers
    assert any(numbers[f"control_{k}"] > v for k, v in limits.items()), numbers
