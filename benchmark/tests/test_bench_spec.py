"""BENCHMARK.json against the contract, and the harness's reliance on data:
a new traffic mix, metric and cell need only new files and entries."""

import json
import shutil

import pytest

from benchmark.harness import spec


def test_the_committed_benchmark_is_valid():
    bench = spec.validate()
    names = [w["name"] for w in bench["workloads"]]
    assert names[0] == "mistral7b.chat"
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert e2e == {"ttft_p95_s", "tpot_p95_ms", "output_tokens_per_s", "train_tokens_per_s",
                   "setup_s"}
    for name in names:
        cell = spec.load_cell(name)
        assert cell.per_layer and any(m.name != "setup_s" for m in cell.end_to_end)


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.repo_root() / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.repo_root() / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_a_new_mix_metric_and_cell_need_only_new_files(tmp_path):
    root = _copy(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    (root / "benchmark/traffic/burst.json").write_text(json.dumps({
        "kind": "open_loop", "rate_per_s": 3.0,
        "prompt": {"dist": "lognormal", "median": 1024, "sigma": 0.8, "min": 64, "max": 3072},
        "output": {"dist": "lognormal", "median": 192, "sigma": 0.7, "min": 16, "max": 1024},
        "check": {"sample_tokens": 600}}))
    (root / "benchmark/metrics/ttft_p50_s.py").write_text(
        "from benchmark.harness.readers import sent_in_window, ttft_s\n"
        "import numpy as np\n\n\n"
        "def read(run):\n"
        "    return float(np.percentile([ttft_s(run, r) for r in sent_in_window(run)], 50))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "mistral7b.burst", "config": "mistral-7b",
                               "traffic": "burst", "chips": 1, "why": "a later cell"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "mistral7b.chat" in m["workloads"]:
            m["workloads"].append("mistral7b.burst")
    bench["per_layer"].append({"name": "ttft_p50_s", "unit": "s", "better": "lower",
                               "source": "host_clock", "layer": "engine loop",
                               "moves": "ttft_p95_s", "workloads": ["mistral7b.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec.validate(root)
    cell = spec.load_cell("mistral7b.burst", root)
    assert cell.kind == "serve" and cell.traffic["rate_per_s"] == 3.0
    assert [m.name for m in cell.per_layer] == ["ttft_p50_s"]
    assert {m.name for m in cell.end_to_end} == {"ttft_p95_s", "tpot_p95_ms", "setup_s"}
    after = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()
             and p in before}
    assert after == before  # no file that was there changed


@pytest.mark.parametrize("breakage, message", [
    (lambda b: b["end_to_end"][0].update(bound=0.3), "bound"),
    (lambda b: b["configs"][0]["reduced"].append("hidden_size"), "width"),
    (lambda b: b["workloads"][0].update(traffic="nope"), "has no file"),
    (lambda b: b["per_layer"][0].update(moves="train_tokens_per_s"), "does not report"),
    (lambda b: b["per_layer"].append(dict(b["per_layer"][0], name="no.reader")), "no reader"),
    (lambda b: b["workloads"].append(dict(b["workloads"][0], name="x")), "pair appears twice"),
    (lambda b: b.update(run_seconds=60), "run_seconds"),
    (lambda b: b["end_to_end"][0].update(unit="tokens per s"), "unit"),
])
def test_validate_names_each_fault(tmp_path, breakage, message):
    root = _copy(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    breakage(bench)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(spec.SpecError, match=message):
        spec.validate(root)


def test_unknown_workload():
    with pytest.raises(spec.SpecError, match="unknown workload"):
        spec.load_cell("no.such.cell")
