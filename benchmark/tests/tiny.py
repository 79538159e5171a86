"""A tiny copy of the benchmark for CPU tests: `benchmark/` and
BENCHMARK.json copied under a temporary root, the configurations shrunk
(a few layers of width 64, a vocabulary of 256, an engine of 4 slots) and
the traffic scaled to match. The serving model computes in float32 on
the CPU, so the program agrees with the reference exactly and the limits
here are small; training keeps bfloat16 compute."""

import json
import shutil
from pathlib import Path

from benchmark.harness import spec

TRAFFIC = {
    "chat": dict(rate_per_s=3.0,
                 prompt=dict(dist="lognormal", median=40, sigma=0.8, min=8, max=120),
                 output=dict(dist="lognormal", median=12, sigma=0.7, min=4, max=40)),
    "agent_shared_prefix": dict(rate_per_s=3.0, prefixes=dict(count=3, tokens=32, zipf_s=1.1),
                                user_turn=dict(dist="uniform", min=4, max=40),
                                output=dict(dist="uniform", min=4, max=30)),
    "offline_backlog": dict(prompt=dict(dist="uniform", min=16, max=80),
                            output=dict(dist="uniform", min=8, max=30)),
    "train_packed": dict(batch=2, seq=64, eot_id=255,
                         doc=dict(dist="lognormal", median=20, sigma=1.0, min=4, max=100)),
}


def _edit(path: Path, fn) -> None:
    data = json.loads(path.read_text())
    fn(data)
    path.write_text(json.dumps(data))


def tiny_root(tmp: Path) -> Path:
    root = Path(tmp) / "tiny"
    shutil.copytree(spec.repo_root() / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.repo_root() / "BENCHMARK.json", root / "BENCHMARK.json")
    cfg = root / "benchmark" / "configs"

    def mistral(c):
        c["model"].update(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                          d_ff=128, max_seq=256, dtype="float32", param_dtype="float32")
        c["engine"].update(max_slots=4, page_size=16, max_pages_per_slot=16, num_pages=65,
                           chunk_pages=2, decode_block_steps=4, max_inflight_blocks=2)
        c["check"]["limits"] = {"max_logit_gap": 1e-4}

    def gpt2(c):
        c["model"].update(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq=64)
        c["check"]["limits"] = {"loss_gap": 1e-3, "grad_gap": 0.05, "change_gap": 0.05}

    _edit(cfg / "mistral-7b.json", mistral)
    _edit(cfg / "gpt2-xl.json", gpt2)
    for name, update in TRAFFIC.items():
        def fn(t, update=update):
            t.update(update)
            if "check" in t:
                t["check"]["sample_tokens"] = 40
        _edit(root / "benchmark" / "traffic" / f"{name}.json", fn)
    return root
