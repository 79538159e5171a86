"""The cluster and head_restart phases of chip_smoke.py alone on one GPU:
env, build, then both phases (head_restart goes on with the cluster
phase's members) with the serve phase's prompts (made from the seed as
phase_serve makes them).

    python3 chip_probes/head_restart_phase.py   (from the repository root)
"""
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from ray_tpu_torch.models import get_config  # noqa: E402

card = cs.phase_env()
cs.phase_build()
config = get_config(cs.MODEL)
rng = np.random.default_rng(cs.SEED)
lengths = np.linspace(64, 900, cs.N_REQUESTS).astype(int)
prompts = [rng.integers(0, config.vocab_size, n).tolist() for n in lengths]
cluster, members, llm, agent = cs.phase_cluster(card, config, prompts)
out = cs.phase_head_restart(card, prompts, members, llm, agent)
print(json.dumps({"cluster_launches": cluster["launches"],
                  "head_restart_launches": out["launches"], "seconds": out["seconds"],
                  "restarts": [{k: v for k, v in r.items() if not k.endswith("_t")}
                               for r in out["restarts"]],
                  "windows": out["windows"], "capture": out["capture"]}))
print(card, flush=True)
print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                         "count": torch.cuda.device_count()}}))
