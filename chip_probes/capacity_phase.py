"""The capacity phase of chip_smoke.py alone on one GPU: env, build,
capacity.

    python3 chip_probes/capacity_phase.py   (from the repository root)
"""
import json
import os
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

card = cs.phase_env()
cs.phase_build()
capacity = cs.phase_capacity(card)
print(json.dumps({"capacity_launches": capacity["launches"],
                  "by_part": capacity["by_part"]}))
print(card, flush=True)
print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                         "count": torch.cuda.device_count()}}))
