"""The gang phase of chip_smoke.py alone on one GPU: env, build, dp (its
references), gang.

    python3 chip_probes/gang_phase.py   (from the repository root)
"""
import json
import os
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

card = cs.phase_env()
cs.phase_build()
dp = cs.phase_dp(card)
gang = cs.phase_gang(card, dp)
print(json.dumps({"gang_launches": gang["launches"]}))
print(card, flush=True)
print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                         "count": torch.cuda.device_count()}}))
