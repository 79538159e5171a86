"""The libraries phase of chip_smoke.py alone on one GPU: env, build,
libraries (Tune, RLlib, Workflow, the CLI and the dashboard).

    python3 chip_probes/libraries_phase.py   (from the repository root)
"""
import json
import os
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

card = cs.phase_env()
cs.phase_build()
libraries = cs.phase_libraries(card)
print(json.dumps({"libraries_launches": libraries["launches"],
                  "workflow_by_run": libraries["workflow_by_run"]}))
print(card, flush=True)
print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                         "count": torch.cuda.device_count()}}))
