"""Train-layer configs: RunConfig, ScalingConfig, FailureConfig and
CheckpointConfig.

Port of `ray_tpu/train/config.py`. The gang fields (workers, elastic
sizing, restart budgets, session checkpoint retention) are read by the
gang `Trainer` and its `TrainController`; `LMTrainer` reads
`CheckpointConfig`. A worker's accelerator resource is the GPU where
JAX's is the TPU."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ..parallel.mesh import MeshSpec


@dataclasses.dataclass
class ScalingConfig:
    """Gang shape. The unit is a host driving its GPUs; the mesh spec
    describes how those devices form dp/fsdp/tp/... axes.

    min_workers enables ELASTIC scaling (reference v2 ScalingPolicy,
    scaling_policy.py:29): each (re)start sizes the gang to what the
    cluster can actually place, between min_workers and num_workers —
    a partial-slice failure shrinks the gang and training continues from
    the last checkpoint instead of waiting for capacity; a later restart
    grows back. The train_fn builds its mesh from the context's
    world_size, so re-meshing is one restart away."""

    num_workers: int = 1
    mesh: Optional[MeshSpec] = None
    resources_per_worker: Optional[Dict[str, float]] = None
    use_gpu: bool = False
    min_workers: Optional[int] = None  # None = fixed-size gang

    def worker_resources(self) -> Dict[str, float]:
        if self.resources_per_worker:
            return dict(self.resources_per_worker)
        return {"GPU": 1.0} if self.use_gpu else {"CPU": 1.0}


@dataclasses.dataclass
class FailureConfig:
    """Retry budget (reference DefaultFailurePolicy default.py:13).

    Preemption-triggered restarts are budgeted SEPARATELY: an announced
    node loss the run rode out cleanly (emergency checkpoint + restart on
    surviving nodes) is not a failure and must not burn max_failures —
    on spot-heavy fleets preemptions outnumber real crashes by orders of
    magnitude."""

    max_failures: int = 0  # 0 = fail fast; -1 = unlimited restarts
    max_preempt_restarts: int = -1  # -1 = unlimited (spot-fleet default)


@dataclasses.dataclass
class CheckpointConfig:
    checkpoint_dir: Optional[str] = None
    max_to_keep: int = 3
    checkpoint_every: int = 0  # steps; 0 = only on report(checkpoint=...)
    async_save: bool = False
    # retention for SESSION (pickle) checkpoints in the trial dir —
    # report(checkpoint=...) — distinct from the step checkpoints'
    # max_to_keep above; None falls back to the RAY_TPU_TRAIN_CKPT_KEEP
    # flag (default 2)
    session_keep: Optional[int] = None


@dataclasses.dataclass
class RunConfig:
    name: str = "train_run"
    storage_path: Optional[str] = None
    failure: FailureConfig = dataclasses.field(default_factory=FailureConfig)
    checkpoint: CheckpointConfig = dataclasses.field(default_factory=CheckpointConfig)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
