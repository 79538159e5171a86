"""ray_tpu_torch.train — training: the step (port of `ray_tpu.train.lm`,
on one device or data-parallel over a mesh's ranks), `LMTrainer`,
checkpoints, the step log, the train configs, and the gang control plane
(`Trainer`, `TrainController`, `WorkerGroup` over the port's thread
actors, `MultihostWorkerGroup` over one process per rank, the per-rank
session)."""

from . import steplog  # noqa: F401
from .checkpoint import CheckpointManager, verify_step_dir, write_step_manifest  # noqa: F401
from .config import CheckpointConfig, FailureConfig, RunConfig, ScalingConfig  # noqa: F401
from .controller import Result, RunStatus, TrainController  # noqa: F401
from .lm import (  # noqa: F401
    Optimizer,
    TrainState,
    clip_by_global_norm_sharded,
    create_train_state,
    default_optimizer,
    global_norm,
    infer_state_specs,
    loss_and_grads,
    make_eval_step,
    make_train_step,
    state_specs,
    train_state_from_numpy,
    tree_leaves,
)
from .multihost import MultihostWorkerGroup  # noqa: F401
from .session import (  # noqa: F401
    get_checkpoint,
    get_context,
    get_dataset_shard,
    get_session,
    is_preempted,
    list_checkpoints,
    load_trial_checkpoint,
    report,
    should_checkpoint,
    verify_checkpoint,
)
from .trainer import LMTrainer, Trainer  # noqa: F401
from .worker_group import TrainWorker, WorkerGroup  # noqa: F401
