"""ray_tpu_torch.train — training on one device: the step (port of
`ray_tpu.train.lm`), `LMTrainer`, checkpoints, the step log, the train
configs, and the gang control plane (`Trainer`, `TrainController`,
`WorkerGroup`, the per-rank session) over the port's thread actors."""

from . import steplog  # noqa: F401
from .checkpoint import CheckpointManager, verify_step_dir, write_step_manifest  # noqa: F401
from .config import CheckpointConfig, FailureConfig, RunConfig, ScalingConfig  # noqa: F401
from .controller import Result, RunStatus, TrainController  # noqa: F401
from .lm import (  # noqa: F401
    Optimizer,
    TrainState,
    create_train_state,
    default_optimizer,
    global_norm,
    loss_and_grads,
    make_eval_step,
    make_train_step,
    train_state_from_numpy,
    tree_leaves,
)
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
