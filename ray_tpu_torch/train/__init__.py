"""ray_tpu_torch.train — LM training on one device: the step (port of
`ray_tpu.train.lm`), `LMTrainer`, checkpoints, the step log and the
train configs."""

from . import steplog  # noqa: F401
from .checkpoint import CheckpointManager, verify_step_dir, write_step_manifest  # noqa: F401
from .config import CheckpointConfig, FailureConfig, RunConfig, ScalingConfig  # noqa: F401
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
from .trainer import LMTrainer  # noqa: F401
