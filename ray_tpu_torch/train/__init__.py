"""ray_tpu_torch.train — the LM training step on one device (port of
`ray_tpu.train.lm`)."""

from .lm import (  # noqa: F401
    Optimizer,
    TrainState,
    create_train_state,
    default_optimizer,
    global_norm,
    loss_and_grads,
    make_eval_step,
    make_train_step,
    tree_leaves,
)
