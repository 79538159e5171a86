"""ray_tpu_torch.rllib — reinforcement learning on the actor runtime.

Reference parity: Ray's rllib (Algorithm :202,
EnvRunner groups, algorithms/ppo + algorithms/dqn). Scoped to the
load-bearing core: vectorized envs, actor rollout workers, PPO (the
on-policy family) and double-DQN with replay (the off-policy family).

Port of `ray_tpu/rllib/__init__.py`: the same exports. The learners run on
the card unless their config asks for `device="cpu"`; the rollout workers
run their policies on the CPU.
"""

from .dqn import DQN, DQNConfig, DQNRolloutWorker, ReplayBuffer  # noqa: F401
from .env import CartPoleVectorEnv, VectorEnv, make_env, register_env  # noqa: F401
from .ppo import PPO, PPOConfig, RolloutWorker, init_policy, policy_forward  # noqa: F401
