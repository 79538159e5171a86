"""PPO: the flagship RL algorithm, with its learner on the card.

Reference parity: Ray's rllib PPO (rllib/algorithms/ppo/ —
Algorithm.train() :202 driving EnvRunner actors + a Learner).

Port of `ray_tpu/rllib/ppo.py`. Rollout workers are actors (`num_cpus=1`,
as in JAX) stepping numpy vector envs with the policy on the CPU: they
get the weights as CPU tensors and sample actions from a torch.Generator
seeded per worker (JAX's jitted rollout policy runs on the default device
and splits a PRNG key). The learner runs on `PPOConfig(device=...)`, the
card by default: GAE targets, then `num_epochs` x `num_minibatches`
clipped-surrogate Adam steps (optax.adam's: b1 0.9, b2 0.999, eps 1e-8, no
decay). `ppo_update` takes the epochs' minibatch permutations as an
argument; `PPO.train` draws them from a seeded torch.Generator on the
learner's device (JAX: `jax.random.permutation` inside the jitted update).

    algo = PPOConfig(env="cartpole", num_workers=2).build()
    for _ in range(20):
        result = algo.train()     # {"episode_reward_mean": ...}
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Tuple, Union

import numpy as np
import torch

from .. import api
from .._device import resolve_device
from ..train.lm import AdamWState, Optimizer
from .env import make_env

Params = Dict[str, torch.Tensor]


# ------------------------------------------------------------------- policy


def init_policy(seed: int, obs_dim: int, num_actions: int,
                hidden: Tuple[int, ...] = (64, 64)) -> Params:
    """MLP actor-critic: shared trunk, policy + value heads (f32, CPU,
    drawn from a torch.Generator seeded with `seed`)."""
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=gen)

    params: Params = {}
    sizes = (obs_dim,) + tuple(hidden)
    for i in range(len(hidden)):
        params[f"w{i}"] = normal(sizes[i], sizes[i + 1]) * (1.0 / np.sqrt(sizes[i]))
        params[f"b{i}"] = torch.zeros(sizes[i + 1])
    params["w_pi"] = normal(hidden[-1], num_actions) * 0.01
    params["b_pi"] = torch.zeros(num_actions)
    params["w_v"] = normal(hidden[-1], 1) * 1.0 / np.sqrt(hidden[-1])
    params["b_v"] = torch.zeros(1)
    return params


def params_from_numpy(tree: Dict[str, Any],
                      device: Union[str, torch.device] = "cpu") -> Params:
    """A flat dict of arrays (JAX's policy or Q-network params, via
    `jax.device_get`) as f32 tensors on `device`."""
    return {k: torch.tensor(np.asarray(v, np.float32), device=device) for k, v in tree.items()}


def policy_forward(params: Params, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """obs (..., D) -> (logits (..., A), value (...,))."""
    x = obs
    i = 0
    while f"w{i}" in params:
        x = torch.tanh(x @ params[f"w{i}"] + params[f"b{i}"])
        i += 1
    logits = x @ params["w_pi"] + params["b_pi"]
    value = (x @ params["w_v"] + params["b_v"])[..., 0]
    return logits, value


def adam(lr: float) -> Optimizer:
    """optax.adam(lr): `train.lm.Optimizer` with no clip and no decay."""
    return Optimizer(schedule=lambda _count: lr, b1=0.9, b2=0.999, eps=1e-8,
                     weight_decay=0.0, grad_clip=math.inf)


def learner_params(params: Params, device: torch.device) -> Params:
    """`params` on the learner's device, as leaves that take gradients
    (the optimizer updates them in place)."""
    return {k: v.detach().to(device, torch.float32).clone().requires_grad_() for k, v in
            params.items()}


def cpu_weights(params: Params) -> Params:
    """The weights a rollout worker gets: detached CPU copies."""
    return {k: v.detach().cpu() for k, v in params.items()}


# ------------------------------------------------------------------ rollout


class RolloutWorker:
    """Actor: steps a vector env with the latest policy, returns batches.
    (reference EnvRunner, rllib/env/env_runner.py)."""

    def __init__(self, env_name: str, num_envs: int, rollout_len: int, seed: int):
        self.env = make_env(env_name, num_envs)
        self.rollout_len = rollout_len
        self.obs = self.env.reset(seed=seed)
        self.seed = seed
        self._gen = torch.Generator().manual_seed(seed)
        self._episode_returns = np.zeros(num_envs, np.float32)
        self._finished_returns: List[float] = []

    def set_weights(self, params: Params) -> None:
        self.params = params

    @torch.no_grad()
    def rollout(self) -> Dict[str, np.ndarray]:
        T, N = self.rollout_len, self.env.num_envs
        obs_buf = np.zeros((T, N, self.env.observation_dim), np.float32)
        act_buf = np.zeros((T, N), np.int32)
        logp_buf = np.zeros((T, N), np.float32)
        val_buf = np.zeros((T, N), np.float32)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), np.bool_)
        self._finished_returns = []
        for t in range(T):
            action, logp, value = _sample_action(self.params, torch.from_numpy(self.obs),
                                                 self._gen)
            action = action.numpy().astype(np.int32)
            obs_buf[t] = self.obs
            act_buf[t] = action
            logp_buf[t] = logp.numpy()
            val_buf[t] = value.numpy()
            self.obs, rewards, dones = self.env.step(action)
            rew_buf[t] = rewards
            done_buf[t] = dones
            self._episode_returns += rewards
            for i in np.nonzero(dones)[0]:
                self._finished_returns.append(float(self._episode_returns[i]))
                self._episode_returns[i] = 0.0
        _, last_value = policy_forward(self.params, torch.from_numpy(self.obs))
        return {
            "obs": obs_buf,
            "actions": act_buf,
            "logp": logp_buf,
            "values": val_buf,
            "rewards": rew_buf,
            "dones": done_buf,
            "last_value": last_value.numpy(),
            "episode_returns": np.asarray(self._finished_returns, np.float32),
        }


def _sample_action(params, obs, gen):
    logits, value = policy_forward(params, obs)
    logp_all = torch.log_softmax(logits, dim=-1)
    action = torch.multinomial(logp_all.exp(), 1, generator=gen)[:, 0]
    logp = logp_all.gather(-1, action[:, None])[:, 0]
    return action, logp, value


# ---------------------------------------------------------------- algorithm


@dataclasses.dataclass
class PPOConfig:
    env: str = "cartpole"
    num_workers: int = 2
    num_envs_per_worker: int = 8
    rollout_len: int = 128
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coeff: float = 0.01
    value_coeff: float = 0.5
    num_epochs: int = 4
    num_minibatches: int = 4
    hidden: Tuple[int, ...] = (64, 64)
    seed: int = 0
    # the learner's device; "cuda" raises without a card (pass "cpu")
    device: str = "cuda"

    def build(self) -> "PPO":
        return PPO(self)


def compute_gae(rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor,
                last_value: torch.Tensor, gamma: float, gae_lambda: float) -> torch.Tensor:
    """Advantages of (..., T, N) rollouts (last_value (..., N)): JAX's
    backward scan, one time step at a time."""
    next_values = torch.cat([values[..., 1:, :], last_value[..., None, :]], dim=-2)
    nonterminal = 1.0 - dones.to(torch.float32)
    advantages = torch.empty_like(rewards)
    gae = torch.zeros_like(last_value)
    for t in reversed(range(rewards.shape[-2])):
        delta = (rewards[..., t, :] + gamma * next_values[..., t, :] * nonterminal[..., t, :]
                 - values[..., t, :])
        gae = delta + gamma * gae_lambda * nonterminal[..., t, :] * gae
        advantages[..., t, :] = gae
    return advantages


def ppo_loss(params: Params, batch: Dict[str, torch.Tensor], c: PPOConfig):
    logits, values = policy_forward(params, batch["obs"])
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, batch["actions"][:, None].long())[:, 0]
    ratio = torch.exp(logp - batch["logp"])
    adv = batch["advantages"]
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - c.clip_eps, 1 + c.clip_eps) * adv
    policy_loss = -torch.minimum(unclipped, clipped).mean()
    value_loss = torch.mean((values - batch["returns"]) ** 2)
    entropy = -torch.sum(torch.exp(logp_all) * logp_all, dim=-1).mean()
    total = policy_loss + c.value_coeff * value_loss - c.entropy_coeff * entropy
    return total, (policy_loss, value_loss, entropy)


def ppo_update(params: Params, opt: Optimizer, opt_state: AdamWState,
               rollouts: Dict[str, torch.Tensor], perms: torch.Tensor,
               c: PPOConfig) -> Tuple[AdamWState, Dict[str, torch.Tensor]]:
    """JAX's fused update, step by step: GAE over the stacked (W, T, N, ...)
    rollouts, then for each epoch e the minibatches of `perms[e]` (a
    permutation of the W x T x N samples), one Adam step each. `params`
    are updated in place; returns the optimizer state and the last
    minibatch's losses (device scalars)."""
    obs = rollouts["obs"]
    W, T, N = obs.shape[0], obs.shape[1], obs.shape[2]
    with torch.no_grad():
        adv = compute_gae(rollouts["rewards"], rollouts["values"], rollouts["dones"],
                          rollouts["last_value"], c.gamma, c.gae_lambda)
        returns = adv + rollouts["values"]
    flat = {
        "obs": obs.reshape(W * T * N, -1),
        "actions": rollouts["actions"].reshape(-1),
        "logp": rollouts["logp"].reshape(-1),
        "advantages": adv.reshape(-1),
        "returns": returns.reshape(-1),
    }
    mb = (W * T * N) // c.num_minibatches
    leaves = list(params.values())
    aux = None
    for perm in perms:
        for i in range(c.num_minibatches):
            take = perm[i * mb:(i + 1) * mb]
            batch = {k: v[take] for k, v in flat.items()}
            total, aux = ppo_loss(params, batch, c)
            grads = torch.autograd.grad(total, leaves)
            opt_state = opt.update(grads, opt_state, params)
    policy_loss, value_loss, entropy = (x.detach() for x in aux)
    return opt_state, {"policy_loss": policy_loss, "value_loss": value_loss,
                       "entropy": entropy}


class PPO:
    """Algorithm.train() parity (reference rllib/algorithms/algorithm.py:202)."""

    def __init__(self, config: PPOConfig):
        self.config = config
        env = make_env(config.env, 1)
        self.device = resolve_device(config.device)
        self.obs_dim = env.observation_dim
        self.num_actions = env.num_actions
        self.params = learner_params(
            init_policy(config.seed, self.obs_dim, self.num_actions, config.hidden),
            self.device)
        self.opt = adam(config.lr)
        self.opt_state = self.opt.init(self.params)
        self._gen = torch.Generator(device=self.device).manual_seed(config.seed + 1)
        self.iteration = 0

        worker_cls = api.remote(RolloutWorker)
        self.workers = [
            worker_cls.options(name=f"ppo-worker-{i}", num_cpus=1).remote(
                config.env, config.num_envs_per_worker, config.rollout_len,
                seed=config.seed * 1000 + i,
            )
            for i in range(config.num_workers)
        ]

    def draw_permutations(self) -> torch.Tensor:
        """The epochs' minibatch permutations, (num_epochs, W x T x N)."""
        c = self.config
        n = c.num_workers * c.num_envs_per_worker * c.rollout_len
        return torch.stack([torch.randperm(n, generator=self._gen, device=self.device)
                            for _ in range(c.num_epochs)])

    def train(self) -> Dict[str, Any]:
        """One iteration: sync weights → parallel rollouts → the update."""
        t0 = time.perf_counter()
        weights = cpu_weights(self.params)
        api.get([w.set_weights.remote(weights) for w in self.workers])
        rollouts = api.get([w.rollout.remote() for w in self.workers])
        stacked = {
            k: torch.from_numpy(np.stack([r[k] for r in rollouts])).to(self.device)
            for k in ("obs", "actions", "logp", "values", "rewards", "dones",
                      "last_value")
        }
        episode_returns = np.concatenate(
            [r["episode_returns"] for r in rollouts]
        )
        self.opt_state, losses = ppo_update(self.params, self.opt, self.opt_state, stacked,
                                            self.draw_permutations(), self.config)
        self.iteration += 1
        c = self.config
        steps = c.num_workers * c.num_envs_per_worker * c.rollout_len
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": (
                float(episode_returns.mean()) if episode_returns.size else float("nan")
            ),
            "episodes_this_iter": int(episode_returns.size),
            "timesteps_this_iter": steps,
            "time_this_iter_s": time.perf_counter() - t0,
            **{k: float(v) for k, v in losses.items()},
        }

    def stop(self) -> None:
        for w in self.workers:
            try:
                api.kill(w)
            except Exception:
                pass
