"""DQN with double-Q targets: the off-policy value-learning family.

Reference parity: Ray's rllib DQN (rllib/algorithms/dqn/ —
EnvRunner actors feeding a replay buffer, a Learner applying TD updates,
periodic target-network sync).

Port of `ray_tpu/rllib/dqn.py`. Rollout workers are actors (`num_cpus=1`)
stepping numpy vector envs with the epsilon-greedy policy on the CPU (CPU
weights); each worker explores from one numpy generator seeded with its
seed (JAX seeds a fresh one every rollout from its PRNG key). The replay
buffer is JAX's flat numpy ring in the calling process, unchanged, and the learner
draws its `updates_per_iter` batches from a numpy `default_rng` as JAX's
does, so the batches are JAX's. Each train() runs those double-DQN Adam
steps (`dqn_update_k`) on `DQNConfig(device=...)`, the card by default,
and the target params sync by copy every `target_update_freq` updates.

    algo = DQNConfig(env="cartpole", num_workers=2).build()
    for _ in range(40):
        result = algo.train()
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .. import api
from .._device import resolve_device
from ..train.lm import AdamWState, Optimizer
from .env import make_env
from .ppo import adam, cpu_weights, learner_params

Params = Dict[str, torch.Tensor]


def init_q_network(seed: int, obs_dim: int, num_actions: int,
                   hidden: Tuple[int, ...] = (64, 64)) -> Params:
    """f32 CPU parameters drawn from a torch.Generator seeded with `seed`."""
    gen = torch.Generator().manual_seed(seed)
    params: Params = {}
    sizes = (obs_dim,) + tuple(hidden)
    for i in range(len(hidden)):
        params[f"w{i}"] = torch.randn(sizes[i], sizes[i + 1], generator=gen) * (
            1.0 / np.sqrt(sizes[i])
        )
        params[f"b{i}"] = torch.zeros(sizes[i + 1])
    params["w_q"] = torch.randn(hidden[-1], num_actions, generator=gen) * 0.01
    params["b_q"] = torch.zeros(num_actions)
    return params


def q_forward(params: Params, obs: torch.Tensor) -> torch.Tensor:
    """obs (..., D) -> Q-values (..., A)."""
    x = obs
    i = 0
    while f"w{i}" in params:
        x = torch.tanh(x @ params[f"w{i}"] + params[f"b{i}"])
        i += 1
    return x @ params["w_q"] + params["b_q"]


class DQNRolloutWorker:
    """Actor: epsilon-greedy steps of a vector env, returning flat
    transitions for the replay buffer (reference EnvRunner in the
    off-policy stack)."""

    def __init__(self, env_name: str, num_envs: int, rollout_len: int, seed: int):
        self.env = make_env(env_name, num_envs)
        self.rollout_len = rollout_len
        self.obs = self.env.reset(seed=seed)
        self._rng = np.random.default_rng(seed)
        self._episode_returns = np.zeros(num_envs, np.float32)
        self._finished: List[float] = []

    def set_weights(self, params: Params) -> None:
        self.params = params

    @torch.no_grad()
    def rollout(self, epsilon: float) -> Dict[str, np.ndarray]:
        T, N, D = self.rollout_len, self.env.num_envs, self.env.observation_dim
        obs_buf = np.zeros((T, N, D), np.float32)
        next_buf = np.zeros((T, N, D), np.float32)
        act_buf = np.zeros((T, N), np.int32)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), np.bool_)
        self._finished = []
        rng = self._rng
        for t in range(T):
            greedy = torch.argmax(q_forward(self.params, torch.from_numpy(self.obs)),
                                  dim=-1).numpy()
            explore = rng.random(N) < epsilon
            action = np.where(
                explore, rng.integers(0, self.env.num_actions, size=N), greedy
            ).astype(np.int32)
            obs_buf[t] = self.obs
            act_buf[t] = action
            self.obs, rewards, dones = self.env.step(action)
            # NOTE: auto-reset envs return the NEW episode's obs on done;
            # the TD target masks next-state value by (1 - done), so the
            # reset obs never leaks into a target
            next_buf[t] = self.obs
            rew_buf[t] = rewards
            done_buf[t] = dones
            self._episode_returns += rewards
            for i in np.nonzero(dones)[0]:
                self._finished.append(float(self._episode_returns[i]))
                self._episode_returns[i] = 0.0
        flat = T * N
        return {
            "obs": obs_buf.reshape(flat, D),
            "actions": act_buf.reshape(flat),
            "rewards": rew_buf.reshape(flat),
            "next_obs": next_buf.reshape(flat, D),
            "dones": done_buf.reshape(flat),
            "episode_returns": np.asarray(self._finished, np.float32),
        }


class ReplayBuffer:
    """Flat numpy ring (reference: replay_buffers/ in rllib utils)."""

    def __init__(self, capacity: int, obs_dim: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros(capacity, np.int32)
        self.rewards = np.zeros(capacity, np.float32)
        self.dones = np.zeros(capacity, np.bool_)
        self.size = 0
        self._pos = 0

    def add(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(batch["actions"])
        idx = (self._pos + np.arange(n)) % self.capacity
        self.obs[idx] = batch["obs"]
        self.next_obs[idx] = batch["next_obs"]
        self.actions[idx] = batch["actions"]
        self.rewards[idx] = batch["rewards"]
        self.dones[idx] = batch["dones"]
        self._pos = int((self._pos + n) % self.capacity)
        self.size = min(self.size + n, self.capacity)

    def sample(self, rng: np.random.Generator, n: int) -> Dict[str, np.ndarray]:
        idx = rng.integers(0, self.size, size=n)
        return {
            "obs": self.obs[idx],
            "next_obs": self.next_obs[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "dones": self.dones[idx].astype(np.float32),
        }


@dataclasses.dataclass
class DQNConfig:
    env: str = "cartpole"
    num_workers: int = 2
    num_envs_per_worker: int = 8
    rollout_len: int = 64
    buffer_size: int = 100_000
    batch_size: int = 256
    updates_per_iter: int = 32
    lr: float = 1e-3
    gamma: float = 0.99
    target_update_freq: int = 200  # in updates
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_iters: int = 30
    learning_starts: int = 1000  # transitions before updates begin
    hidden: Tuple[int, ...] = (64, 64)
    seed: int = 0
    # the learner's device; "cuda" raises without a card (pass "cpu")
    device: str = "cuda"

    def build(self) -> "DQN":
        return DQN(self)


def td_loss(params: Params, target_params: Params, batch: Dict[str, torch.Tensor],
            gamma: float) -> Tuple[torch.Tensor, torch.Tensor]:
    q = q_forward(params, batch["obs"])
    q_taken = q.gather(-1, batch["actions"][:, None].long())[:, 0]
    with torch.no_grad():
        # double DQN: online net picks the action, target net scores it
        next_act = torch.argmax(q_forward(params, batch["next_obs"]), dim=-1)
        next_q_target = q_forward(target_params, batch["next_obs"]).gather(
            -1, next_act[:, None])[:, 0]
    target = batch["rewards"] + gamma * (1.0 - batch["dones"]) * next_q_target
    td = q_taken - target
    return torch.mean(td * td), torch.mean(torch.abs(td)).detach()


def dqn_update_k(params: Params, target_params: Params, opt: Optimizer,
                 opt_state: AdamWState, batches: Dict[str, torch.Tensor],
                 gamma: float) -> Tuple[AdamWState, torch.Tensor, torch.Tensor]:
    """JAX's fused K updates, step by step: one Adam step on each of the
    (K, B, ...) `batches`. `params` are updated in place; returns the
    optimizer state, the last TD loss and the mean |TD| (device scalars)."""
    leaves = list(params.values())
    loss = None
    td_abs = []
    for k in range(batches["actions"].shape[0]):
        batch = {name: v[k] for name, v in batches.items()}
        loss, td = td_loss(params, target_params, batch, gamma)
        grads = torch.autograd.grad(loss, leaves)
        opt_state = opt.update(grads, opt_state, params)
        td_abs.append(td)
    return opt_state, loss.detach(), torch.stack(td_abs).mean()


class DQN:
    """Algorithm.train() parity for the off-policy family."""

    def __init__(self, config: DQNConfig):
        self.config = config
        env = make_env(config.env, 1)
        self.device = resolve_device(config.device)
        self.obs_dim = env.observation_dim
        self.num_actions = env.num_actions
        self.params = learner_params(
            init_q_network(config.seed, self.obs_dim, self.num_actions, config.hidden),
            self.device)
        self.target_params = {k: v.detach().clone() for k, v in self.params.items()}
        self.opt = adam(config.lr)
        self.opt_state = self.opt.init(self.params)
        self.buffer = ReplayBuffer(config.buffer_size, self.obs_dim)
        self._rng = np.random.default_rng(config.seed)
        self.iteration = 0
        self.num_updates = 0

        worker_cls = api.remote(DQNRolloutWorker)
        self.workers = [
            worker_cls.options(name=f"dqn-worker-{i}", num_cpus=1).remote(
                config.env, config.num_envs_per_worker, config.rollout_len,
                seed=config.seed * 1000 + i,
            )
            for i in range(config.num_workers)
        ]

    def _epsilon(self) -> float:
        c = self.config
        frac = min(1.0, self.iteration / max(1, c.eps_decay_iters))
        return float(c.eps_start + frac * (c.eps_end - c.eps_start))

    def sample_batches(self) -> Dict[str, torch.Tensor]:
        """The iteration's `updates_per_iter` replay batches, stacked
        (K, B, ...) on the learner's device (JAX's draws, in JAX's order)."""
        c = self.config
        ks = [self.buffer.sample(self._rng, c.batch_size) for _ in range(c.updates_per_iter)]
        return {k: torch.from_numpy(np.stack([b[k] for b in ks])).to(self.device)
                for k in ks[0]}

    def train(self) -> Dict[str, Any]:
        """One iteration: sync → epsilon-greedy rollouts → replay-sampled
        double-DQN updates → periodic target sync."""
        c = self.config
        t0 = time.perf_counter()
        eps = self._epsilon()
        weights = cpu_weights(self.params)
        api.get([w.set_weights.remote(weights) for w in self.workers])
        rollouts = api.get([w.rollout.remote(eps) for w in self.workers])
        for r in rollouts:
            self.buffer.add(r)
        episode_returns = np.concatenate(
            [r["episode_returns"] for r in rollouts]
        )
        loss = td_abs = float("nan")
        if self.buffer.size >= max(c.learning_starts, c.batch_size):
            self.opt_state, loss_t, td_t = dqn_update_k(
                self.params, self.target_params, self.opt, self.opt_state,
                self.sample_batches(), c.gamma)
            loss, td_abs = float(loss_t), float(td_t)
            prev = self.num_updates
            self.num_updates += c.updates_per_iter
            if self.num_updates // c.target_update_freq != prev // c.target_update_freq:
                self.target_params = {k: v.detach().clone() for k, v in self.params.items()}
        self.iteration += 1
        steps = c.num_workers * c.num_envs_per_worker * c.rollout_len
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": (
                float(episode_returns.mean())
                if episode_returns.size else float("nan")
            ),
            "episodes_this_iter": int(episode_returns.size),
            "timesteps_this_iter": steps,
            "buffer_size": self.buffer.size,
            "epsilon": eps,
            "td_loss": loss,
            "td_abs": td_abs,
            "num_updates": self.num_updates,
            "time_this_iter_s": time.perf_counter() - t0,
        }

    def stop(self) -> None:
        for w in self.workers:
            try:
                api.kill(w)
            except Exception:
                pass
