"""Vectorized environments for the RL library.

Reference parity: rllib's EnvRunner/vector-env substrate
(rllib/env/ in Ray). No gym dependency: the
classic CartPole dynamics are implemented directly in numpy (same
physics constants as gym's CartPole-v1), vectorized over N lanes with
auto-reset — the standard benchmark env for "does the algorithm learn".

Port of `ray_tpu/rllib/env.py`, numpy only and unchanged: equal seeds and
actions give the same observations, rewards and dones, bit for bit.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np


class VectorEnv:
    """N independent env lanes stepped in lockstep, auto-resetting."""

    observation_dim: int
    num_actions: int

    def reset(self, seed: int = 0) -> np.ndarray:
        raise NotImplementedError

    def step(self, actions: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (obs (N, D), rewards (N,), dones (N,)); done lanes restart."""
        raise NotImplementedError


class CartPoleVectorEnv(VectorEnv):
    """CartPole-v1 physics (pole balancing; +1 reward per step, episode
    ends past ±12° / ±2.4 units / 500 steps)."""

    observation_dim = 4
    num_actions = 2
    max_steps = 500

    GRAVITY = 9.8
    CART_MASS = 1.0
    POLE_MASS = 0.1
    POLE_HALF_LEN = 0.5
    FORCE = 10.0
    DT = 0.02
    THETA_LIMIT = 12 * 2 * np.pi / 360
    X_LIMIT = 2.4

    def __init__(self, num_envs: int = 8):
        self.num_envs = num_envs
        self._state = np.zeros((num_envs, 4), np.float64)
        self._steps = np.zeros(num_envs, np.int64)
        self._rng = np.random.default_rng(0)

    def reset(self, seed: int = 0) -> np.ndarray:
        self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, size=(self.num_envs, 4))
        self._steps[:] = 0
        return self._state.astype(np.float32)

    def _reset_lanes(self, mask: np.ndarray) -> None:
        n = int(mask.sum())
        if n:
            self._state[mask] = self._rng.uniform(-0.05, 0.05, size=(n, 4))
            self._steps[mask] = 0

    def step(self, actions: np.ndarray):
        x, x_dot, theta, theta_dot = self._state.T
        force = np.where(actions == 1, self.FORCE, -self.FORCE)
        cos, sin = np.cos(theta), np.sin(theta)
        total_mass = self.CART_MASS + self.POLE_MASS
        pole_ml = self.POLE_MASS * self.POLE_HALF_LEN
        temp = (force + pole_ml * theta_dot**2 * sin) / total_mass
        theta_acc = (self.GRAVITY * sin - cos * temp) / (
            self.POLE_HALF_LEN * (4.0 / 3.0 - self.POLE_MASS * cos**2 / total_mass)
        )
        x_acc = temp - pole_ml * theta_acc * cos / total_mass
        x = x + self.DT * x_dot
        x_dot = x_dot + self.DT * x_acc
        theta = theta + self.DT * theta_dot
        theta_dot = theta_dot + self.DT * theta_acc
        self._state = np.stack([x, x_dot, theta, theta_dot], axis=1)
        self._steps += 1
        dones = (
            (np.abs(x) > self.X_LIMIT)
            | (np.abs(theta) > self.THETA_LIMIT)
            | (self._steps >= self.max_steps)
        )
        rewards = np.ones(self.num_envs, np.float32)
        self._reset_lanes(dones)
        return self._state.astype(np.float32), rewards, dones


_ENV_REGISTRY: Dict[str, Callable[[int], VectorEnv]] = {
    "cartpole": lambda n: CartPoleVectorEnv(n),
    "CartPole-v1": lambda n: CartPoleVectorEnv(n),
}


def register_env(name: str, factory: Callable[[int], VectorEnv]) -> None:
    _ENV_REGISTRY[name] = factory


def make_env(name: str, num_envs: int) -> VectorEnv:
    if name not in _ENV_REGISTRY:
        raise ValueError(f"unknown env {name!r}; register_env() it first")
    return _ENV_REGISTRY[name](num_envs)
