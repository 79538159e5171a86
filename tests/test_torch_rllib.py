"""The port's RLlib against the JAX package.

A port of `tests/test_rllib.py` (learners on `device="cpu"`), plus parity
on the same numpy inputs: CartPole trajectories and the replay buffer's
ring and samples bit for bit; `policy_forward`, `q_forward` and GAE at f32
to 1e-6; one PPO update fed JAX's `jax.random.permutation` draws and one
DQN `update_k` on the same batches against JAX's jitted updates (from the
same parameters and optax.adam state): parameters and losses to 1e-4
after 16 and 8 Adam steps. The learners default to the card.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu.rllib as jrl
import ray_tpu.rllib.dqn as jdqn
import ray_tpu.rllib.ppo as jppo
import ray_tpu_torch
from ray_tpu_torch.rllib import (
    CartPoleVectorEnv,
    DQNConfig,
    PPOConfig,
    ReplayBuffer,
    policy_forward,
    register_env,
)
from ray_tpu_torch.rllib import dqn as tdqn
from ray_tpu_torch.rllib import ppo as tppo

F32_TOL = dict(rtol=1e-6, atol=1e-6)
ADAM_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _cluster():
    ray_tpu_torch.init(num_cpus=8, detect_accelerators=False)
    yield
    ray_tpu_torch.shutdown()


def _close(mine, ref, tol):
    np.testing.assert_allclose(np.asarray(mine.detach().cpu() if isinstance(mine, torch.Tensor)
                                          else mine), np.asarray(ref), **tol)


# ------------------------------------------------------- parity with JAX's


def test_cartpole_trajectories_match_jax_bitwise():
    mine, ref = CartPoleVectorEnv(num_envs=6), jrl.CartPoleVectorEnv(num_envs=6)
    assert np.array_equal(mine.reset(seed=3), ref.reset(seed=3))
    actions = np.random.default_rng(0).integers(0, 2, size=(400, 6))
    for a in actions:
        for x, y in zip(mine.step(a), ref.step(a)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    assert np.array_equal(mine._state, ref._state)


def test_replay_buffer_ring_and_samples_match_jax_bitwise():
    rng = np.random.default_rng(4)
    mine, ref = ReplayBuffer(capacity=37, obs_dim=3), jrl.ReplayBuffer(capacity=37, obs_dim=3)
    for n in (5, 20, 13, 30, 1):
        batch = {"obs": rng.standard_normal((n, 3)).astype(np.float32),
                 "next_obs": rng.standard_normal((n, 3)).astype(np.float32),
                 "actions": rng.integers(0, 2, n).astype(np.int32),
                 "rewards": rng.standard_normal(n).astype(np.float32),
                 "dones": rng.random(n) < 0.2}
        mine.add(batch)
        ref.add(batch)
        assert (mine.size, mine._pos) == (ref.size, ref._pos)
        a, b = mine.sample(np.random.default_rng(n), 16), ref.sample(np.random.default_rng(n), 16)
        assert a.keys() == b.keys()
        assert all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def _jax_policy(seed=0):
    return jax.device_get(jppo.init_policy(jax.random.PRNGKey(seed), 4, 2))


def _jax_qnet(seed=0):
    return jax.device_get(jdqn.init_q_network(jax.random.PRNGKey(seed), 4, 2))


def test_forwards_match_jax():
    obs = np.random.default_rng(1).standard_normal((7, 5, 4)).astype(np.float32)
    jp = _jax_policy()
    logits, value = jppo.policy_forward(jp, jnp.asarray(obs))
    mlogits, mvalue = policy_forward(tppo.params_from_numpy(jp), torch.from_numpy(obs))
    _close(mlogits, logits, F32_TOL)
    _close(mvalue, value, F32_TOL)
    jq = _jax_qnet()
    _close(tdqn.q_forward(tppo.params_from_numpy(jq), torch.from_numpy(obs)),
           jdqn.q_forward(jq, jnp.asarray(obs)), F32_TOL)
    # the port's own init: the same shapes and scales, drawn from torch
    mine = tppo.init_policy(0, 4, 2)
    assert {k: tuple(v.shape) for k, v in mine.items()} == {k: v.shape for k, v in jp.items()}
    assert {k: tuple(v.shape) for k, v in tdqn.init_q_network(0, 4, 2).items()} == \
        {k: v.shape for k, v in jq.items()}


def _rollouts(W=2, T=16, N=4, seed=2):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.standard_normal((W, T, N, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, (W, T, N)).astype(np.int32),
        "logp": np.log(rng.uniform(0.3, 0.7, (W, T, N))).astype(np.float32),
        "values": rng.standard_normal((W, T, N)).astype(np.float32),
        "rewards": np.ones((W, T, N), np.float32),
        "dones": rng.random((W, T, N)) < 0.1,
        "last_value": rng.standard_normal((W, N)).astype(np.float32),
    }


def _jax_update(cls, config):
    fake = types.SimpleNamespace(config=config, opt=optax.adam(config.lr))
    return fake.opt, cls._make_update(fake)


def test_gae_matches_jax():
    config = jppo.PPOConfig(gamma=0.97, gae_lambda=0.9)
    _, update = _jax_update(jppo.PPO, config)
    compute_gae = update.__closure__[update.__code__.co_freevars.index("compute_gae")].cell_contents
    r = _rollouts()
    ref = jax.vmap(compute_gae)(r["rewards"], r["values"], r["dones"], r["last_value"])
    t = {k: torch.from_numpy(v) for k, v in r.items()}
    mine = tppo.compute_gae(t["rewards"], t["values"], t["dones"], t["last_value"], 0.97, 0.9)
    _close(mine, ref, F32_TOL)


def test_one_ppo_update_with_jax_permutations_matches_jax():
    config = jppo.PPOConfig(lr=3e-3, num_epochs=4, num_minibatches=4)
    opt, update = _jax_update(jppo.PPO, config)
    jp = _jax_policy(5)
    r = _rollouts()
    key = jax.random.PRNGKey(9)
    B = 2 * 16 * 4
    perms = np.stack([np.asarray(jax.random.permutation(k, B))
                      for k in jax.random.split(key, config.num_epochs)])
    ref_params, _, ref_losses = jax.jit(update)(jp, opt.init(jp), key, r)

    tconfig = PPOConfig(lr=3e-3, num_epochs=4, num_minibatches=4, device="cpu")
    params = tppo.learner_params(tppo.params_from_numpy(jp), torch.device("cpu"))
    topt = tppo.adam(tconfig.lr)
    state = topt.init(params)
    rollouts = {k: torch.from_numpy(v) for k, v in r.items()}
    state, losses = tppo.ppo_update(params, topt, state, rollouts, torch.from_numpy(perms),
                                    tconfig)
    assert state.count == config.num_epochs * config.num_minibatches
    for k in jp:
        _close(params[k], ref_params[k], ADAM_TOL)
    for k in ("policy_loss", "value_loss", "entropy"):
        _close(losses[k], ref_losses[k], ADAM_TOL)


def test_one_dqn_update_k_matches_jax():
    config = jdqn.DQNConfig(lr=1e-3, gamma=0.98)
    opt, update_k = _jax_update(jdqn.DQN, config)
    jq, jt = _jax_qnet(1), _jax_qnet(2)
    buf = jrl.ReplayBuffer(capacity=500, obs_dim=4)
    rng = np.random.default_rng(6)
    n = 400
    buf.add({"obs": rng.standard_normal((n, 4)).astype(np.float32),
             "next_obs": rng.standard_normal((n, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, n).astype(np.int32),
             "rewards": rng.standard_normal(n).astype(np.float32),
             "dones": rng.random(n) < 0.1})
    draw = np.random.default_rng(0)
    ks = [buf.sample(draw, 32) for _ in range(8)]
    batches = {k: np.stack([b[k] for b in ks]) for k in ks[0]}
    ref_params, _, ref_loss, ref_td = jax.jit(update_k)(
        jq, jt, opt.init(jq), {k: jnp.asarray(v) for k, v in batches.items()})

    params = tppo.learner_params(tppo.params_from_numpy(jq), torch.device("cpu"))
    target = tppo.params_from_numpy(jt)
    topt = tppo.adam(config.lr)
    state, loss, td = tdqn.dqn_update_k(params, target, topt, topt.init(params),
                                        {k: torch.from_numpy(v) for k, v in batches.items()},
                                        config.gamma)
    assert state.count == 8
    for k in jq:
        _close(params[k], ref_params[k], ADAM_TOL)
    _close(loss, ref_loss, ADAM_TOL)
    _close(td, ref_td, ADAM_TOL)


def test_dqn_learner_draws_jax_batches():
    """The learner's replay draws are JAX's: the same buffer and seed give
    the same (K, B, ...) batches, on the learner's device."""
    algo = DQNConfig(num_workers=1, num_envs_per_worker=2, rollout_len=4, batch_size=8,
                     updates_per_iter=3, seed=4, device="cpu").build()
    try:
        ref = jrl.ReplayBuffer(capacity=algo.config.buffer_size, obs_dim=4)
        rng = np.random.default_rng(8)
        batch = {"obs": rng.standard_normal((50, 4)).astype(np.float32),
                 "next_obs": rng.standard_normal((50, 4)).astype(np.float32),
                 "actions": rng.integers(0, 2, 50).astype(np.int32),
                 "rewards": rng.standard_normal(50).astype(np.float32),
                 "dones": rng.random(50) < 0.1}
        algo.buffer.add(batch)
        ref.add(batch)
        mine = algo.sample_batches()
        draw = np.random.default_rng(4)
        ks = [ref.sample(draw, 8) for _ in range(3)]
        for k in ks[0]:
            assert np.array_equal(mine[k].numpy(), np.stack([b[k] for b in ks]))
    finally:
        algo.stop()


def test_learners_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    for config in (PPOConfig(num_workers=1), DQNConfig(num_workers=1)):
        assert config.device == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            config.build()


# --------------------------------------------- tests/test_rllib.py, ported


def test_cartpole_env_basics():
    env = CartPoleVectorEnv(num_envs=4)
    obs = env.reset(seed=0)
    assert obs.shape == (4, 4)
    total_dones = 0
    for _ in range(300):
        obs, rewards, dones = env.step(np.random.randint(0, 2, size=4))
        assert rewards.shape == (4,) and (rewards == 1.0).all()
        total_dones += int(dones.sum())
    assert total_dones >= 4
    assert np.isfinite(obs).all()


def test_random_policy_baseline_short_episodes():
    env = CartPoleVectorEnv(num_envs=8)
    env.reset(seed=1)
    lengths = []
    steps = np.zeros(8)
    for _ in range(500):
        _, _, dones = env.step(np.random.randint(0, 2, size=8))
        steps += 1
        for i in np.nonzero(dones)[0]:
            lengths.append(steps[i])
            steps[i] = 0
    assert 5 < np.mean(lengths) < 60


def test_ppo_learns_cartpole():
    """The end-to-end RL story: PPO must clearly beat the random baseline."""
    algo = PPOConfig(
        env="cartpole", num_workers=2, num_envs_per_worker=8,
        rollout_len=128, lr=3e-3, num_epochs=4, seed=0, device="cpu",
    ).build()
    try:
        first = None
        result = None
        for _ in range(25):
            result = algo.train()
            if first is None and result["episodes_this_iter"] > 0:
                first = result["episode_reward_mean"]
        assert result["training_iteration"] == 25
        assert result["timesteps_this_iter"] == 2 * 8 * 128
        assert result["episode_reward_mean"] > max(60.0, 2 * first), (
            first, result["episode_reward_mean"]
        )
    finally:
        algo.stop()


def test_custom_env_registration():
    class ConstantEnv(CartPoleVectorEnv):
        pass

    register_env("constant", lambda n: ConstantEnv(n))
    algo = PPOConfig(env="constant", num_workers=1, num_envs_per_worker=2,
                     rollout_len=8, device="cpu").build()
    try:
        result = algo.train()
        assert result["timesteps_this_iter"] == 16
    finally:
        algo.stop()

    with pytest.raises(ValueError, match="unknown env"):
        PPOConfig(env="nope", device="cpu").build()


def test_dqn_learns_cartpole():
    """The off-policy family: double-DQN with replay must clearly beat
    the random baseline."""
    algo = DQNConfig(
        env="cartpole", num_workers=2, num_envs_per_worker=8,
        rollout_len=64, lr=1e-3, updates_per_iter=48,
        learning_starts=512, eps_decay_iters=12, seed=0, device="cpu",
    ).build()
    try:
        result = None
        recent = []
        for _ in range(30):
            result = algo.train()
            if result["episodes_this_iter"] > 0:
                recent.append(result["episode_reward_mean"])
        assert result["training_iteration"] == 30
        assert result["buffer_size"] > 512
        assert result["num_updates"] > 0
        tail = float(np.mean(recent[-5:]))
        assert tail > 60.0, (recent[:5], recent[-5:])
    finally:
        algo.stop()


def test_dqn_replay_buffer_ring():
    buf = ReplayBuffer(capacity=10, obs_dim=2)
    batch = {
        "obs": np.arange(8).reshape(4, 2).astype(np.float32),
        "next_obs": np.zeros((4, 2), np.float32),
        "actions": np.arange(4, dtype=np.int32),
        "rewards": np.ones(4, np.float32),
        "dones": np.zeros(4, np.bool_),
    }
    for _ in range(4):
        buf.add(batch)
    assert buf.size == 10
    s = buf.sample(np.random.default_rng(0), 6)
    assert s["obs"].shape == (6, 2) and s["dones"].dtype == np.float32
