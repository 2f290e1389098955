"""Sharded PPO learner tests (CPU mesh of 8 virtual devices)."""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sustaingym_tpu import make
from sustaingym_tpu.parallel import (PPOConfig, init_policy, make_mesh,
                                     policy_apply, train)
from sustaingym_tpu.parallel.ppo import _shard_carry, make_train_step
from sustaingym_tpu.parallel.mesh import data_sharding, replicated


def test_policy_shapes():
    p = init_policy(jax.random.PRNGKey(0), obs_dim=10, act_dim=6, hidden=32)
    mu, log_std, v = policy_apply(p, jnp.zeros((4, 10)))
    assert mu.shape == (4, 6) and log_std.shape == (6,) and v.shape == (4,)


def test_train_step_runs_and_updates():
    env, params = make("building")
    cfg = PPOConfig(num_envs=16, rollout_len=8, hidden=32, epochs=1,
                    minibatches=2)
    init_state, train_step = make_train_step(env, params, cfg)
    carry = init_state(jax.random.PRNGKey(0))
    before = np.asarray(carry["policy"]["mu"]["w"]).copy()
    carry, metrics = jax.jit(train_step)(carry, jax.random.PRNGKey(1))
    after = np.asarray(carry["policy"]["mu"]["w"])
    assert not np.allclose(before, after)
    assert np.isfinite(metrics["mean_reward"])


class _QuadTrackEnv:
    """Minimal stationary env with a deterministic learnable optimum:
    reward = -||action - 0.3 * obs||^2. Validates the PPO update math
    end-to-end without BuildingEnv's weather-episode reward variance."""

    from sustaingym_tpu.core import Box, TimeStep

    def __init__(self, dim=4):
        self.dim = dim

    def observation_space(self, params):
        from sustaingym_tpu.core import Box
        return Box(-1, 1, (self.dim,))

    def action_space(self, params):
        from sustaingym_tpu.core import Box
        return Box(-1, 1, (self.dim,))

    def reset(self, params, key):
        from sustaingym_tpu.core import TimeStep
        obs = jax.random.uniform(key, (self.dim,), minval=-1, maxval=1)
        ts = TimeStep(obs=obs, reward=jnp.zeros(()),
                      terminated=jnp.zeros((), bool),
                      truncated=jnp.zeros((), bool), info={})
        return obs, ts

    def step(self, params, state, action, key):
        from sustaingym_tpu.core import TimeStep
        reward = -jnp.sum((action - 0.3 * state) ** 2)
        obs = jax.random.uniform(key, (self.dim,), minval=-1, maxval=1)
        ts = TimeStep(obs=obs, reward=reward,
                      terminated=jnp.zeros((), bool),
                      truncated=jnp.zeros((), bool), info={})
        return obs, ts


def test_ppo_learns_quadratic_tracking():
    env = _QuadTrackEnv()
    cfg = PPOConfig(num_envs=64, rollout_len=16, hidden=32, epochs=4,
                    minibatches=4, lr=3e-3, gamma=0.0, lam=0.0)
    carry, history = train(env, None, cfg, jax.random.PRNGKey(0),
                           num_iterations=25, verbose=False)
    first = np.mean([h["mean_reward"] for h in history[:3]])
    last = np.mean([h["mean_reward"] for h in history[-3:]])
    assert last > first + 0.2, (first, last)


def test_sharded_train_step_matches_mesh():
    n = len(jax.devices())
    assert n == 8, "conftest should provide 8 virtual CPU devices"
    mesh = make_mesh(8, mp=2)
    env, params = make("building")
    cfg = PPOConfig(num_envs=16, rollout_len=4, hidden=64, epochs=1,
                    minibatches=2)
    init_state, train_step = make_train_step(env, params, cfg)
    carry = init_state(jax.random.PRNGKey(0))
    carry = _shard_carry(carry, mesh, data_sharding(mesh), replicated(mesh))
    # hidden axis of trunk1 sharded over mp
    sh = carry["policy"]["trunk1"]["w"].sharding
    assert "mp" in str(sh.spec)
    carry, metrics = jax.jit(train_step)(carry, jax.random.PRNGKey(1))
    assert np.isfinite(float(metrics["mean_reward"]))


def test_ppo_multiagent_ev_smoke():
    """Shared-policy PPO over the agent-axis MA EV view: the agent axis is
    extra batch, act_dim is per-agent (the batched analogue of the
    reference's per-agent RLLib policies, train_rllib.py:119-132)."""
    import sustaingym_tpu as sg
    from sustaingym_tpu.parallel import PPOConfig
    from sustaingym_tpu.parallel.ppo import make_train_step

    env, params = sg.make("evcharging-multiagent", periods_delay=1,
                          project_action=False)
    cfg = PPOConfig(num_envs=4, rollout_len=6, hidden=32, epochs=1,
                    minibatches=2)
    init_state, train_step = make_train_step(env, params, cfg)
    carry = init_state(jax.random.PRNGKey(0))
    n_agents = params.base.n_stations
    assert carry["obs"].shape[1] == n_agents
    carry, metrics = jax.jit(train_step)(carry, jax.random.PRNGKey(1))
    assert np.isfinite(float(metrics["pg_loss"]))
    assert np.isfinite(float(metrics["mean_reward"]))


def test_ppo_multiagent_building_smoke():
    import sustaingym_tpu as sg
    from sustaingym_tpu.parallel import PPOConfig
    from sustaingym_tpu.parallel.ppo import make_train_step

    env, params = sg.make("building-multiagent")
    cfg = PPOConfig(num_envs=4, rollout_len=5, hidden=32, epochs=1,
                    minibatches=1)
    init_state, train_step = make_train_step(env, params, cfg)
    carry = init_state(jax.random.PRNGKey(0))
    carry, metrics = jax.jit(train_step)(carry, jax.random.PRNGKey(1))
    assert np.isfinite(float(metrics["mean_reward"]))


def test_ppo_multiagent_ev_sharded_mesh():
    """The BASELINE ladder's top config: multi-agent EVCharging sharded over
    a device mesh feeding the PPO learner — env batch + trajectories over
    'dp', tensor-parallel MLP over 'mp' (8 virtual CPU devices in CI; the
    identical program spans real hosts via jax.distributed)."""
    import sustaingym_tpu as sg

    env, params = sg.make("evcharging-multiagent", periods_delay=1,
                          project_action=False)
    cfg = PPOConfig(num_envs=16, rollout_len=4, hidden=32, epochs=1,
                    minibatches=2)
    init_state, train_step = make_train_step(env, params, cfg)
    carry = init_state(jax.random.PRNGKey(0))
    mesh = make_mesh(8, mp=2)
    carry = _shard_carry(carry, mesh, data_sharding(mesh), replicated(mesh))
    carry, metrics = jax.jit(train_step, donate_argnums=0)(
        carry, jax.random.PRNGKey(1))
    assert np.isfinite(float(metrics["pg_loss"]))


def test_ppo_multiagent_cogen_per_agent_policies():
    """Heterogeneous multi-agent cogen trains NATIVELY: one policy per agent
    (stacked params vmapped over the agent axis, ST's padded 4th action slot
    masked), matching the reference's per-agent RLLib PolicySpec semantics
    (/root/reference/examples/cogen/train_rllib.py:119-132)."""
    import sustaingym_tpu as sg
    from sustaingym_tpu.envs.multiagent import COGEN_AGENTS, COGEN_PAD_DIM

    env, params = sg.make("cogen-multiagent")
    cfg = PPOConfig(num_envs=8, rollout_len=6, hidden=32, epochs=1,
                    minibatches=2)
    init_state, train_step = make_train_step(env, params, cfg)
    carry = init_state(jax.random.PRNGKey(0))
    n_agents = len(COGEN_AGENTS)
    # stacked per-agent parameters, padded per-agent actions
    assert carry["policy"]["trunk1"]["w"].shape[0] == n_agents
    assert carry["policy"]["mu"]["w"].shape[-1] == COGEN_PAD_DIM
    assert carry["obs"].shape[1] == n_agents

    before = np.asarray(carry["policy"]["mu"]["w"]).copy()
    carry, metrics = jax.jit(train_step)(carry, jax.random.PRNGKey(1))
    after = np.asarray(carry["policy"]["mu"]["w"])
    # every agent's own policy received an update
    for a in range(n_agents):
        assert not np.allclose(before[a], after[a]), f"agent {a} not trained"
    # ST's padded (masked) action slot contributes no density => no gradient
    assert float(carry["policy"]["log_std"][3, 3]) == -0.5
    assert float(carry["policy"]["log_std"][0, 0]) != -0.5
    assert np.isfinite(float(metrics["mean_reward"]))


def test_cogen_padded_action_equals_flat_action():
    """step() with the learner's padded (4, 4) action equals step() with the
    equivalent flat 15-vector."""
    import sustaingym_tpu as sg
    from sustaingym_tpu.envs.multiagent import (COGEN_AGENT_ACTION_IDX,
                                                COGEN_AGENTS, COGEN_PAD_DIM)

    env, params = sg.make("cogen-multiagent")
    state, _ = env.reset(params, jax.random.PRNGKey(0))
    flat = env.base.sample_action(params, jax.random.PRNGKey(1))
    padded = np.zeros((len(COGEN_AGENTS), COGEN_PAD_DIM), np.float32)
    for a, agent in enumerate(COGEN_AGENTS):
        for j, k in enumerate(COGEN_AGENT_ACTION_IDX[agent]):
            padded[a, j] = float(flat[k])
    padded[3, 3] = 123.0  # padding: must be ignored
    _, ts_flat = env.step(params, state, flat, jax.random.PRNGKey(2))
    _, ts_pad = env.step(params, state, jnp.asarray(padded),
                         jax.random.PRNGKey(2))
    np.testing.assert_allclose(np.asarray(ts_flat.reward),
                               np.asarray(ts_pad.reward), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ts_flat.obs),
                               np.asarray(ts_pad.obs), rtol=1e-6)


def test_ppo_multiagent_cogen_learns():
    """Learning-improvement on cogen-multiagent: per-agent policies reduce
    the (heavily penalized) dispatch cost within a few iterations."""
    import sustaingym_tpu as sg
    from sustaingym_tpu.parallel import train

    env, params = sg.make("cogen-multiagent")
    cfg = PPOConfig(num_envs=32, rollout_len=16, hidden=32, epochs=2,
                    minibatches=4, lr=1e-3, gamma=0.5, reward_scale=1e-4)
    carry, history = train(env, params, cfg, jax.random.PRNGKey(0),
                           num_iterations=20, verbose=False)
    first = np.mean([h["mean_reward"] for h in history[:3]])
    last = np.mean([h["mean_reward"] for h in history[-3:]])
    # the dispatch cost collapses by an order of magnitude (-60k -> -5k
    # band); assert a decisive improvement, not just noise
    assert last > first + 10_000, (first, last)


def test_ppo_multiagent_cogen_sharded_mesh():
    """Per-agent-policy PPO under the (dp, mp) mesh: stacked params shard
    their hidden dims over mp (agent axis replicated), env batch over dp."""
    import sustaingym_tpu as sg

    env, params = sg.make("cogen-multiagent")
    cfg = PPOConfig(num_envs=16, rollout_len=4, hidden=32, epochs=1,
                    minibatches=2)
    init_state, train_step = make_train_step(env, params, cfg)
    carry = init_state(jax.random.PRNGKey(0))
    mesh = make_mesh(8, mp=2)
    carry = _shard_carry(carry, mesh, data_sharding(mesh), replicated(mesh))
    carry, metrics = jax.jit(train_step, donate_argnums=0)(
        carry, jax.random.PRNGKey(1))
    assert np.isfinite(float(metrics["pg_loss"]))


class _DiscreteTrackEnv:
    """Stationary discrete-action env: obs in [-1,1]^dim, per-dim target bin
    = round((obs+1)/2 * (bins-1)), reward = -mean |a - target| / bins.
    Validates the categorical-policy PPO path end-to-end."""

    def __init__(self, dim=3, bins=5):
        self.dim, self.bins = dim, bins

    def observation_space(self, params):
        from sustaingym_tpu.core import Box
        return Box(-1, 1, (self.dim,))

    def action_space(self, params):
        from sustaingym_tpu.core import MultiDiscrete
        return MultiDiscrete(np.full(self.dim, self.bins))

    def reset(self, params, key):
        from sustaingym_tpu.core import TimeStep
        obs = jax.random.uniform(key, (self.dim,), minval=-1, maxval=1)
        ts = TimeStep(obs=obs, reward=jnp.zeros(()),
                      terminated=jnp.zeros((), bool),
                      truncated=jnp.zeros((), bool), info={})
        return obs, ts

    def step(self, params, state, action, key):
        from sustaingym_tpu.core import TimeStep
        target = jnp.round((state + 1) / 2 * (self.bins - 1))
        reward = -jnp.mean(jnp.abs(action.astype(jnp.float32) - target)
                           ) / self.bins
        obs = jax.random.uniform(key, (self.dim,), minval=-1, maxval=1)
        ts = TimeStep(obs=obs, reward=reward,
                      terminated=jnp.zeros((), bool),
                      truncated=jnp.zeros((), bool), info={})
        return obs, ts


def test_ppo_learns_discrete_tracking():
    """Categorical-policy PPO (the analogue of the reference harnesses
    training on DiscreteActionWrapper'd envs) learns a per-dim bin-tracking
    task."""
    from sustaingym_tpu.parallel import train

    env = _DiscreteTrackEnv()
    cfg = PPOConfig(num_envs=64, rollout_len=16, hidden=32, epochs=4,
                    minibatches=4, lr=3e-3, gamma=0.0, lam=0.0,
                    ent_coef=0.005)
    carry, history = train(env, None, cfg, jax.random.PRNGKey(0),
                           num_iterations=25, verbose=False)
    first = np.mean([h["mean_reward"] for h in history[:3]])
    last = np.mean([h["mean_reward"] for h in history[-3:]])
    assert last > first + 0.05, (first, last)


def test_ppo_discrete_multiagent_ev_smoke():
    """Discrete-action MA EV trains through the categorical head (per-agent
    Discrete(bins), the reference's MultiAgentEVChargingEnv(discrete_bins),
    multiagent_env.py:64,91-96)."""
    import sustaingym_tpu as sg
    from sustaingym_tpu.parallel import PPOConfig
    from sustaingym_tpu.parallel.ppo import make_train_step

    env, params = sg.make("evcharging-multiagent", discrete_bins=5,
                          project_action=False)
    cfg = PPOConfig(num_envs=4, rollout_len=6, hidden=32, epochs=1,
                    minibatches=2)
    init_state, train_step = make_train_step(env, params, cfg)
    carry = init_state(jax.random.PRNGKey(0))
    # categorical head: one 5-bin logit row per agent
    assert carry["policy"]["mu"]["w"].shape[-1] == 5
    carry, metrics = jax.jit(train_step)(carry, jax.random.PRNGKey(1))
    assert np.isfinite(float(metrics["pg_loss"]))
    assert 0.0 < float(metrics["entropy"]) <= np.log(5) + 1e-5


@pytest.mark.parametrize("obs_bf16", [False, True])
def test_episodic_fast_path_reconstruction_exact(obs_bf16):
    """rollout_len == episode length routes the rollout through the env's
    batch_unroll prefetcher, and (u, logp, value) are RECONSTRUCTED from
    the same keys/obs after the fact. With lr=0 the policy never changes,
    so if the reconstruction is exact every PPO ratio is exactly 1 and
    pg_loss == -mean(normalized adv) == 0 on every minibatch; any drift in
    the reconstructed logp would show up as a nonzero pg_loss. The
    obs_bf16 variant proves the bf16 storage path keeps the SAME values
    end to end (rollout, behavior logp, epoch scores)."""
    env, params = make("building")
    L = env.episode_steps(params)
    cfg = PPOConfig(num_envs=16, rollout_len=L, lr=0.0, epochs=2,
                    minibatches=4, obs_bf16=obs_bf16)
    init_state, train_step = make_train_step(env, params, cfg)
    assert train_step.episodic
    carry = init_state(jax.random.PRNGKey(0))
    carry, metrics = jax.jit(train_step)(carry, jax.random.PRNGKey(1))
    assert abs(float(metrics["pg_loss"])) < 1e-5, metrics
    assert np.isfinite(float(metrics["vf_loss"]))
    assert float(metrics["episode_done_frac"]) == pytest.approx(1.0 / L)
    # a non-episode-length rollout stays on the generic path
    _, ts2 = make_train_step(env, params,
                             PPOConfig(num_envs=16, rollout_len=32))
    assert not ts2.episodic


def test_episodic_fast_path_learns_building():
    """Episodic PPO actually trains (reward improves on the comfort task),
    exercising the batch_unroll-driven rollout end to end."""
    env, params = make("building")
    L = env.episode_steps(params)
    cfg = PPOConfig(num_envs=32, rollout_len=L, lr=3e-4, epochs=2,
                    minibatches=4)
    init_state, train_step = make_train_step(env, params, cfg)
    carry = init_state(jax.random.PRNGKey(0))
    step = jax.jit(train_step)
    rewards = []
    for i in range(8):
        carry, metrics = step(carry, jax.random.fold_in(
            jax.random.PRNGKey(1), i))
        rewards.append(float(metrics["mean_reward"]))
    assert np.isfinite(rewards).all()
    assert np.mean(rewards[-2:]) > np.mean(rewards[:2]), rewards


def test_obs_bf16_generic_path_consistent_and_learns():
    """obs_bf16 on the generic (non-episodic) path: lr=0 gives exactly-1
    ratios (pg_loss ~ 0), and with a real lr the building comfort task
    still improves."""
    env, params = make("building")
    cfg = PPOConfig(num_envs=16, rollout_len=32, lr=0.0, obs_bf16=True,
                    epochs=2, minibatches=4)
    init_state, train_step = make_train_step(env, params, cfg)
    assert not train_step.episodic
    carry = init_state(jax.random.PRNGKey(0))
    carry, metrics = jax.jit(train_step)(carry, jax.random.PRNGKey(1))
    assert abs(float(metrics["pg_loss"])) < 1e-5, metrics

    # learning sanity on the same quadratic-tracking env as the f32
    # learning test (building's comfort reward is too noisy at 10 iters)
    qenv = _QuadTrackEnv()
    qcfg = PPOConfig(num_envs=64, rollout_len=16, hidden=32, epochs=4,
                     minibatches=4, lr=3e-3, gamma=0.0, lam=0.0,
                     obs_bf16=True)
    _, history = train(qenv, None, qcfg, jax.random.PRNGKey(0),
                       num_iterations=25, verbose=False)
    first = np.mean([h["mean_reward"] for h in history[:3]])
    last = np.mean([h["mean_reward"] for h in history[-3:]])
    assert last > first + 0.2, (first, last)


def test_ma_ev_episodic_fast_path_reconstruction_exact():
    """The agent-axis MA-EV view rides the episodic fast path (round-4
    verdict item 2): rollout_len == 288 routes through the view's
    batch_unroll, and the reconstructed (u, logp, value) must be exact —
    with lr=0 every PPO ratio is exactly 1 so pg_loss == 0 (same invariant
    as test_episodic_fast_path_reconstruction_exact, now with the agent
    axis + staleness ring in the loop)."""
    env, params = make("evcharging-multiagent", periods_delay=1,
                       project_action=False)
    L = env.episode_steps(params)
    cfg = PPOConfig(num_envs=2, rollout_len=L, lr=0.0, epochs=1,
                    minibatches=2, hidden=32, obs_bf16=True)
    init_state, train_step = make_train_step(env, params, cfg)
    assert train_step.episodic
    carry = init_state(jax.random.PRNGKey(0))
    carry, metrics = jax.jit(train_step)(carry, jax.random.PRNGKey(1))
    assert abs(float(metrics["pg_loss"])) < 1e-5, metrics
    assert np.isfinite(float(metrics["vf_loss"]))
    assert float(metrics["episode_done_frac"]) == pytest.approx(1.0 / L)


def test_uma_fast_path_matches_generic_ma():
    """The uniform-obs MA fast path (periods_delay=0: trunk once per env,
    per-agent sampling around the shared mu) must produce the SAME
    training step as the generic agent-axis path: identical rollout
    trajectories (same PRNG stream through the same base unroll) and,
    with lr=0 / 1 epoch / 1 minibatch (so both paths see every sample in
    one batch), identical metrics."""
    import sustaingym_tpu as sg

    env, params = sg.make("evcharging-multiagent", periods_delay=0,
                          project_action=False)
    L = env.episode_steps(params)
    cfg = PPOConfig(num_envs=2, rollout_len=L, lr=0.0, epochs=1,
                    minibatches=1, hidden=32, obs_bf16=True)

    init_state, fast_step = make_train_step(env, params, cfg)
    assert fast_step.uma and fast_step.episodic
    carry = init_state(jax.random.PRNGKey(0))
    _, m_fast = jax.jit(fast_step)(carry, jax.random.PRNGKey(1))

    env_slow, _ = sg.make("evcharging-multiagent", periods_delay=0,
                          project_action=False)
    env_slow.uniform_agent_obs = lambda p: False   # force the generic path
    init_state2, slow_step = make_train_step(env_slow, params, cfg)
    assert not slow_step.uma and slow_step.episodic
    carry2 = init_state2(jax.random.PRNGKey(0))
    _, m_slow = jax.jit(slow_step)(carry2, jax.random.PRNGKey(1))

    for k in m_slow:
        np.testing.assert_allclose(
            float(m_fast[k]), float(m_slow[k]), rtol=2e-4, atol=1e-6,
            err_msg=k)
    assert abs(float(m_fast["pg_loss"])) < 1e-5


def test_uma_fast_path_learns():
    """The uma path trains: EV MA reward (profit-driven) improves."""
    import sustaingym_tpu as sg

    env, params = sg.make("evcharging-multiagent", periods_delay=0,
                          project_action=False)
    L = env.episode_steps(params)
    cfg = PPOConfig(num_envs=32, rollout_len=L, lr=2e-3, epochs=2,
                    minibatches=4, hidden=32, obs_bf16=True)
    init_state, train_step = make_train_step(env, params, cfg)
    assert train_step.uma
    carry = init_state(jax.random.PRNGKey(0))
    step = jax.jit(train_step, donate_argnums=0)
    rewards = []
    for i in range(12):
        carry, m = step(carry, jax.random.fold_in(jax.random.PRNGKey(1), i))
        rewards.append(float(m["mean_reward"]))
    assert np.isfinite(rewards).all()
    assert np.mean(rewards[-3:]) > np.mean(rewards[:3]), rewards
