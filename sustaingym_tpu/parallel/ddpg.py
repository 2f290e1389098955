"""Sharded DDPG learner — the last entry of the market doc's advertised
algorithm set ("dqn, sac, ppo, a2c, or ddpg",
/root/reference/docs/electricitymarketenv.md:84-90).

Deterministic-policy-gradient sibling of the SAC learner (parallel/sac.py),
sharing its device-resident shape: on-device replay ring with the env axis
sharded over ``dp``, one fused rollout+update XLA program per train step.
Differences from SAC: deterministic tanh actor with additive Gaussian
exploration noise (no entropy term, no temperature), twin critics with
target-policy smoothing (the TD3 refinements — plain single-critic DDPG is
a config away via ``policy_noise=0``), and Polyak targets for both actor
and critics.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..core import FunctionalEnv, autoreset_vstep
from ..core.struct import dataclass, static_field
from .ppo import flat_obs_fn
from .replay import sample_transitions, write_block, write_transition
from .runner import run_train_loop
from .sac import _dense, critic_apply, init_critic

__all__ = ["DDPGConfig", "make_ddpg_train_step", "train_ddpg"]


@dataclass
class DDPGConfig:
    num_envs: int = static_field(default=256)
    rollout_len: int = static_field(default=16)
    capacity: int = static_field(default=1024)
    batch_per_env: int = static_field(default=4)
    updates: int = static_field(default=16)
    hidden: int = static_field(default=256)
    lr: float = static_field(default=3e-4)
    gamma: float = static_field(default=0.99)
    tau: float = static_field(default=0.005)
    expl_noise: float = static_field(default=0.1)    # rollout action noise
    policy_noise: float = static_field(default=0.2)  # target smoothing
    noise_clip: float = static_field(default=0.5)
    # replay sampling index mode — see parallel/replay.py: False (default)
    # samples whole time slices (fast, phase-concentrated per update),
    # True restores per-env time indices (slower, max phase diversity)
    per_env_sample: bool = static_field(default=False)


def init_det_actor(key, obs_dim, act_dim, hidden):
    k = jax.random.split(key, 3)
    return {"trunk1": _dense(k[0], obs_dim, hidden),
            "trunk2": _dense(k[1], hidden, hidden),
            "mu": _dense(k[2], hidden, act_dim)}


def det_actor_apply(params, obs):
    h = jnp.tanh(obs @ params["trunk1"]["w"] + params["trunk1"]["b"])
    h = jnp.tanh(h @ params["trunk2"]["w"] + params["trunk2"]["b"])
    return jnp.tanh(h @ params["mu"]["w"] + params["mu"]["b"])  # (-1, 1)


def make_ddpg_train_step(env: FunctionalEnv, env_params, cfg: DDPGConfig,
                         obs_fn: Callable | None = None):
    """Builds (init_state, train_step), same contract as the other
    learner factories."""
    if getattr(env, "ppo_incompatible", None):
        raise ValueError(env.ppo_incompatible)
    if getattr(env, "per_agent_policy", False):
        raise ValueError(
            f"{env.name}: heterogeneous per-agent action dims are only "
            "supported by the PPO learner; use --algo ppo")
    vstep = autoreset_vstep(env)
    ma = bool(getattr(env, "agent_axis", False))
    if ma and obs_fn is None:
        obs_fn = lambda o: jnp.asarray(o, jnp.float32)  # noqa: E731
    obs_fn = obs_fn or flat_obs_fn(env, env_params)

    space = env.action_space(env_params)
    if not hasattr(space, "low"):
        raise ValueError(
            f"{env.name}: DDPG needs a continuous (Box) action space, got "
            f"{type(space).__name__} — discrete envs train with "
            "--algo dqn or the PPO categorical head")
    act_dim = int(space.shape[-1]) if ma else int(np.prod(space.shape))
    low = jnp.asarray(space.low, jnp.float32)
    high = jnp.asarray(space.high, jnp.float32)

    def to_env_action(a):
        return low + (a + 1.0) * 0.5 * (high - low)

    actor_opt = optax.adam(cfg.lr)
    critic_opt = optax.adam(cfg.lr)

    def init_state(key):
        ka, kc1, kc2, kr = jax.random.split(key, 4)
        keys = jax.random.split(kr, cfg.num_envs)
        states, ts = jax.vmap(env.reset, in_axes=(None, 0))(env_params, keys)
        obs = jax.vmap(obs_fn)(ts.obs)
        obs_dim = obs.shape[-1]
        actor = init_det_actor(ka, obs_dim, act_dim, cfg.hidden)
        critics = {"q1": init_critic(kc1, obs_dim, act_dim, cfg.hidden),
                   "q2": init_critic(kc2, obs_dim, act_dim, cfg.hidden)}
        lead = obs.shape[:-1]

        def ring(shape, dtype=jnp.float32):
            return jnp.zeros((cfg.capacity,) + shape, dtype)

        buffer = {
            "obs": ring(lead + (obs_dim,)),
            "act": ring(lead + (act_dim,)),
            "reward": ring(lead),
            "next_obs": ring(lead + (obs_dim,)),
            "done": ring(lead),
        }
        return {"actor": actor, "critics": critics,
                "actor_target": jax.tree.map(jnp.copy, actor),
                "targets": jax.tree.map(jnp.copy, critics),
                "actor_opt": actor_opt.init(actor),
                "critic_opt": critic_opt.init(critics),
                "env_states": states, "obs": obs, "buffer": buffer,
                "written": jnp.zeros((), jnp.int32)}

    # see replay.write_block: ring stays out of the scan carry when the
    # capacity is a rollout multiple (ring-sized while-boundary copies)
    block_write = cfg.capacity % cfg.rollout_len == 0

    def rollout(actor, env_states, obs, buffer, written, key):
        def body(carry, key_t):
            states, obs, *ring = carry
            k_noise, k_env = jax.random.split(key_t)
            a = det_actor_apply(actor, obs)
            a = jnp.clip(a + cfg.expl_noise * jax.random.normal(
                k_noise, a.shape, a.dtype), -1.0, 1.0)
            env_keys = jax.random.split(k_env, cfg.num_envs)
            states, ts = vstep(env_params, states, to_env_action(a), env_keys)
            next_obs = jax.vmap(obs_fn)(ts.obs)
            reward, done = ts.reward, ts.done
            if done.ndim < reward.ndim:
                done = jnp.broadcast_to(done[..., None], reward.shape)
            tr = {"obs": obs, "act": a, "reward": reward,
                  "next_obs": next_obs, "done": done.astype(jnp.float32)}
            if block_write:
                return (states, next_obs), (tr, reward.mean())
            buffer, written = ring
            buffer = write_transition(buffer, tr, written, cfg.capacity)
            return (states, next_obs, buffer, written + 1), (None, reward.mean())

        keys = jax.random.split(key, cfg.rollout_len)
        if block_write:
            (env_states, obs), (block, rews) = jax.lax.scan(
                body, (env_states, obs), keys)
            buffer = write_block(buffer, block, written, cfg.capacity)
            written = written + cfg.rollout_len
        else:
            (env_states, obs, buffer, written), (_, rews) = jax.lax.scan(
                body, (env_states, obs, buffer, written), keys)
        return env_states, obs, buffer, written, rews.mean()

    def sample(buffer, written, key):
        return sample_transitions(buffer, written, cfg.capacity,
                                  cfg.batch_per_env, key,
                                  per_env_sample=cfg.per_env_sample)

    def update(carry, key):
        actor, critics = carry["actor"], carry["critics"]
        a_tgt, q_tgt = carry["actor_target"], carry["targets"]
        k_samp, k_noise = jax.random.split(key)
        batch = sample(carry["buffer"], carry["written"], k_samp)

        # target-policy smoothing (TD3): clipped noise on the target action
        a_next = det_actor_apply(a_tgt, batch["next_obs"])
        noise = jnp.clip(
            cfg.policy_noise * jax.random.normal(
                k_noise, a_next.shape, a_next.dtype),
            -cfg.noise_clip, cfg.noise_clip)
        a_next = jnp.clip(a_next + noise, -1.0, 1.0)
        q_n = jnp.minimum(critic_apply(q_tgt["q1"], batch["next_obs"], a_next),
                          critic_apply(q_tgt["q2"], batch["next_obs"], a_next))
        target = jax.lax.stop_gradient(
            batch["reward"] + cfg.gamma * (1.0 - batch["done"]) * q_n)

        def critic_loss(critics):
            e1 = critic_apply(critics["q1"], batch["obs"], batch["act"]) - target
            e2 = critic_apply(critics["q2"], batch["obs"], batch["act"]) - target
            return 0.5 * (jnp.mean(e1 ** 2) + jnp.mean(e2 ** 2))

        c_loss, c_grads = jax.value_and_grad(critic_loss)(critics)
        c_updates, critic_opt_state = critic_opt.update(
            c_grads, carry["critic_opt"], critics)
        critics = optax.apply_updates(critics, c_updates)

        def actor_loss(actor):
            a = det_actor_apply(actor, batch["obs"])
            return -jnp.mean(critic_apply(critics["q1"], batch["obs"], a))

        a_loss, a_grads = jax.value_and_grad(actor_loss)(actor)
        a_updates, actor_opt_state = actor_opt.update(
            a_grads, carry["actor_opt"], actor)
        actor = optax.apply_updates(actor, a_updates)

        pol = lambda t, o: (1.0 - cfg.tau) * t + cfg.tau * o  # noqa: E731
        carry = {**carry, "actor": actor, "critics": critics,
                 "actor_target": jax.tree.map(pol, a_tgt, actor),
                 "targets": jax.tree.map(pol, q_tgt, critics),
                 "actor_opt": actor_opt_state,
                 "critic_opt": critic_opt_state}
        return carry, {"q_loss": c_loss, "actor_loss": a_loss}

    def train_step(carry, key):
        k_roll, k_upd = jax.random.split(key)
        env_states, obs, buffer, written, mean_reward = rollout(
            carry["actor"], carry["env_states"], carry["obs"],
            carry["buffer"], carry["written"], k_roll)
        carry = {**carry, "env_states": env_states, "obs": obs,
                 "buffer": buffer, "written": written}
        carry, metrics = jax.lax.scan(
            update, carry, jax.random.split(k_upd, cfg.updates))
        out = {"mean_reward": mean_reward,
               **{k: v.mean() for k, v in metrics.items()}}
        return carry, out

    def actor_fn(actor, obs_raw):
        """Deterministic eval actions (no exploration noise)."""
        obs_f = jax.vmap(obs_fn)(obs_raw)
        return to_env_action(det_actor_apply(actor, obs_f))

    train_step.actor_fn = actor_fn
    train_step.actor_key = "actor"
    return init_state, train_step


def shard_ddpg_carry(carry, mesh):
    from .sac import shard_sac_carry
    return shard_sac_carry(carry, mesh)


def train_ddpg(env: FunctionalEnv, env_params, cfg: DDPGConfig,
               key: jax.Array, num_iterations: int, mesh=None,
               verbose: bool = True):
    init_state, train_step = make_ddpg_train_step(env, env_params, cfg)
    k_init, k_train = jax.random.split(key)
    carry = init_state(k_init)
    if mesh is not None:
        carry = shard_ddpg_carry(carry, mesh)
    return run_train_loop(train_step, carry, k_train, num_iterations,
                          verbose=verbose)
