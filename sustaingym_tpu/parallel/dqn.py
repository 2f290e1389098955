"""Sharded double-DQN learner — completes the doc-advertised algorithm set
("dqn, sac, ppo, a2c, or ddpg", /root/reference/docs/electricitymarketenv.md:84-90)
for discrete / discretized action spaces.

The design mirrors the SAC learner (parallel/sac.py): the replay
buffer is an on-device ring shaped (capacity, num_envs, ...) with the env
axis sharded over the mesh's ``dp`` axis, and one ``train_step`` is a
single fused XLA program (epsilon-greedy ``lax.scan`` rollout writing the
ring, then a ``lax.scan`` of double-DQN gradient steps with a Polyak
target network).

Action-space handling matches the PPO categorical head: ``Discrete(n)``
is one head of n values; ``MultiDiscrete`` with uniform bins (e.g. the
market's 3-action wrapper after vectorization, or discrete multi-agent EV
where every station picks a bin) trains one independent Q head per action
dimension — branching Q-learning, the standard factorization for
combinatorial discrete spaces. Agent-axis multi-agent views are plain
extra batch dimensions, exactly as in the PPO learner.
"""
from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..core import FunctionalEnv, autoreset_vstep
from ..core.spaces import Discrete, MultiDiscrete
from ..core.struct import dataclass, static_field
from .ppo import flat_obs_fn
from .replay import sample_transitions, write_block, write_transition
from .runner import run_train_loop
from .sac import _dense

__all__ = ["DQNConfig", "make_dqn_train_step", "train_dqn"]


@dataclass
class DQNConfig:
    num_envs: int = static_field(default=256)
    rollout_len: int = static_field(default=16)
    capacity: int = static_field(default=1024)    # ring slots per env
    batch_per_env: int = static_field(default=4)  # sampled steps per env/update
    updates: int = static_field(default=16)       # gradient steps per train_step
    hidden: int = static_field(default=256)
    lr: float = static_field(default=3e-4)
    gamma: float = static_field(default=0.99)
    tau: float = static_field(default=0.01)       # Polyak target rate
    eps_start: float = static_field(default=1.0)
    eps_end: float = static_field(default=0.05)
    eps_decay_iters: int = static_field(default=50)  # train_step calls
    double: bool = static_field(default=True)     # double-DQN targets
    # multiplies rewards inside the TD target (reported metrics unscaled)
    reward_scale: float = static_field(default=1.0)
    # replay sampling index mode — see parallel/replay.py: False (default)
    # samples whole time slices (fast, phase-concentrated per update),
    # True restores per-env time indices (slower, max phase diversity)
    per_env_sample: bool = static_field(default=False)


def init_qnet(key: jax.Array, obs_dim: int, act_dim: int, n_bins: int,
              hidden: int) -> dict[str, Any]:
    k = jax.random.split(key, 3)
    return {"trunk1": _dense(k[0], obs_dim, hidden),
            "trunk2": _dense(k[1], hidden, hidden),
            "head": _dense(k[2], hidden, act_dim * n_bins)}


def qnet_apply(params, obs, act_dim: int, n_bins: int) -> jax.Array:
    """obs (..., D) -> Q-values (..., act_dim, n_bins)."""
    h = jnp.tanh(obs @ params["trunk1"]["w"] + params["trunk1"]["b"])
    h = jnp.tanh(h @ params["trunk2"]["w"] + params["trunk2"]["b"])
    q = h @ params["head"]["w"] + params["head"]["b"]
    return q.reshape(q.shape[:-1] + (act_dim, n_bins))


def make_dqn_train_step(env: FunctionalEnv, env_params, cfg: DQNConfig,
                        obs_fn: Callable | None = None):
    """Builds (init_state, train_step), same contract as the PPO/SAC
    factories so the train CLI / checkpointing / sharding treat all
    learners identically."""
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
    if isinstance(space, Discrete):
        act_dim, n_bins = 1, int(space.n)
        start = int(space.start)
    elif isinstance(space, MultiDiscrete):
        nvec = np.asarray(space.nvec)
        if not np.all(nvec == nvec.flat[0]):
            raise ValueError(f"DQN needs uniform bins, got nvec={nvec}")
        act_dim, n_bins = int(nvec.size) if not ma else int(nvec.shape[-1]), \
            int(nvec.flat[0])
        start = 0
    else:
        raise ValueError(
            f"{env.name}: DQN needs a Discrete/MultiDiscrete action space, "
            f"got {type(space).__name__} — continuous envs train with "
            "--algo ppo/a2c/sac (or discretize, e.g. the market's "
            "discrete=True or MA-EV discrete_bins)")

    def to_env_action(idx):
        # idx (..., act_dim) int32 -> env action (squeeze Discrete scalars)
        if isinstance(space, Discrete):
            return idx[..., 0] + start
        return idx

    opt = optax.adam(cfg.lr)

    def init_state(key):
        kq, kr = jax.random.split(key)
        keys = jax.random.split(kr, cfg.num_envs)
        states, ts = jax.vmap(env.reset, in_axes=(None, 0))(env_params, keys)
        obs = jax.vmap(obs_fn)(ts.obs)
        obs_dim = obs.shape[-1]
        qnet = init_qnet(kq, obs_dim, act_dim, n_bins, cfg.hidden)
        lead = obs.shape[:-1]  # (num_envs,) or (num_envs, n_agents)

        def ring(shape, dtype=jnp.float32):
            return jnp.zeros((cfg.capacity,) + shape, dtype)

        buffer = {
            "obs": ring(lead + (obs_dim,)),
            "act": ring(lead + (act_dim,), jnp.int32),
            "reward": ring(lead),
            "next_obs": ring(lead + (obs_dim,)),
            "done": ring(lead),
        }
        return {"qnet": qnet,
                "target": jax.tree.map(jnp.copy, qnet),
                "opt": opt.init(qnet),
                "env_states": states, "obs": obs, "buffer": buffer,
                "written": jnp.zeros((), jnp.int32),
                "iter": jnp.zeros((), jnp.int32)}

    def epsilon(it):
        frac = jnp.clip(it.astype(jnp.float32) / cfg.eps_decay_iters, 0, 1)
        return cfg.eps_start + frac * (cfg.eps_end - cfg.eps_start)

    # see replay.write_block: ring stays out of the scan carry when the
    # capacity is a rollout multiple (ring-sized while-boundary copies)
    block_write = cfg.capacity % cfg.rollout_len == 0

    def rollout(qnet, env_states, obs, buffer, written, eps, key):
        def body(carry, key_t):
            states, obs, *ring = carry
            k_greedy, k_expl, k_mask, k_env = jax.random.split(key_t, 4)
            q = qnet_apply(qnet, obs, act_dim, n_bins)
            greedy = jnp.argmax(q, axis=-1).astype(jnp.int32)
            random_a = jax.random.randint(
                k_expl, greedy.shape, 0, n_bins, jnp.int32)
            explore = jax.random.uniform(k_mask, greedy.shape) < eps
            a = jnp.where(explore, random_a, greedy)
            env_keys = jax.random.split(k_env, cfg.num_envs)
            states, ts = vstep(env_params, states, to_env_action(a), env_keys)
            next_obs = jax.vmap(obs_fn)(ts.obs)
            reward = ts.reward
            done = ts.done
            if done.ndim < reward.ndim:  # agent-axis rewards
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
        qnet, target = carry["qnet"], carry["target"]
        batch = sample(carry["buffer"], carry["written"], key)
        reward = batch["reward"] * cfg.reward_scale

        q_next_t = qnet_apply(target, batch["next_obs"], act_dim, n_bins)
        if cfg.double:
            # double-DQN: online net picks the argmax, target net scores it
            sel = jnp.argmax(
                qnet_apply(qnet, batch["next_obs"], act_dim, n_bins), -1)
            q_next = jnp.take_along_axis(
                q_next_t, sel[..., None], axis=-1)[..., 0]
        else:
            q_next = jnp.max(q_next_t, axis=-1)
        # branching heads bootstrap independently; scalar Discrete is the
        # act_dim == 1 special case
        tgt = (reward[..., None]
               + cfg.gamma * (1.0 - batch["done"][..., None]) * q_next)
        tgt = jax.lax.stop_gradient(tgt)

        def loss_fn(qnet):
            q = qnet_apply(qnet, batch["obs"], act_dim, n_bins)
            q_a = jnp.take_along_axis(
                q, batch["act"][..., None], axis=-1)[..., 0]
            return jnp.mean(optax.huber_loss(q_a, tgt))

        loss, grads = jax.value_and_grad(loss_fn)(qnet)
        updates, opt_state = opt.update(grads, carry["opt"], qnet)
        qnet = optax.apply_updates(qnet, updates)
        target = jax.tree.map(
            lambda t, o: (1.0 - cfg.tau) * t + cfg.tau * o, target, qnet)
        carry = {**carry, "qnet": qnet, "target": target, "opt": opt_state}
        return carry, {"q_loss": loss}

    def train_step(carry, key):
        k_roll, k_upd = jax.random.split(key)
        eps = epsilon(carry["iter"])
        env_states, obs, buffer, written, mean_reward = rollout(
            carry["qnet"], carry["env_states"], carry["obs"],
            carry["buffer"], carry["written"], eps, k_roll)
        carry = {**carry, "env_states": env_states, "obs": obs,
                 "buffer": buffer, "written": written,
                 "iter": carry["iter"] + 1}
        carry, metrics = jax.lax.scan(
            update, carry, jax.random.split(k_upd, cfg.updates))
        out = {"mean_reward": mean_reward, "epsilon": eps,
               **{k: v.mean() for k, v in metrics.items()}}
        return carry, out

    def actor_fn(qnet, obs_raw):
        """Greedy-Q eval actions (epsilon=0)."""
        obs_f = jax.vmap(obs_fn)(obs_raw)
        q = qnet_apply(qnet, obs_f, act_dim, n_bins)
        return to_env_action(jnp.argmax(q, axis=-1).astype(jnp.int32))

    train_step.actor_fn = actor_fn
    train_step.actor_key = "qnet"
    return init_state, train_step


def shard_dqn_carry(carry, mesh):
    """Same placement as the SAC carry: env batch + replay ring env axis
    over ``dp``, networks replicated."""
    from .sac import shard_sac_carry
    return shard_sac_carry(carry, mesh)


def train_dqn(env: FunctionalEnv, env_params, cfg: DQNConfig, key: jax.Array,
              num_iterations: int, mesh=None, verbose: bool = True):
    """Runs DQN; with a mesh, shards env batch + replay ring over 'dp'."""
    init_state, train_step = make_dqn_train_step(env, env_params, cfg)
    k_init, k_train = jax.random.split(key)
    carry = init_state(k_init)
    if mesh is not None:
        carry = shard_dqn_carry(carry, mesh)

    return run_train_loop(train_step, carry, k_train, num_iterations,
                          verbose=verbose)
