"""Sharded SAC learner — off-policy counterpart to the PPO learner,
covering the reference harnesses' SAC option (/root/reference/examples/
evcharging/train_rllib.py:43-84 ``--algo [ppo|sac]``, train_stable_baselines
.py:156-187 ``--algo [ppo|a2c|sac]``).

Design:
- The replay buffer lives ON DEVICE as a fixed-size ring over the time axis,
  shaped ``(capacity, num_envs, ...)`` with the env axis sharded over the
  mesh's ``dp`` axis. Sampling draws per-env time indices, so gathers stay
  local to each device shard — the only cross-device traffic is the gradient
  psum XLA inserts.
- One ``train_step`` is a single fused XLA program: a ``lax.scan`` rollout of
  ``rollout_len`` vmapped env steps writing transitions into the ring, then a
  ``lax.scan`` of ``updates`` gradient steps (twin-critic TD3-style targets,
  reparameterized tanh-Gaussian actor, auto-tuned temperature).
- Episode ends follow the same convention as the PPO learner: autoreset
  keeps the batch in lockstep and ``done`` zeroes the bootstrap.
"""
from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..core import FunctionalEnv, autoreset_vstep
from ..core.struct import dataclass, static_field
from .ppo import flat_obs_fn
from .replay import sample_transitions, write_block, write_transition
from .runner import run_train_loop

__all__ = ["SACConfig", "make_sac_train_step", "train_sac"]

_LOG_STD_LO, _LOG_STD_HI = -5.0, 2.0


@dataclass
class SACConfig:
    num_envs: int = static_field(default=256)
    rollout_len: int = static_field(default=16)
    capacity: int = static_field(default=1024)   # ring slots per env
    batch_per_env: int = static_field(default=4)  # sampled steps per env/update
    updates: int = static_field(default=16)       # gradient steps per train_step
    hidden: int = static_field(default=256)
    lr: float = static_field(default=3e-4)
    alpha_lr: float = static_field(default=3e-4)
    gamma: float = static_field(default=0.99)
    tau: float = static_field(default=0.005)
    init_alpha: float = static_field(default=0.1)
    # target entropy defaults to -act_dim (SAC-v2 heuristic)
    target_entropy: float | None = static_field(default=None)
    # replay sampling index mode — see parallel/replay.py: False (default)
    # samples whole time slices (fast, phase-concentrated per update),
    # True restores per-env time indices (slower, max phase diversity).
    # BEHAVIOR CHANGE (round 3): the default flipped False; with lockstep
    # autoreset each update batch then covers batch_per_env in-episode
    # phases instead of batch_per_env*num_envs. Set True to reproduce
    # pre-round-3 SAC training statistics exactly.
    per_env_sample: bool = static_field(default=False)


# ---------------------------------------------------------------------------
# Networks (plain pytrees, same conventions as ppo.init_policy)
# ---------------------------------------------------------------------------

def _dense(k, din, dout, dtype=jnp.float32):
    scale = np.sqrt(2.0 / din)
    return {"w": jax.random.normal(k, (din, dout), dtype) * scale,
            "b": jnp.zeros((dout,), dtype)}


def init_actor(key: jax.Array, obs_dim: int, act_dim: int,
               hidden: int) -> dict[str, Any]:
    k = jax.random.split(key, 4)
    return {"trunk1": _dense(k[0], obs_dim, hidden),
            "trunk2": _dense(k[1], hidden, hidden),
            "mu": _dense(k[2], hidden, act_dim),
            "log_std": _dense(k[3], hidden, act_dim)}


def actor_apply(params, obs):
    h = jnp.tanh(obs @ params["trunk1"]["w"] + params["trunk1"]["b"])
    h = jnp.tanh(h @ params["trunk2"]["w"] + params["trunk2"]["b"])
    mu = h @ params["mu"]["w"] + params["mu"]["b"]
    raw = h @ params["log_std"]["w"] + params["log_std"]["b"]
    # smooth bound (clip would kill gradients at the rails)
    log_std = _LOG_STD_LO + 0.5 * (_LOG_STD_HI - _LOG_STD_LO) * (
        jnp.tanh(raw) + 1.0)
    return mu, log_std


def init_critic(key: jax.Array, obs_dim: int, act_dim: int,
                hidden: int) -> dict[str, Any]:
    k = jax.random.split(key, 3)
    return {"l1": _dense(k[0], obs_dim + act_dim, hidden),
            "l2": _dense(k[1], hidden, hidden),
            "out": _dense(k[2], hidden, 1)}


def critic_apply(params, obs, act):
    x = jnp.concatenate([obs, act], axis=-1)
    h = jnp.tanh(x @ params["l1"]["w"] + params["l1"]["b"])
    h = jnp.tanh(h @ params["l2"]["w"] + params["l2"]["b"])
    return (h @ params["out"]["w"] + params["out"]["b"])[..., 0]


def _sample_tanh_gauss(key, mu, log_std):
    """Reparameterized tanh-Gaussian sample.

    Returns (a, logp) with a in (-1, 1). Uses the numerically stable
    log(1 - tanh(u)^2) = 2*(log 2 - u - softplus(-2u)).
    """
    std = jnp.exp(log_std)
    u = mu + std * jax.random.normal(key, mu.shape, mu.dtype)
    a = jnp.tanh(u)
    gauss_logp = jnp.sum(
        -0.5 * ((u - mu) ** 2 / (std ** 2) + 2 * log_std
                + jnp.log(2 * jnp.pi)), axis=-1)
    corr = jnp.sum(2.0 * (jnp.log(2.0) - u - jax.nn.softplus(-2.0 * u)),
                   axis=-1)
    return a, gauss_logp - corr


# ---------------------------------------------------------------------------
# Training step
# ---------------------------------------------------------------------------

def make_sac_train_step(env: FunctionalEnv, env_params, cfg: SACConfig,
                        obs_fn: Callable | None = None):
    """Builds (init_state, train_step): one fused rollout+update program.

    Mirrors the shape of ``ppo.make_train_step`` so the train CLI, orbax
    checkpointing and mesh sharding treat both learners identically.
    """
    if getattr(env, "ppo_incompatible", None):
        raise ValueError(env.ppo_incompatible)
    if getattr(env, "per_agent_policy", False):
        raise ValueError(
            f"{env.name}: heterogeneous per-agent action dims are only "
            "supported by the PPO learner (stacked per-agent policies); "
            "use --algo ppo")
    vstep = autoreset_vstep(env)
    ma = bool(getattr(env, "agent_axis", False))
    if ma and obs_fn is None:
        obs_fn = lambda o: jnp.asarray(o, jnp.float32)  # noqa: E731
    obs_fn = obs_fn or flat_obs_fn(env, env_params)

    space = env.action_space(env_params)
    if not hasattr(space, "low"):
        raise ValueError(
            f"{env.name}: SAC needs a continuous (Box) action space, got "
            f"{type(space).__name__} — discrete/discretized envs train "
            "with the PPO categorical head (--algo ppo)")
    act_dim = int(space.shape[-1]) if ma else int(np.prod(space.shape))
    low = jnp.asarray(space.low, jnp.float32)
    high = jnp.asarray(space.high, jnp.float32)
    target_entropy = (cfg.target_entropy if cfg.target_entropy is not None
                      else -float(act_dim))

    def to_env_action(a):
        # a in (-1,1) -> env Box; affine, so logp differs by a constant that
        # only shifts the entropy target's reference point
        return low + (a + 1.0) * 0.5 * (high - low)

    actor_opt = optax.adam(cfg.lr)
    critic_opt = optax.adam(cfg.lr)
    alpha_opt = optax.adam(cfg.alpha_lr)

    def init_state(key):
        ka, kc1, kc2, kr = jax.random.split(key, 4)
        keys = jax.random.split(kr, cfg.num_envs)
        states, ts = jax.vmap(env.reset, in_axes=(None, 0))(env_params, keys)
        obs = jax.vmap(obs_fn)(ts.obs)
        obs_dim = obs.shape[-1]
        actor = init_actor(ka, obs_dim, act_dim, cfg.hidden)
        q1 = init_critic(kc1, obs_dim, act_dim, cfg.hidden)
        q2 = init_critic(kc2, obs_dim, act_dim, cfg.hidden)
        lead = obs.shape[:-1]  # (num_envs,) or (num_envs, n_agents)

        def ring(shape, dtype=jnp.float32):
            return jnp.zeros((cfg.capacity,) + shape, dtype)

        buffer = {
            "obs": ring(lead + (obs_dim,)),
            "act": ring(lead + (act_dim,)),
            "reward": ring(lead),
            "next_obs": ring(lead + (obs_dim,)),
            "done": ring(lead),
        }
        critics = {"q1": q1, "q2": q2}
        return {
            "actor": actor, "critics": critics,
            # real copies — aliased leaves would break buffer donation
            "targets": jax.tree.map(jnp.copy, critics),
            "log_alpha": jnp.asarray(np.log(cfg.init_alpha), jnp.float32),
            "actor_opt": actor_opt.init(actor),
            "critic_opt": critic_opt.init(critics),
            "alpha_opt": alpha_opt.init(
                jnp.asarray(np.log(cfg.init_alpha), jnp.float32)),
            "env_states": states, "obs": obs, "buffer": buffer,
            "written": jnp.zeros((), jnp.int32),
        }

    # block-write mode keeps the ring OUT of the rollout scan carry (see
    # replay.write_block); falls back to in-scan per-step writes when the
    # capacity is not a rollout multiple
    block_write = cfg.capacity % cfg.rollout_len == 0

    def rollout(actor, env_states, obs, buffer, written, key):
        def body(carry, key_t):
            states, obs, *ring = carry
            k_act, k_env = jax.random.split(key_t)
            mu, log_std = actor_apply(actor, obs)
            a, _ = _sample_tanh_gauss(k_act, mu, log_std)
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
        actor, critics, targets = (carry["actor"], carry["critics"],
                                   carry["targets"])
        log_alpha = carry["log_alpha"]
        k_samp, k_next, k_act = jax.random.split(key, 3)
        batch = sample(carry["buffer"], carry["written"], k_samp)
        alpha = jnp.exp(log_alpha)

        # --- critic update (twin targets, entropy-regularized bootstrap)
        mu_n, ls_n = actor_apply(actor, batch["next_obs"])
        a_n, logp_n = _sample_tanh_gauss(k_next, mu_n, ls_n)
        q_n = jnp.minimum(critic_apply(targets["q1"], batch["next_obs"], a_n),
                          critic_apply(targets["q2"], batch["next_obs"], a_n))
        target = batch["reward"] + cfg.gamma * (1.0 - batch["done"]) * (
            q_n - alpha * logp_n)
        target = jax.lax.stop_gradient(target)

        def critic_loss(critics):
            e1 = critic_apply(critics["q1"], batch["obs"], batch["act"]) - target
            e2 = critic_apply(critics["q2"], batch["obs"], batch["act"]) - target
            return 0.5 * (jnp.mean(e1 ** 2) + jnp.mean(e2 ** 2))

        c_loss, c_grads = jax.value_and_grad(critic_loss)(critics)
        c_updates, critic_opt_state = critic_opt.update(
            c_grads, carry["critic_opt"], critics)
        critics = optax.apply_updates(critics, c_updates)

        # --- actor update (reparameterized; fresh actions through min-Q)
        def actor_loss(actor):
            mu, ls = actor_apply(actor, batch["obs"])
            a, logp = _sample_tanh_gauss(k_act, mu, ls)
            q = jnp.minimum(critic_apply(critics["q1"], batch["obs"], a),
                            critic_apply(critics["q2"], batch["obs"], a))
            return jnp.mean(alpha * logp - q), logp

        (a_loss, logp), a_grads = jax.value_and_grad(
            actor_loss, has_aux=True)(actor)
        a_updates, actor_opt_state = actor_opt.update(
            a_grads, carry["actor_opt"], actor)
        actor = optax.apply_updates(actor, a_updates)

        # --- temperature update toward the entropy target
        def alpha_loss(log_alpha):
            return -jnp.mean(jnp.exp(log_alpha) * jax.lax.stop_gradient(
                logp + target_entropy))

        al_loss, al_grad = jax.value_and_grad(alpha_loss)(log_alpha)
        al_updates, alpha_opt_state = alpha_opt.update(
            al_grad, carry["alpha_opt"], log_alpha)
        log_alpha = optax.apply_updates(log_alpha, al_updates)

        # --- polyak target sync
        targets = jax.tree.map(
            lambda t, o: (1.0 - cfg.tau) * t + cfg.tau * o, targets, critics)

        carry = {**carry, "actor": actor, "critics": critics,
                 "targets": targets, "log_alpha": log_alpha,
                 "actor_opt": actor_opt_state,
                 "critic_opt": critic_opt_state,
                 "alpha_opt": alpha_opt_state}
        metrics = {"q_loss": c_loss, "actor_loss": a_loss,
                   "alpha": jnp.exp(log_alpha), "entropy": -logp.mean()}
        return carry, metrics

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
        """Deterministic eval actions: tanh(mu) through the env mapping."""
        obs_f = jax.vmap(obs_fn)(obs_raw)
        mu, _ = actor_apply(actor, obs_f)
        return to_env_action(jnp.tanh(mu))

    train_step.actor_fn = actor_fn
    train_step.actor_key = "actor"
    return init_state, train_step


def shard_sac_carry(carry, mesh):
    """Places the SAC carry on a (dp, mp) mesh: env batch + replay ring's env
    axis over dp, networks replicated (SAC's scaling axis here is dp)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    ds = NamedSharding(mesh, P("dp"))
    ring = NamedSharding(mesh, P(None, "dp"))
    rep = NamedSharding(mesh, P())

    def place(path, x):
        name = "/".join(str(p.key) if hasattr(p, "key") else str(p)
                        for p in path)
        if name.startswith("buffer"):
            return jax.device_put(x, ring)
        if name.startswith("env_states") or name.startswith("obs"):
            return jax.device_put(x, ds)
        return jax.device_put(x, rep)

    return jax.tree_util.tree_map_with_path(place, carry)


def train_sac(env: FunctionalEnv, env_params, cfg: SACConfig, key: jax.Array,
              num_iterations: int, mesh=None, verbose: bool = True):
    """Runs SAC; with a mesh, shards env batch + replay ring over 'dp'."""
    init_state, train_step = make_sac_train_step(env, env_params, cfg)
    k_init, k_train = jax.random.split(key)
    carry = init_state(k_init)
    if mesh is not None:
        carry = shard_sac_carry(carry, mesh)

    return run_train_loop(train_step, carry, k_train, num_iterations,
                          verbose=verbose)
