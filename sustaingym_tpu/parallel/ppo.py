"""Sharded PPO learner — the engine's replacement for the reference's
RLLib/SB3 training harnesses (/root/reference/examples/evcharging/
train_rllib.py:138-164, train_stable_baselines.py:264-292).

Design: actors and learner are fused into ONE jitted SPMD program per
iteration — a `lax.scan` rollout over vmapped envs (autoreset), GAE, and
minibatched clipped-PPO epochs. The env-state/trajectory batch axis is
sharded over the mesh's ``dp`` axis and the policy MLP's hidden dimension
over ``mp``; collectives are XLA-inserted (no explicit NCCL/Ray analog —
SURVEY.md §2.2, §5 'communication backend'). The minibatch shuffle draws
from the whole trajectory, so XLA gathers it before the epochs, which
then run replicated on every ``dp`` device.

The policy is a diag-Gaussian tanh MLP over flattened observations; discrete
action components (cogen switches/bays, discretized wrappers) are handled by
the per-env action transform in ``act_transform``.
"""
from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..core import FunctionalEnv, autoreset_vstep, flatten
from ..core.spaces import Discrete, MultiDiscrete
from ..core.struct import dataclass, static_field

__all__ = ["PPOConfig", "init_policy", "policy_apply", "make_train_step",
           "train", "flat_obs_fn"]


@dataclass
class PPOConfig:
    # "ppo" (clipped surrogate) or "a2c" (plain advantage actor-critic — the
    # SB3 A2C option of the reference harness, train_stable_baselines.py:162;
    # use epochs=1, minibatches=1 for textbook on-policy A2C)
    algo: str = static_field(default="ppo")
    num_envs: int = static_field(default=256)
    rollout_len: int = static_field(default=64)
    hidden: int = static_field(default=256)
    epochs: int = static_field(default=4)
    minibatches: int = static_field(default=8)
    lr: float = static_field(default=3e-4)
    gamma: float = static_field(default=0.99)
    lam: float = static_field(default=0.95)
    clip_eps: float = static_field(default=0.2)
    vf_coef: float = static_field(default=0.5)
    ent_coef: float = static_field(default=0.0)
    max_grad_norm: float = static_field(default=0.5)
    # multiplies rewards before GAE/returns (reported metrics stay unscaled).
    # Envs with |reward| >> 1 (cogen's 1e4-1e5 penalty scale) need ~1/|r| here
    # or the value-loss gradient drowns the policy gradient under the shared
    # global-norm clip.
    reward_scale: float = static_field(default=1.0)
    # store observations (rollout trajectory + minibatch samples) in
    # bfloat16: the policy consumes the SAME bf16 values at rollout,
    # behavior-logp scoring and every update epoch, so PPO ratios are
    # exactly 1 at epoch 0 (no hidden mismatch) — the policy simply trains
    # on bf16-quantized inputs. This halves the obs bytes moved by
    # packing, epoch shuffles and minibatch reads (EV: 146-float obs,
    # 1.9GB of samples at 8192x288). Default off: f32 obs.
    obs_bf16: bool = static_field(default=False)
    # target bytes per shuffle block (the unit of the epoch permutation):
    # larger blocks mean fewer, wider gathers, but a minibatch must draw
    # >= 16 blocks to remix across epochs, so narrow configs cap G below
    # this target automatically. The value is kept from an earlier sweep;
    # it has not been re-swept on the H100 (ROADMAP item 1.6)
    shuffle_block_bytes: int = static_field(default=32768)


# ---------------------------------------------------------------------------
# Pure-JAX MLP actor-critic (plain pytree params — trivially shardable)
# ---------------------------------------------------------------------------

def init_policy(key: jax.Array, obs_dim: int, act_dim: int,
                hidden: int = 256, dtype=jnp.float32) -> dict[str, Any]:
    k = jax.random.split(key, 5)

    def dense(k, din, dout):
        scale = np.sqrt(2.0 / din)
        return {"w": jax.random.normal(k, (din, dout), dtype) * scale,
                "b": jnp.zeros((dout,), dtype)}

    return {
        "trunk1": dense(k[0], obs_dim, hidden),
        "trunk2": dense(k[1], hidden, hidden),
        "mu": dense(k[2], hidden, act_dim),
        "value": dense(k[3], hidden, 1),
        "log_std": jnp.full((act_dim,), -0.5, dtype),
    }


def policy_apply(params: dict[str, Any], obs: jax.Array
                 ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """obs (..., obs_dim) -> (mu, log_std, value). The hidden dimension is
    the tensor-parallel axis: sharding trunk1.w's output dim over ``mp``
    makes XLA all-reduce the trunk2 matmul over the mesh.

    The mu and value heads run as ONE matmul on concatenated weights
    instead of two narrow ones. The param layout keeps separate
    'mu'/'value' leaves (checkpoints/sharding unchanged); the 56KB weight
    concat folds into the matmul."""
    h = jnp.tanh(obs @ params["trunk1"]["w"] + params["trunk1"]["b"])
    h = jnp.tanh(h @ params["trunk2"]["w"] + params["trunk2"]["b"])
    w_heads = jnp.concatenate([params["mu"]["w"], params["value"]["w"]],
                              axis=1)
    b_heads = jnp.concatenate([params["mu"]["b"], params["value"]["b"]])
    out = h @ w_heads + b_heads
    return out[..., :-1], params["log_std"], out[..., -1]


def _gauss_logp(mu, log_std, a, mask=None):
    """Diagonal-Gaussian log-prob; ``mask`` (broadcastable over the last
    axis) zeroes padded action components so they contribute neither density
    nor gradient (heterogeneous multi-agent padding)."""
    var = jnp.exp(2 * log_std)
    terms = -0.5 * ((a - mu) ** 2 / var + 2 * log_std
                    + jnp.log(2 * jnp.pi))
    if mask is not None:
        terms = terms * mask
    return jnp.sum(terms, axis=-1)


def _categorical_logp(logits, idx):
    """Sum over action dims of log softmax(logits) at the chosen bins.
    logits (..., act_dim, n_bins), idx (..., act_dim) int."""
    logp = jax.nn.log_softmax(logits, axis=-1)
    return jnp.sum(jnp.take_along_axis(
        logp, idx[..., None].astype(jnp.int32), axis=-1)[..., 0], axis=-1)


def _categorical_entropy(logits):
    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.sum(jnp.exp(logp) * logp, axis=(-2, -1))


def per_agent_apply(params: dict[str, Any], obs: jax.Array
                    ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Stacked per-agent actor-critic: every leaf of ``params`` carries a
    leading (n_agents,) axis (one policy per agent, the SPMD equivalent of
    the reference's per-agent RLLib PolicySpec,
    /root/reference/examples/cogen/train_rllib.py:119-132) and ``obs`` is
    (..., n_agents, obs_dim). One batched einsum per layer runs every
    agent's policy in one product instead of a Python loop over
    policies."""
    w1, b1 = params["trunk1"]["w"], params["trunk1"]["b"]
    h = jnp.tanh(jnp.einsum("...ad,adh->...ah", obs, w1) + b1)
    h = jnp.tanh(jnp.einsum("...ah,ahk->...ak", h,
                            params["trunk2"]["w"]) + params["trunk2"]["b"])
    mu = jnp.einsum("...ah,ahm->...am", h,
                    params["mu"]["w"]) + params["mu"]["b"]
    value = (jnp.einsum("...ah,ahv->...av", h, params["value"]["w"])
             + params["value"]["b"])[..., 0]
    return mu, params["log_std"], value


def flat_obs_fn(env: FunctionalEnv, params) -> Callable[[Any], jax.Array]:
    """Returns obs -> flat float32 vector using the env's space (mirrors
    gymnasium FlattenObservation used by the reference harnesses,
    examples/evcharging/train_rllib.py:105)."""
    space = env.observation_space(params)

    def fn(obs):
        return flatten(space, obs)

    return fn


def default_act_transform(env: FunctionalEnv, params, space=None):
    """Maps the policy's unbounded output to the env's Box action space via
    tanh squashing. ``space`` overrides the env's action space (used for the
    padded per-agent layout of heterogeneous multi-agent envs)."""
    space = space if space is not None else env.action_space(params)
    low = jnp.asarray(space.low, jnp.float32)
    high = jnp.asarray(space.high, jnp.float32)

    def fn(u):
        return low + (jnp.tanh(u) * 0.5 + 0.5) * (high - low)

    return fn


# ---------------------------------------------------------------------------
# Training step
# ---------------------------------------------------------------------------

def make_train_step(env: FunctionalEnv, env_params, cfg: PPOConfig,
                    act_transform=None, obs_fn=None, mesh=None):
    """Builds (init_state, train_step) where train_step is one fused
    rollout+update program: jit it with shardings from parallel.mesh.

    ``mesh``: the (dp, mp) mesh the carry is sharded over. The episodic
    rollouts generate their env batch inside the step from one key, so
    nothing in the carry tells XLA to split it; with a mesh their batch
    axis is constrained to ``dp`` (without one, every card would run the
    whole batch)."""
    if getattr(env, "ppo_incompatible", None):
        raise ValueError(env.ppo_incompatible)
    if cfg.algo not in ("ppo", "a2c"):
        raise ValueError(f"unknown on-policy algo {cfg.algo!r}")
    vstep = autoreset_vstep(env)
    # the uniform-obs multi-agent path rebuilds obs and actions from the
    # base env with the default flat-obs layout and tanh Box squash —
    # custom callbacks opt out of it
    user_act_transform = act_transform is not None
    user_obs_fn = obs_fn is not None
    # multi-agent views (env.agent_axis): obs are already flat float arrays
    # with an (n_agents, D) leading axis; the shared policy treats the agent
    # axis as extra batch and act_dim is PER AGENT (the reference trains one
    # RLLib policy per agent, examples/cogen/train_rllib.py:119-132; shared
    # parameters are the batched equivalent)
    ma = bool(getattr(env, "agent_axis", False))
    # heterogeneous multi-agent (per-agent action dims differ): stack one
    # policy per agent and train them all inside the same SPMD program,
    # acting through the env's padded action layout
    pap = bool(getattr(env, "per_agent_policy", False))
    if ma and obs_fn is None:
        obs_fn = lambda o: jnp.asarray(o, jnp.float32)  # noqa: E731
    obs_fn = obs_fn or flat_obs_fn(env, env_params)
    if cfg.obs_bf16:
        # one storage dtype end to end: rollout, behavior logp, and every
        # epoch score the SAME bf16 obs (see PPOConfig.obs_bf16)
        _obs_fn_f32 = obs_fn
        obs_fn = lambda o: _obs_fn_f32(o).astype(jnp.bfloat16)  # noqa: E731
    opt = optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm),
        optax.adam(cfg.lr))

    if pap:
        space = env.padded_action_space(env_params)
        n_agents, act_dim = (int(s) for s in space.shape)
        mask = jnp.asarray(env.action_pad_mask(), jnp.float32)
        apply_fn = per_agent_apply
        act_transform = act_transform or default_act_transform(
            env, env_params, space=space)
    else:
        space = env.action_space(env_params)
        n_agents, mask, apply_fn = 0, None, policy_apply
        if not space.shape:
            act_dim = 1
        elif ma:
            act_dim = int(space.shape[-1])
        else:
            act_dim = int(np.prod(space.shape))

    # discrete action spaces (DiscreteActionWrapper semantics / MA EV
    # discrete_bins) get a categorical policy head instead of the
    # diag-Gaussian — the analogue of the reference harnesses training on
    # discretized envs (examples/evcharging/train_stable_baselines.py
    # action_type='discrete', train_rllib.py get_env discrete_action)
    discrete = isinstance(space, (Discrete, MultiDiscrete))
    n_bins = 0
    if discrete:
        if pap:
            raise ValueError("per-agent policies with discrete actions are "
                             "not supported")
        nvec = (np.asarray([space.n]) if isinstance(space, Discrete)
                else np.asarray(space.nvec))
        if not np.all(nvec == nvec.flat[0]):
            raise ValueError(
                f"categorical PPO needs uniform bins, got nvec={nvec}")
        n_bins = int(nvec.flat[0])
        if n_bins < 2:
            raise ValueError(f"categorical PPO needs >= 2 bins, got {n_bins}")
    elif act_transform is None and not pap:
        act_transform = default_act_transform(env, env_params)
    # policy head width: logits for discrete, mu for continuous
    head_dim = act_dim * n_bins if discrete else act_dim

    def sample_action(policy, obs, k_act):
        """-> (u, logp, value, action). ``u`` is what the learner stores and
        re-scores (pre-squash gaussian draw, or integer bin indices)."""
        mu, log_std, value = apply_fn(policy, obs)
        if discrete:
            logits = mu.reshape(mu.shape[:-1] + (act_dim, n_bins))
            u = jax.random.categorical(k_act, logits)
            logp = _categorical_logp(logits, u)
            return u, logp, value, u
        u = mu + jnp.exp(log_std) * jax.random.normal(
            k_act, mu.shape, mu.dtype)
        return u, _gauss_logp(mu, log_std, u, mask), value, act_transform(u)

    def score_action(policy, obs, u):
        """-> (logp, value, log_std_or_logits) for the PPO/A2C loss."""
        mu, log_std, value = apply_fn(policy, obs)
        if discrete:
            logits = mu.reshape(mu.shape[:-1] + (act_dim, n_bins))
            u_int = u.astype(jnp.int32)
            return _categorical_logp(logits, u_int), value, logits
        return _gauss_logp(mu, log_std, u, mask), value, log_std

    def init_state(key):
        kp, kr = jax.random.split(key)
        keys = jax.random.split(kr, cfg.num_envs)
        states, ts = jax.vmap(env.reset, in_axes=(None, 0))(env_params, keys)
        obs = jax.vmap(obs_fn)(ts.obs)
        if pap:
            policy = jax.vmap(
                lambda k: init_policy(k, obs.shape[-1], head_dim, cfg.hidden)
            )(jax.random.split(kp, n_agents))
        else:
            policy = init_policy(kp, obs.shape[-1], head_dim, cfg.hidden)
        return {"policy": policy, "opt": opt.init(policy),
                "env_states": states, "obs": obs}

    def rollout(policy, env_states, obs, key):
        def body(carry, keys_t):
            states, obs = carry
            k_act, env_keys = keys_t[0], keys_t[1:]
            u, logp, value, action = sample_action(policy, obs, k_act)
            states, ts = vstep(env_params, states, action, env_keys)
            next_obs = jax.vmap(obs_fn)(ts.obs)
            done = ts.done
            if done.ndim < ts.reward.ndim:   # agent-axis rewards
                done = jnp.broadcast_to(done[..., None], ts.reward.shape)
            out = {"obs": obs, "u": u, "logp": logp, "value": value,
                   "reward": ts.reward, "done": done}
            return (states, next_obs), out

        # ONE key split for the whole rollout instead of 2 splits per scan
        # step; row t = [action key, env key x num_envs]
        keys = jax.random.split(
            key, cfg.rollout_len * (cfg.num_envs + 1)).reshape(
            cfg.rollout_len, cfg.num_envs + 1, 2)
        (env_states, obs), traj = jax.lax.scan(
            body, (env_states, obs), keys)
        _, _, last_value = apply_fn(policy, obs)
        return env_states, obs, traj, last_value

    # ---- episodic fast path --------------------------------------------
    # When the rollout spans EXACTLY one episode of a fixed-length env that
    # provides a lockstep ``batch_unroll`` prefetcher, drive the rollout
    # through it: the generic vmapped step re-gathers per-(env, step)
    # exogenous rows that batch_unroll amortizes per episode, and resets
    # only at the episode boundary. The policy callback samples actions
    # in-rollout from
    # the per-step action keys; afterwards (u, logp, value) are
    # RECONSTRUCTED in one batched pass — same params, same observations,
    # and the same `normal(key_act_t)` draws, so the values are
    # bit-identical to having stored them step by step. Whole-episode PPO
    # rollouts match the reference's episodic training batches
    # (examples/evcharging/train_rllib.py:35-38: 288-step episodes).
    ep_len = (env.episode_steps(env_params)
              if hasattr(env, "episode_steps") else None)
    # agent-axis (ma) views ride the fast path too when they provide a
    # batch_unroll — the MA-EV view does (round-4 verdict item 2); the
    # reconstruction below is shape-agnostic over the trailing agent axis
    episodic = (ep_len is not None and cfg.rollout_len == ep_len
                and hasattr(env, "batch_unroll")
                and not pap and not discrete)
    # uniform-obs multi-agent fast path (e.g. MA-EV with periods_delay=0):
    # every agent's obs row is identical, so the policy trunk runs ONCE
    # per env and broadcasts over agents — gradient-exact for the shared
    # policy (a unique row's weight gradient is the sum of its agents'
    # contributions) and ~n_agents x less matmul work in rollout, scoring
    # and update than materializing the broadcast
    uma = (ma and episodic and not discrete
           and not user_act_transform and not user_obs_fn
           and getattr(env, "uniform_agent_obs", None) is not None
           and env.uniform_agent_obs(env_params))
    if uma:
        uma_agents = int(env.action_space(env_params).shape[0])
        _obs_fn_uma = flat_obs_fn(env, env_params)
        if cfg.obs_bf16:
            _f = _obs_fn_uma
            obs_fn_uma = lambda o: _f(o).astype(jnp.bfloat16)  # noqa: E731
        else:
            obs_fn_uma = _obs_fn_uma

    if mesh is not None and mesh.shape["dp"] > 1:
        from jax.sharding import NamedSharding, PartitionSpec

        def on_dp(tree, axis=0):
            """Constrains ``axis`` of every leaf of ``tree`` to ``dp``."""
            spec = NamedSharding(mesh, PartitionSpec(*[None] * axis, "dp"))
            return jax.tree.map(
                lambda x: jax.lax.with_sharding_constraint(x, spec), tree)
    else:
        def on_dp(tree, axis=0):
            return tree

    def rollout_episodic(policy, key):
        def sampling_policy(p, obs_raw, k_act):
            obs_f = jax.vmap(obs_fn)(on_dp(obs_raw))
            mu, log_std, _ = apply_fn(p, obs_f)
            u = mu + jnp.exp(log_std) * jax.random.normal(
                k_act, mu.shape, mu.dtype)
            return on_dp(act_transform(u))

        ts = on_dp(env.batch_unroll(env_params, sampling_policy, policy, key,
                                    cfg.num_envs, cfg.rollout_len), 1)
        # re-derive the reset obs and per-step action keys with
        # batch_unroll's exact key derivation (one reset re-run per
        # episode — amortized noise)
        key_init, key_scan = jax.random.split(key)
        init_keys = on_dp(jax.random.split(key_init, cfg.num_envs))
        _, ts0 = jax.vmap(env.reset, in_axes=(None, 0))(
            env_params, init_keys)
        keys = jax.random.split(key_scan, cfg.rollout_len)
        k_act = jax.vmap(lambda kk: jax.random.split(kk)[0])(keys)
        # obs the policy saw at step t: reset obs at t=0, then ts.obs[t-1]
        obs0 = jax.vmap(obs_fn)(ts0.obs)
        obs_tail = jax.vmap(jax.vmap(obs_fn))(
            jax.tree.map(lambda x: x[:-1], ts.obs))
        obs_seen = jnp.concatenate([obs0[None], obs_tail], axis=0)
        mu, log_std, value = apply_fn(policy, obs_seen)
        noise = jax.vmap(
            lambda kk: jax.random.normal(kk, mu.shape[1:], mu.dtype))(k_act)
        u = mu + jnp.exp(log_std) * noise
        logp = _gauss_logp(mu, log_std, u, mask)
        done = ts.done
        if done.ndim < ts.reward.ndim:
            done = jnp.broadcast_to(done[..., None], ts.reward.shape)
        traj = {"obs": obs_seen, "u": u, "logp": logp, "value": value,
                "reward": ts.reward, "done": done}
        # episodes TERMINATE on the final step (done masks the bootstrap),
        # so the last value never contributes to GAE
        last_value = jnp.zeros_like(value[0])
        return traj, last_value

    def rollout_uma_episodic(policy, key):
        """Uniform-obs MA whole-episode rollout: base-env unroll with the
        trunk run once per env; (u, logp, value) reconstructed exactly as
        ``rollout_episodic`` (same key derivation), with u drawn PER
        AGENT around the shared mu."""
        A = uma_agents

        def sampling_policy(p, obs_raw, k_act):
            obs_f = jax.vmap(obs_fn_uma)(on_dp(obs_raw))   # (B, D)
            mu, log_std, _ = apply_fn(p, obs_f)            # (B, 1)
            noise = jax.random.normal(
                k_act, mu.shape[:-1] + (A,), mu.dtype)
            u = mu + jnp.exp(log_std) * noise              # (B, A)
            return on_dp(act_transform(u[..., None])[..., 0])  # (B, A)

        ts = on_dp(env.uniform_ma_unroll(env_params, sampling_policy, policy,
                                         key, cfg.num_envs,
                                         cfg.rollout_len), 1)
        key_init, key_scan = jax.random.split(key)
        init_keys = on_dp(jax.random.split(key_init, cfg.num_envs))
        _, ts0 = jax.vmap(env.base.reset, in_axes=(None, 0))(
            env_params.base, init_keys)
        keys = jax.random.split(key_scan, cfg.rollout_len)
        k_act = jax.vmap(lambda kk: jax.random.split(kk)[0])(keys)
        obs0 = jax.vmap(obs_fn_uma)(ts0.obs)
        obs_tail = jax.vmap(jax.vmap(obs_fn_uma))(
            jax.tree.map(lambda x: x[:-1], ts.obs))
        obs_seen = jnp.concatenate([obs0[None], obs_tail], axis=0)
        mu, log_std, value = apply_fn(policy, obs_seen)    # (T, B, 1)
        noise = jax.vmap(lambda kk: jax.random.normal(
            kk, mu.shape[1:-1] + (A,), mu.dtype))(k_act)   # (T, B, A)
        u = mu + jnp.exp(log_std) * noise
        ls = log_std[None, None, :]
        logp = -0.5 * ((u - mu) ** 2 * jnp.exp(-2 * ls)
                       + 2 * ls + jnp.log(2 * jnp.pi))     # (T, B, A)
        traj = {"obs": obs_seen, "u": u, "logp": logp, "value": value,
                "reward": ts.reward / A,                   # per-agent share
                "done": ts.done}
        return traj, jnp.zeros_like(value[0])

    def gae(traj, last_value):
        def body(carry, x):
            adv_next, v_next = carry
            value, reward, done = x
            nonterm = 1.0 - done.astype(reward.dtype)
            delta = reward + cfg.gamma * v_next * nonterm - value
            adv = delta + cfg.gamma * cfg.lam * nonterm * adv_next
            return (adv, value), adv

        reward = traj["reward"]
        if cfg.reward_scale != 1.0:
            reward = reward * cfg.reward_scale
        (_, _), advs = jax.lax.scan(
            body, (jnp.zeros_like(last_value), last_value),
            (traj["value"], reward, traj["done"]), reverse=True)
        return advs, advs + traj["value"]

    def loss_fn(policy, batch):
        if uma:
            # trunk once per unique obs row; per-agent scalar logp around
            # the shared mu (act_dim == 1 per agent)
            mu_, log_std_, value = apply_fn(policy, batch["obs"])
            ls = log_std_[None, :]
            logp = -0.5 * ((batch["u"] - mu_) ** 2 * jnp.exp(-2 * ls)
                           + 2 * ls + jnp.log(2 * jnp.pi))  # (mb, A)
            dist_stats = log_std_
        else:
            logp, value, dist_stats = score_action(policy, batch["obs"],
                                                   batch["u"])
        adv = batch["adv"]
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)
        if uma:
            # per-(env, t) advantage broadcast over the agent axis of the
            # per-agent ratios (identical values — matches the generic MA
            # accounting exactly)
            adv = adv[:, None]
        if cfg.algo == "a2c":
            pg = -(logp * adv).mean()
        else:
            ratio = jnp.exp(logp - batch["logp"])
            pg = -jnp.minimum(
                ratio * adv,
                jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
            ).mean()
        vf = 0.5 * jnp.mean((value - batch["ret"]) ** 2)
        if discrete:
            ent = jnp.mean(_categorical_entropy(dist_stats))
        else:
            ent_terms = dist_stats + 0.5 * jnp.log(2 * jnp.pi * jnp.e)
            ent = (jnp.sum(mask * ent_terms) / n_agents if pap
                   else jnp.sum(ent_terms))
        loss = pg + cfg.vf_coef * vf - cfg.ent_coef * ent
        return loss, {"pg_loss": pg, "vf_loss": vf, "entropy": ent}

    def train_step(carry, key):
        policy, opt_state = carry["policy"], carry["opt"]
        k_roll, k_perm = jax.random.split(key)
        if uma:
            env_states, obs = carry["env_states"], carry["obs"]
            traj, last_value = rollout_uma_episodic(policy, k_roll)
        elif episodic:
            # whole-episode rollout through the env's lockstep prefetcher;
            # env_states/obs stay in the carry untouched (each train step
            # rolls a fresh batch of full episodes)
            env_states, obs = carry["env_states"], carry["obs"]
            traj, last_value = rollout_episodic(policy, k_roll)
        else:
            env_states, obs, traj, last_value = rollout(
                policy, carry["env_states"], carry["obs"], k_roll)
        advs, rets = gae(traj, last_value)

        if pap:
            # per-agent policies: a sample is one (time, env) pair carrying
            # the full agent axis, so each minibatch row still routes every
            # agent's slice to its own stacked parameters
            n = int(np.prod(traj["logp"].shape[:2]))
            flat = {
                "obs": traj["obs"].reshape(n, n_agents, -1),
                "u": traj["u"].reshape(n, n_agents, -1),
                "logp": traj["logp"].reshape(n, n_agents),
                "adv": advs.reshape(n, n_agents),
                "ret": rets.reshape(n, n_agents),
            }
            fields = None
        else:
            # total sample count: time x envs (x agents for shared-policy
            # agent-axis views; uma keeps ONE row per (env, t) with the
            # agent axis folded into the u/logp field widths)
            n = (int(np.prod(traj["logp"].shape[:2])) if uma
                 else int(np.prod(traj["logp"].shape)))
            logp_w = int(traj["logp"].shape[-1]) if uma else 1
            flat = {
                "obs": traj["obs"].reshape(n, -1),
                "u": traj["u"].reshape(n, -1),
                "logp": traj["logp"].reshape(n, logp_w),
                "adv": advs.reshape(n),
                "ret": rets.reshape(n),
            }
            obs_w = int(flat["obs"].shape[1])
            u_dtype = flat["u"].dtype
            u_w = int(flat["u"].shape[1])
            F = obs_w + u_w + logp_w + 2
            # pack every per-sample field into ONE (n, F) array so each
            # epoch shuffles with a single wide gather instead of one
            # narrow gather per field per minibatch
            if cfg.obs_bf16:
                # dual-array packing: obs stays bf16 (concatenating into
                # one f32 array would up-cast it back and double the
                # shuffle bytes); the narrow fields pack into one f32
                # array. Both shuffle with the same block permutation.
                fields = [("u", u_w), ("logp", logp_w),
                          ("adv", 1), ("ret", 1)]
                packed_obs = flat["obs"]            # (n, obs_w) bf16
                packed = jnp.concatenate(
                    [flat["u"].astype(jnp.float32),
                     flat["logp"], advs.reshape(n, 1),
                     rets.reshape(n, 1)], axis=1)   # f32
            else:
                fields = [("obs", obs_w), ("u", u_w),
                          ("logp", logp_w), ("adv", 1), ("ret", 1)]
                packed_obs = None
                packed = jnp.concatenate(
                    [flat["obs"].astype(jnp.float32),
                     flat["u"].astype(jnp.float32),
                     flat["logp"], advs.reshape(n, 1),
                     rets.reshape(n, 1)], axis=1)

        if fields is None:
            # per-agent path: rows are (n_agents, ...) slabs, wide enough
            # that the plain row gather is not the bottleneck
            mb = n // cfg.minibatches
            dropped = n - mb * cfg.minibatches
        else:
            # shuffle BLOCKS of G adjacent samples. Flat order is
            # (time, env): G adjacent rows are G INDEPENDENT envs at the
            # same timestep, so block shuffling costs nothing statistically
            # — blocks land in random minibatches, and their members are
            # iid envs. Fewer, larger contiguous blocks mean fewer gather
            # indices per epoch (block size: PPOConfig.shuffle_block_bytes).
            # Each minibatch must still draw >= 16 blocks so epoch
            # composition remixes
            # (a minibatch == one block would make the 72 minibatch SETS
            # fixed across epochs, only reordered).
            row_bytes = (obs_w * 2 + (u_w + logp_w + 2) * 4
                         if cfg.obs_bf16 else F * 4)
            G = 1
            while (G * row_bytes < cfg.shuffle_block_bytes
                   and n % (2 * G) == 0
                   and n // (2 * G) >= 16 * cfg.minibatches):
                G *= 2
            n_blocks = n // G
            rest_F = int(packed.shape[1])
            blocks = packed.reshape(n_blocks, G * rest_F)
            blocks_obs = (packed_obs.reshape(n_blocks, G * obs_w)
                          if packed_obs is not None else None)
            mb_blocks = n_blocks // cfg.minibatches
            mb = mb_blocks * G
            dropped = n - mb * cfg.minibatches
        if dropped == n:
            raise ValueError(
                f"PPO minibatching would drop ALL {n} samples per epoch: "
                f"rollout_len*num_envs[*n_agents]={n} yields fewer than "
                f"minibatches={cfg.minibatches} rows. Lower minibatches or "
                f"raise num_envs/rollout_len.")
        if dropped:
            # n is static at trace time, so this warns once per compile (the
            # SURVEY "no silent caps" rule): with agent-axis envs n is rarely
            # a multiple of minibatches and the remainder never trains
            import warnings
            warnings.warn(
                f"PPO minibatching drops {dropped}/{n} samples per epoch "
                f"(rollout_len*num_envs[*n_agents]={n} not divisible by "
                f"minibatches={cfg.minibatches})", stacklevel=2)

        def unpack(mbarr):
            out = {}
            off = 0
            for name, width in fields:
                col = mbarr[:, off:off + width]
                off += width
                out[name] = col
            out["u"] = out["u"].astype(u_dtype)
            if not uma:          # uma keeps the (mb, A) agent axis
                out["logp"] = out["logp"][:, 0]
            out["adv"] = out["adv"][:, 0]
            out["ret"] = out["ret"][:, 0]
            return out

        def epoch(carry, key_e):
            policy, opt_state = carry

            def minibatch(carry, batch):
                policy, opt_state = carry
                (_, metrics), grads = jax.value_and_grad(
                    loss_fn, has_aux=True)(policy, batch)
                updates, opt_state = opt.update(grads, opt_state, policy)
                policy = optax.apply_updates(policy, updates)
                return (policy, opt_state), metrics

            if fields is None:
                perm = jax.random.permutation(key_e, n)
                idxs = perm[:mb * cfg.minibatches].reshape(
                    cfg.minibatches, mb)
                (policy, opt_state), metrics = jax.lax.scan(
                    lambda c, idx: minibatch(
                        c, jax.tree.map(lambda x: x[idx], flat)),
                    (policy, opt_state), idxs)
            else:
                perm = jax.random.permutation(key_e, n_blocks)
                sel = perm[:mb_blocks * cfg.minibatches]
                shuffled = blocks[sel]
                mbs = shuffled.reshape(cfg.minibatches, mb, rest_F)
                if blocks_obs is not None:
                    obs_mbs = blocks_obs[sel].reshape(
                        cfg.minibatches, mb, obs_w)
                    (policy, opt_state), metrics = jax.lax.scan(
                        lambda c, arrs: minibatch(
                            c, {**unpack(arrs[0]), "obs": arrs[1]}),
                        (policy, opt_state), (mbs, obs_mbs))
                else:
                    (policy, opt_state), metrics = jax.lax.scan(
                        lambda c, arr: minibatch(c, unpack(arr)),
                        (policy, opt_state), mbs)
            return (policy, opt_state), metrics

        (policy, opt_state), metrics = jax.lax.scan(
            epoch, (policy, opt_state), jax.random.split(k_perm, cfg.epochs))

        new_carry = {"policy": policy, "opt": opt_state,
                     "env_states": env_states, "obs": obs}
        out_metrics = {
            "mean_reward": traj["reward"].mean(),
            "episode_done_frac": traj["done"].mean(),
            **{k: v.mean() for k, v in metrics.items()},
        }
        return new_carry, out_metrics

    def actor_fn(policy, obs_raw):
        """Deterministic greedy actions from raw batched obs — the
        evaluation-time policy (SB3 eval's deterministic=True analogue,
        reference train_stable_baselines.py:126)."""
        obs_f = jax.vmap(obs_fn)(obs_raw)
        mu, _, _ = apply_fn(policy, obs_f)
        if discrete:
            logits = mu.reshape(mu.shape[:-1] + (act_dim, n_bins))
            return jnp.argmax(logits, axis=-1)
        return act_transform(mu)

    train_step.episodic = episodic  # introspection (tests/bench labeling)
    train_step.uma = uma            # uniform-obs MA fast path active
    train_step.actor_fn = actor_fn       # deterministic eval policy
    train_step.actor_key = "policy"      # carry subtree holding its params
    return init_state, train_step


def train(env: FunctionalEnv, env_params, cfg: PPOConfig, key: jax.Array,
          num_iterations: int, mesh=None, verbose: bool = True):
    """Runs PPO; with a mesh, shards env/trajectory batch over 'dp' and
    policy hidden over 'mp'."""
    init_state, train_step = make_train_step(env, env_params, cfg,
                                             mesh=mesh)
    k_init, k_train = jax.random.split(key)
    carry = init_state(k_init)

    if mesh is not None:
        from .mesh import data_sharding, model_sharding, replicated
        ds, rep = data_sharding(mesh), replicated(mesh)
        carry = _shard_carry(carry, mesh, ds, rep)

    from .runner import run_train_loop
    return run_train_loop(train_step, carry, k_train, num_iterations,
                          verbose=verbose)


def carry_shardings(carry_like, mesh, ds, rep):
    """Sharding pytree for a PPO carry: env batch over ``dp``, Megatron-style
    MLP tensor parallelism over ``mp``. ``carry_like`` may be concrete arrays
    or ``jax.eval_shape`` structs — only shapes/paths are read, so the result
    can serve as ``out_shardings`` for a jitted ``init_state`` (the
    multi-process path, where host-side device_put of the global carry is
    not possible)."""
    from .mesh import model_sharding

    def place(path, x):
        name = "/".join(str(p.key) if hasattr(p, "key") else str(p)
                        for p in path)
        if name.startswith("env_states") or name.startswith("obs"):
            return ds
        # Megatron-style MLP TP: trunk1 column-parallel (out-dim + bias
        # sharded over mp), trunk2 row-parallel (in-dim sharded; XLA inserts
        # the all-reduce after the trunk2 matmul)
        if "trunk1/w" in name or "trunk1/b" in name:
            return model_sharding(mesh, x.ndim - 1)
        if "trunk2/w" in name:
            # row-parallel: shard the input-hidden dim — second-to-last axis,
            # so stacked per-agent params (A, H, H) shard H, not the agent axis
            return model_sharding(mesh, x.ndim - 2)
        return rep

    return jax.tree_util.tree_map_with_path(place, carry_like)


def _shard_carry(carry, mesh, ds, rep):
    return jax.tree.map(jax.device_put, carry,
                        carry_shardings(carry, mesh, ds, rep))
