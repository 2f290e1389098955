"""Multi-agent views: per-agent leading axes over the single-agent envs.

The reference wraps each env in a PettingZoo ParallelEnv with per-agent
dicts (/root/reference/sustaingym/envs/{evcharging,building,cogen}/
multiagent_env.py). Batched design (SURVEY.md §7 rule 5): a multi-agent
env is a VIEW — obs carries an (n_agents, obs_dim) leading axis and reward
an (n_agents,) axis over the SAME underlying state, so the whole system
still vmaps/shards as one program. PettingZoo dict adapters live at the
host edge (sustaingym_tpu.compat).

Views implemented (matching the reference semantics):
- MultiAgentBuildingEnv: one agent per AC-equipped zone; every agent sees
  the global obs and the same global reward (building/multiagent_env.py:54,91-97).
- MultiAgentCogenEnv: agents GT1/GT2/GT3/ST with action-component subsets;
  per-agent reward = own fuel+ramp+cv + shared non-delivery/4
  (cogen/multiagent_env.py:50-55,97-101).
- MultiAgentEVChargingEnv: one agent per station, scalar action each;
  flattened global obs; optional ``periods_delay`` staleness so other
  agents' est_departures/demands are delayed (evcharging/multiagent_env.py:
  100,130-148); global reward / n per agent (:186).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core import (Box, DictSpace, FunctionalEnv, TimeStep, dataclass,
                    flatdim, flatten, static_field)
from .building.env import BuildingEnv, BuildingParams
from .cogen.env import ACTION_KEYS, CogenEnv, CogenParams
from .evcharging.env import EVChargingEnv, EVParams, EVState

__all__ = ["MultiAgentBuildingEnv", "MultiAgentCogenEnv",
           "MultiAgentEVChargingEnv", "COGEN_AGENTS",
           "COGEN_AGENT_ACTION_IDX"]


# ---------------------------------------------------------------------------
# Building
# ---------------------------------------------------------------------------

class MultiAgentBuildingEnv(FunctionalEnv):
    """Agents = indices of AC-equipped zones. Actions: (n_agents, 1) in
    [-1, 1]; obs: (n_agents, n+4) global state replicated; rewards:
    (n_agents,) same global reward."""

    name = "building-multiagent"
    agent_axis = True

    def __init__(self, base: BuildingEnv | None = None):
        self.base = base or BuildingEnv()
        self._agent_idx: list[int] | None = None

    def agent_ids(self, params: BuildingParams) -> list[int]:
        # static agent set: computed once from concrete params (the first
        # call must be outside jit; reset()/adapter construction does this)
        if self._agent_idx is None:
            self._agent_idx = [
                int(i) for i in np.nonzero(np.asarray(params.ac_map))[0]]
        return self._agent_idx

    def _expand(self, params, ts: TimeStep) -> TimeStep:
        n_agents = len(self.agent_ids(params))
        obs = jnp.broadcast_to(ts.obs, (n_agents,) + ts.obs.shape)
        reward = jnp.broadcast_to(ts.reward, (n_agents,))
        return ts.replace(obs=obs, reward=reward)

    def reset(self, params, key):
        state, ts = self.base.reset(params, key)
        return state, self._expand(params, ts)

    def reset_at_epoch(self, params, epoch, **kw):
        state, ts = self.base.reset_at_epoch(params, epoch, **kw)
        return state, self._expand(params, ts)

    def step(self, params, state, action, key):
        agents = self.agent_ids(params)
        action = jnp.reshape(jnp.asarray(action), (len(agents),))
        full = jnp.zeros(params.n, action.dtype).at[
            jnp.asarray(agents)].set(action)
        state, ts = self.base.step(params, state, full, key)
        return state, self._expand(params, ts)

    def observation_space(self, params):
        return self.base.observation_space(params)

    def action_space(self, params):
        return Box(-1.0, 1.0, (len(self.agent_ids(params)), 1))

    def episode_steps(self, params):
        return self.base.episode_steps(params)


# ---------------------------------------------------------------------------
# Cogen
# ---------------------------------------------------------------------------

COGEN_AGENTS = ("GT1", "GT2", "GT3", "ST")
# per-agent indices into the flat 15-dim action
# (cogen/multiagent_env.py:50-55)
COGEN_AGENT_ACTION_IDX = {
    "GT1": (0, 1, 2, 3),
    "GT2": (4, 5, 6, 7),
    "GT3": (8, 9, 10, 11),
    "ST": (12, 13, 14),
}
# padded per-agent action layout for the native SPMD learner: every agent
# owns max(4) action slots; ST's 4th slot is padding (mask False). The
# learner trains one policy PER agent (stacked params vmapped over the agent
# axis), matching the reference's per-agent RLLib PolicySpec semantics
# (/root/reference/examples/cogen/train_rllib.py:119-132).
COGEN_PAD_DIM = 4
_COGEN_PAD_MASK = np.zeros((len(COGEN_AGENTS), COGEN_PAD_DIM), dtype=bool)
_COGEN_FLAT_IDX = np.zeros((len(COGEN_AGENTS), COGEN_PAD_DIM), dtype=np.int32)
for _a, _agent in enumerate(COGEN_AGENTS):
    for _j, _flat in enumerate(COGEN_AGENT_ACTION_IDX[_agent]):
        _COGEN_PAD_MASK[_a, _j] = True
        _COGEN_FLAT_IDX[_a, _j] = _flat


class MultiAgentCogenEnv(FunctionalEnv):
    """Agents GT1/GT2/GT3/ST. Actions: dict agent -> sub-vector (host edge),
    the assembled flat 15-vector split per COGEN_AGENT_ACTION_IDX, or the
    padded (4, 4) per-agent array consumed by the native learner.
    Obs: (4, obs_flat_dim) global; rewards: (4,) per-agent costs."""

    name = "cogen-multiagent"
    agent_axis = True

    def episode_steps(self, params):
        return self.base.episode_steps(params)

    # heterogeneous per-agent action dims (4/4/4/3): the native learner must
    # stack per-agent policy params and mask the padded slot rather than
    # share one policy across the agent axis
    per_agent_policy = True

    def __init__(self, base: CogenEnv | None = None):
        self.base = base or CogenEnv()

    def assemble_action(self, agent_actions: dict[str, jax.Array]
                        ) -> jax.Array:
        full = jnp.zeros(len(ACTION_KEYS),
                         jax.tree.leaves(agent_actions)[0].dtype)
        for agent, idx in COGEN_AGENT_ACTION_IDX.items():
            full = full.at[jnp.asarray(idx)].set(agent_actions[agent])
        return full

    def _flat_obs(self, params, obs):
        return flatten(self.base.observation_space(params), obs)

    def _expand(self, params, ts: TimeStep, rewards: jax.Array) -> TimeStep:
        flat = self._flat_obs(params, ts.obs)
        obs = jnp.broadcast_to(flat, (len(COGEN_AGENTS),) + flat.shape)
        return ts.replace(obs=obs, reward=rewards)

    def reset(self, params, key):
        state, ts = self.base.reset(params, key)
        return state, self._expand(
            params, ts, jnp.zeros(len(COGEN_AGENTS), flat_dtype(params)))

    def step(self, params, state, action, key):
        action = jnp.asarray(action)
        if action.shape == (len(COGEN_AGENTS), COGEN_PAD_DIM):
            # padded per-agent layout from the native learner: scatter the
            # valid entries back into the flat 15-vector (padding ignored);
            # index arrays are static numpy so the gather/scatter compiles
            # to fixed-shape ops
            valid = np.nonzero(_COGEN_PAD_MASK.reshape(-1))[0]
            dest = _COGEN_FLAT_IDX.reshape(-1)[valid]
            flat = jnp.zeros(len(ACTION_KEYS), action.dtype)
            action = flat.at[dest].set(action.reshape(-1)[valid])
        else:
            action = jnp.reshape(action, (len(ACTION_KEYS),))
        state, ts = self.base.step(params, state, action, key)
        info = ts.info
        nd_share = info["non_delivery_cost"] / len(COGEN_AGENTS)
        fuel = jnp.concatenate([info["fuel_costs"],
                                jnp.zeros(1, info["fuel_costs"].dtype)])
        rewards = -(fuel + info["ramp_costs"] + info["dyn_cv_costs"]
                    + nd_share)
        return state, self._expand(params, ts, rewards)

    def observation_space(self, params):
        return self.base.observation_space(params)

    def action_space(self, params):
        return self.base.action_space(params)

    def agent_action_space(self, params, agent: str) -> Box:
        space = self.base.action_space(params)
        idx = list(COGEN_AGENT_ACTION_IDX[agent])
        return Box(space.low[idx], space.high[idx])

    def padded_action_space(self, params) -> Box:
        """(n_agents, COGEN_PAD_DIM) Box for the native per-agent learner;
        padded slots get dummy [0, 1] bounds (masked out of the policy's
        log-prob/entropy and ignored by :meth:`step`)."""
        space = self.base.action_space(params)
        low = np.zeros((len(COGEN_AGENTS), COGEN_PAD_DIM))
        high = np.ones((len(COGEN_AGENTS), COGEN_PAD_DIM))
        low[_COGEN_PAD_MASK] = space.low[_COGEN_FLAT_IDX[_COGEN_PAD_MASK]]
        high[_COGEN_PAD_MASK] = space.high[_COGEN_FLAT_IDX[_COGEN_PAD_MASK]]
        return Box(low, high)

    def action_pad_mask(self) -> np.ndarray:
        """(n_agents, COGEN_PAD_DIM) bool: True where the padded slot is a
        real action component."""
        return _COGEN_PAD_MASK.copy()


def flat_dtype(params: CogenParams):
    return params.ambients.dtype


# ---------------------------------------------------------------------------
# EV charging
# ---------------------------------------------------------------------------

@dataclass
class MAEVParams:
    base: EVParams
    periods_delay: int = static_field(default=0)
    # > 0: per-agent actions are Discrete(discrete_bins) mapped to [0, 1] by
    # a/(bins-1) — DiscreteActionWrapper composed into the view, mirroring
    # the reference's MultiAgentEVChargingEnv(discrete_bins=...)
    # (/root/reference/sustaingym/envs/evcharging/multiagent_env.py:64,80
    # and wrappers.py:43-45)
    discrete_bins: int = static_field(default=0)


@dataclass
class MAEVState:
    base: EVState
    # staleness ring buffer of past (est_departures, demands), newest last
    past_obs: jax.Array   # (delay, 2, n) — zeros-shaped (1,2,n) when delay=0
    prev_flat: jax.Array  # flattened current obs (for convenience)


class MultiAgentEVChargingEnv(FunctionalEnv[MAEVParams, MAEVState]):
    """One agent per station. Obs: (n_stations, flat_dim); with
    ``periods_delay`` > 0, rows i see delayed est_departures/demands for
    stations != i and current values for themselves."""

    name = "evcharging-multiagent"
    agent_axis = True

    def __init__(self, base: EVChargingEnv | None = None):
        self.base = base or EVChargingEnv()

    def episode_steps(self, params: MAEVParams):
        return self.base.episode_steps(params.base)

    # flat layout mirrors gymnasium.spaces.flatten over the obs Dict in key
    # insertion order (evcharging/multiagent_env.py:115)
    def _flat(self, params: EVParams, obs: dict[str, jax.Array]) -> jax.Array:
        return flatten(self.base.observation_space(params), obs)

    def _agent_obs(self, params: MAEVParams, obs: dict[str, jax.Array],
                   past: jax.Array) -> jax.Array:
        n = params.base.n_stations
        if params.periods_delay == 0:
            flat = self._flat(params.base, obs)
            return jnp.broadcast_to(flat, (n,) + flat.shape)
        stale_est, stale_dem = past[0, 0], past[0, 1]
        eye = jnp.eye(n, dtype=bool)
        est = jnp.where(eye, obs["est_departures"][None, :],
                        stale_est[None, :])     # (n agents, n stations)
        dem = jnp.where(eye, obs["demands"][None, :], stale_dem[None, :])

        def flat_row(est_row, dem_row):
            return self._flat(params.base,
                              {**obs, "est_departures": est_row,
                               "demands": dem_row})

        return jax.vmap(flat_row)(est, dem)

    def _push(self, params: MAEVParams, past: jax.Array,
              obs: dict[str, jax.Array]) -> jax.Array:
        if params.periods_delay == 0:
            return past
        new = jnp.stack([obs["est_departures"], obs["demands"]])
        return jnp.concatenate([past[1:], new[None]], axis=0)

    def reset(self, params: MAEVParams, key):
        base_state, ts = self.base.reset(params.base, key)
        return self._after_reset(params, base_state, ts)

    def reset_at_day(self, params: MAEVParams, day):
        base_state, ts = self.base.reset_at_day(params.base, day)
        return self._after_reset(params, base_state, ts)

    def _after_reset(self, params, base_state, ts):
        n = params.base.n_stations
        delay = max(params.periods_delay, 1)
        init = jnp.stack([ts.obs["est_departures"], ts.obs["demands"]])
        past = jnp.broadcast_to(init[None], (delay,) + init.shape)
        flat = self._flat(params.base, ts.obs)
        state = MAEVState(base=base_state, past_obs=past, prev_flat=flat)
        obs = self._agent_obs(params, ts.obs, past)
        reward = jnp.zeros(n, flat.dtype)
        return state, ts.replace(obs=obs, reward=reward)

    def step(self, params: MAEVParams, state: MAEVState, action, key):
        n = params.base.n_stations
        action = jnp.reshape(jnp.asarray(action), (n,))
        if params.discrete_bins > 0:
            # {0..bins-1} -> {0, 1/(bins-1), ..., 1} (wrappers.py:43-45)
            action = (action.astype(jnp.float32)
                      / (params.discrete_bins - 1))
        base_state, ts = self.base.step(params.base, state.base, action, key)
        # stale values come from the buffer BEFORE pushing the new obs:
        # the reference pops the (t - delay) entry, then appends obs(t)
        # (evcharging/multiagent_env.py:131-140)
        obs = self._agent_obs(params, ts.obs, state.past_obs)
        past = self._push(params, state.past_obs, ts.obs)
        flat = self._flat(params.base, ts.obs)
        new_state = MAEVState(base=base_state, past_obs=past, prev_flat=flat)
        reward = jnp.broadcast_to(ts.reward / n, (n,))
        return new_state, ts.replace(obs=obs, reward=reward)

    # ---- uniform-obs fast path ------------------------------------------
    def uniform_agent_obs(self, params: MAEVParams) -> bool:
        """True when every agent's obs row is IDENTICAL by construction —
        ``periods_delay == 0`` broadcasts the global flat obs to all
        agents (reference multiagent_env.py:115 with delay off). Learners
        can then run the policy trunk once per env and broadcast, which
        is gradient-exact for a shared policy (each unique obs row's
        weight gradient is the sum of its agents' contributions)."""
        return params.periods_delay == 0 and params.discrete_bins == 0

    def uniform_ma_unroll(self, params: MAEVParams, policy, policy_params,
                          key: jax.Array, batch: int, num_steps: int):
        """delay=0 rollout on the BASE env (no per-agent obs broadcast is
        ever materialized): ``policy`` receives the base env's raw obs
        dict batch and must return the (batch, n_stations) base action.
        Returns the base env's TimeStep (flat obs, global reward)."""
        return self.base.batch_unroll(params.base, policy, policy_params,
                                      key, batch, num_steps)

    # ---- lockstep fast path ---------------------------------------------
    def batch_unroll(self, params: MAEVParams, policy, policy_params,
                     key: jax.Array, batch: int, num_steps: int,
                     prefetch: int = 48) -> TimeStep:
        """Lockstep whole-episode unroll of the multi-agent view — the
        episodic fast path the shared-policy PPO learner rides (round-4
        verdict item 2; BASELINE configs[4]). Reuses the base env's
        segment driver (envs/evcharging/env._lockstep_ev_unroll: onehot
        day-row fetch, autoreset PRNG contract) with the view's
        staleness-ring + per-agent-obs step stacked on top, so
        trajectories match the generic ``autoreset_vstep`` path on the
        same PRNG stream exactly like the base env's ``batch_unroll``
        does."""
        del prefetch
        from .evcharging.env import _lockstep_ev_unroll

        n = params.base.n_stations

        def step_row(state: MAEVState, action, row):
            action = jnp.reshape(jnp.asarray(action), (n,))
            if params.discrete_bins > 0:
                action = (action.astype(jnp.float32)
                          / (params.discrete_bins - 1))
            base_state, ts = self.base._step_row(
                params.base, state.base, action, row)
            obs = self._agent_obs(params, ts.obs, state.past_obs)
            past = self._push(params, state.past_obs, ts.obs)
            flat = self._flat(params.base, ts.obs)
            new_state = MAEVState(base=base_state, past_obs=past,
                                  prev_flat=flat)
            reward = jnp.broadcast_to(ts.reward / n, (n,))
            return new_state, ts.replace(obs=obs, reward=reward)

        return _lockstep_ev_unroll(
            params.base,
            reset_fn=lambda k: self.reset(params, k),
            reset_at_day_fn=lambda d: self.reset_at_day(params, d),
            step_row_fn=step_row,
            day_of=lambda st: st.base.day,
            policy=policy, policy_params=policy_params, key=key,
            batch=batch, num_steps=num_steps)

    def observation_space(self, params: MAEVParams):
        return self.base.observation_space(params.base)

    def action_space(self, params: MAEVParams):
        if params.discrete_bins > 0:
            from ..core import MultiDiscrete
            return MultiDiscrete(np.full((params.base.n_stations, 1),
                                         params.discrete_bins,
                                         dtype=np.int64))
        return Box(0.0, 1.0, (params.base.n_stations, 1))


def make_ma_ev_params(periods_delay: int = 0, discrete_bins: int = 0,
                      **kwargs) -> MAEVParams:
    from .evcharging import make_params
    if discrete_bins == 1:
        # a/(bins-1) would divide by zero and silently flood the env with
        # NaNs; 1 bin means "no action choice" and is never meaningful
        raise ValueError("discrete_bins must be 0 (continuous) or >= 2")
    return MAEVParams(base=make_params(**kwargs),
                      periods_delay=periods_delay,
                      discrete_bins=discrete_bins)
