"""BuildingEnv — pure jittable multi-zone thermal RC control (layer L2'/L3').

Semantics mirror the reference BuildingEnv
(/root/reference/sustaingym/envs/building/env.py:16-434): a discrete LTI
update ``X' = A_d X + BD_d Y`` per step, occupant sensible-heat polynomial,
reward ``-(q_rate * ||a||_p + beta * ||err||_p)``, seed->epoch episode
selection over a year of weather. Redesigned for batched accelerators:

- all per-step work is one (n,n)x(n,) + (n,n+4)x(n+4,) matmul pair — fused by
  XLA and vmapped over thousands of building instances;
- exogenous weather/occupancy live in device arrays indexed by a traced epoch
  (dynamic gather), so the full episode rolls under ``lax.scan``;
- autoreset is functional (core.autoreset_step).
"""
from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ...core import (Box, FunctionalEnv, MultiDiscrete, TimeStep, dataclass,
                     static_field)

# Occupancy sensible-heat polynomial coefficients, EnergyPlus engineering
# reference p.1299 (/root/reference/sustaingym/envs/building/env.py:87-99).
OCCU_COEF = (6.461927, 0.946892, 0.0000255737, 0.0627909, 0.0000589172,
             0.19855, 0.000940018, 0.00000149532)
OCCU_COEF_LINEAR = 7.139322
DISCRETE_LENGTH = 100
SCALING_FACTOR = 24


@dataclass
class BuildingParams:
    """Device-side parameter pack (compiled once on host)."""
    # dynamics
    A_d: jax.Array            # (n, n)
    BD_d: jax.Array           # (n, n+4)
    # exogenous year-long series at time_res resolution
    out_temp: jax.Array       # (T,)
    ground_temp: jax.Array    # (T,)
    ghi: jax.Array            # (T,) normalized [0, 1]
    metabolism: jax.Array     # (T,)
    # packed exogenous table [out, ground, ghi, metabolism], padded with its
    # own first episode_len rows so epoch wraparound reads (reference
    # env.py:302-305 wraps epoch to 0) resolve without a modulo. One row
    # gather per step replaces four scalar gathers.
    exog: jax.Array           # (T + episode_len, 4)
    # the same table packed 32 epochs per 128-float row: the generic
    # (vmapped) step gathers one 128-wide chunk row and selects the
    # epoch's 4 columns with an EXACT one-hot contract (one 1.0*v product
    # per output) instead of gathering a 4-wide row per env. Its cost on
    # the H100 against a plain row gather is not measured.
    exog_chunks: jax.Array    # (ceil((T+episode_len)/32), 128)
    # zone config
    target: jax.Array         # (n,)
    ac_map: jax.Array         # (n,)
    # reward
    q_rate: jax.Array         # scalar
    error_rate: jax.Array     # scalar
    # static metadata
    n: int = static_field()
    episode_len: int = static_field()
    length_of_weather: int = static_field()
    reward_pnorm: float = static_field()
    max_power: float = static_field()
    time_resolution: int = static_field()
    temp_min: float = static_field()
    temp_max: float = static_field()
    is_continuous_action: bool = static_field(default=True)
    # data-driven dynamics mode (reference env.py:436-490 `train()`):
    # BD_d has n+7 input columns [avg^2, avg, meta^2, meta, ground, out,
    # action(n), ghi] instead of the physics model's n+4
    data_driven: bool = static_field(default=False)


@dataclass
class BuildingState:
    x: jax.Array              # (n,) zone temperatures (step precision)
    occupower: jax.Array      # scalar, W
    epoch: jax.Array          # int32 index into weather arrays
    steps: jax.Array          # int32 steps taken this episode


def make_params(p: dict[str, Any], dtype=jnp.float32) -> BuildingParams:
    """Packs the host compiler's dict (envs/building/params.py) into the
    device pytree, precomputing the ZOH discretisation."""
    from .params import discretize
    A_d, BD_d = discretize(np.asarray(p["A"]), np.asarray(p["B"]),
                           np.asarray(p["D"]), p["time_resolution"])
    n = p["n"]
    beta = p["reward_beta"]
    episode_len = int(p["episode_len"])
    exog = np.stack([np.asarray(p["out_temp"], np.float64),
                     np.asarray(p["ground_temp"], np.float64),
                     np.asarray(p["ghi"], np.float64),
                     np.asarray(p["metabolism"], np.float64)], axis=1)
    exog = np.concatenate([exog, exog[:episode_len]], axis=0)
    pad_rows = (-len(exog)) % 32
    exog_padded = np.concatenate(
        [exog, np.zeros((pad_rows, 4), exog.dtype)], axis=0)
    exog_chunks = exog_padded.reshape(-1, 128)
    return BuildingParams(
        A_d=jnp.asarray(A_d, dtype),
        BD_d=jnp.asarray(BD_d, dtype),
        out_temp=jnp.asarray(p["out_temp"], dtype),
        ground_temp=jnp.asarray(p["ground_temp"], dtype),
        ghi=jnp.asarray(p["ghi"], dtype),
        metabolism=jnp.asarray(p["metabolism"], dtype),
        exog=jnp.asarray(exog, dtype),
        exog_chunks=jnp.asarray(exog_chunks, dtype),
        target=jnp.asarray(p["target"], dtype),
        ac_map=jnp.asarray(p["ac_map"], dtype),
        q_rate=jnp.asarray((1 - beta) * SCALING_FACTOR, dtype),
        error_rate=jnp.asarray(beta, dtype),
        n=n,
        episode_len=int(p["episode_len"]),
        length_of_weather=int(len(p["out_temp"])),
        reward_pnorm=float(p["reward_pnorm"]),
        max_power=float(p["max_power"]),
        time_resolution=int(p["time_resolution"]),
        temp_min=float(p["temp_range"][0]),
        temp_max=float(p["temp_range"][1]),
        is_continuous_action=bool(p["is_continuous_action"]),
    )


def calc_occupower(temp: jax.Array, meta: jax.Array) -> jax.Array:
    """Occupant sensible heat gain (W)
    (/root/reference/sustaingym/envs/building/env.py:411-434).

    Precision contract: products involving ``temp`` are evaluated at
    ``temp.dtype`` before being widened by ``meta``. This reproduces NumPy 2
    weak scalar promotion in the reference, where the step-time temperature is
    a float32 scalar (mean of the float32 obs) and ``coef * temp`` rounds the
    coefficient to float32, while at reset time temp is float64.
    """
    temp = jnp.asarray(temp)
    meta = jnp.asarray(meta)
    tdt = temp.dtype
    wdt = jnp.result_type(tdt, meta.dtype)
    c = [jnp.asarray(ci, tdt) for ci in OCCU_COEF]
    cw = [jnp.asarray(ci, wdt) for ci in OCCU_COEF]
    t2 = temp * temp
    meta2 = meta * meta
    return (cw[0] + cw[1] * meta + cw[2] * meta2
            - (c[3] * temp).astype(wdt) * meta
            + (c[4] * temp).astype(wdt) * meta2
            - (c[5] * t2).astype(wdt)
            + (c[6] * t2).astype(wdt) * meta
            - (c[7] * t2).astype(wdt) * meta2)


def _seq_sum(x: jax.Array, n: int) -> jax.Array:
    """Strictly sequential sum over a small static-length vector.

    XLA's ``reduce`` may use a tree order; numpy sums short vectors
    sequentially. For n <= 32 we unroll to preserve bit-level parity of the
    average-temperature reduction feeding the occupancy polynomial.
    """
    if n <= 32:
        s = x[0]
        for i in range(1, n):
            s = s + x[i]
        return s
    return jnp.sum(x)


def _pnorm(x: jax.Array, p: float) -> jax.Array:
    n = x.shape[-1]
    if p == 2:
        return jnp.sqrt(_seq_sum(x * x, n))
    if p == 1:
        return _seq_sum(jnp.abs(x), n)
    return _seq_sum(jnp.abs(x) ** p, n) ** (1.0 / p)


class BuildingEnv(FunctionalEnv[BuildingParams, BuildingState]):
    """Functional BuildingEnv.

    ``reset(params, key)`` picks a uniform-random starting epoch in
    [0, T-2] like the reference's unseeded reset
    (/root/reference/sustaingym/envs/building/env.py:339-340); deterministic
    seeded resets go through :meth:`reset_at_epoch` +
    :meth:`epoch_from_seed` (env.py:341-345).
    """

    name = "building"

    # ---- seeding --------------------------------------------------------
    @staticmethod
    def epoch_from_seed(params: BuildingParams, seed: int) -> int:
        num_days_normalizer = (
            (params.episode_len * params.time_resolution) // 86_400) * 365
        epoch = int((seed / num_days_normalizer) * params.length_of_weather)
        return min(epoch, params.length_of_weather - 1)

    # ---- pure API -------------------------------------------------------
    @staticmethod
    def _exog_row(params: BuildingParams, epoch) -> jax.Array:
        """Fetch exog[epoch] via the packed chunk table: one 128-wide
        aligned row gather + an exact one-hot column contract (bit-equal
        to ``params.exog[epoch]`` — each output is a single 1.0 * v
        product accumulated with zeros)."""
        chunk = params.exog_chunks[epoch // 32]            # (..., 128)
        onehot = (jnp.arange(32) == jnp.asarray(epoch % 32)[..., None]
                  ).astype(chunk.dtype)
        rows = chunk.reshape(*chunk.shape[:-1], 32, 4)
        return jnp.einsum("...c,...cf->...f", onehot, rows,
                          precision=jax.lax.Precision.HIGHEST)

    def reset(self, params: BuildingParams, key: jax.Array
              ) -> tuple[BuildingState, TimeStep]:
        epoch = jax.random.randint(key, (), 0, params.length_of_weather - 1)
        return self.reset_at_epoch(params, epoch)

    def reset_at_epoch(self, params: BuildingParams, epoch,
                       t_initial: jax.Array | None = None
                       ) -> tuple[BuildingState, TimeStep]:
        epoch = jnp.asarray(epoch, jnp.int32)
        exog_row = self._exog_row(params, epoch)
        x0 = params.target if t_initial is None else jnp.asarray(t_initial)
        avg_temp = _seq_sum(x0, params.n) / params.n
        occupower = calc_occupower(avg_temp, exog_row[3])
        state = BuildingState(
            x=x0.astype(params.A_d.dtype), occupower=occupower,
            epoch=epoch, steps=jnp.zeros((), jnp.int32))
        obs = self._obs(params, state, exog_row)
        ts = TimeStep(
            obs=obs, reward=jnp.zeros((), params.A_d.dtype),
            terminated=jnp.zeros((), bool), truncated=jnp.zeros((), bool),
            info=self._zero_info(params))
        return state, ts

    def step(self, params: BuildingParams, state: BuildingState,
             action: jax.Array, key: jax.Array
             ) -> tuple[BuildingState, TimeStep]:
        del key  # dynamics are deterministic
        exog_row = self._exog_row(params, state.epoch)
        x_new, occupower, reward, obs, info = self._step_exog(
            params, state.x, action, exog_row)

        next_epoch = jnp.where(state.epoch + 1 >= params.length_of_weather,
                               0, state.epoch + 1)
        steps = state.steps + 1
        done = steps >= params.episode_len

        new_state = BuildingState(
            x=x_new, occupower=occupower, epoch=next_epoch, steps=steps)
        ts = TimeStep(
            obs=obs, reward=reward,
            terminated=done, truncated=done,
            info=info)
        return new_state, ts

    def _step_exog(self, params: BuildingParams, x: jax.Array,
                   action: jax.Array, exog_row: jax.Array):
        """Dynamics + reward + obs given the step's exogenous row
        ``[out_temp, ground_temp, ghi, metabolism]``. Shared by the generic
        per-state :meth:`step` (which gathers the row by epoch) and the
        lockstep :meth:`batch_unroll` (which prefetches rows time-major so
        the episode scan does no gathers at all)."""
        dtype = params.A_d.dtype
        if not params.is_continuous_action:
            # MultiDiscrete {0..2*100*ac} -> continuous [-ac, ac]
            # (/root/reference/sustaingym/envs/building/env.py:234-235)
            action = (jnp.asarray(action, dtype)
                      - params.ac_map * DISCRETE_LENGTH) / DISCRETE_LENGTH
        # the action norm in the reward is evaluated at the caller's dtype
        # (reference norms the incoming float32 action directly, env.py:276)
        action_in = jnp.asarray(action)
        action = jnp.asarray(action, dtype)

        out_t, ground_t, ghi_t, meta = (exog_row[0], exog_row[1],
                                        exog_row[2], exog_row[3])
        # obs vector is stored at float32 precision between steps, matching
        # the reference's float32 state cast (env.py:286-296)
        x_in = x.astype(jnp.float32).astype(dtype)
        # the reference averages the float32 obs vector (env.py:249); keep the
        # reduction AND the polynomial's temp products in float32 for parity
        avg_temp32 = _seq_sum(x.astype(jnp.float32), params.n) / params.n
        occupower = calc_occupower(avg_temp32, meta).astype(dtype)

        if params.data_driven:
            # Y = [avg^2, avg, meta^2, meta, ground, out, a(n), ghi]
            # (env.py:252-257)
            avg = avg_temp32.astype(dtype)
            y = jnp.concatenate([
                jnp.stack([avg * avg, avg, meta * meta, meta,
                           ground_t, out_t]),
                action, ghi_t[None]])
        else:
            # Y = [occupower, ground, out, action(n), ghi] (env.py:243-263)
            y = jnp.concatenate([
                jnp.stack([occupower, ground_t, out_t]),
                action, ghi_t[None]])

        x_new = params.A_d @ x_in + params.BD_d @ y

        # keep the reference's exact expression order for bit parity
        # (env.py:272): X_new * ac_map - target * ac_map
        error = x_new * params.ac_map - params.target * params.ac_map
        p = params.reward_pnorm
        # norm(f32 action) * q_rate stays float32 under NumPy-2 weak
        # promotion in the reference (env.py:276); reproduce before widening
        power_cost = (_pnorm(action_in, p)
                      * params.q_rate.astype(action_in.dtype)).astype(dtype)
        comfort_cost = _pnorm(error, p) * params.error_rate
        reward = -(power_cost + comfort_cost)

        obs = jnp.concatenate([
            x_new,
            jnp.stack([out_t, ground_t, ghi_t, occupower / 1000.0]),
        ]).astype(jnp.float32)
        info = {
            "zone_temperature": x_new,
            "comfort_level": -comfort_cost,
            "power_consumption": -power_cost,
        }
        return x_new, occupower, reward, obs, info

    def episode_steps(self, params: BuildingParams) -> int:
        return int(params.episode_len)

    # ---- lockstep fast path ----------------------------------------------
    def batch_unroll(self, params: BuildingParams, policy, policy_params,
                     key: jax.Array, batch: int, num_steps: int) -> TimeStep:
        """Fused reset+rollout of ``batch`` lockstep envs on the same PRNG
        stream as the generic ``batch_rollout`` — identical trajectories up
        to 1 ulp of float32 fusion drift in the autoreset obs — with zero
        per-step gathers.

        Building episodes have a static length, so a batch reset together
        stays in lockstep forever: episode boundaries fall at static scan
        offsets. Within an episode the epoch advances by +1 per step
        (reference env.py:302-305), so each env's exogenous rows for a whole
        episode segment are one contiguous slice of ``params.exog`` — fetched
        with a single vmapped ``dynamic_slice`` per segment (one gather of
        ``batch`` indices amortized over ``episode_len`` steps) and fed to
        ``lax.scan`` time-major.
        """
        L = params.episode_len
        Tw = params.length_of_weather
        dtype = params.A_d.dtype
        key_init, key_scan = jax.random.split(key)
        # identical derivation to core.rollout.batch_reset
        init_keys = jax.random.split(key_init, batch)
        states, ts0 = jax.vmap(self.reset, in_axes=(None, 0))(params, init_keys)
        obs = ts0.obs
        x = states.x
        e0 = states.epoch
        keys = jax.random.split(key_scan, num_steps)

        vcore = jax.vmap(self._step_exog, in_axes=(None, 0, 0, 0))
        x0_fresh = jnp.broadcast_to(
            params.target.astype(dtype), (batch, params.n))

        from ...ops.gather import episode_slice_gather

        parts = []
        t = 0
        while t < num_steps:
            seg_len = min(L, num_steps - t)
            # rows for epochs e0 .. e0+seg_len-1 (padding handles wraparound)
            block = episode_slice_gather(params.exog, e0, seg_len)
            block = jnp.swapaxes(block, 0, 1)          # (seg_len, B, 4)
            seg_keys = keys[t:t + seg_len]

            def body(carry, inp):
                x, obs = carry
                key_t, rows = inp
                key_act, key_env = jax.random.split(key_t)
                actions = policy(policy_params, obs, key_act)
                x_new, occ, reward, obs_new, info = vcore(
                    params, x, actions, rows)
                ts = TimeStep(obs=obs_new, reward=reward,
                              terminated=jnp.zeros((batch,), bool),
                              truncated=jnp.zeros((batch,), bool),
                              info=info)
                return (x_new, obs_new), (ts, key_env)

            (x, obs), (traj, env_keys) = jax.lax.scan(
                body, (x, obs), (seg_keys, block))

            if seg_len == L:
                # episode boundary: mark done and splice in the autoreset
                # obs/state, reproducing core.env.autoreset_step's key
                # derivation exactly (env key -> split -> reset key).
                done = jnp.ones((batch,), bool)
                traj = traj.replace(
                    terminated=traj.terminated.at[-1].set(done),
                    truncated=traj.truncated.at[-1].set(done))
                bkeys = jax.random.split(env_keys[-1], batch)
                reset_keys = jax.vmap(
                    lambda k: jax.random.split(k)[1])(bkeys)
                e0 = jax.vmap(
                    lambda k: jax.random.randint(k, (), 0, Tw - 1))(reset_keys)
                row0 = params.exog[e0]                  # (B, 4)
                avg0 = _seq_sum(params.target, params.n) / params.n
                occ0 = calc_occupower(avg0, row0[:, 3])
                obs = jnp.concatenate([
                    x0_fresh,
                    jnp.stack([row0[:, 0], row0[:, 1], row0[:, 2],
                               occ0 / 1000.0], axis=1),
                ], axis=1).astype(jnp.float32)
                x = x0_fresh
                traj = traj.replace(obs=traj.obs.at[-1].set(obs))
            parts.append(traj)
            t += seg_len

        if len(parts) == 1:
            return parts[0]
        return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *parts)

    def _obs(self, params: BuildingParams, state: BuildingState,
             exog_row: jax.Array | None = None) -> jax.Array:
        """obs = [zone temps (n), out temp, ground temp, ghi, occupower/1000]
        (/root/reference/sustaingym/envs/building/env.py:286-296)."""
        row = params.exog[state.epoch] if exog_row is None else exog_row
        return jnp.concatenate([
            state.x,
            jnp.stack([row[0], row[1], row[2], state.occupower / 1000.0]),
        ]).astype(jnp.float32)

    def _zero_info(self, params: BuildingParams) -> dict[str, jax.Array]:
        dtype = params.A_d.dtype
        return {
            "zone_temperature": jnp.zeros(params.n, dtype),
            "comfort_level": jnp.zeros((), dtype),
            "power_consumption": jnp.zeros((), dtype),
        }

    # ---- metadata -------------------------------------------------------
    def observation_space(self, params: BuildingParams) -> Box:
        """obs = [temps(n), out, ground, ghi, occupower/1000].

        Deviation from the reference (env.py:160-176): its bound vector is
        misaligned with the obs layout (GHI/ground swapped) and gives
        occupower a positive lower bound while values are negative; here the
        bounds match the actual layout and occupower is two-sided.
        """
        n = params.n
        min_t, max_t = params.temp_min, params.temp_max
        heat_max = 1000.0
        low = np.concatenate([
            np.full(n + 2, min_t), [0], [-heat_max]])
        high = np.concatenate([
            np.full(n + 2, max_t), [heat_max], [heat_max]])
        return Box(low, high, dtype=jnp.float32)

    def action_space(self, params: BuildingParams) -> Box | MultiDiscrete:
        ac = np.asarray(params.ac_map, dtype=np.float64)
        if params.is_continuous_action:
            return Box(-ac, ac, dtype=jnp.float32)
        return MultiDiscrete((2 * ac * DISCRETE_LENGTH).astype(np.int64))
