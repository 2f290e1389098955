"""CogenEnv — pure jittable combined-cycle cogeneration dispatch.

Semantics mirror the reference CogenEnv
(/root/reference/sustaingym/envs/cogen/env.py:18-388): 96-step (15-min) day;
Dict action of 15 components (3x GT power/switches/steam + ST power +
condenser flow + cooling bays); obs = time + previous action + 7 noisy
forecast channels; reward = -(fuel + ramp + non-delivery + dynamic
constraint violations). Redesigned for batched accelerators:

- actions/observations are flat fixed-shape arrays (Dict adapters live in
  ``sustaingym_tpu.compat``), so the whole step is one fused XLA program;
- the ONNX plant surrogate becomes the pure-JAX physics surrogate in
  ``plant.py`` (model.onnx is absent from the reference snapshot);
- forecasts are gathers from a padded (n_days, 96+H+1, 7) ambient pack, and
  forecast noise is drawn from the per-step PRNG key.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ...core import (Box, DictSpace, FunctionalEnv, TimeStep, dataclass,
                     static_field)
from . import plant

# Flat action layout, in the reference Dict's insertion order
# (/root/reference/sustaingym/envs/cogen/env.py:114-130).
ACTION_KEYS = (
    "GT1_PWR", "GT1_PAC_FFU", "GT1_EVC_FFU", "HR1_HPIP_M_PROC",
    "GT2_PWR", "GT2_PAC_FFU", "GT2_EVC_FFU", "HR2_HPIP_M_PROC",
    "GT3_PWR", "GT3_PAC_FFU", "GT3_EVC_FFU", "HR3_HPIP_M_PROC",
    "ST_PWR", "IPPROC_M", "CT_NrBays")

ACTION_LOW = np.array([
    plant.GT_PWR_LO[0], 0, 0, plant.HR_LO[0],
    plant.GT_PWR_LO[1], 0, 0, plant.HR_LO[1],
    plant.GT_PWR_LO[2], 0, 0, plant.HR_LO[2],
    plant.ST_LO, plant.IP_LO, 1], dtype=np.float64)
ACTION_HIGH = np.array([
    plant.GT_PWR_HI[0], 1, 1, plant.HR_HI[0],
    plant.GT_PWR_HI[1], 1, 1, plant.HR_HI[1],
    plant.GT_PWR_HI[2], 1, 1, plant.HR_HI[2],
    plant.ST_HI, plant.IP_HI, 12], dtype=np.float64)

# indices of the discrete components within the flat action
BINARY_IDX = (1, 2, 5, 6, 9, 10)
BAYS_IDX = 14
PWR_IDX = (0, 4, 8, 12)  # GT1, GT2, GT3, ST — ramp-cost components

# forecast channel order (env.py:156-158)
FORECAST_KEYS = ("TAMB", "PAMB", "RHAMB", "Target_Power", "Target_Steam",
                 "Energy_Price", "Gas_Price")


@dataclass
class CogenParams:
    # (n_days, 96 + horizon + 1, 7): each day padded with the head of the
    # next day so forecasts never cross an array boundary
    ambients: jax.Array
    # the same pack channel-major and flattened, (n_days, 7 * (96 + h + 1)):
    # the generic (vmapped) step gathers ONE wide day row from here and
    # extracts the now-row/forecast window with exact one-hot time
    # contracts instead of gathering (day, t)-indexed 7-wide slabs from
    # ``ambients`` per env (H100 cost of either form not measured)
    ambients_cm: jax.Array
    ramp_penalty: jax.Array
    supply_imbalance_penalty: jax.Array
    constraint_violation_penalty: jax.Array
    forecast_noise_std: jax.Array
    n_days: int = static_field()
    timesteps_per_day: int = static_field(default=96)
    forecast_horizon: int = static_field(default=3)


@dataclass
class CogenState:
    day: jax.Array          # int32
    t: jax.Array            # int32
    prev_action: jax.Array  # (15,)
    # the episode's channel-major ambient day slab (7, 96+H+1), gathered
    # ONCE at reset and ROLLED one column left per step so that column 0 is
    # always the current time: the now-row and the (h+1)-wide forecast
    # window become STATIC slices instead of a per-env, per-step gather of
    # the wide day row; the roll is a 2.8KB contiguous copy per env per
    # step.
    slab: jax.Array


def make_params(renewables_magnitude: float = 0.0,
                ramp_penalty: float = 2.0,
                supply_imbalance_penalty: float = 1000.0,
                constraint_violation_penalty: float = 1000.0,
                forecast_horizon: int = 3,
                forecast_noise_std: float = 0.0,
                dtype=jnp.float32) -> CogenParams:
    from ...data.cogen_etl import build_ambients_pack
    amb = build_ambients_pack(renewables_magnitude)  # (n_days, 96, 7)
    n_days, steps, _ = amb.shape
    assert 0 <= forecast_horizon < steps - 1
    # pad each day with the first H+1 rows of the following day (wrapping)
    pad = np.roll(amb, -1, axis=0)[:, :forecast_horizon + 1, :]
    amb_padded = np.concatenate([amb, pad], axis=1)
    return CogenParams(
        ambients=jnp.asarray(amb_padded, dtype),
        ambients_cm=jnp.asarray(
            amb_padded.transpose(0, 2, 1).reshape(n_days, -1), dtype),
        ramp_penalty=jnp.asarray(ramp_penalty, dtype),
        supply_imbalance_penalty=jnp.asarray(supply_imbalance_penalty, dtype),
        constraint_violation_penalty=jnp.asarray(constraint_violation_penalty, dtype),
        forecast_noise_std=jnp.asarray(forecast_noise_std, dtype),
        n_days=int(n_days),
        timesteps_per_day=int(steps),
        forecast_horizon=int(forecast_horizon),
    )


def pack_model_input(ambient_row: jax.Array, action: jax.Array) -> jax.Array:
    """Builds the 18-dim plant-model input from the true ambient row and the
    flat action (mirrors env.py:294-302)."""
    a = action
    return jnp.concatenate([
        ambient_row[:3],                                    # TAMB, PAMB, RHAMB
        jnp.stack([a[1], a[2], a[0],                        # GT1 PAC, EVC, PWR
                   a[5], a[6], a[4],                        # GT2
                   a[9], a[10], a[8],                       # GT3
                   a[3], a[7], a[11],                       # HR1-3 steam
                   a[12], a[13], a[14]]),                   # ST, IPPROC, bays
    ])


def dyn_constraint_violation(x: jax.Array, y: jax.Array) -> jax.Array:
    """16-element dynamic operating-constraint violation
    (mirrors env.py:232-274)."""
    r = jax.nn.relu
    return jnp.stack([
        r(y[9] - x[5]), r(x[5] - y[10]),      # GT1 power min/max
        r(y[15] - x[12]), r(x[12] - y[16]),   # GT1 HRSG steam min/max
        r(y[11] - x[8]), r(x[8] - y[12]),     # GT2 power
        r(y[17] - x[13]), r(x[13] - y[18]),   # GT2 steam
        r(y[13] - x[11]), r(x[11] - y[14]),   # GT3 power
        r(y[19] - x[14]), r(x[14] - y[20]),   # GT3 steam
        r(y[24] - x[15]), r(x[15] - y[25]),   # ST power
        r(x[16] - y[22]), r(x[16] - y[23]),   # IP process steam letdown
    ])


class CogenEnv(FunctionalEnv[CogenParams, CogenState]):
    name = "cogen"
    # NOTE: with the rolled state slab, reset is the expensive side (wide
    # ambients_cm day gather) and the step is cheap, which is the case the
    # gated autoreset (core.env.autoreset_vstep default) is for.

    # ---- seeding --------------------------------------------------------
    @staticmethod
    def day_from_seed(params: CogenParams, seed: int) -> int:
        """seed -> episode day (env.py:214-216)."""
        return seed % params.n_days

    # ---- helpers --------------------------------------------------------
    def sample_action(self, params: CogenParams, key: jax.Array) -> jax.Array:
        """Uniform sample over the flat action space (Box components uniform,
        binary switches Bernoulli(1/2), bays uniform integer 1..12) — the
        functional analogue of ``action_space.sample()`` at reset
        (env.py:222-223)."""
        dtype = params.ambients.dtype
        k1, k2, k3 = jax.random.split(key, 3)
        low = jnp.asarray(ACTION_LOW, dtype)
        high = jnp.asarray(ACTION_HIGH, dtype)
        u = jax.random.uniform(k1, (len(ACTION_KEYS),), dtype=dtype)
        a = low + u * (high - low)
        binm = np.zeros(len(ACTION_KEYS), dtype=bool)
        binm[list(BINARY_IDX)] = True
        bins = jax.random.bernoulli(k2, 0.5, (len(ACTION_KEYS),)).astype(dtype)
        a = jnp.where(jnp.asarray(binm), bins, a)
        bays = jax.random.randint(k3, (), 1, 13).astype(dtype)
        a = a.at[BAYS_IDX].set(bays)
        return a

    @staticmethod
    def _day_slab(params: CogenParams, day: jax.Array) -> jax.Array:
        """(7, rows) channel-major day slab from ONE wide row gather."""
        rows = params.timesteps_per_day + params.forecast_horizon + 1
        flat = params.ambients_cm[day]
        return flat.reshape(*flat.shape[:-1], 7, rows)

    @staticmethod
    def _slab_window(params: CogenParams, slab: jax.Array, t: jax.Array
                     ) -> jax.Array:
        """(h+1, 7) noise-free window at ``t`` via an exact one-hot time
        contract (each output is a single 1.0 * v product — bit-equal to
        the dynamic_slice of ``ambients[day]`` it replaces)."""
        h = params.forecast_horizon
        rows = params.timesteps_per_day + h + 1
        w = (jnp.asarray(t, jnp.int32)[..., None, None]
             + jnp.arange(h + 1)[:, None] == jnp.arange(rows)[None, :])
        return jnp.einsum("...wt,...ct->...wc", w.astype(slab.dtype), slab,
                          precision=jax.lax.Precision.HIGHEST)

    def _forecast(self, params: CogenParams, key: jax.Array,
                  slab: jax.Array) -> jax.Array:
        """(H+1, 7) forecast slice with iid Gaussian noise on future rows
        (env.py:145-162). ``slab`` is (7, rows) aligned so column 0 is the
        current time — the window is a static slice, and the noise lands
        via concatenate instead of an .at[1:].add scatter."""
        h = params.forecast_horizon
        window = jnp.swapaxes(slab[..., :h + 1], -1, -2)   # (h+1, 7)
        noise = params.forecast_noise_std * jax.random.normal(
            key, (h, 7), dtype=window.dtype)
        return jnp.concatenate([window[:1], window[1:] + noise], axis=0)

    def _obs(self, params: CogenParams, state: CogenState, key: jax.Array,
             slab: jax.Array) -> dict[str, jax.Array]:
        f = self._forecast(params, key, slab)
        dtype = params.ambients.dtype
        obs = {
            "Time": (state.t / params.timesteps_per_day).astype(dtype)[None],
            "Prev_Action": state.prev_action,
        }
        for i, name in enumerate(FORECAST_KEYS):
            obs[name] = f[:, i]
        return obs

    # ---- pure API -------------------------------------------------------
    def reset(self, params: CogenParams, key: jax.Array
              ) -> tuple[CogenState, TimeStep]:
        kday, kact, kobs = jax.random.split(key, 3)
        day = jax.random.randint(kday, (), 0, params.n_days - 1)
        return self.reset_at_day(params, day, kact, kobs)

    def reset_at_day(self, params: CogenParams, day, kact: jax.Array,
                     kobs: jax.Array) -> tuple[CogenState, TimeStep]:
        day = jnp.asarray(day, jnp.int32)
        state = CogenState(
            day=day, t=jnp.zeros((), jnp.int32),
            prev_action=self.sample_action(params, kact),
            slab=self._day_slab(params, day))
        obs = self._obs(params, state, kobs, state.slab)
        dtype = params.ambients.dtype
        ts = TimeStep(obs=obs, reward=jnp.zeros((), dtype),
                      terminated=jnp.zeros((), bool),
                      truncated=jnp.zeros((), bool),
                      info=self._zero_info(params))
        return state, ts

    def step(self, params: CogenParams, state: CogenState, action: jax.Array,
             key: jax.Array) -> tuple[CogenState, TimeStep]:
        dtype = params.ambients.dtype
        action = jnp.asarray(action, dtype)

        # reward is computed against the CURRENT (pre-step) true ambient row
        # (env.py:370: _compute_reward(self.obs, action); forecast row 0 is
        # noise-free). The rolled state slab serves the now-row and the
        # next obs window as static slices — no per-step gather.
        ambient_now = state.slab[..., 0]
        slab_next = jnp.roll(state.slab, -1, axis=-1)
        reward, info = self._step_core(params, state.prev_action, action,
                                       ambient_now)

        t_next = state.t + 1
        new_state = CogenState(day=state.day, t=t_next,
                               prev_action=action, slab=slab_next)
        obs = self._obs(params, new_state, key, slab_next)
        terminated = t_next >= params.timesteps_per_day

        ts = TimeStep(
            obs=obs, reward=reward, terminated=terminated,
            truncated=jnp.zeros((), bool),
            info=info)
        return new_state, ts

    def _step_core(self, params: CogenParams, prev_action: jax.Array,
                   action: jax.Array, ambient_now: jax.Array
                   ) -> tuple[jax.Array, dict[str, jax.Array]]:
        """Plant dispatch + reward given the step's true ambient row; shared
        by :meth:`step` and the lockstep :meth:`batch_unroll`."""
        x = pack_model_input(ambient_now, action)
        y = plant.plant_model(x)

        # fuel: reference total_fuel_cost = model_output[-8] = PLANT_NG_M
        # (env.py:316)
        fuel_per_gt = y[6:9]
        total_fuel = y[21]

        ramp = params.ramp_penalty * jnp.abs(
            action[jnp.asarray(PWR_IDX)]
            - prev_action[jnp.asarray(PWR_IDX)])
        total_ramp = jnp.sum(ramp)

        cv = dyn_constraint_violation(x, y)
        cv_groups = jnp.stack([cv[0:4].sum(), cv[4:8].sum(),
                               cv[8:12].sum(), cv[12:16].sum()])
        cv_costs = params.constraint_violation_penalty * cv_groups
        total_cv = jnp.sum(cv_costs)

        steam_pen = jax.nn.relu(ambient_now[4] - y[28])
        energy_pen = jax.nn.relu(ambient_now[3] - y[27])
        non_delivery = params.supply_imbalance_penalty * (steam_pen + energy_pen)

        reward = -(total_fuel + total_ramp + non_delivery + total_cv)
        info = {
            "fuel_costs": fuel_per_gt,          # per GT1..GT3 (ST = 0)
            "ramp_costs": ramp,                 # GT1, GT2, GT3, ST
            "dyn_cv_costs": cv_costs,           # GT1, GT2, GT3, ST
            "non_delivery_cost": non_delivery,
            "net_power": y[27],
            "proc_steam": y[28],
        }
        return reward, info

    # ---- lockstep fast path ----------------------------------------------
    def episode_steps(self, params: CogenParams) -> int:
        return int(params.timesteps_per_day)

    def batch_unroll(self, params: CogenParams, policy, policy_params,
                     key: jax.Array, batch: int, num_steps: int) -> TimeStep:
        """Fused lockstep rollout: per-episode day-block prefetch instead of
        per-step ambient gathers.

        Each env's whole padded day (96+H+1 rows) is fetched once per episode
        with one contiguous slice per env and scanned time-major; per step
        the forecast window is a scalar-indexed dynamic_slice (contiguous,
        no gather). Same PRNG stream as the generic path for resets and
        actions; forecast noise is drawn as one batched normal per step
        instead of per-env streams (identical distribution; exact-equality
        parity holds when ``forecast_noise_std == 0``, the default).
        """
        from ...ops.gather import episode_slice_gather

        L = params.timesteps_per_day
        h = params.forecast_horizon
        day_rows = L + h + 1
        dtype = params.ambients.dtype
        flat_amb = params.ambients.reshape(-1, params.ambients.shape[-1])

        key_init, key_scan = jax.random.split(key)
        init_keys = jax.random.split(key_init, batch)
        states, ts0 = jax.vmap(self.reset, in_axes=(None, 0))(params, init_keys)
        obs = ts0.obs
        prev_action = states.prev_action
        days = states.day
        keys = jax.random.split(key_scan, num_steps)

        vcore = jax.vmap(self._step_core, in_axes=(None, 0, 0, 0))

        parts = []
        t0 = 0
        while t0 < num_steps:
            seg_len = min(L, num_steps - t0)
            block = episode_slice_gather(
                flat_amb, days * day_rows, day_rows)     # (B, day_rows, 7)
            block = jnp.swapaxes(block, 0, 1)            # (day_rows, B, 7)
            seg_keys = keys[t0:t0 + seg_len]

            def body(carry, inp):
                prev_action, obs, t = carry
                key_t = inp
                key_act, key_env = jax.random.split(key_t)
                # cast like the generic step() does before _step_core, so
                # the carry dtype (and obs Prev_Action) match the generic
                # path for non-f32 params
                actions = jnp.asarray(
                    policy(policy_params, obs, key_act), dtype)
                window = jax.lax.dynamic_slice(
                    block, (t, jnp.zeros((), t.dtype), jnp.zeros((), t.dtype)),
                    (h + 2, batch, block.shape[-1]))
                reward, info = vcore(params, prev_action, actions, window[0])
                # obs at t+1: forecast rows t+1 .. t+1+h, noise on future rows
                fore = window[1:]                        # (h+1, B, 7)
                noise = params.forecast_noise_std * jax.random.normal(
                    key_env, (h, batch, fore.shape[-1]), dtype=fore.dtype)
                fore = fore.at[1:].add(noise)
                fore_bt = jnp.transpose(fore, (1, 0, 2))  # (B, h+1, 7)
                new_obs = {
                    "Time": jnp.broadcast_to(
                        ((t + 1) / L).astype(dtype), (batch,))[:, None],
                    "Prev_Action": actions,
                }
                for i, name in enumerate(FORECAST_KEYS):
                    new_obs[name] = fore_bt[:, :, i]
                done = jnp.broadcast_to(t + 1 >= L, (batch,))
                ts = TimeStep(obs=new_obs, reward=reward, terminated=done,
                              truncated=jnp.zeros((batch,), bool), info=info)
                return (actions, new_obs, t + 1), (ts, key_env)

            t_start = jnp.zeros((), jnp.int32)
            (prev_action, obs, _), (traj, env_keys) = jax.lax.scan(
                body, (prev_action, obs, t_start), seg_keys)

            if seg_len == L:
                # autoreset splice: same key derivation as autoreset_step
                bkeys = jax.random.split(env_keys[-1], batch)
                reset_keys = jax.vmap(lambda k: jax.random.split(k)[1])(bkeys)
                states, ts_r = jax.vmap(self.reset, in_axes=(None, 0))(
                    params, reset_keys)
                obs = ts_r.obs
                prev_action = states.prev_action
                days = states.day
                traj = traj.replace(obs=jax.tree.map(
                    lambda o, r: o.at[-1].set(r), traj.obs, obs))
            parts.append(traj)
            t0 += seg_len

        if len(parts) == 1:
            return parts[0]
        return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *parts)

    def _zero_info(self, params: CogenParams) -> dict[str, jax.Array]:
        dtype = params.ambients.dtype
        z = jnp.zeros((), dtype)
        return {
            "fuel_costs": jnp.zeros(3, dtype),
            "ramp_costs": jnp.zeros(4, dtype),
            "dyn_cv_costs": jnp.zeros(4, dtype),
            "non_delivery_cost": z,
            "net_power": z,
            "proc_steam": z,
        }

    # ---- metadata -------------------------------------------------------
    def action_space(self, params: CogenParams) -> Box:
        return Box(ACTION_LOW, ACTION_HIGH, dtype=jnp.float32)

    def observation_space(self, params: CogenParams) -> DictSpace:
        h = params.forecast_horizon
        return DictSpace({
            "Time": Box(0, 1, (1,)),
            "Prev_Action": Box(ACTION_LOW, ACTION_HIGH),
            "TAMB": Box(32, 115, (h + 1,)),
            "PAMB": Box(14, 15, (h + 1,)),
            "RHAMB": Box(0, 1, (h + 1,)),
            "Target_Power": Box(0, 700, (h + 1,)),
            "Target_Steam": Box(0, 1300, (h + 1,)),
            "Energy_Price": Box(0, 1500, (h + 1,)),
            "Gas_Price": Box(0, 7, (h + 1,)),
        })
