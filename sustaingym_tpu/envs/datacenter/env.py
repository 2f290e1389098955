"""DataCenterEnv — carbon-aware job scheduling via virtual capacity curves.

Implemented FROM THE DOC SPEC (/root/reference/docs/datacenterenv.md; the
reference's sustaingym/envs/data_center.py:12-36 is an unimplemented stub):

- hourly steps, one episode per calendar month (fixed 28 days = 672 steps
  for static shapes);
- the agent sets the VCC a(t) in [0,1] — the fraction of datacenter
  capacity C the scheduler may allocate next hour;
- jobs arrive as job-hours (a deterministic Google-cluster-like trace with
  diurnal/weekday structure — the real May-2019 cluster sample is not
  packaged anywhere in the reference) and run FIFO up to the active VCC;
- reward (doc eq., negated into a proper reward):
      r(t) = -( d_t * m_t
                + 1[t % 24 == 0] * max(0, 0.97 w_t - C * sum_{h=1..24} a(t-h)) )
  where d_t is the executed load, m_t the MOER, and w_t the job-hours
  enqueued over the just-finished day (the penalty discourages delaying
  work by more than ~a day);
- obs (27,): [a(t-1), d_t, n_jobs_waiting, 24h MOER forecast]. MOER comes
  from the packaged SGIP data (hourly subsample); the 24-h "forecast" is
  the true future trajectory (the packaged forecasts only reach 3 h).
- distribution shift = episode month (2019-05 .. 2021-08 packaged range).
"""
from __future__ import annotations

import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np

from ...core import (Box, FunctionalEnv, TimeStep, dataclass, static_field)

HOURS_PER_DAY = 24
EPISODE_DAYS = 28
EPISODE_LEN = HOURS_PER_DAY * EPISODE_DAYS  # 672
FORECAST_H = 24
CAPACITY = 1.0            # normalized datacenter capacity C
DELAY_FACTOR = 0.97       # doc: 0.97 w_t
AVG_JOB_SIZE = 0.02       # job-hours per job (for the n-jobs-waiting obs)

MONTH_RANGE_START = (2019, 5)
MONTH_RANGE_END = (2021, 8)


@dataclass
class DCParams:
    arrivals: jax.Array   # (n_months, 672) job-hours arriving per hour
    moer: jax.Array       # (n_months, 672 + 24) hourly MOER kg/kWh
    n_months: int = static_field()


@dataclass
class DCState:
    month: jax.Array       # int32 episode index
    t: jax.Array           # int32 hour within episode
    queue: jax.Array       # backlog job-hours
    prev_a: jax.Array      # previous VCC
    running: jax.Array     # executed load last hour (d_t)
    day_vcc_sum: jax.Array   # sum of VCC over current day
    day_arrivals: jax.Array  # job-hours enqueued over current day
    # the episode's month rows, gathered ONCE at reset instead of per env
    # per step (4096 envs x 2.8KB x 64 steps); they only change at reset
    arr_slab: jax.Array    # (672,) this month's arrival row
    moer_slab: jax.Array   # (696,) this month's MOER row


def _months() -> list[tuple[int, int]]:
    out = []
    y, m = MONTH_RANGE_START
    while (y, m) <= MONTH_RANGE_END:
        out.append((y, m))
        m += 1
        if m > 12:
            y, m = y + 1, 1
    return out


def _synthesize_arrivals(n_months: int, seed: int = 11) -> np.ndarray:
    """Deterministic cluster-trace-like arrivals: business-hours diurnal
    peak, weekday/weekend split, heavy-tailed bursts. Mean utilization
    ~0.55 C."""
    rng = np.random.default_rng(seed)
    out = np.empty((n_months, EPISODE_LEN))
    for mth in range(n_months):
        hours = np.arange(EPISODE_LEN)
        hod = hours % 24
        dow = (hours // 24) % 7
        diurnal = 0.35 + 0.3 * np.exp(-0.5 * ((hod - 14.5) / 3.5) ** 2)
        weekday = np.where(dow < 5, 1.0, 0.72)
        bursts = rng.pareto(3.0, EPISODE_LEN) * 0.05
        noise = rng.normal(scale=0.03, size=EPISODE_LEN)
        out[mth] = np.clip(diurnal * weekday + bursts + noise, 0.02, 1.5)
    return out


def make_params(dtype=jnp.float32) -> DCParams:
    from ...data.ev_etl import build_moer_pack

    months = _months()
    moer_rows = []
    for (y, m) in months:
        first = dt.date(y, m, 1)
        last = first + dt.timedelta(days=EPISODE_DAYS + 1)
        pack = build_moer_pack((first.isoformat(), last.isoformat()))
        hourly = pack[:, ::12, 0][:, :HOURS_PER_DAY]  # (days, 24)
        flat = hourly.reshape(-1)[:EPISODE_LEN + FORECAST_H]
        moer_rows.append(flat)
    moer = np.stack(moer_rows)
    arrivals = _synthesize_arrivals(len(months))
    return DCParams(
        arrivals=jnp.asarray(arrivals, dtype),
        moer=jnp.asarray(moer, dtype),
        n_months=len(months))


class DataCenterEnv(FunctionalEnv[DCParams, DCState]):
    name = "datacenter"

    @staticmethod
    def month_from_seed(params: DCParams, seed: int) -> int:
        return seed % params.n_months

    def reset(self, params: DCParams, key: jax.Array
              ) -> tuple[DCState, TimeStep]:
        month = jax.random.randint(key, (), 0, params.n_months)
        return self.reset_at_month(params, month)

    def reset_at_month(self, params: DCParams, month
                       ) -> tuple[DCState, TimeStep]:
        dtype = params.moer.dtype
        z = jnp.zeros((), dtype)
        month = jnp.asarray(month, jnp.int32)
        state = DCState(
            month=month,
            t=jnp.zeros((), jnp.int32),
            queue=z, prev_a=jnp.ones((), dtype), running=z,
            day_vcc_sum=z, day_arrivals=z,
            arr_slab=params.arrivals[month],
            moer_slab=params.moer[month])
        ts = TimeStep(obs=self._obs(params, state), reward=z,
                      terminated=jnp.zeros((), bool),
                      truncated=jnp.zeros((), bool),
                      info={"carbon_cost": z, "delay_penalty": z,
                            "queue": z, "executed": z})
        return state, ts

    @staticmethod
    def _slab_window(slab: jax.Array, start, length: int) -> jax.Array:
        """(length,) window of a per-env (..., R) slab via an exact one-hot
        time contract (each output is one 1.0 * v product) in place of a
        vmapped dynamic_slice / scalar index per env."""
        R = slab.shape[-1]
        w = (jnp.asarray(start, jnp.int32)[..., None, None]
             + jnp.arange(length)[:, None] == jnp.arange(R)[None, :])
        return jnp.einsum("...wt,...t->...w", w.astype(slab.dtype), slab,
                          precision=jax.lax.Precision.HIGHEST)

    def step(self, params: DCParams, state: DCState, action: jax.Array,
             key: jax.Array) -> tuple[DCState, TimeStep]:
        del key
        # the month rows live in the state (gathered once at reset); the
        # step only does exact one-hot contracts for the hour's scalars
        # and the now+forecast window
        arrivals = self._slab_window(state.arr_slab, state.t, 1)[..., 0]
        m_and_fc = self._slab_window(state.moer_slab, state.t,
                                     FORECAST_H + 1)
        m_t = m_and_fc[..., 0]
        fc = m_and_fc[..., 1:]
        return self._step_exog(params, state, action, arrivals, m_t, fc)

    def _step_exog(self, params: DCParams, state: DCState, action: jax.Array,
                   arrivals: jax.Array, m_t: jax.Array, fc: jax.Array
                   ) -> tuple[DCState, TimeStep]:
        """Step given the hour's exogenous values (arrival job-hours, MOER
        now, next-24h MOER forecast); shared by :meth:`step` and the
        lockstep :meth:`batch_unroll`."""
        dtype = params.moer.dtype
        a = jnp.clip(jnp.reshape(jnp.asarray(action, dtype), ()), 0.0, 1.0)

        t = state.t
        backlog = state.queue + arrivals
        cap = a * CAPACITY
        executed = jnp.minimum(backlog, cap)
        queue = backlog - executed

        carbon_cost = executed * m_t

        day_vcc_sum = state.day_vcc_sum + a
        day_arrivals = state.day_arrivals + arrivals
        t_next = t + 1
        day_boundary = (t_next % HOURS_PER_DAY) == 0
        delay_penalty = jnp.where(
            day_boundary,
            jnp.maximum(0.0, DELAY_FACTOR * day_arrivals
                        - CAPACITY * day_vcc_sum),
            0.0)
        reward = -(carbon_cost + delay_penalty)

        new_state = DCState(
            month=state.month, t=t_next, queue=queue, prev_a=a,
            running=executed,
            day_vcc_sum=jnp.where(day_boundary, 0.0, day_vcc_sum),
            day_arrivals=jnp.where(day_boundary, 0.0, day_arrivals),
            arr_slab=state.arr_slab, moer_slab=state.moer_slab)
        obs = jnp.concatenate([
            a[None], executed[None], (queue / AVG_JOB_SIZE)[None], fc,
        ]).astype(dtype)
        ts = TimeStep(
            obs=obs,
            reward=reward,
            terminated=t_next >= EPISODE_LEN,
            truncated=jnp.zeros((), bool),
            info={"carbon_cost": carbon_cost,
                  "delay_penalty": delay_penalty,
                  "queue": queue, "executed": executed})
        return new_state, ts

    def episode_steps(self, params: DCParams) -> int:
        return EPISODE_LEN

    # ---- lockstep fast path ----------------------------------------------
    def batch_unroll(self, params: DCParams, policy, policy_params,
                     key: jax.Array, batch: int, num_steps: int) -> TimeStep:
        """Fused lockstep rollout: one per-episode prefetch of each env's
        packed [arrivals, moer] month table (one contiguous slice) instead of
        a full 696-wide MOER row gather per env per step. Same PRNG stream
        as the generic path (exact parity — the env is deterministic given
        the reset stream)."""
        from ...ops.gather import episode_slice_gather

        L = EPISODE_LEN
        rows = params.moer.shape[1]               # 696 = L + FORECAST_H
        arr_pad = jnp.pad(params.arrivals,
                          ((0, 0), (0, rows - params.arrivals.shape[1])))
        flat = jnp.stack([arr_pad, params.moer], axis=-1).reshape(-1, 2)

        key_init, key_scan = jax.random.split(key)
        init_keys = jax.random.split(key_init, batch)
        states, ts0 = jax.vmap(self.reset, in_axes=(None, 0))(
            params, init_keys)
        obs = ts0.obs
        keys = jax.random.split(key_scan, num_steps)
        vstep = jax.vmap(self._step_exog, in_axes=(None, 0, 0, 0, 0, 1))

        parts = []
        t0 = 0
        while t0 < num_steps:
            seg_len = min(L, num_steps - t0)
            block = episode_slice_gather(
                flat, states.month * rows, rows)   # (B, rows, 2)
            block = jnp.swapaxes(block, 0, 1)      # (rows, B, 2)
            seg_keys = keys[t0:t0 + seg_len]

            def body(carry, key_t):
                states, obs, t = carry
                key_act, key_env = jax.random.split(key_t)
                actions = policy(policy_params, obs, key_act)
                win = jax.lax.dynamic_slice(
                    block, (t, jnp.zeros((), t.dtype),
                            jnp.zeros((), t.dtype)),
                    (FORECAST_H + 1, batch, 2))
                states, ts = vstep(params, states, actions,
                                   win[0, :, 0], win[0, :, 1], win[1:, :, 1])
                return (states, ts.obs, t + 1), (ts, key_env)

            (states, obs, _), (traj, env_keys) = jax.lax.scan(
                body, (states, obs, jnp.zeros((), jnp.int32)), seg_keys)

            if seg_len == L:
                bkeys = jax.random.split(env_keys[-1], batch)
                reset_keys = jax.vmap(lambda k: jax.random.split(k)[1])(bkeys)
                states, ts_r = jax.vmap(self.reset, in_axes=(None, 0))(
                    params, reset_keys)
                obs = ts_r.obs
                traj = traj.replace(obs=traj.obs.at[-1].set(obs))
            parts.append(traj)
            t0 += seg_len

        if len(parts) == 1:
            return parts[0]
        return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *parts)

    def _obs(self, params: DCParams, state: DCState) -> jax.Array:
        """(27,) = [a(t-1), d_t, n_waiting, moer forecast 24h]
        (docs/datacenterenv.md:8)."""
        fc = self._slab_window(state.moer_slab, state.t, FORECAST_H)
        n_waiting = state.queue / AVG_JOB_SIZE
        return jnp.concatenate([
            state.prev_a[None], state.running[None], n_waiting[None], fc,
        ]).astype(params.moer.dtype)

    def observation_space(self, params: DCParams) -> Box:
        low = np.concatenate([[0, 0, 0], np.zeros(FORECAST_H)])
        high = np.concatenate([[1, CAPACITY, 1e5], np.ones(FORECAST_H)])
        return Box(low, high)

    def action_space(self, params: DCParams) -> Box:
        return Box(0.0, 1.0, (1,))
