"""EVChargingEnv — pure jittable EV charging-network simulation.

Rebuilds the reference EVChargingEnv
(/root/reference/sustaingym/envs/evcharging/env.py:20-500) WITHOUT acnportal:
the ACN-Sim digital twin (Simulator / ChargingNetwork / Linear2StageBattery /
EventQueue, env.py:324-328) becomes fixed-size station-slot arrays advanced
by a pure step function, and the per-step MOSEK projection (env.py:200-221)
becomes a batched fixed-iteration dual-FISTA solver (ops/qp.py): a few
skinny matrix products per iteration over the whole env batch.

Per step (5 simulated minutes):
 1. optional action projection onto the network feasible set;
 2. EVSE pilot quantization — AV: {0,8,16,24,32}, CC: {0} U {6..32}
    (env.py:368-378, round-half-even like np.round);
 3. plug/unplug events from the compiled day trace (SURVEY.md §3.1: the
    reference rebuilds pandas event queues every reset; here reset is an
    index gather);
 4. two-stage battery charging (acnsim Linear2StageBattery semantics:
    linear taper above transition SoC, period-energy cap);
 5. reward = profit - carbon cost - excess network charge (env.py:431-464).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ...core import (Box, DictSpace, FunctionalEnv, TimeStep, dataclass,
                     static_field)
from ...ops import qp
from .sites import SiteSpec, load_site

# Reward constants (env.py:99-114)
TIMESTEP_DURATION = 5
ACTION_SCALE_FACTOR = 32.0
VOLTAGE = 208.0
MARGINAL_PROFIT_PER_KWH = 0.15 * 0.20
CO2_COST_PER_METRIC_TON = 30.85
A_MINS_TO_KWH = (1 / 60) * (VOLTAGE / 1000)
VIOLATION_WEIGHT = 0.001
A_PERS_TO_KWH = A_MINS_TO_KWH * TIMESTEP_DURATION
PROFIT_FACTOR = A_PERS_TO_KWH * MARGINAL_PROFIT_PER_KWH
VIOLATION_FACTOR = A_PERS_TO_KWH * VIOLATION_WEIGHT
CARBON_COST_FACTOR = A_PERS_TO_KWH * (CO2_COST_PER_METRIC_TON / 1000)

MAX_TIMESTEP = 288

# Battery constants (event_generation.py:59-63,173-176 + acnsim defaults)
BATTERY_CAPACITY = 100.0
BATTERY_MAX_POWER = 100.0
TRANSITION_SOC = 0.8


@dataclass
class EVParams:
    # data packs
    moer: jax.Array          # (n_days, 289, 37)
    ev_data: jax.Array       # (n_days, MAX_EVS, 4) [arr, dep, est, req_kwh]
    ev_station: jax.Array    # (n_days, MAX_EVS) int32
    ev_mask: jax.Array       # (n_days, MAX_EVS) bool
    # per-day episode info (precomputed; the reference recomputes
    # max_profit once per reset, env.py:322)
    day_max_profit: jax.Array  # (n_days,)
    day_num_evs: jax.Array     # (n_days,) int32
    # packed per-(day, t) step table: [plug_dep(n), plug_est(n), plug_req(n),
    # moer_row(t+1)(37), max_profit, num_evs] — ONE row gather per step
    # instead of five. The dense per-station
    # plug-event grids exist only inside this pack (plug events keyed by
    # (day, t, station): dep/est/req, 0 = no arrival).
    step_table: jax.Array    # (n_days, 289, 3n + 39)
    # network constants
    constraint_re: jax.Array  # (m, n) Re(A~)
    constraint_im: jax.Array  # (m, n) Im(A~)
    magnitudes: jax.Array     # (m,)
    min_pilots: jax.Array     # (n,)
    # projection operator (dual-FISTA default, ADMM legacy)
    proj: qp.DualSOCProjection | qp.SOCProjection
    # statics
    n_stations: int = static_field()
    n_days: int = static_field()
    max_evs: int = static_field()
    moer_forecast_steps: int = static_field(default=36)
    project_action: bool = static_field(default=True)
    site: str = static_field(default="caltech")


@dataclass
class EVState:
    day: jax.Array        # int32
    t: jax.Array          # int32
    plugged: jax.Array    # (n,) bool
    dep: jax.Array        # (n,) int32 true departure period
    est_dep: jax.Array    # (n,) int32 estimated departure period
    demand: jax.Array     # (n,) float32 remaining demand (kWh)


def make_params(site: str = "caltech",
                date_period="Summer 2021",
                moer_forecast_steps: int = 36,
                project_action: bool = True,
                requested_energy_cap: float = 100.0,
                proj_method: str = "dual",
                proj_iters: int | None = None,
                trace: str = "real",
                gmm_days: int = 200,
                gmm_components: int = 30,
                dtype=jnp.float32) -> EVParams:
    """``trace='real'`` compiles the packaged ACN sessions
    (RealTraceGenerator analogue); ``trace='gmm'`` samples a bank of
    artificial days from the packaged GMMs (GMMsTraceGenerator analogue,
    event_generation.py:331-515).

    ``proj_method`` selects the feasibility-projection kernel:
    ``'dual'`` (default) is preconditioned dual-FISTA — ~4x fewer
    flops/iteration than ADMM, robust to reduced-precision matmuls, and
    more accurate vs the exact (MOSEK-equivalent) projection; ``'admm'``
    is the legacy over-relaxed ADMM operator (float32-pinned matmuls),
    kept for comparison.
    ``proj_iters`` defaults per method (15 dual / 30 admm)."""
    from ...data.ev_etl import build_moer_pack, build_trace_pack
    spec: SiteSpec = load_site(site)
    moer = build_moer_pack(date_period)
    if trace == "gmm":
        from ...data.ev_gmm import build_gmm_trace_pack
        traces = build_gmm_trace_pack(
            site, date_period, n_days=gmm_days,
            n_components=gmm_components,
            requested_energy_cap=requested_energy_cap)
        # MOER days cycle under the (possibly longer) GMM day bank
        reps = -(-traces["ev_data"].shape[0] // moer.shape[0])
        moer = np.tile(moer, (reps, 1, 1))[:traces["ev_data"].shape[0]]
    else:
        traces = build_trace_pack(site, date_period, spec.station_ids,
                                  requested_energy_cap=requested_energy_cap)
    phase = np.exp(1j * np.deg2rad(spec.phase_angles))
    a_tilde = spec.constraint_matrix * phase[None, :]
    if proj_method == "dual":
        # 15 iterations: max error vs the float64 exact projection ~0.014
        # (stress battery ~0.02), quantized-pilot mismatch 0.04% — an
        # order of magnitude tighter than the legacy ADMM-30 operator's
        # accuracy (~0.05 max err; tools/fista_tune.py)
        proj = qp.make_dual_soc_projection(
            spec.constraint_matrix, spec.phase_angles, spec.magnitudes,
            action_scale=ACTION_SCALE_FACTOR,
            iters=15 if proj_iters is None else proj_iters, dtype=dtype)
    elif proj_method == "admm":
        proj = qp.make_soc_projection(
            spec.constraint_matrix, spec.phase_angles, spec.magnitudes,
            action_scale=ACTION_SCALE_FACTOR,
            iters=30 if proj_iters is None else proj_iters, dtype=dtype)
    else:
        raise ValueError(f"unknown proj_method {proj_method!r}")

    # compile event grids + per-day info on host
    ev = traces["ev_data"]
    st = traces["ev_station"]
    msk = traces["ev_mask"]
    n_days_tr = ev.shape[0]
    n = spec.num_stations
    grid_shape = (n_days_tr, MAX_TIMESTEP + 1, n)
    plug_dep = np.zeros(grid_shape, np.float32)
    plug_est = np.zeros(grid_shape, np.float32)
    plug_req = np.zeros(grid_shape, np.float32)
    for d in range(n_days_tr):
        for k in range(ev.shape[1]):
            if not msk[d, k]:
                continue
            t0 = int(ev[d, k, 0])
            plug_dep[d, t0, st[d, k]] = ev[d, k, 1]
            plug_est[d, t0, st[d, k]] = ev[d, k, 2]
            plug_req[d, t0, st[d, k]] = ev[d, k, 3]
    dur = (ev[..., 1] - ev[..., 0]) * msk
    max_kwh = np.minimum(ev[..., 3], dur * ACTION_SCALE_FACTOR * A_PERS_TO_KWH)
    day_max_profit = (max_kwh * msk).sum(axis=1) * MARGINAL_PROFIT_PER_KWH
    day_num_evs = msk.sum(axis=1).astype(np.int32)

    # one packed row per (day, t) with everything step() reads
    # [plug_dep | plug_est | plug_req | moer(t+1) | max_profit | num_evs]
    moer_np = np.asarray(moer, np.float32)
    moer_next = np.concatenate(
        [moer_np[:, 1:, :], moer_np[:, -1:, :]], axis=1)  # row t -> moer t+1
    step_table = np.concatenate([
        plug_dep, plug_est, plug_req, moer_next,
        np.broadcast_to(day_max_profit[:, None, None].astype(np.float32),
                        grid_shape[:2] + (1,)),
        np.broadcast_to(day_num_evs[:, None, None].astype(np.float32),
                        grid_shape[:2] + (1,)),
    ], axis=2)

    return EVParams(
        moer=jnp.asarray(moer, dtype),
        ev_data=jnp.asarray(traces["ev_data"], dtype),
        ev_station=jnp.asarray(traces["ev_station"], jnp.int32),
        ev_mask=jnp.asarray(traces["ev_mask"]),
        day_max_profit=jnp.asarray(day_max_profit, dtype),
        day_num_evs=jnp.asarray(day_num_evs, jnp.int32),
        step_table=jnp.asarray(step_table, dtype),
        constraint_re=jnp.asarray(a_tilde.real, dtype),
        constraint_im=jnp.asarray(a_tilde.imag, dtype),
        magnitudes=jnp.asarray(spec.magnitudes, dtype),
        min_pilots=jnp.asarray(spec.min_pilots, dtype),
        proj=proj,
        n_stations=spec.num_stations,
        n_days=int(moer.shape[0]),
        max_evs=int(traces["ev_data"].shape[1]),
        moer_forecast_steps=int(moer_forecast_steps),
        project_action=bool(project_action),
        site=site,
    )


def quantize_pilots(norm_action: jax.Array, min_pilots: jax.Array
                    ) -> jax.Array:
    """normalized [0,1] action -> pilot signal in amps (env.py:366-378)."""
    amps = norm_action * ACTION_SCALE_FACTOR
    cc = jnp.where(amps >= 6.0, jnp.round(amps), 0.0)
    av = jnp.round(amps / 8.0) * 8.0
    return jnp.where(min_pilots == 6.0, cc, av)


def battery_charge(pilot_amps: jax.Array, demand: jax.Array,
                   plugged: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Two-stage battery model, vectorized over stations.

    SoC relation: every EV battery has capacity 100 kWh with initial charge
    (100 - requested) (event_generation.py:173-176), so
    soc = 1 - demand / capacity at all times.

    Returns (actual charging rate in A, energy delivered in kWh).
    """
    pilot_kw = pilot_amps * VOLTAGE / 1000.0
    soc = 1.0 - demand / BATTERY_CAPACITY
    taper_kw = BATTERY_MAX_POWER * (1.0 - soc) / (1.0 - TRANSITION_SOC)
    cap_kw = jnp.where(soc < TRANSITION_SOC, BATTERY_MAX_POWER, taper_kw)
    power = jnp.minimum(pilot_kw, cap_kw)
    # cannot exceed remaining capacity within one period
    power = jnp.minimum(power, demand * (60.0 / TIMESTEP_DURATION))
    power = jnp.where(plugged, jnp.maximum(power, 0.0), 0.0)
    energy = power * (TIMESTEP_DURATION / 60.0)
    rate_amps = power * 1000.0 / VOLTAGE
    return rate_amps, energy


def _lockstep_ev_unroll(params: EVParams, reset_fn, reset_at_day_fn,
                        step_row_fn, day_of, policy, policy_params,
                        key: jax.Array, batch: int, num_steps: int
                        ) -> TimeStep:
    """Shared lockstep episode-unroll driver behind both
    ``EVChargingEnv.batch_unroll`` and the multi-agent view's
    (envs/multiagent.py) — the view adds a staleness ring + per-agent obs
    on top of the same (day, t) row stream, so the fetch strategy and the
    autoreset PRNG contract must not be duplicated.

    ``reset_fn(key)``/``reset_at_day_fn(day)`` build one env's state+ts;
    ``step_row_fn(state, action, row)`` steps one env given the packed
    (day, t) table row; ``day_of(state)`` reads the (B,) day vector from
    the vmapped state."""
    L = MAX_TIMESTEP
    rows_per_day = params.step_table.shape[1]
    width = params.step_table.shape[2]
    flat_table = params.step_table.reshape(-1, width)
    n_days = params.n_days
    # row-fetch strategy: with few distinct days the (B,) step-table rows
    # come from ONE matmul, onehot(days) @ table[t], which is EXACT at
    # HIGHEST precision (each output element is a single 1.0 * v
    # product); large day banks (GMM traces) gather rows instead, where
    # the (B, n_days) matmul stops being cheap. Which of the two is faster
    # on the H100 at the real day bank is not measured.
    use_onehot = n_days <= 128
    if use_onehot:
        table_tm = jnp.swapaxes(params.step_table, 0, 1)  # (289, D, W)

    key_init, key_scan = jax.random.split(key)
    init_keys = jax.random.split(key_init, batch)
    state, ts0 = jax.vmap(reset_fn)(init_keys)
    obs = ts0.obs
    keys = jax.random.split(key_scan, num_steps)
    vrow = jax.vmap(step_row_fn)

    parts = []
    t0 = 0
    while t0 < num_steps:
        t_in_ep = t0 % L
        seg = min(L - t_in_ep, num_steps - t0)
        seg_keys = keys[t0:t0 + seg]
        # all envs share the scan-step index; days are fixed within an
        # episode segment, so the row index is one (B,) vector add
        base = day_of(state) * rows_per_day
        if use_onehot:
            onehot = (day_of(state)[:, None]
                      == jnp.arange(n_days)[None, :]).astype(
                          params.step_table.dtype)

        def body(carry, inp):
            st, obs = carry
            key_t, t = inp
            key_act, key_env = jax.random.split(key_t)
            actions = policy(policy_params, obs, key_act)
            if use_onehot:
                rows = jnp.matmul(
                    onehot, table_tm[t],
                    precision=jax.lax.Precision.HIGHEST)
            else:
                rows = flat_table[base + t]       # (B, width) gather
            st, ts = vrow(st, actions, rows)
            return (st, ts.obs), (ts, key_env)

        ts_idx = jnp.arange(t_in_ep, t_in_ep + seg, dtype=jnp.int32)
        (state, obs), (traj, env_keys) = jax.lax.scan(
            body, (state, obs), (seg_keys, ts_idx))

        if t_in_ep + seg == L:
            # episode boundary: splice in the autoreset state/obs with
            # exactly core.autoreset_step's key derivation
            days = EVChargingEnv._autoreset_days(params, env_keys[-1], batch)
            state, ts_reset = jax.vmap(reset_at_day_fn)(days)
            obs = ts_reset.obs
            traj = traj.replace(obs=jax.tree.map(
                lambda o, r: o.at[-1].set(r), traj.obs, obs))
        parts.append(traj)
        t0 += seg

    if len(parts) == 1:
        return parts[0]
    return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *parts)


class EVChargingEnv(FunctionalEnv[EVParams, EVState]):
    name = "evcharging"

    # ---- seeding --------------------------------------------------------
    @staticmethod
    def day_from_seed(params: EVParams, seed: int) -> int:
        """Sequential-day mapping of RealTraceGenerator.set_seed
        (event_generation.py:273-281)."""
        return seed % params.n_days

    # ---- pure API -------------------------------------------------------
    def reset(self, params: EVParams, key: jax.Array
              ) -> tuple[EVState, TimeStep]:
        day = jax.random.randint(key, (), 0, params.n_days)
        return self.reset_at_day(params, day)

    def reset_at_day(self, params: EVParams, day) -> tuple[EVState, TimeStep]:
        n = params.n_stations
        dtype = params.moer.dtype
        state = EVState(
            day=jnp.asarray(day, jnp.int32),
            t=jnp.zeros((), jnp.int32),
            plugged=jnp.zeros(n, bool),
            dep=jnp.zeros(n, jnp.int32),
            est_dep=jnp.zeros(n, jnp.int32),
            demand=jnp.zeros(n, dtype))
        ts = TimeStep(
            obs=self._obs(params, state),
            reward=jnp.zeros((), dtype),
            terminated=jnp.zeros((), bool),
            truncated=jnp.zeros((), bool),
            info=self._info(params, state, jnp.zeros((), dtype),
                            jnp.zeros((), dtype), jnp.zeros((), dtype)))
        return state, ts

    def step(self, params: EVParams, state: EVState, action: jax.Array,
             key: jax.Array) -> tuple[EVState, TimeStep]:
        del key
        # ONE packed row gather per step: [plug_dep | plug_est | plug_req |
        # moer(t+1) | max_profit | num_evs]
        row = params.step_table[state.day, state.t]
        return self._step_row(params, state, action, row)

    def _step_row(self, params: EVParams, state: EVState, action: jax.Array,
                  row: jax.Array) -> tuple[EVState, TimeStep]:
        """Step given the packed (day, t) table row; shared by the generic
        :meth:`step` and the lockstep :meth:`batch_unroll`."""
        dtype = params.moer.dtype
        n = params.n_stations
        action = jnp.clip(jnp.asarray(action, dtype), 0.0, 1.0)

        plug_dep_row = row[:n]
        plug_est_row = row[n:2 * n]
        plug_req_row = row[2 * n:3 * n]
        moer_next = row[3 * n:3 * n + 37]
        max_profit = row[3 * n + 37]
        num_evs = row[3 * n + 38].astype(jnp.int32)

        # 1) feasibility projection (env.py:200-221): upper bound is
        #    min(1, demand / A_PERS_TO_KWH / 32) from the CURRENT obs demands
        if params.project_action:
            demands_obs = jnp.where(state.plugged, state.demand, 0.0)
            ub = jnp.minimum(
                1.0, demands_obs / A_PERS_TO_KWH / ACTION_SCALE_FACTOR)
            action = qp.project(params.proj, action, ub)

        # 2) pilot quantization
        pilots = quantize_pilots(action, params.min_pilots)

        # 3) events at iteration t: unplug (departure == t), then plug
        t = state.t
        plugged = jnp.where(state.dep == t, False, state.plugged)

        # plug events from the dense per-station grids: pure (n,)-vector ops
        arrive = plug_dep_row > 0
        plugged = plugged | arrive
        dep = jnp.where(arrive, plug_dep_row.astype(jnp.int32), state.dep)
        est_dep = jnp.where(arrive, plug_est_row.astype(jnp.int32),
                            state.est_dep)
        demand = jnp.where(arrive, plug_req_row, state.demand)

        # 4) charge batteries at quantized pilots
        rates, energy = battery_charge(pilots, demand, plugged)
        demand = demand - energy

        # 5) reward (env.py:431-464): carbon/prev-moer row is the
        #    post-increment timestep t+1
        total_rate = jnp.sum(rates)
        profit = PROFIT_FACTOR * total_rate
        # reward accounting in full float32: a TF32 product would shift
        # the excess-current penalty by ~1e-3 relative
        agg_re = jnp.matmul(params.constraint_re, pilots,
                            precision=jax.lax.Precision.HIGHEST)
        agg_im = jnp.matmul(params.constraint_im, pilots,
                            precision=jax.lax.Precision.HIGHEST)
        current_mag = jnp.sqrt(agg_re ** 2 + agg_im ** 2)
        excess = jnp.sum(jax.nn.relu(current_mag - params.magnitudes))
        excess_charge = excess * VIOLATION_FACTOR
        moer_now = moer_next[0]
        carbon_cost = CARBON_COST_FACTOR * total_rate * moer_now
        reward = profit - carbon_cost - excess_charge

        new_state = EVState(day=state.day, t=t + 1, plugged=plugged,
                            dep=dep, est_dep=est_dep, demand=demand)
        terminated = (t + 1) >= MAX_TIMESTEP
        k = params.moer_forecast_steps
        obs = {
            "timestep": ((t + 1) / MAX_TIMESTEP).astype(dtype)[None],
            "est_departures": jnp.where(
                plugged, (est_dep - (t + 1)).astype(dtype), 0.0),
            "demands": jnp.where(plugged, demand, 0.0),
            "prev_moer": moer_next[0][None],
            "forecasted_moer": jax.lax.dynamic_slice(moer_next, (1,), (k,)),
        }
        info = {
            "profit": profit,
            "carbon_cost": carbon_cost,
            "excess_charge": excess_charge,
            "max_profit": max_profit,
            "num_evs": num_evs,
        }
        ts = TimeStep(
            obs=obs, reward=reward, terminated=terminated,
            truncated=jnp.zeros((), bool), info=info)
        return new_state, ts

    # ---- lockstep fast path ----------------------------------------------
    @staticmethod
    def _autoreset_days(params: EVParams, key_env: jax.Array, batch: int
                        ) -> jax.Array:
        """Boundary-step reset days, bit-identical to what the generic
        ``core.autoreset_step`` path draws: the step's env key splits into
        per-env keys, each env's key splits into (step, reset), and
        ``reset`` maps its key to a uniform day."""
        bkeys = jax.random.split(key_env, batch)
        reset_keys = jax.vmap(lambda k: jax.random.split(k)[1])(bkeys)
        return jax.vmap(lambda k: jax.random.randint(
            k, (), 0, params.n_days))(reset_keys)

    def episode_steps(self, params: EVParams) -> int:
        return MAX_TIMESTEP

    def batch_unroll(self, params: EVParams, policy, policy_params,
                     key: jax.Array, batch: int, num_steps: int,
                     prefetch: int = 48) -> TimeStep:
        """Fused reset+rollout of ``batch`` lockstep envs on the SAME PRNG
        stream as the generic ``batch_rollout`` (bit-compatible
        trajectories up to XLA fusion drift).

        EV episodes all have static length MAX_TIMESTEP, so a batch reset
        together stays in lockstep forever. The win over the generic
        autoreset scan: the functional autoreset's per-step ``env.reset``
        (discarded on every non-boundary step — a fresh zero-state + obs
        build + moer gather + tree-select over every TimeStep leaf) happens
        only at the actual episode boundary, once per MAX_TIMESTEP steps.
        The (day, t) row is fetched per step and feeds compute directly,
        with no staged (seg, B, 203) block.
        """
        del prefetch  # kept for call-compat; segmenting follows episodes
        return _lockstep_ev_unroll(
            params,
            reset_fn=lambda k: self.reset(params, k),
            reset_at_day_fn=lambda d: self.reset_at_day(params, d),
            step_row_fn=lambda st, a, row: self._step_row(params, st, a, row),
            day_of=lambda st: st.day,
            policy=policy, policy_params=policy_params, key=key,
            batch=batch, num_steps=num_steps)

    # ---- obs/info -------------------------------------------------------
    def _obs(self, params: EVParams, state: EVState) -> dict[str, jax.Array]:
        """(env.py:381-394)"""
        dtype = params.moer.dtype
        t = state.t
        k = params.moer_forecast_steps
        est = jnp.where(state.plugged,
                        (state.est_dep - t).astype(dtype), 0.0)
        demands = jnp.where(state.plugged, state.demand, 0.0)
        moer_row = params.moer[state.day, t]
        return {
            "timestep": (t / MAX_TIMESTEP).astype(dtype)[None],
            "est_departures": est,
            "demands": demands,
            "prev_moer": moer_row[0][None],
            "forecasted_moer": jax.lax.dynamic_slice(moer_row, (1,), (k,)),
        }

    def _info(self, params: EVParams, state: EVState, profit, carbon,
              excess) -> dict[str, jax.Array]:
        return {
            "profit": profit,
            "carbon_cost": carbon,
            "excess_charge": excess,
            "max_profit": params.day_max_profit[state.day],
            "num_evs": params.day_num_evs[state.day],
        }

    # ---- metadata -------------------------------------------------------
    def observation_space(self, params: EVParams) -> DictSpace:
        n = params.n_stations
        return DictSpace({
            "timestep": Box(0, 1, (1,)),
            "est_departures": Box(-288, 288, (n,)),
            "demands": Box(0, 100, (n,)),
            "prev_moer": Box(0, 1, (1,)),
            "forecasted_moer": Box(0, 1, (params.moer_forecast_steps,)),
        })

    def action_space(self, params: EVParams) -> Box:
        return Box(0.0, 1.0, (params.n_stations,))
