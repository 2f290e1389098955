"""ElectricityMarketEnv — battery bidding into a 5-min SCED market.

Implemented FROM THE DOC SPEC (/root/reference/docs/electricitymarketenv.md;
no reference code exists — registration commented out at
/root/reference/sustaingym/__init__.py:9-12):

- 24-bus IEEE RTS-24 congested network, 33 generators bidding true cost,
  one 80 MWh battery (the agent) submitting charge/discharge price bids for
  the next k settlement intervals;
- every 5-min step the market operator clears a multi-interval SCED
  (ops/lp.py PDHG solver — batched, fixed iterations, prices = equality
  duals), producing the clearing price p_t and the agent dispatch x_t;
  the cold first solve of an episode runs ``lp_iters`` PDHG iterations,
  warm-started subsequent solves run ``lp_warm_iters`` (the previous
  solution is a near-optimal initial iterate — each step only shifts the
  SCED horizon one interval);
- doc-wording note: the action-space text says bids cover "the next k+1
  time steps" while the observation text and the forecast vectors use k
  steps (l-hat_{t:t+k-1}); this implementation takes the consistent
  reading — ``horizon`` = k bid pairs, k-step forecasts, a k-interval
  SCED;
- the doc's 3-action discretize wrapper ("charge, do nothing, or
  discharge", docs/electricitymarketenv.md:18) is ``discrete=True``:
  Discrete(3) actions mapped to extreme/zero bids (see
  :data:`DISCRETE_BIDS`);
- reward r(t) = p_t x_t + P_CO2 m_t x_t - c_T(t) (revenue + displaced
  carbon value - terminal state-of-charge penalty), with the doc's option
  to defer all reward to the terminal step;
- distribution shift via the data month (demand level + MOER source data).

Demand traces are synthesized deterministically (CAISO-like diurnal shape
scaled to the RTS peak; RTS-GMLC load files are not packaged anywhere in the
reference), MOER comes from the packaged SGIP CAISO data.
"""
from __future__ import annotations

import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np

from ...core import (Box, DictSpace, FunctionalEnv, TimeStep, dataclass,
                     static_field)
from ...ops import lp
from . import network as net_mod
from .network import (BATTERY_CAPACITY_MWH, BATTERY_EFFICIENCY,
                      BATTERY_POWER_MW, build_network, build_sced_matrices)

T_STEPS = 288
TAU_H = 1.0 / 12.0
P_CO2 = 30.85 / 1000.0     # $/kg CO2 (EV env carbon price, env.py:107)
MAX_BID = 1000.0           # $/MWh cap on battery bids

# precision of the SCED solver's matrix products (ops/lp.py modes), the
# same on every backend: TF32, the faster mode whose clearing prices pass
# every check of sustaingym_tpu.checks on the H100 (on an H100 80GB HBM3
# at 400 W: 1.70 ms vs 2.21 ms per 40-iteration solve at batch 4096, mean
# price drift vs full float32 $0.005/MWh; CHANGES.md). On a CPU the mode
# computes in full float32.
LP_MATMUL = "tf32"

# 3-action discretization (charge / do nothing / discharge) as
# (charge_bid, discharge_bid) pairs: charging is guaranteed economic at a
# MAX_BID willingness-to-pay, discharging at a zero ask; MAX_BID asks and
# zero willingness-to-pay switch the other leg off
DISCRETE_BIDS = ((MAX_BID, MAX_BID),   # 0: charge
                 (0.0, MAX_BID),       # 1: do nothing
                 (0.0, 0.0))           # 2: discharge


@dataclass
class MarketParams:
    # static SCED structure
    op: lp.LPOperator
    ub: jax.Array           # (n,) variable upper bounds
    gen_cost_tiled: jax.Array   # (n_gen * k,)
    line_rating: jax.Array  # (nl,)
    load_sf: jax.Array      # (nl,) PTDF @ load distribution
    # data
    load: jax.Array         # (n_days, 289 + k) MW system load (padded)
    moer: jax.Array         # (n_days, 289, 37) kg CO2 / kWh
    # cols [0:k+1] of each day's MOER table, flattened row-major to ONE
    # wide row per day — the state slab gathers/rolls this layout
    moer_kflat: jax.Array   # (n_days, 289 * (k + 1))
    # warm-start shift permutations: each step moves the SCED horizon one
    # interval, so the previous solution warm-starts best with its per-tau
    # blocks shifted tau+1 -> tau (last block duplicated)
    warm_perm_x: jax.Array  # (n,) int32
    warm_perm_y: jax.Array  # (me,) int32
    warm_perm_z: jax.Array  # (mi,) int32
    # statics
    n_gen: int = static_field()
    n_lines: int = static_field()
    horizon: int = static_field()
    n_days: int = static_field()
    ic: int = static_field()
    id: int = static_field()
    intermediate_rewards: bool = static_field(default=True)
    # warm-started PDHG iteration budget (op.iters is the cold budget)
    lp_warm_iters: int = static_field(default=60)
    # 3-action mode (doc's discretize wrapper)
    discrete: bool = static_field(default=False)


@dataclass
class MarketState:
    day: jax.Array          # int32
    t: jax.Array            # int32
    energy: jax.Array       # MWh in battery
    energy0: jax.Array      # initial MWh (terminal penalty target)
    prev_action: jax.Array  # (2k,)
    prev_dispatch: jax.Array
    prev_price: jax.Array
    prev_load: jax.Array    # l_{t-1}: demand experienced last step (MW)
    cum_reward: jax.Array
    price_sum: jax.Array    # running sum for terminal penalty price
    # PDHG warm start carried between steps: consecutive SCEDs shift the
    # horizon one 5-min interval, so the previous solution is a near-optimal
    # initial iterate (several-fold fewer iterations for equal accuracy)
    warm_x: jax.Array       # (n,)
    warm_y: jax.Array       # (me,)
    warm_z: jax.Array       # (mi,)
    # the episode's exogenous day rows, gathered ONCE at reset and ROLLED
    # one position per step so the current load window / MOER row are
    # STATIC slices instead of per-(env, step) dynamic_slice gathers
    # (same pattern as the DC/cogen state slabs)
    load_slab: jax.Array    # (289 + k,) this day's load row
    moer_slab: jax.Array    # (289 * (k+1),) flattened MOER cols [0:k+1]


def _synthesize_load(n_days: int, month: int, seed: int = 7) -> np.ndarray:
    """Deterministic CAISO-like system load at 5-min resolution."""
    rng = np.random.default_rng(seed + month)
    steps = T_STEPS + 1
    t = np.arange(steps) / T_STEPS
    season = 1.0 + 0.12 * np.cos(2 * np.pi * (month - 7.5) / 12.0)
    out = np.empty((n_days, steps))
    for d in range(n_days):
        base = (0.62 - 0.10 * np.cos(2 * np.pi * (t - 0.08))
                + 0.16 * np.exp(-0.5 * ((t - 0.79) / 0.09) ** 2)   # evening pk
                + 0.05 * np.exp(-0.5 * ((t - 0.5) / 0.2) ** 2))
        ar = rng.normal(scale=0.004, size=steps).cumsum()
        out[d] = net_mod.PEAK_LOAD_MW * np.clip(
            season * (base + 0.03 * rng.normal() + ar), 0.35, 0.95)
    return out


def make_params(month: str = "2021-05",
                horizon: int = 4,
                # COLD iteration budget (step 0 of an episode). 200
                # iterations track a 600-iteration solve within $0.23/MWh
                # mean price error over an episode; PDHG convergence is
                # non-monotone and 200 cold iters measured CLOSER to the
                # 1500-iter price than 500 did ($0.01 vs $1.51 on day 3)
                lp_iters: int = 200,
                # WARM budget for every subsequent step: the previous
                # step's solution warm-starts a horizon shifted by one
                # 5-min interval, needing several-fold fewer iterations
                # for the same accuracy (test_warm_iters_price_accuracy;
                # round-5 sweep: warm=40 at alpha=0.35 tracks the 600-iter
                # reference as tightly as the old warm=60 at alpha=0.5)
                lp_warm_iters: int = 40,
                intermediate_rewards: bool = True,
                # doc's 3-action discretize wrapper: Discrete(3) actions
                # charge / do nothing / discharge -> DISCRETE_BIDS
                discrete: bool = False,
                moer_ba: str = "SGIP_CAISO_PGE",
                # precision of the PDHG matrix products: "f32" (full
                # float32) or "tf32" (ops/lp.py); default LP_MATMUL
                lp_matmul: str = LP_MATMUL,
                # PDHG over-relaxation (ops/lp.py relax): measured NO
                # gain on this geometry (1.8 tracked worse at every warm
                # budget) — kept for completeness, default off
                lp_relax: float = 1.0,
                # Pock-Chambolle preconditioner exponent: alpha sweeps
                # (tools/warm_sweep.py + the round-5 2-D refinement)
                # rank 0.35 best on the SCED geometry — warm=40@0.35
                # mean |dp| $0.25 vs the 600-iter reference, matching
                # warm=60@0.5 ($0.20) within the flat-200 baseline's
                # tolerance at 1.5x fewer iterations
                lp_precond_alpha: float = 0.35,
                # merged [A; S] PDHG matmuls (ops/lp.py merge_blocks):
                # one matmul per direction instead of one per block, at
                # the price of a per-iteration dual concat. Default off;
                # its H100 cost is not measured
                lp_merge: bool = False,
                dtype=jnp.float32) -> MarketParams:
    from ...data.ev_etl import build_moer_pack

    y, m = (int(s) for s in month.split("-"))
    first = dt.date(y, m, 1)
    last = (dt.date(y + 1, 1, 1) if m == 12 else dt.date(y, m + 1, 1)) \
        - dt.timedelta(days=1)
    moer = build_moer_pack((first.isoformat(), last.isoformat()), ba=moer_ba)
    n_days = moer.shape[0]

    net = build_network()
    mats = build_sced_matrices(net, horizon)
    # flow + energy limits are all +/- pairs of the S block: the paired-row
    # form halves the PDHG matmul rows vs stacking [S; -S] (ops/lp.py)
    op = lp.make_lp_operator(
        mats["A"], np.zeros((0, mats["A"].shape[1])), iters=lp_iters,
        dtype=dtype, sym=mats["S"],
        matmul=lp_matmul,
        relax=lp_relax, precond_alpha=lp_precond_alpha,
        merge_blocks=lp_merge)
    load = _synthesize_load(n_days, m)
    # pad horizon steps with the head of the next day for lookahead
    pad = np.roll(load, -1, axis=0)[:, :horizon]
    load = np.concatenate([load, pad], axis=1)

    # horizon-shift permutations (variable layout per build_sced_matrices:
    # x = [g(n_gen) per tau | c(k) | d(k)], y = per-tau balance, z half =
    # [per-tau flow blocks (nl each) | k energy rows])
    k, ng, nl = horizon, net.n_gen, net.n_lines
    nxt = np.minimum(np.arange(k) + 1, k - 1)
    perm_x = np.concatenate([
        (nxt[:, None] * ng + np.arange(ng)[None, :]).reshape(-1),
        mats["ic"] + nxt, mats["id"] + nxt]).astype(np.int32)
    perm_y = nxt.astype(np.int32)
    half = np.concatenate([
        (nxt[:, None] * nl + np.arange(nl)[None, :]).reshape(-1),
        k * nl + nxt]).astype(np.int32)
    perm_z = np.concatenate([half, half + op.ms]).astype(np.int32)

    return MarketParams(
        op=op,
        ub=jnp.asarray(mats["ub"], dtype),
        gen_cost_tiled=jnp.asarray(np.tile(net.gen_cost, horizon), dtype),
        line_rating=jnp.asarray(net.line_rating, dtype),
        load_sf=jnp.asarray(mats["load_sf"], dtype),
        load=jnp.asarray(load, dtype),
        moer=jnp.asarray(moer, dtype),
        moer_kflat=jnp.asarray(
            moer[:, :, :horizon + 1].reshape(n_days, -1), dtype),
        warm_perm_x=jnp.asarray(perm_x),
        warm_perm_y=jnp.asarray(perm_y),
        warm_perm_z=jnp.asarray(perm_z),
        n_gen=net.n_gen, n_lines=net.n_lines, horizon=horizon,
        n_days=n_days, ic=mats["ic"], id=mats["id"],
        intermediate_rewards=intermediate_rewards,
        lp_warm_iters=int(lp_warm_iters), discrete=bool(discrete),
    )


class ElectricityMarketEnv(FunctionalEnv[MarketParams, MarketState]):
    name = "electricitymarket"

    @staticmethod
    def day_from_seed(params: MarketParams, seed: int) -> int:
        return seed % params.n_days

    def reset(self, params: MarketParams, key: jax.Array
              ) -> tuple[MarketState, TimeStep]:
        day = jax.random.randint(key, (), 0, params.n_days)
        return self.reset_at_day(params, day)

    def reset_at_day(self, params: MarketParams, day
                     ) -> tuple[MarketState, TimeStep]:
        dtype = params.load.dtype
        k = params.horizon
        e0 = jnp.asarray(BATTERY_CAPACITY_MWH / 2.0, dtype)
        day = jnp.asarray(day, jnp.int32)
        state = MarketState(
            day=day, t=jnp.zeros((), jnp.int32),
            energy=e0, energy0=e0,
            prev_action=jnp.zeros(2 * k, dtype),
            prev_dispatch=jnp.zeros((), dtype),
            prev_price=jnp.zeros((), dtype),
            prev_load=jnp.zeros((), dtype),
            cum_reward=jnp.zeros((), dtype),
            price_sum=jnp.zeros((), dtype),
            warm_x=jnp.zeros(params.op.n, dtype),
            warm_y=jnp.zeros(params.op.me, dtype),
            warm_z=jnp.zeros(params.op.mi, dtype),
            load_slab=params.load[day],
            moer_slab=params.moer_kflat[day])
        ts = TimeStep(obs=self._obs(params, state),
                      reward=jnp.zeros((), dtype),
                      terminated=jnp.zeros((), bool),
                      truncated=jnp.zeros((), bool),
                      info=self._zero_info(params))
        return state, ts

    def _sced_problem(self, params: MarketParams, state: MarketState,
                      action: jax.Array):
        """Per-env SCED problem data (c, b, h, warm init) for the current
        step — separate from the solve so the lockstep :meth:`batch_unroll`
        can run one batched solve per step."""
        k = params.horizon
        action = jnp.asarray(action, params.load.dtype)
        a_charge = action[:k]
        a_discharge = action[k:]

        c = jnp.concatenate([params.gen_cost_tiled, -a_charge, a_discharge])
        loads = state.load_slab[:k]            # rolled slab: static slice
        b = loads

        # h follows the paired-operator ordering [h_plus(ms), h_minus(ms)]
        # with S rows = per-tau flow blocks then per-tau energy rows
        # (build_sced_matrices): +S x <= h_plus, -S x <= h_minus
        flow_p = []
        flow_m = []
        for tau in range(k):
            base = params.load_sf * loads[tau]
            flow_p.append(params.line_rating + base)
            flow_m.append(params.line_rating - base)
        e_room = BATTERY_CAPACITY_MWH - state.energy
        h = jnp.concatenate(
            flow_p + [jnp.broadcast_to(e_room, (k,))]
            + flow_m + [jnp.broadcast_to(state.energy, (k,))])
        # shift the carried solution one interval to align with the
        # moved horizon (zeros at t=0, so the cold start is unchanged)
        init = lp.LPSolution(x=state.warm_x[params.warm_perm_x],
                             y=state.warm_y[params.warm_perm_y],
                             z=state.warm_z[params.warm_perm_z])
        return c, b, h, init, loads[0]

    def clear_market(self, params: MarketParams, state: MarketState,
                     action: jax.Array) -> dict[str, jax.Array]:
        """Builds and solves the SCED LP for the current step."""
        c, b, h, init, load0 = self._sced_problem(params, state, action)
        # cold budget on the episode's first solve, warm budget after (the
        # carried solution is a near-optimal iterate once the horizon has
        # only shifted one interval); traced trip count -> while lowering
        iters = jnp.where(state.t == 0, params.op.iters,
                          params.lp_warm_iters)
        sol = lp.solve_lp(
            params.op, c, b, h, jnp.zeros_like(params.ub), params.ub,
            init=init, iters=iters)
        return self._cleared(params, sol, load0)

    @staticmethod
    def _cleared(params: MarketParams, sol: lp.LPSolution, load0
                 ) -> dict[str, jax.Array]:
        price = -sol.y[0]
        charge = sol.x[params.ic]
        discharge = sol.x[params.id]
        return {"price": price, "charge": charge, "discharge": discharge,
                "gen_dispatch": sol.x[:params.n_gen], "sol": sol,
                "load": load0}

    @staticmethod
    def _prep_action(params: MarketParams, action: jax.Array) -> jax.Array:
        dtype = params.load.dtype
        if params.discrete:
            # doc's 3-action wrapper: 0=charge / 1=idle / 2=discharge
            idx = jnp.asarray(action, jnp.int32).reshape(())
            table = jnp.asarray(DISCRETE_BIDS, dtype)  # (3, 2)
            return jnp.repeat(table[idx], params.horizon)   # (2k,) bids
        return jnp.clip(jnp.asarray(action, dtype), 0.0, MAX_BID)

    def step(self, params: MarketParams, state: MarketState,
             action: jax.Array, key: jax.Array
             ) -> tuple[MarketState, TimeStep]:
        del key
        action = self._prep_action(params, action)
        cleared = self.clear_market(params, state, action)
        return self._apply_cleared(params, state, action, cleared)

    def _apply_cleared(self, params: MarketParams, state: MarketState,
                       action: jax.Array, cleared: dict
                       ) -> tuple[MarketState, TimeStep]:
        dtype = params.load.dtype
        price = cleared["price"]
        c0, d0 = cleared["charge"], cleared["discharge"]

        dispatch_mwh = (d0 - c0) * TAU_H
        energy = jnp.clip(
            state.energy + (BATTERY_EFFICIENCY * c0 - d0 / BATTERY_EFFICIENCY)
            * TAU_H, 0.0, BATTERY_CAPACITY_MWH)

        t = state.t
        moer_kg_mwh = state.moer_slab[0] * 1000.0
        revenue = price * dispatch_mwh
        carbon_value = P_CO2 * moer_kg_mwh * dispatch_mwh
        step_reward = revenue + carbon_value

        t_next = t + 1
        terminated = t_next >= T_STEPS
        price_sum = state.price_sum + price
        avg_price = price_sum / t_next.astype(dtype)
        # terminal penalty: missing energy valued at twice the day's
        # average clearing price (doc: encourage same start/end level)
        terminal_cost = jnp.where(
            terminated,
            2.0 * avg_price * jnp.maximum(state.energy0 - energy, 0.0),
            0.0)
        step_reward = step_reward - terminal_cost

        cum = state.cum_reward + step_reward
        if params.intermediate_rewards:
            reward = step_reward
        else:
            reward = jnp.where(terminated, cum, 0.0)

        sol = cleared["sol"]
        new_state = MarketState(
            day=state.day, t=t_next, energy=energy, energy0=state.energy0,
            prev_action=action, prev_dispatch=dispatch_mwh,
            prev_price=price, prev_load=cleared["load"],
            cum_reward=cum, price_sum=price_sum,
            warm_x=sol.x, warm_y=sol.y, warm_z=sol.z,
            load_slab=jnp.roll(state.load_slab, -1),
            moer_slab=jnp.roll(state.moer_slab, -(params.horizon + 1)))
        ts = TimeStep(
            obs=self._obs(params, new_state),
            reward=reward, terminated=terminated,
            truncated=jnp.zeros((), bool),
            info={
                "price": price,
                "dispatch_mwh": dispatch_mwh,
                "energy_level": energy,
                "revenue": revenue,
                "carbon_value": carbon_value,
                "terminal_cost": terminal_cost,
            })
        return new_state, ts

    # ---- lockstep fast path ---------------------------------------------
    def batch_unroll(self, params: MarketParams, policy, policy_params,
                     key: jax.Array, batch: int, num_steps: int
                     ) -> TimeStep:
        """Fused reset+rollout of ``batch`` lockstep envs on the SAME PRNG
        stream as the generic autoreset scan (same key contract as the
        EV/building unrolls — trajectories match to float tolerance).

        The win: episodes are lockstep, so the cold/warm PDHG budget is a
        PYTHON-static property of the scan position (episode step 0 cold,
        rest warm) instead of a traced per-env ``where``: each step runs
        one batched solve with a static iteration count.
        """
        L = T_STEPS
        op = params.op
        lb_b = jnp.zeros((batch, op.n), params.load.dtype)
        ub_b = jnp.broadcast_to(params.ub, (batch, op.n))

        def batched_solve(c, b, h, init, iters):
            return lp.solve_lp(op, c, b, h, lb_b, ub_b, init=init,
                               iters=iters)

        vprep = jax.vmap(self._prep_action, in_axes=(None, 0))
        vprob = jax.vmap(self._sced_problem, in_axes=(None, 0, 0))
        vclr = jax.vmap(self._cleared, in_axes=(None, 0, 0))
        vapply = jax.vmap(self._apply_cleared, in_axes=(None, 0, 0, 0))

        def solve_step(states, obs, key_t, iters):
            key_act, key_env = jax.random.split(key_t)
            actions = vprep(params, policy(policy_params, obs, key_act))
            c, b, h, init, load0 = vprob(params, states, actions)
            sol = batched_solve(c, b, h, init, iters)
            cleared = vclr(params, sol, load0)
            states, ts = vapply(params, states, actions, cleared)
            return states, ts, key_env

        key_init, key_scan = jax.random.split(key)
        init_keys = jax.random.split(key_init, batch)
        states, ts0 = jax.vmap(self.reset, in_axes=(None, 0))(
            params, init_keys)
        obs = ts0.obs
        keys = jax.random.split(key_scan, num_steps)

        parts = []
        t0 = 0
        while t0 < num_steps:
            t_in_ep = t0 % L
            seg = min(L - t_in_ep, num_steps - t0)
            if t_in_ep == 0:
                # episode-opening COLD solve, statically budgeted
                states, ts_c, key_env = solve_step(
                    states, obs, keys[t0], int(op.iters))
                obs = ts_c.obs
                cold = jax.tree.map(lambda x: x[None], ts_c)
                parts.append(cold)
                t0 += 1
                t_in_ep = 1
                seg -= 1
                if seg == 0:
                    continue

            def body(carry, key_t):
                states, obs = carry
                states, ts, key_env = solve_step(
                    states, obs, key_t, int(params.lp_warm_iters))
                return (states, ts.obs), (ts, key_env)

            (states, obs), (traj, env_keys) = jax.lax.scan(
                body, (states, obs), keys[t0:t0 + seg])

            if t_in_ep + seg == L:
                # autoreset splice with the generic path's key derivation
                bkeys = jax.random.split(env_keys[-1], batch)
                reset_keys = jax.vmap(
                    lambda k: jax.random.split(k)[1])(bkeys)
                states, ts_r = jax.vmap(self.reset, in_axes=(None, 0))(
                    params, reset_keys)
                obs = ts_r.obs
                traj = traj.replace(obs=jax.tree.map(
                    lambda o, r: o.at[-1].set(r), traj.obs, obs))
            parts.append(traj)
            t0 += seg

        if len(parts) == 1:
            return parts[0]
        return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *parts)

    # ---- obs ------------------------------------------------------------
    def _obs(self, params: MarketParams, state: MarketState
             ) -> dict[str, jax.Array]:
        k = params.horizon
        dtype = params.load.dtype
        t = state.t
        # the state's slabs are rolled so position 0 is the current t
        load_fc = state.load_slab[:k]
        moer_row = state.moer_slab[:k + 1]
        return {
            "time": (t / T_STEPS).astype(dtype)[None],
            "energy_level": state.energy[None],
            "prev_action": state.prev_action,
            "prev_dispatch": state.prev_dispatch[None],
            "prev_price": state.prev_price[None],
            "prev_load": state.prev_load[None],
            "load_forecast": load_fc,
            "prev_moer": moer_row[0][None],
            "moer_forecast": jax.lax.dynamic_slice(moer_row, (1,), (k,)),
        }

    def _zero_info(self, params: MarketParams) -> dict[str, jax.Array]:
        z = jnp.zeros((), params.load.dtype)
        return {"price": z, "dispatch_mwh": z, "energy_level": z,
                "revenue": z, "carbon_value": z, "terminal_cost": z}

    # ---- metadata --------------------------------------------------------
    def episode_steps(self, params: MarketParams) -> int:
        """Fixed 288-step (5-min) day, docs/electricitymarketenv.md spec."""
        return T_STEPS

    def observation_space(self, params: MarketParams) -> DictSpace:
        k = params.horizon
        return DictSpace({
            "time": Box(0, 1, (1,)),
            "energy_level": Box(0, BATTERY_CAPACITY_MWH, (1,)),
            "prev_action": Box(0, MAX_BID, (2 * k,)),
            "prev_dispatch": Box(-BATTERY_POWER_MW * TAU_H,
                                 BATTERY_POWER_MW * TAU_H, (1,)),
            "prev_price": Box(-MAX_BID, MAX_BID, (1,)),
            "prev_load": Box(0, 4000, (1,)),
            "load_forecast": Box(0, 4000, (k,)),
            "prev_moer": Box(0, 1, (1,)),
            "moer_forecast": Box(0, 1, (k,)),
        })

    def action_space(self, params: MarketParams):
        if params.discrete:
            from ...core.spaces import Discrete
            return Discrete(3)
        return Box(0.0, MAX_BID, (2 * params.horizon,))
