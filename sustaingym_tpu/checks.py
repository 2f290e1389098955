"""Accuracy checks of the batched solvers against plain references.

Each check runs the production solver on one device (CPU in the tests, the
GPU in ``chip_smoke.py``) at a given batch and compares it with an
independent float64 host reference:

- :func:`projection_check` — the EV dual-FISTA feasibility projection
  (``ops/qp.py``) against a float64 ADMM ground truth run to convergence
  (:func:`projection_reference`);
- :func:`market_price_check` — the SCED clearing prices of the PDHG solver
  (``ops/lp.py``) against ``scipy.optimize.linprog`` (HiGHS) duals, and
  the TF32 solve against the same solve at full float32 precision;
- :func:`market_warm_check` — the env's cold/warm iteration budgets over an
  episode prefix against a flat 600-iteration full-float32 solve.

Each returns a dict of measured errors with the tolerances they were held to
and an ``ok`` flag, so callers print the numbers and decide.
"""
from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["projection_reference", "projection_inputs", "projection_check",
           "market_problems", "market_price_check", "market_warm_check",
           "PROJ_MAX_ERR", "PROJ_MAX_VIOLATION", "PRICE_SCIPY_MEDIAN",
           "PRICE_SCIPY_P90", "PRICE_PREC_MEAN", "PRICE_PREC_MAX",
           "PRICE_WARM_MEAN", "PRICE_WARM_MAX"]

# |x - x*| bound of the default 15-iteration operator, the bound the CPU
# tests hold (tests/test_evcharging.py dual-projection accuracy tests)
PROJ_MAX_ERR = 0.03
# largest cone overshoot ||C_k x|| - r_k in normalized current units: the
# dual iterate is only approximately feasible after 15 iterations, and the
# pilot quantization that follows re-rounds by up to 8/32 = 0.25 anyway
PROJ_MAX_VIOLATION = 0.05
# clearing price vs HiGHS duals ($/MWh) after the check's iteration budget:
# the bound of tests/test_electricitymarket.py::test_sced_clearing_vs_scipy
# held by the median and the 90th percentile of the sampled envs (a
# degenerate SCED has a non-unique dual, where HiGHS and PDHG may both be
# right and still differ)
PRICE_SCIPY_MEDIAN = 0.5
PRICE_SCIPY_P90 = 1.5
# price drift of the TF32 solve vs the full-f32 solve on the same device:
# the mean bound is about the solver's own iteration tolerance (~$0.23/MWh,
# electricitymarket.make_params)
PRICE_PREC_MEAN = 0.25
PRICE_PREC_MAX = 2.0
# warm-started episode prices vs a flat 600-iteration solve: the bounds of
# tests/test_electricitymarket.py::test_warm_iters_price_accuracy
PRICE_WARM_MEAN = 0.4
PRICE_WARM_MAX = 2.5


# ---------------------------------------------------------------------------
# EV projection
# ---------------------------------------------------------------------------

def projection_reference(C: np.ndarray, radii: np.ndarray, A: np.ndarray,
                         UB: np.ndarray, iters: int = 8000, rho: float = 2.0,
                         alpha: float = 1.7) -> np.ndarray:
    """float64 numpy ADMM at a huge iteration budget: the exact projection
    of each row of ``A`` onto {0 <= x <= UB} ∩ {||C_k x|| <= r_k}
    (matches scipy SLSQP to 1e-6 on the packaged sites,
    tools/proj_gt_check.py)."""
    n = C.shape[1]
    K = np.linalg.inv((1.0 + rho) * np.eye(n) + rho * (C.T @ C))
    x = np.clip(A, 0, UB)
    z0 = x.copy()
    u0 = np.zeros_like(x)
    zc = x @ C.T
    uc = np.zeros_like(zc)
    for _ in range(iters):
        rhs = A + rho * (z0 - u0) + rho * ((zc - uc) @ C)
        x = rhs @ K.T
        cx = x @ C.T
        xh = alpha * x + (1 - alpha) * z0
        cxh = alpha * cx + (1 - alpha) * zc
        z0 = np.clip(xh + u0, 0, UB)
        v = (cxh + uc).reshape(len(A), -1, 2)
        nr = np.sqrt((v ** 2).sum(-1) + 1e-12)
        sc = np.minimum(1.0, radii / nr)
        zc = (v * sc[..., None]).reshape(len(A), -1)
        u0 = u0 + xh - z0
        uc = uc + cxh - zc
    return np.clip(x, 0, UB)


def projection_inputs(n: int, batch: int, seed: int = 0
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Realistic projection inputs: actions U(0, 1); per-station upper
    bounds min(1, U(0, 2)) with 30% of stations unplugged (bound 0); the
    first rows are the adversarial corners (all-on at full and tiny
    bounds)."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(0, 1, (batch, n))
    UB = np.minimum(1.0, rng.uniform(0, 2, (batch, n)))
    UB[rng.uniform(size=UB.shape) < 0.3] = 0.0
    A[:2] = 1.0
    UB[0] = 1.0
    UB[1] = 0.03
    return A, UB


def projection_check(site: str = "caltech", batch: int = 2048,
                     device=None, iters: int = 15,
                     n_ref: int = 256, seed: int = 0,
                     time_steps: int = 0) -> dict:
    """Projects ``batch`` realistic (a, ub) rows for ``site`` with the env's
    default dual-FISTA operator on ``device`` and measures, in float64 on
    the host: the largest cone violation over the whole batch, and the
    distance to the exact projection on the first ``n_ref`` rows.

    ``time_steps`` > 0 also times that many chained projections (one
    episode's worth of per-step projections at this batch) and reports the
    warm seconds."""
    from .envs.evcharging.env import ACTION_SCALE_FACTOR
    from .envs.evcharging.sites import load_site
    from .ops import qp

    device = device or jax.devices()[0]
    spec = load_site(site)
    op = qp.make_dual_soc_projection(
        spec.constraint_matrix, spec.phase_angles, spec.magnitudes,
        action_scale=ACTION_SCALE_FACTOR, iters=iters)
    n = spec.num_stations
    A, UB = projection_inputs(n, batch, seed)
    op_d, a_d, ub_d = jax.device_put(
        (op, jnp.asarray(A, jnp.float32), jnp.asarray(UB, jnp.float32)),
        device)
    project = jax.jit(qp.project)
    x = np.asarray(project(op_d, a_d, ub_d), np.float64)

    C = np.asarray(op.C, np.float64)
    radii = np.asarray(op.radii, np.float64)
    cone = np.sqrt(((x @ C.T).reshape(batch, -1, 2) ** 2).sum(-1))
    violation = float(np.maximum(cone - radii, 0.0).max())
    box = float(max(np.maximum(-x, 0).max(), np.maximum(x - UB, 0).max()))
    m = min(n_ref, batch)
    xs = projection_reference(C, radii, A[:m], UB[:m])
    err = np.abs(x[:m] - xs)
    out = {
        "site": site, "batch": batch, "iters": iters,
        "device": str(device.device_kind),
        "max_cone_violation": violation,
        "max_box_violation": box,
        "max_abs_err": float(err.max()),
        "mean_abs_err": float(err.mean()),
        "tol_max_abs_err": PROJ_MAX_ERR,
        "tol_max_cone_violation": PROJ_MAX_VIOLATION,
    }
    out["ok"] = bool(out["max_abs_err"] < PROJ_MAX_ERR
                     and violation < PROJ_MAX_VIOLATION and box <= 1e-6)
    if time_steps:
        @jax.jit
        def chain(op, a, ub):
            def body(a, _):
                return qp.project(op, a, ub), None
            return jax.lax.scan(body, a, None, length=time_steps)[0]

        chain(op_d, a_d, ub_d).block_until_ready()
        t0 = time.perf_counter()
        chain(op_d, a_d, ub_d).block_until_ready()
        out["seconds_per_episode"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Market clearing prices
# ---------------------------------------------------------------------------

def market_problems(params, batch: int, seed: int = 0):
    """``batch`` SCED clearing problems of the market env: random days,
    times of day, battery levels and bids, built by the env's own
    ``_sced_problem``. Returns host float64 (c, b, h) arrays."""
    from .envs.electricitymarket.env import (BATTERY_CAPACITY_MWH,
                                             ElectricityMarketEnv, T_STEPS)

    env = ElectricityMarketEnv()
    rng = np.random.default_rng(seed)
    k = params.horizon
    days = rng.integers(0, params.n_days, batch)
    ts = rng.integers(0, T_STEPS, batch)
    energy = rng.uniform(0.1, 0.9, batch) * BATTERY_CAPACITY_MWH
    bids = np.concatenate([rng.uniform(0, 60, (batch, k)),
                           rng.uniform(20, 200, (batch, k))], axis=1)
    load = np.asarray(params.load)

    def one(day, t, e, a):
        st, _ = env.reset_at_day(params, day)
        slab = jnp.roll(jnp.asarray(load)[day], -t)
        st = st.replace(load_slab=slab, energy=e, energy0=e)
        c, b, h, _, _ = env._sced_problem(params, st, a)
        return c, b, h

    with jax.default_device(jax.devices("cpu")[0]):
        c, b, h = jax.jit(jax.vmap(one))(
            jnp.asarray(days), jnp.asarray(ts),
            jnp.asarray(energy, jnp.float32), jnp.asarray(bids, jnp.float32))
    return (np.asarray(c, np.float64), np.asarray(b, np.float64),
            np.asarray(h, np.float64))


def _scipy_prices(mats, c, b, h, ub) -> np.ndarray:
    from scipy.optimize import linprog

    out = []
    for i in range(len(c)):
        res = linprog(c[i], A_ub=mats["G"], b_ub=h[i], A_eq=mats["A"],
                      b_eq=b[i], bounds=[(0, u) for u in ub],
                      method="highs")
        if res.status != 0:
            raise RuntimeError(f"linprog failed on sample {i}: "
                               f"{res.message}")
        out.append(res.eqlin.marginals[0])   # df/db: marginal cost of load
    return np.asarray(out)


def market_price_check(batch: int = 4096, device=None,
                       matmuls: tuple[str, ...] = ("f32",),
                       iters: int = 600, n_scipy: int = 32, seed: int = 0,
                       horizon: int = 4, time_iters: int = 0) -> dict:
    """Clears ``batch`` SCED problems on ``device`` with the PDHG solver at
    each precision in ``matmuls`` (``iters`` iterations from a cold start)
    and measures the clearing prices against scipy HiGHS duals on
    ``n_scipy`` sampled envs, and against the full-f32 solve on every env.

    ``time_iters`` > 0 also times one warm batched solve of that many
    iterations (the env's warm budget) per precision."""
    from .envs.electricitymarket import make_params
    from .envs.electricitymarket.network import (build_network,
                                                 build_sced_matrices)
    from .ops import lp

    device = device or jax.devices()[0]
    params = make_params(horizon=horizon)
    c, b, h = market_problems(params, batch, seed)
    ub = np.asarray(params.ub, np.float64)
    mats = build_sced_matrices(build_network(), horizon)
    sample = np.random.default_rng(seed + 1).choice(
        batch, size=min(n_scipy, batch), replace=False)
    p_scipy = _scipy_prices(mats, c[sample], b[sample], h[sample], ub)

    args = jax.device_put(
        tuple(jnp.asarray(x, jnp.float32)
              for x in (c, b, h, np.zeros_like(c),
                        np.broadcast_to(ub, c.shape))), device)
    out = {"batch": batch, "iters": iters, "n_scipy": len(sample),
           "device": str(device.device_kind),
           "tol_scipy_median": PRICE_SCIPY_MEDIAN,
           "tol_scipy_p90": PRICE_SCIPY_P90,
           "tol_prec_mean": PRICE_PREC_MEAN, "tol_prec_max": PRICE_PREC_MAX}
    solve = jax.jit(lambda op, c, b, h, lb, ub, it:
                    lp.solve_lp(op, c, b, h, lb, ub, iters=it),
                    static_argnums=6)
    prices = {}
    ok = True
    for mode in ("f32",) + tuple(m for m in matmuls if m != "f32"):
        op = jax.device_put(params.op.replace(matmul=mode), device)
        sol = solve(op, *args, iters)
        prices[mode] = -np.asarray(sol.y[:, 0], np.float64)
        d = np.abs(prices[mode][sample] - p_scipy)
        row = {"scipy_median_err": float(np.median(d)),
               "scipy_p90_err": float(np.quantile(d, 0.9)),
               "scipy_max_err": float(d.max()),
               "finite": bool(np.isfinite(prices[mode]).all())}
        row_ok = (row["finite"] and row["scipy_median_err"]
                  < PRICE_SCIPY_MEDIAN
                  and row["scipy_p90_err"] < PRICE_SCIPY_P90)
        if mode != "f32":
            dp = np.abs(prices[mode] - prices["f32"])
            row["vs_f32_mean_err"] = float(dp.mean())
            row["vs_f32_max_err"] = float(dp.max())
            row_ok = (row_ok and row["vs_f32_mean_err"] < PRICE_PREC_MEAN
                      and row["vs_f32_max_err"] < PRICE_PREC_MAX)
        if time_iters:
            solve(op, *args, time_iters).y.block_until_ready()
            t0 = time.perf_counter()
            solve(op, *args, time_iters).y.block_until_ready()
            row["seconds_per_solve"] = time.perf_counter() - t0
        row["ok"] = bool(row_ok)
        ok = ok and row_ok
        out[mode] = row
    out["ok"] = bool(ok)
    return out


def market_warm_check(device=None, matmul: str | None = None,
                      steps: int = 96) -> dict:
    """Steps one market env ``steps`` times from day 0 with the default
    cold/warm PDHG budgets at precision ``matmul`` (default: the env's)
    and with a flat 600-iteration full-float32 solve, under fixed bids, on
    ``device``; compares the clearing prices."""
    from .envs.electricitymarket import make_env
    from .envs.electricitymarket.env import LP_MATMUL

    device = device or jax.devices()[0]
    matmul = matmul or LP_MATMUL
    prices = {}
    for name, kw in (("default", {"lp_matmul": matmul}),
                     ("reference", {"lp_iters": 600, "lp_warm_iters": 600,
                                    "lp_precond_alpha": 1.0,
                                    "lp_matmul": "f32"})):
        env, params = make_env(month="2021-05", horizon=4, **kw)
        params = jax.device_put(params, device)
        state, _ = env.reset_at_day(params, 0)
        action = jax.device_put(jnp.concatenate(
            [jnp.full(4, 20.0), jnp.full(4, 60.0)]), device)

        def run(params, state, action, env=env):
            def body(state, _):
                state, ts = env.step(params, state, action,
                                     jax.random.PRNGKey(0))
                return state, ts.info["price"]
            return jax.lax.scan(body, state, None, length=steps)[1]

        prices[name] = np.asarray(jax.jit(run)(params, state, action),
                                  np.float64)
    err = np.abs(prices["default"] - prices["reference"])
    out = {"matmul": matmul, "steps": steps,
           "device": str(device.device_kind),
           "mean_err": float(err.mean()), "max_err": float(err.max()),
           "tol_mean": PRICE_WARM_MEAN, "tol_max": PRICE_WARM_MAX}
    out["ok"] = bool(np.isfinite(err).all() and err.mean() < PRICE_WARM_MEAN
                     and err.max() < PRICE_WARM_MAX)
    return out
