"""EVChargingEnv + QP projection tests.

acnportal/cvxpy are absent, so the reference EV env cannot run here. Parity
is established structurally: the QP kernel is validated against a
brute-force projected-gradient oracle, the battery model against a NumPy
oracle of acnsim Linear2StageBattery semantics, and episode accounting
against hand-walked traces.
"""
from __future__ import annotations

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sustaingym_tpu.envs import evcharging
from sustaingym_tpu.envs.evcharging.env import (
    A_PERS_TO_KWH, ACTION_SCALE_FACTOR, BATTERY_CAPACITY, MAX_TIMESTEP,
    PROFIT_FACTOR, TRANSITION_SOC, battery_charge, quantize_pilots)
from sustaingym_tpu.checks import projection_reference
from sustaingym_tpu.ops import qp
from sustaingym_tpu.core import batch_rollout, random_policy


@pytest.fixture(scope="module")
def env_and_params():
    return evcharging.make_env(site="caltech", date_period="Summer 2021")


# ---------------------------------------------------------------------------
# QP projection kernel
# ---------------------------------------------------------------------------

def _oracle_project(C, radii, a, ub, iters=30000, lr=2e-3):
    """Slow projected-(sub)gradient oracle for the same problem, via a heavy
    penalty formulation, for cross-checking the ADMM kernel."""
    x = np.clip(a, 0, ub)
    pen = 1e3
    for it in range(iters):
        grad = (x - a)
        cx = C @ x
        pairs = cx.reshape(-1, 2)
        norms = np.sqrt((pairs ** 2).sum(-1) + 1e-12)
        viol = np.maximum(norms - radii, 0.0)
        if viol.max() > 0:
            dn = (pairs / norms[:, None])  # d||.||/dpairs
            g = (pen * viol[:, None] * dn).reshape(-1)
            grad = grad + C.T @ g
        x = np.clip(x - lr * grad, 0, ub)
    return x


def test_qp_projection_matches_oracle():
    rng = np.random.default_rng(0)
    spec = evcharging.caltech_site()
    op = qp.make_soc_projection(
        spec.constraint_matrix, spec.phase_angles, spec.magnitudes,
        iters=100, dtype=jnp.float32)
    C = np.asarray(op.C, np.float64)
    radii = np.asarray(op.radii, np.float64)
    n = spec.num_stations

    a = rng.uniform(0, 1, n)
    ub = np.minimum(1.0, rng.uniform(0, 2, n))
    x_admm = np.asarray(qp.project(op, jnp.asarray(a, jnp.float32),
                                   jnp.asarray(ub, jnp.float32)))
    x_oracle = _oracle_project(C, radii, a, ub)
    # identical objective to within kernel tolerance
    f_admm = np.linalg.norm(x_admm - a)
    f_oracle = np.linalg.norm(x_oracle - a)
    assert abs(f_admm - f_oracle) < 2e-2
    # feasibility of ADMM output
    pairs = (C @ x_admm).reshape(-1, 2)
    norms = np.sqrt((pairs ** 2).sum(-1))
    assert np.all(norms <= radii * 1.01 + 1e-3)
    assert np.all(x_admm >= -1e-6) and np.all(x_admm <= ub + 1e-6)


def test_qp_projection_identity_when_feasible():
    spec = evcharging.caltech_site()
    op = qp.make_soc_projection(
        spec.constraint_matrix, spec.phase_angles, spec.magnitudes,
        iters=100)
    a = np.full(spec.num_stations, 0.02, np.float32)  # tiny feasible action
    ub = np.ones(spec.num_stations, np.float32)
    x = np.asarray(qp.project(op, jnp.asarray(a), jnp.asarray(ub)))
    np.testing.assert_allclose(x, a, atol=2e-3)


def test_qp_projection_batched():
    spec = evcharging.caltech_site()
    op = qp.make_soc_projection(
        spec.constraint_matrix, spec.phase_angles, spec.magnitudes, iters=60)
    rng = np.random.default_rng(1)
    A = rng.uniform(0, 1, (32, spec.num_stations)).astype(np.float32)
    ub = np.ones_like(A)
    xb = np.asarray(qp.project(op, jnp.asarray(A), jnp.asarray(ub)))
    x0 = np.asarray(qp.project(op, jnp.asarray(A[0]), jnp.asarray(ub[0])))
    # batched matmul vs single matvec round differently; 3e-5 is ~500x below
    # the coarsest pilot quantization step (8/32 = 0.25 normalized)
    np.testing.assert_allclose(xb[0], x0, atol=3e-5)




def test_dual_projection_batched_accuracy():
    """BATCHED dual-FISTA projection vs float64 ground truth at realistic
    (a, ub) (30% unplugged stations). This is the regression the ADMM
    operator failed under reduced-precision (bf16) matmuls: its dual
    accumulators integrated the rounding noise to ~0.9 max error while
    staying feasible (tools/proj_experiment.py). The dual method is a
    descent scheme on a 16-dim dual and stays ~7e-3-accurate even at bf16
    matmul precision."""
    spec = evcharging.caltech_site()
    op = qp.make_dual_soc_projection(
        spec.constraint_matrix, spec.phase_angles, spec.magnitudes,
        iters=20)
    C = np.asarray(op.C, np.float64)
    radii = np.asarray(op.radii, np.float64)
    n = spec.num_stations
    rng = np.random.default_rng(3)
    B = 32
    A = rng.uniform(0, 1, (B, n))
    UB = np.minimum(1.0, rng.uniform(0, 2, (B, n)))
    UB[rng.uniform(size=UB.shape) < 0.3] = 0.0
    xs = projection_reference(C, radii, A, UB)
    x = np.asarray(qp.project(op, jnp.asarray(A, jnp.float32),
                              jnp.asarray(UB, jnp.float32)), np.float64)
    assert np.abs(x - xs).max() < 0.03
    # box feasibility is exact by construction
    assert np.all(x >= 0) and np.all(x <= UB + 1e-6)


def test_dual_projection_stress_battery():
    """Adversarial (a, ub) battery at the production step_scale=2.0
    overstep: corners, tiny bounds, sparse plug sets. Guards the overstep
    against divergence (step_scale=3.0 measured to 2-cycle on exactly this
    battery — the 2.0 default is only valid because this test pins it)."""
    rng = np.random.default_rng(42)
    for site in ("caltech", "jpl"):
        for iters in (15, 20):   # 15 = env default, 20 = library default
            spec = (evcharging.caltech_site() if site == "caltech"
                    else evcharging.jpl_site())
            op = qp.make_dual_soc_projection(
                spec.constraint_matrix, spec.phase_angles, spec.magnitudes,
                iters=iters)
            C = np.asarray(op.C, np.float64)
            radii = np.asarray(op.radii, np.float64)
            n = spec.num_stations
            a_sp = np.ones((16, n))
            ub_sp = np.zeros((16, n))
            for i in range(16):
                idx = rng.choice(n, size=rng.integers(1, n), replace=False)
                ub_sp[i, idx] = 1.0
            A = np.concatenate([np.ones((1, n)), np.ones((1, n)), a_sp])
            UB = np.concatenate([np.ones((1, n)), np.full((1, n), 0.03),
                                 ub_sp])
            xs = projection_reference(C, radii, A, UB, iters=20000)
            x = np.asarray(qp.project(op, jnp.asarray(A, jnp.float32),
                                      jnp.asarray(UB, jnp.float32)),
                           np.float64)
            assert np.abs(x - xs).max() < 0.03, (site, iters)


def test_dual_projection_spectral_scale_convergent():
    """step_scale=None (exact spectral bound) is the provably-convergent
    config: long-budget run must reach the ground truth tightly."""
    spec = evcharging.caltech_site()
    op = qp.make_dual_soc_projection(
        spec.constraint_matrix, spec.phase_angles, spec.magnitudes,
        iters=400, step_scale=None)
    C = np.asarray(op.C, np.float64)
    radii = np.asarray(op.radii, np.float64)
    n = spec.num_stations
    rng = np.random.default_rng(5)
    A = rng.uniform(0, 1, (8, n))
    UB = np.minimum(1.0, rng.uniform(0, 2, (8, n)))
    xs = projection_reference(C, radii, A, UB)
    x = np.asarray(qp.project(op, jnp.asarray(A, jnp.float32),
                              jnp.asarray(UB, jnp.float32)), np.float64)
    assert np.abs(x - xs).max() < 2e-3


def test_dual_projection_identity_when_feasible():
    spec = evcharging.caltech_site()
    op = qp.make_dual_soc_projection(
        spec.constraint_matrix, spec.phase_angles, spec.magnitudes)
    a = np.full(spec.num_stations, 0.02, np.float32)
    ub = np.ones(spec.num_stations, np.float32)
    x = np.asarray(qp.project(op, jnp.asarray(a), jnp.asarray(ub)))
    np.testing.assert_allclose(x, a, atol=2e-3)


def test_dual_projection_batched_matches_single():
    spec = evcharging.caltech_site()
    op = qp.make_dual_soc_projection(
        spec.constraint_matrix, spec.phase_angles, spec.magnitudes)
    rng = np.random.default_rng(1)
    A = rng.uniform(0, 1, (32, spec.num_stations)).astype(np.float32)
    ub = np.ones_like(A)
    xb = np.asarray(qp.project(op, jnp.asarray(A), jnp.asarray(ub)))
    x0 = np.asarray(qp.project(op, jnp.asarray(A[0]), jnp.asarray(ub[0])))
    np.testing.assert_allclose(xb[0], x0, atol=3e-5)


# ---------------------------------------------------------------------------
# pilot quantization & battery
# ---------------------------------------------------------------------------

def test_quantize_pilots():
    minp = jnp.asarray([6.0, 8.0])
    # CC: <6 -> 0, else round; AV: round to multiple of 8 (round-half-even)
    out = np.asarray(quantize_pilots(jnp.asarray([[0.17, 0.17],
                                                  [0.5, 0.5],
                                                  [0.125, 0.125]]),
                                     minp))
    np.testing.assert_allclose(out[0], [0.0, 8.0])     # 5.44A: CC->0, AV->8
    np.testing.assert_allclose(out[1], [16.0, 16.0])
    np.testing.assert_allclose(out[2], [0.0, 0.0])     # 4A: CC->0, AV 4/8=.5 -> round-even 0

def test_battery_two_stage_taper():
    # below transition: full pilot power delivered
    rates, energy = battery_charge(jnp.asarray([32.0]), jnp.asarray([50.0]),
                                   jnp.asarray([True]))
    np.testing.assert_allclose(np.asarray(rates), [32.0], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(energy),
                               [32.0 * 208 / 1000 / 12], rtol=1e-6)
    # above transition: tapered: soc=0.9 -> cap = 100*(0.1/0.2) = 50kW > pilot
    rates, _ = battery_charge(jnp.asarray([32.0]), jnp.asarray([10.0]),
                              jnp.asarray([True]))
    np.testing.assert_allclose(np.asarray(rates), [32.0], rtol=1e-6)
    # deep taper: soc=0.999 -> cap=0.5kW < pilot power 6.656kW
    rates, _ = battery_charge(jnp.asarray([32.0]), jnp.asarray([0.1]),
                              jnp.asarray([True]))
    expected_kw = min(32 * 208 / 1000, 100 * (0.1 / 100) / (1 - TRANSITION_SOC))
    np.testing.assert_allclose(np.asarray(rates), [expected_kw * 1000 / 208],
                               rtol=1e-4)
    # unplugged -> zero
    rates, energy = battery_charge(jnp.asarray([32.0]), jnp.asarray([50.0]),
                                   jnp.asarray([False]))
    assert float(rates[0]) == 0.0 and float(energy[0]) == 0.0


# ---------------------------------------------------------------------------
# env integration
# ---------------------------------------------------------------------------

def test_reset_obs_structure(env_and_params):
    env, params = env_and_params
    state, ts = env.reset_at_day(params, 0)
    assert ts.obs["est_departures"].shape == (54,)
    assert ts.obs["demands"].shape == (54,)
    assert ts.obs["forecasted_moer"].shape == (36,)
    assert float(ts.obs["timestep"][0]) == 0.0
    # no EVs plugged before the first step (reference resets the simulator
    # before processing any events)
    assert np.all(np.asarray(ts.obs["demands"]) == 0)


def test_episode_charging_accounting(env_and_params):
    """Greedy full-power episode: delivered energy implied by profit must
    equal the total demand drained from the state."""
    env, params = env_and_params
    day = int(np.argmax(np.asarray(params.ev_mask).sum(axis=1)))
    state, ts = env.reset_at_day(params, day)
    a = jnp.ones(params.n_stations)

    step = jax.jit(env.step)
    total_profit = 0.0
    key = jax.random.PRNGKey(0)
    plugged_seen = 0
    for _ in range(288):
        state, ts = step(params, state, a, key)
        total_profit += float(ts.info["profit"])
        plugged_seen = max(plugged_seen, int(np.asarray(state.plugged).sum()))
    assert bool(ts.terminated)
    assert plugged_seen > 0
    assert total_profit > 0
    # profit cannot exceed the max_profit bound (ignores constraints)
    assert total_profit <= float(ts.info["max_profit"]) * 1.01


def test_unplug_stops_charging(env_and_params):
    env, params = env_and_params
    day = int(np.argmax(np.asarray(params.ev_mask).sum(axis=1)))
    ev = np.asarray(params.ev_data)[day]
    mask = np.asarray(params.ev_mask)[day]
    k = int(np.argmax(mask))
    dep_t = int(ev[k, 1])
    station = int(np.asarray(params.ev_station)[day, k])
    state, _ = env.reset_at_day(params, day)
    a = jnp.ones(params.n_stations)
    step = jax.jit(env.step)
    key = jax.random.PRNGKey(0)
    for t in range(min(dep_t + 2, 288)):
        prev_plugged = bool(np.asarray(state.plugged)[station])
        state, ts = step(params, state, a, key)
        if t + 1 > dep_t:
            assert not bool(np.asarray(state.plugged)[station]) or \
                int(np.asarray(state.dep)[station]) > dep_t  # re-plugged by later EV


def test_no_projection_violates_network(env_and_params):
    """With projection off and all stations maxed, the network constraints
    must register excess charge on a busy day."""
    env_p, params_p = env_and_params
    env, params = evcharging.make_env(site="caltech",
                                      date_period="Summer 2021",
                                      project_action=False)
    day = int(np.argmax(np.asarray(params.ev_mask).sum(axis=1)))
    state, _ = env.reset_at_day(params, day)
    a = jnp.ones(params.n_stations)
    step = jax.jit(env.step)
    key = jax.random.PRNGKey(0)
    excess = 0.0
    for _ in range(288):
        state, ts = step(params, state, a, key)
        excess += float(ts.info["excess_charge"])
    assert excess > 0


def test_projection_keeps_network_feasible(env_and_params):
    env, params = env_and_params
    day = int(np.argmax(np.asarray(params.ev_mask).sum(axis=1)))
    state, _ = env.reset_at_day(params, day)
    a = jnp.ones(params.n_stations)
    step = jax.jit(env.step)
    key = jax.random.PRNGKey(0)
    excess = 0.0
    for _ in range(120):
        state, ts = step(params, state, a, key)
        excess += float(ts.info["excess_charge"])
    # small residual violations allowed: pilot quantization re-rounds the
    # projected action (the reference behaves identically, env.py:368-378)
    assert excess < 0.05


def test_vmap_batch_rollout(env_and_params):
    env, params = env_and_params
    batch, steps = 8, 10
    traj = batch_rollout(env, params, random_policy(env, params, batch), None,
                         jax.random.PRNGKey(0), batch, steps)
    assert traj.reward.shape == (steps, batch)
    assert np.all(np.isfinite(np.asarray(traj.reward)))


def test_jpl_site_loads():
    env, params = evcharging.make_env(site="jpl", date_period="Summer 2021",
                                      project_action=False)
    assert params.n_stations == 52
    state, ts = env.reset_at_day(params, 3)
    assert ts.obs["demands"].shape == (52,)


def test_gmm_trace_generator():
    """GMM-based artificial trace bank (GMMsTraceGenerator analogue)."""
    env, params = evcharging.make_env(
        site="caltech", date_period="Summer 2021", trace="gmm",
        gmm_days=10, project_action=False)
    assert params.n_days == 10
    mask = np.asarray(params.ev_mask)
    ev = np.asarray(params.ev_data)
    assert mask.sum() > 20  # plausible session volume over 10 days
    # arrivals strictly before departures and estimated departures
    valid = mask.astype(bool)
    assert np.all(ev[valid][:, 0] < ev[valid][:, 1])
    assert np.all(ev[valid][:, 0] < ev[valid][:, 2])
    assert np.all((ev[valid][:, 3] > 0) & (ev[valid][:, 3] <= 100))
    # no station double-booked: overlapping sessions at one station
    for d in range(10):
        for s in range(params.n_stations):
            rows = np.where(valid[d] & (np.asarray(params.ev_station)[d] == s))[0]
            spans = sorted((ev[d, r, 0], ev[d, r, 1]) for r in rows)
            for (a1, d1), (a2, d2) in zip(spans, spans[1:]):
                assert a2 >= d1, (d, s, spans)
    # deterministic for a given seed
    from sustaingym_tpu.data.ev_gmm import build_gmm_trace_pack
    p2 = build_gmm_trace_pack("caltech", "Summer 2021", n_days=10, cache=False)
    np.testing.assert_array_equal(np.asarray(params.ev_data), p2["ev_data"])
    # episode runs
    state, ts = env.reset_at_day(params, 0)
    state, ts = env.step(params, state, jnp.ones(params.n_stations),
                         jax.random.PRNGKey(0))
    assert np.isfinite(float(ts.reward))


# ---------------------------------------------------------------------------
# Network-constant fidelity (SURVEY §7 hard part 1; sites.py provenance table)
# ---------------------------------------------------------------------------

def _scaled_magnitude_params(scale: float, project: bool):
    """Params with every constraint magnitude scaled by ``scale`` (the
    projection operator is re-factorized to match)."""
    from sustaingym_tpu.envs.evcharging.env import ACTION_SCALE_FACTOR
    from sustaingym_tpu.envs.evcharging.sites import load_site

    env, params = evcharging.make_env(site="caltech",
                                      date_period="Summer 2021",
                                      project_action=project)
    spec = load_site("caltech")
    mags = spec.magnitudes * scale
    proj = qp.make_soc_projection(
        spec.constraint_matrix, spec.phase_angles, mags,
        action_scale=ACTION_SCALE_FACTOR, iters=30)
    return env, params.replace(
        magnitudes=jnp.asarray(mags, params.magnitudes.dtype), proj=proj)


def _greedy_episode_terms(env, params, steps: int = 288):
    day = int(np.argmax(np.asarray(params.ev_mask).sum(axis=1)))
    state, _ = env.reset_at_day(params, day)
    a = jnp.ones(params.n_stations)

    def body(s, _):
        s, ts = env.step(params, s, a, jax.random.PRNGKey(0))
        return s, (ts.info["profit"], ts.info["excess_charge"])

    _, (profit, excess) = jax.jit(
        lambda s: jax.lax.scan(body, s, None, length=steps))(state)
    return float(profit.sum()), float(excess.sum())


def test_magnitude_sensitivity_projected_greedy():
    """Quantifies the blast radius of the RECONSTRUCTED constraint
    magnitudes (sites.py provenance table): under the projected greedy
    policy, magnitudes scale the feasible set, so profit must be monotone
    nondecreasing in the scale while the network stays feasible."""
    results = {}
    for scale in (0.5, 1.0, 2.0):
        env, params = _scaled_magnitude_params(scale, project=True)
        profit, excess = _greedy_episode_terms(env, params)
        results[scale] = (profit, excess)
        # projection keeps the (rescaled) network feasible at every scale
        assert excess < 0.05 * scale + 0.05, (scale, excess)
    assert results[0.5][0] <= results[1.0][0] + 1e-3, results
    assert results[1.0][0] <= results[2.0][0] + 1e-3, results
    # -50% magnitude error visibly binds (profit strictly drops), so the
    # reconstruction's accuracy matters and is worth documenting
    assert results[0.5][0] < results[2.0][0], results


def test_magnitude_sensitivity_unprojected_greedy():
    """Without projection, magnitudes only enter the excess_charge reward
    term: it must be monotone nonincreasing in the magnitude scale and
    strictly positive when magnitudes are halved."""
    results = {}
    for scale in (0.5, 1.0, 2.0):
        env, params = _scaled_magnitude_params(scale, project=False)
        profit, excess = _greedy_episode_terms(env, params)
        results[scale] = (profit, excess)
        # profit term itself is magnitude-independent with projection off
    assert results[0.5][1] >= results[1.0][1] >= results[2.0][1], results
    assert results[0.5][1] > 0, results
    p = [results[s][0] for s in (0.5, 1.0, 2.0)]
    np.testing.assert_allclose(p, p[0], rtol=1e-5)


def test_extracted_site_json_roundtrip(tmp_path):
    """tools/extract_acn_site.py's JSON schema loads through
    sites.load_site and reproduces the spec exactly (the override path the
    reconstruction docs point acnportal users at)."""
    import json

    from sustaingym_tpu.envs.evcharging.sites import caltech_site, load_site

    spec = caltech_site()
    # exactly the schema extract_acn_site.py writes (tools/extract_acn_site.py:26-33)
    payload = {
        "station_ids": list(spec.station_ids),
        "phase_angles": spec.phase_angles.tolist(),
        "constraint_matrix": spec.constraint_matrix.tolist(),
        "magnitudes": spec.magnitudes.tolist(),
        "constraint_names": list(spec.constraint_names),
        "min_pilots": [float(p) for p in spec.min_pilots],
    }
    path = tmp_path / "caltech_acn.json"
    path.write_text(json.dumps(payload, indent=1))
    spec2 = load_site("caltech", json_path=str(path))
    assert spec2.station_ids == spec.station_ids
    assert spec2.constraint_names == spec.constraint_names
    np.testing.assert_array_equal(spec2.phase_angles, spec.phase_angles)
    np.testing.assert_array_equal(spec2.constraint_matrix,
                                  spec.constraint_matrix)
    np.testing.assert_array_equal(spec2.magnitudes, spec.magnitudes)
    np.testing.assert_array_equal(spec2.min_pilots, spec.min_pilots)


def test_gmm_bank_matches_reference_sampler_distribution():
    """The precomputed GMM day bank (a semantic delta vs the reference's
    per-reset sampling, COMPONENTS.md 'Known deltas') is distributionally
    faithful: KS tests on the arrival-time and requested-energy marginals
    against fresh draws of the reference sampling algorithm from the same
    packaged GMM pickle."""
    from scipy import stats

    from sustaingym_tpu.data.ev_gmm import (_assign_stations,
                                            _sample_sessions,
                                            build_gmm_trace_pack, load_gmm)

    pack = build_gmm_trace_pack("caltech", "Summer 2021", n_days=60)
    msk = pack["ev_mask"]
    bank_arr = pack["ev_data"][..., 0][msk]
    bank_req = pack["ev_data"][..., 3][msk]

    # fresh reference-style draws (different seed stream than the bank)
    data = load_gmm("caltech", "Summer 2021", 30)
    cnt = np.asarray(data["count"])
    usage = np.asarray(data["station_usage"], dtype=np.float64)
    fresh = []
    for d in range(60):
        rng = np.random.default_rng(987654 + d)
        n = int(rng.choice(cnt))
        s = _sample_sessions(data, n, 987654 + d)
        st = _assign_stations(s, usage, rng)
        fresh.append(s[st >= 0])
    fresh = np.concatenate(fresh)
    fresh_req = np.clip(fresh[:, 3], 0, 100.0)

    ks_arr = stats.ks_2samp(bank_arr, fresh[:, 0])
    ks_req = stats.ks_2samp(bank_req, fresh_req)
    # generous alpha: these are two finite draws of the same distribution
    assert ks_arr.pvalue > 1e-3, (ks_arr, len(bank_arr), len(fresh))
    assert ks_req.pvalue > 1e-3, (ks_req,)


@pytest.mark.parametrize("site", ["caltech", "jpl"])
def test_gmm_sampler_bit_exact_vs_sklearn(site):
    """The sklearn-free sampler reproduces the reference's GMM day
    BIT-EXACTLY: runs the reference's _create_events algorithm
    (event_generation.py:416-515) with the REAL sklearn GaussianMixture
    object from the packaged pickle, and compares against this repo's
    replica (sample_gmm + _sample_sessions + _assign_stations) under the
    same seed. Covers the multinomial/MVN RandomState call sequence, the
    fresh-RandomState-per-sample-call quirk, the pandas quicksort tie
    order, and the Generator station-choice stream."""
    pickle_path = os.path.join(
        f"/root/reference/sustaingym/data/evcharging/gmms/{site}",
        "2021-05-01 2021-08-31 30.pkl")
    sklearn = pytest.importorskip("sklearn")  # noqa: F841 (unpickle needs it)
    if not os.path.exists(pickle_path):
        pytest.skip("reference GMM pickle not available")
    import pickle
    import warnings

    from sustaingym_tpu.data.ev_gmm import (_assign_stations,
                                            _sample_sessions, load_gmm,
                                            sample_gmm)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with open(pickle_path, "rb") as f:
            ref = pickle.load(f)
    gmm, cnt = ref["gmm"], np.asarray(ref["count"])
    usage = np.asarray(ref["station_usage"], dtype=np.float64)
    MINS_IN_DAY, PERIOD, ESCALE = 1440, 5, 100.0

    for seed in (0, 7, 12345):
        # --- reference algorithm, real sklearn object -------------------
        gmm.set_params(random_state=seed)
        rng = np.random.default_rng(seed)
        n = int(rng.choice(cnt))
        all_s, total = [], 0
        # reference _sample(0) short-circuits to an empty array
        # (event_generation.py:431-432) — JPL has zero-session days
        while total < n:
            s = gmm.sample(int(n * 1.2))[0]
            s = s[(0 <= s[:, 0]) & (s[:, 1] < 1) & (s[:, 2] < 1)
                  & (s[:, 3] >= 0)]
            s[:, [0, 1, 2]] = MINS_IN_DAY * s[:, [0, 1, 2]] // PERIOD
            s = s[(s[:, 0] < s[:, 1]) & (s[:, 0] < s[:, 2])]
            s[:, 3] *= ESCALE
            all_s.append(s)
            total += len(s)
        ref_samples = (np.concatenate(all_s)[:n] if all_s
                       else np.empty((0, 4)))
        # station assignment: pandas sort_values('arrival') == quicksort
        order = np.argsort(ref_samples[:, 0].astype(np.int64),
                           kind="quicksort")
        probs = usage / usage.sum()
        station_dep = np.full(len(usage), -1, dtype=np.int32)
        ref_assigned = np.full(n, -1, dtype=np.int64)
        for i in order:
            avail = np.where(station_dep < ref_samples[i, 0])[0]
            if len(avail) == 0:
                continue
            ps = probs[avail].sum()
            if ps <= 1e-5:
                idx = rng.choice(avail)
            else:
                idx = rng.choice(avail, p=probs[avail] / ps)
            station_dep[idx] = max(ref_samples[i, 1], station_dep[idx])
            ref_assigned[i] = idx

        # --- this repo's sklearn-free replica ---------------------------
        data = load_gmm(site, "Summer 2021", 30)
        # npz export content == pickle content
        np.testing.assert_array_equal(data["count"], cnt)
        np.testing.assert_array_equal(data["station_usage"], usage)
        np.testing.assert_array_equal(data["weights"], gmm.weights_)
        np.testing.assert_array_equal(data["means"], gmm.means_)
        np.testing.assert_array_equal(data["covariances"], gmm.covariances_)
        rng2 = np.random.default_rng(seed)
        n2 = int(rng2.choice(data["count"]))
        assert n2 == n
        mine = _sample_sessions(data, n2, seed)
        st = _assign_stations(mine, usage, rng2)

        np.testing.assert_array_equal(mine, ref_samples)
        np.testing.assert_array_equal(st, ref_assigned)
        # raw sklearn sample() vs replica, pre-filtering
        raw_ref = gmm.sample(max(n, 8))[0]
        raw_mine = sample_gmm(data["weights"], data["means"],
                              data["covariances"], max(n, 8), seed)
        np.testing.assert_array_equal(raw_mine, raw_ref)


def test_batch_unroll_matches_generic(env_and_params):
    """EV lockstep fast path == the generic autoreset scan on the same PRNG
    stream (trajectories bit-compatible up to XLA fusion drift), across an
    episode boundary so the autoreset splice is exercised."""
    env, params = env_and_params
    batch = 4
    steps = MAX_TIMESTEP + 5
    policy = random_policy(env, params, batch)
    key = jax.random.PRNGKey(42)
    slow = batch_rollout(env, params, policy, None, key, batch, steps,
                         fast=False)
    fast = env.batch_unroll(params, policy, None, key, batch, steps,
                            prefetch=48)
    np.testing.assert_allclose(np.asarray(fast.reward),
                               np.asarray(slow.reward), rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(fast.terminated),
                                  np.asarray(slow.terminated))
    for k in slow.obs:
        np.testing.assert_allclose(np.asarray(fast.obs[k]),
                                   np.asarray(slow.obs[k]),
                                   rtol=2e-5, atol=1e-6, err_msg=k)
    for k in slow.info:
        np.testing.assert_allclose(np.asarray(fast.info[k]),
                                   np.asarray(slow.info[k]),
                                   rtol=2e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("site", ["caltech", "jpl"])
def test_gmm_trace_pack_end_to_end_vs_reference(site):
    """END-TO-END GMM episode contract (round-4 verdict item 6): day ``d``
    of ``build_gmm_trace_pack(seed=s)`` equals the session set the ACTUAL
    reference ``GMMsTraceGenerator._create_events`` produces after
    ``set_seed(s + d)`` (the documented seed mapping, data/ev_gmm.py:
    build_gmm_trace_pack vs reference event_generation.py:411-515).
    Unlike test_gmm_sampler_bit_exact_vs_sklearn (which re-implements the
    reference algorithm inline), this runs the reference METHODS verbatim —
    the class is instantiated via ``__new__`` with only the attributes
    ``set_seed``/``_create_events`` touch, because the full constructor
    needs acnportal (absent; import satisfied by tests/_shims/acnportal)."""
    from .conftest import add_reference_to_path

    if not add_reference_to_path():
        pytest.skip("reference tree not available")
    sklearn = pytest.importorskip("sklearn")  # noqa: F841 (unpickle)
    pickle_path = os.path.join(
        f"/root/reference/sustaingym/data/evcharging/gmms/{site}",
        "2021-05-01 2021-08-31 30.pkl")
    if not os.path.exists(pickle_path):
        pytest.skip("reference GMM pickle not available")
    import importlib
    import pickle
    import sys
    import types
    import warnings

    # the reference subpackage __init__ is broken in this snapshot (imports
    # the non-existent .discrete_action_wrapper, and .env needs cvxpy) —
    # register the package node WITHOUT executing its __init__ so the
    # event_generation submodule (pure numpy/pandas/sklearn) loads verbatim
    pkg_name = "sustaingym.envs.evcharging"
    importlib.import_module("sustaingym.envs")
    if pkg_name not in sys.modules:
        pkg = types.ModuleType(pkg_name)
        pkg.__path__ = ["/root/reference/sustaingym/envs/evcharging"]
        sys.modules[pkg_name] = pkg
    ref_eg = importlib.import_module(
        "sustaingym.envs.evcharging.event_generation")

    from sustaingym_tpu.data.ev_etl import MAX_EVS
    from sustaingym_tpu.data.ev_gmm import build_gmm_trace_pack
    from sustaingym_tpu.envs.evcharging.sites import load_site

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with open(pickle_path, "rb") as f:
            ref_data = pickle.load(f)

    spec = load_site(site)
    gen = ref_eg.GMMsTraceGenerator.__new__(ref_eg.GMMsTraceGenerator)
    gen.gmm = ref_data["gmm"]
    gen.cnt = np.asarray(ref_data["count"])
    gen.station_usage = np.asarray(ref_data["station_usage"],
                                   dtype=np.float64)
    # identity index mapping: _create_events maps chosen station index ->
    # station_ids[idx]; using the repo spec's ordering makes idx comparable
    # to the pack's ev_station directly (the usage vector's index space is
    # shared by construction — both sides loaded it from the same pickle)
    gen.station_ids = list(spec.station_ids)
    gen.requested_energy_cap = 100.0

    seed, n_days = 0, 4
    pack = build_gmm_trace_pack(site, "Summer 2021", n_days=n_days,
                                n_components=30, seed=seed, cache=False)
    sid_to_idx = {s: i for i, s in enumerate(spec.station_ids)}

    for day in range(n_days):
        gen.set_seed(seed + day)          # reference seed mapping
        events = gen._create_events()     # the real reference method
        ref_rows = np.array(
            [[float(r["arrival"]), float(r["departure"]),
              float(r["estimated_departure"]),
              float(r["requested_energy (kWh)"]),
              float(sid_to_idx[r["station_id"]])]
             for _, r in events.iterrows()])
        if len(ref_rows) == 0:
            assert not pack["ev_mask"][day].any()
            continue
        assert len(ref_rows) <= MAX_EVS   # no silent truncation in play
        k = int(pack["ev_mask"][day].sum())
        mine = np.concatenate(
            [pack["ev_data"][day, :k].astype(np.float64),
             pack["ev_station"][day, :k, None].astype(np.float64)], axis=1)
        # (arrival, station) is unique — assignment only grants a station
        # whose last departure precedes the arrival — so this sort order
        # aligns the two row sets deterministically
        def _sorted(rows):
            return rows[np.lexsort((rows[:, 4], rows[:, 0]))]
        mine_s, ref_s = _sorted(mine), _sorted(ref_rows)
        # integer columns (arrival/departure/est-departure/station): exact
        np.testing.assert_array_equal(mine_s[:, [0, 1, 2, 4]],
                                      ref_s[:, [0, 1, 2, 4]])
        # requested energy: the pack stores float32 (ev_etl layout); the
        # value must be EXACTLY the f32 cast of the reference's float64 —
        # any looser tolerance would hide a real sampling drift
        np.testing.assert_array_equal(
            mine_s[:, 3].astype(np.float32),
            ref_s[:, 3].astype(np.float32))


@pytest.mark.parametrize("periods_delay", [0, 2])
def test_ma_batch_unroll_matches_generic(periods_delay):
    """MA-EV view lockstep fast path == the generic autoreset scan on the
    same PRNG stream (round-4 verdict item 2), across an episode boundary,
    with the staleness ring exercised (periods_delay=2)."""
    from sustaingym_tpu import make

    env, params = make("evcharging-multiagent", periods_delay=periods_delay,
                       project_action=False)
    batch = 3
    steps = MAX_TIMESTEP + 4
    policy = random_policy(env, params, batch)
    key = jax.random.PRNGKey(7)
    slow = batch_rollout(env, params, policy, None, key, batch, steps,
                         fast=False)
    fast = env.batch_unroll(params, policy, None, key, batch, steps)
    np.testing.assert_allclose(np.asarray(fast.reward),
                               np.asarray(slow.reward), rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(fast.terminated),
                                  np.asarray(slow.terminated))
    np.testing.assert_allclose(np.asarray(fast.obs), np.asarray(slow.obs),
                               rtol=2e-5, atol=1e-6)
    for k in slow.info:
        np.testing.assert_allclose(np.asarray(fast.info[k]),
                                   np.asarray(slow.info[k]),
                                   rtol=2e-5, atol=1e-6)
