"""BuildingEnv tests: golden parity vs the reference package + engine checks.

Parity strategy (SURVEY.md §4): run the ACTUAL reference BuildingEnv
(/root/reference/sustaingym/envs/building/env.py) on CPU under fixed seeds
(with a pvlib shim for EPW parsing) and diff full trajectories against the
functional JAX env in float64.
"""
from __future__ import annotations

import numpy as np
import pytest

from .conftest import add_reference_to_path

import jax
import jax.numpy as jnp  # noqa: E402

from sustaingym_tpu.envs.building import (  # noqa: E402
    BuildingEnv, generate_building_params, make_params)
from sustaingym_tpu.core import batch_rollout, random_policy  # noqa: E402


@pytest.fixture(scope="module")
def param_dict():
    return generate_building_params("OfficeSmall", "Hot_Dry", "Tucson")


@pytest.fixture(scope="module")
def env_and_params64(param_dict):
    return BuildingEnv(), make_params(param_dict, dtype=jnp.float64)


@pytest.fixture(scope="module")
def reference_env():
    if not add_reference_to_path():
        pytest.skip("reference tree unavailable")
    from sustaingym.envs.building import BuildingEnv as RefBuildingEnv
    from sustaingym.envs.building import ParameterGenerator as RefPG
    params = RefPG(building="OfficeSmall", weather="Hot_Dry", location="Tucson")
    return RefBuildingEnv(params)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_trajectory_parity_vs_reference(env_and_params64, reference_env, seed):
    env, params = env_and_params64
    ref = reference_env

    rng = np.random.default_rng(seed)
    n = params.n
    actions = rng.uniform(-1, 1, size=(50, n)).astype(np.float32)
    actions *= np.asarray(params.ac_map, dtype=np.float32)

    obs_ref, _ = ref.reset(seed=seed)
    epoch = BuildingEnv.epoch_from_seed(params, seed)
    assert epoch == ref.epoch
    state, ts = env.reset_at_epoch(params, epoch)
    np.testing.assert_allclose(np.asarray(ts.obs), obs_ref, rtol=0, atol=0)

    step = jax.jit(env.step)
    key = jax.random.PRNGKey(0)
    for t in range(50):
        obs_ref, r_ref, term_ref, trunc_ref, _ = ref.step(actions[t])
        state, ts = step(params, state, actions[t], key)
        # Parity is ulp-level, not bit-level: OpenBLAS dgemv uses SIMD
        # accumulation trees whose last-bit rounding XLA cannot (and should
        # not) replicate — the reference itself is not bit-stable across
        # BLAS builds. A float64 last-bit difference in X_new flips the
        # float32 state cast by <=1 ulp, which re-enters the next step's
        # dynamics. Everything else (promotion rules, reduction orders,
        # occupancy polynomial, reward assembly) is matched exactly.
        np.testing.assert_allclose(
            np.asarray(ts.obs), obs_ref, rtol=3e-7, atol=2e-8,
            err_msg=f"obs mismatch at t={t}")
        np.testing.assert_allclose(
            float(ts.reward), r_ref, rtol=1e-6, atol=5e-6,
            err_msg=f"reward mismatch at t={t}")
        assert bool(ts.terminated) == term_ref


def test_full_episode_return_parity(env_and_params64, reference_env):
    env, params = env_and_params64
    ref = reference_env
    seed = 42
    rng = np.random.default_rng(seed)
    actions = rng.uniform(-1, 1, size=(params.episode_len, params.n)).astype(np.float32)

    ref.reset(seed=seed)
    ret_ref = 0.0
    done = False
    t = 0
    while not done:
        _, r, term, trunc, _ = ref.step(actions[t])
        ret_ref += r
        done = term or trunc
        t += 1
    assert t == params.episode_len

    state, _ = env.reset_at_epoch(params, BuildingEnv.epoch_from_seed(params, seed))

    def body(carry, a):
        state, _ = carry
        state, ts = env.step(params, state, a, jax.random.PRNGKey(0))
        return (state, ts.reward), (ts.reward, ts.terminated)

    (_, _), (rewards, terms) = jax.lax.scan(
        body, (state, jnp.zeros((), jnp.float64)), jnp.asarray(actions))
    assert bool(terms[-1]) and not bool(terms[-2])
    np.testing.assert_allclose(float(jnp.sum(rewards)), ret_ref, rtol=1e-6)


def test_vmap_batch_consistency(param_dict):
    """batch of 1 == unbatched (SURVEY.md §4 'vmap-consistency')."""
    env = BuildingEnv()
    params = make_params(param_dict, dtype=jnp.float32)
    key = jax.random.PRNGKey(3)
    state, ts = env.reset(params, key)
    vstate, vts = jax.vmap(env.reset, in_axes=(None, 0))(params, key[None])
    np.testing.assert_allclose(np.asarray(vts.obs[0]), np.asarray(ts.obs))

    action = env.action_space(params).sample(jax.random.PRNGKey(4))
    s1, t1 = env.step(params, state, action, key)
    s2, t2 = jax.vmap(env.step, in_axes=(None, 0, 0, 0))(
        params, vstate, action[None], key[None])
    np.testing.assert_allclose(float(t2.reward[0]), float(t1.reward), rtol=1e-6)


def test_batch_rollout_shapes_and_autoreset(param_dict):
    env = BuildingEnv()
    params = make_params(param_dict, dtype=jnp.float32)
    batch, steps = 8, 12
    traj = batch_rollout(env, params, random_policy(env, params, batch), None,
                         jax.random.PRNGKey(0), batch, steps)
    assert traj.reward.shape == (steps, batch)
    assert traj.obs.shape == (steps, batch, params.n + 4)
    assert np.all(np.isfinite(np.asarray(traj.obs)))


def test_batch_unroll_matches_generic(param_dict):
    """The lockstep fast path (per-episode exog prefetch, zero per-step
    gathers) must be bit-identical to the generic vmap+autoreset path —
    same PRNG stream, same trajectories, across episode boundaries."""
    env = BuildingEnv()
    p = dict(param_dict)
    p["episode_len"] = 10
    params = make_params(p, dtype=jnp.float32)
    batch = 8
    for steps in (7, 25):  # partial episode; across 2 boundaries
        pol = random_policy(env, params, batch)
        key = jax.random.PRNGKey(3)
        fast = batch_rollout(env, params, pol, None, key, batch, steps)
        slow = batch_rollout(env, params, pol, None, key, batch, steps,
                             fast=False)
        for name in ("reward", "terminated", "truncated"):
            np.testing.assert_array_equal(
                np.asarray(getattr(fast, name)),
                np.asarray(getattr(slow, name)), err_msg=name)
        # autoreset-boundary obs recompute occupower in a different XLA
        # fusion context -> up to 1 ulp of float32 drift
        np.testing.assert_allclose(
            np.asarray(fast.obs), np.asarray(slow.obs),
            rtol=3e-7, atol=1e-7, err_msg="obs")
        for k in fast.info:
            np.testing.assert_array_equal(
                np.asarray(fast.info[k]), np.asarray(slow.info[k]),
                err_msg=k)


def test_discrete_action_mode(param_dict):
    env = BuildingEnv()
    p = dict(param_dict)
    p["is_continuous_action"] = False
    params = make_params(p, dtype=jnp.float32)
    space = env.action_space(params)
    a = space.sample(jax.random.PRNGKey(0))
    state, _ = env.reset(params, jax.random.PRNGKey(1))
    state, ts = env.step(params, state, a, jax.random.PRNGKey(2))
    assert np.isfinite(float(ts.reward))


def test_stochastic_ambients(param_dict):
    p = generate_building_params(
        "OfficeSmall", "Hot_Dry", "Tucson",
        stochastic_summer_percentage=0.7, stochastic_seed=0)
    assert p["out_temp"].shape == param_dict["out_temp"].shape
    # resampled series differ from the deterministic weather but stay in a
    # physically plausible range
    assert not np.allclose(p["out_temp"][:100], param_dict["out_temp"][:100])
    assert -30 < np.mean(p["out_temp"]) < 50


def test_data_driven_identification(param_dict):
    from sustaingym_tpu.envs.building import fit_data_driven
    env = BuildingEnv()
    params = make_params(param_dict, dtype=jnp.float64)
    # roll a trajectory under the physics model
    state, ts = env.reset_at_epoch(params, 1000)
    states = [np.asarray(state.x)]
    actions = []
    rng = np.random.default_rng(0)
    for _ in range(400):
        a = rng.uniform(-1, 1, params.n).astype(np.float32)
        state, ts = env.step(params, state, a, jax.random.PRNGKey(0))
        states.append(np.asarray(state.x))
        actions.append(a * params.max_power)
    dd = fit_data_driven(params, np.asarray(states), np.asarray(actions),
                         start_epoch=1000)
    assert dd.data_driven and dd.BD_d.shape == (params.n, params.n + 7)
    # the identified model should predict the physics trajectory closely
    state_dd, _ = env.reset_at_epoch(dd, 1000)
    state_ph, _ = env.reset_at_epoch(params, 1000)
    errs = []
    for i in range(50):
        a = jnp.asarray(np.asarray(actions[i]) / params.max_power,
                        jnp.float64)
        state_dd, _ = env.step(dd, state_dd, a, jax.random.PRNGKey(0))
        state_ph, _ = env.step(params, state_ph, a, jax.random.PRNGKey(0))
        errs.append(np.abs(np.asarray(state_dd.x) - np.asarray(state_ph.x)).max())
    assert np.max(errs) < 1.5, np.max(errs)
