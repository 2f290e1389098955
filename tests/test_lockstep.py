"""Lockstep episode unrolls (``batch_unroll``) against the generic
per-step autoreset scan on the same PRNG stream.

The EV cases cover both packaged sites with the projection off, and on
with the dual-FISTA gradient restart on and off, over a rollout that
crosses the 288-step episode boundary (autoreset splice). The market
cases compare the batched cold (episode step 0) and warm (step 1) SCED
solves with the generic path's per-env ``lp.solve_lp``.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest

from sustaingym_tpu.core import batch_rollout, random_policy
from sustaingym_tpu.envs import electricitymarket as em
from sustaingym_tpu.envs import evcharging
from sustaingym_tpu.envs.evcharging.env import (ACTION_SCALE_FACTOR,
                                                MAX_TIMESTEP)
from sustaingym_tpu.ops import qp


@pytest.mark.parametrize("site", ["caltech", "jpl"])
@pytest.mark.parametrize("proj", ["off", "restart", "no_restart"])
def test_ev_batch_unroll_matches_step_loop(site, proj):
    env, params = evcharging.make_env(site=site, date_period="Summer 2021",
                                      project_action=proj != "off")
    if proj == "no_restart":
        spec = evcharging.load_site(site)
        params = params.replace(proj=qp.make_dual_soc_projection(
            spec.constraint_matrix, spec.phase_angles, spec.magnitudes,
            action_scale=ACTION_SCALE_FACTOR, iters=25, step_scale=None,
            restart=False))
    batch, steps = 3, MAX_TIMESTEP + 3
    policy = random_policy(env, params, batch)
    key = jax.random.PRNGKey(5)
    slow = batch_rollout(env, params, policy, None, key, batch, steps,
                         fast=False)
    fast = env.batch_unroll(params, policy, None, key, batch, steps)
    np.testing.assert_array_equal(np.asarray(fast.terminated),
                                  np.asarray(slow.terminated))
    assert np.asarray(fast.terminated)[MAX_TIMESTEP - 1].all()
    np.testing.assert_allclose(np.asarray(fast.reward),
                               np.asarray(slow.reward), rtol=2e-5, atol=1e-6)
    for k in slow.info:
        np.testing.assert_allclose(np.asarray(fast.info[k]),
                                   np.asarray(slow.info[k]),
                                   rtol=2e-5, atol=1e-6, err_msg=k)
    for k in slow.obs:
        np.testing.assert_allclose(np.asarray(fast.obs[k]),
                                   np.asarray(slow.obs[k]),
                                   rtol=2e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("solve,t", [("cold", 0), ("warm", 1)])
def test_market_batched_solve_matches_solve_lp(solve, t):
    env, params = em.make_env(month="2021-05", horizon=4, lp_iters=30,
                              lp_warm_iters=10)
    batch = 128
    policy = random_policy(env, params, batch)
    key = jax.random.PRNGKey(3)
    slow = batch_rollout(env, params, policy, None, key, batch, 2,
                         fast=False)
    fast = env.batch_unroll(params, policy, None, key, batch, 2)
    for k in ("price", "dispatch_mwh", "energy_level"):
        np.testing.assert_allclose(np.asarray(fast.info[k][t]),
                                   np.asarray(slow.info[k][t]),
                                   rtol=2e-4, atol=2e-3, err_msg=k)
    np.testing.assert_allclose(np.asarray(fast.reward[t]),
                               np.asarray(slow.reward[t]),
                               rtol=2e-4, atol=2e-3)
