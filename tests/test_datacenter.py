"""DataCenterEnv tests (doc-spec env; no reference implementation exists)."""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sustaingym_tpu.envs import datacenter as dc
from sustaingym_tpu.core import batch_rollout, random_policy


@pytest.fixture(scope="module")
def env_and_params():
    return dc.make_env()


def test_pack_shapes(env_and_params):
    _, params = env_and_params
    assert params.n_months == 28  # 2019-05 .. 2021-08
    assert params.arrivals.shape == (28, 672)
    assert params.moer.shape == (28, 672 + 24)
    assert float(params.moer.min()) >= 0


def test_obs_is_27_dim(env_and_params):
    env, params = env_and_params
    state, ts = env.reset_at_month(params, 0)
    assert ts.obs.shape == (27,)


def test_full_vcc_runs_all_jobs(env_and_params):
    env, params = env_and_params
    state, _ = env.reset_at_month(params, 0)
    step = jax.jit(env.step)
    key = jax.random.PRNGKey(0)
    total_penalty = 0.0
    for _ in range(48):
        state, ts = step(params, state, jnp.ones(1), key)
        total_penalty += float(ts.info["delay_penalty"])
    # arrivals never exceed capacity on average; with VCC=1 the queue can
    # only hold burst residue and the daily delay penalty must be zero
    assert total_penalty == 0.0
    assert float(state.queue) < 1.0


def test_zero_vcc_accumulates_queue_and_penalty(env_and_params):
    env, params = env_and_params
    state, _ = env.reset_at_month(params, 0)
    step = jax.jit(env.step)
    key = jax.random.PRNGKey(0)
    carbon = 0.0
    penalty = 0.0
    for _ in range(24):
        state, ts = step(params, state, jnp.zeros(1), key)
        carbon += float(ts.info["carbon_cost"])
        penalty += float(ts.info["delay_penalty"])
    assert carbon == 0.0            # nothing executed -> no carbon
    assert penalty > 0.0            # day boundary fired the delay penalty
    assert float(state.queue) > 5.0


def test_carbon_shifting_incentive(env_and_params):
    """Running a unit of work at the greenest hour must cost less than at
    the dirtiest hour — the core premise of the env."""
    env, params = env_and_params
    m = np.asarray(params.moer)[0, :672]
    assert m.max() > m.min() * 1.2  # real MOER data varies


def test_episode_length(env_and_params):
    env, params = env_and_params
    state, ts = env.reset_at_month(params, 2)

    def body(carry, _):
        st, _ = carry
        st, ts = env.step(params, st, jnp.full((1,), 0.7), jax.random.PRNGKey(0))
        return (st, ts.terminated), ts.terminated

    (_, _), terms = jax.lax.scan(body, (state, ts.terminated), None,
                                 length=dc.EPISODE_LEN)
    assert bool(terms[-1]) and not bool(terms[-2])


def test_vmap_batch(env_and_params):
    env, params = env_and_params
    traj = batch_rollout(env, params, random_policy(env, params, 16), None,
                         jax.random.PRNGKey(0), 16, 24)
    assert traj.reward.shape == (24, 16)
    assert np.all(np.isfinite(np.asarray(traj.reward)))


def test_batch_unroll_matches_generic():
    """Lockstep fast path (month-table prefetch) vs generic vmap+autoreset:
    exact parity (the env is deterministic given the reset stream)."""
    env, params = dc.make_env()
    batch = 6
    for steps in (30, 680):  # partial; across an episode boundary
        pol = random_policy(env, params, batch)
        key = jax.random.PRNGKey(11)
        fast = batch_rollout(env, params, pol, None, key, batch, steps)
        slow = batch_rollout(env, params, pol, None, key, batch, steps,
                             fast=False)
        for name in ("reward", "terminated", "truncated"):
            np.testing.assert_allclose(
                np.asarray(getattr(fast, name)),
                np.asarray(getattr(slow, name)), rtol=1e-6, atol=1e-6,
                err_msg=name)
        np.testing.assert_allclose(
            np.asarray(fast.obs), np.asarray(slow.obs), rtol=1e-6,
            atol=1e-6, err_msg="obs")


def test_arrival_trace_calibration():
    """Pins the synthetic Google-cluster-like arrival trace's summary
    statistics (docs/datacenterenv.md trace description) so refactors
    cannot silently change episode difficulty: diurnal peak at 14:00,
    business-hours weekday/weekend split, daily peak/mean ratio, and mean
    utilization ~0.45 C (round-3 verdict item 8)."""
    from sustaingym_tpu.envs.datacenter.env import (EPISODE_LEN,
                                                    _synthesize_arrivals)

    arr = _synthesize_arrivals(28)
    hod = np.arange(EPISODE_LEN) % 24
    dow = (np.arange(EPISODE_LEN) // 24) % 7
    hod_mean = np.array([arr[:, hod == h].mean() for h in range(24)])
    # diurnal peak lands in the 14:00-15:00 business-afternoon bucket
    assert int(hod_mean.argmax()) in (14, 15), hod_mean.argmax()
    # weekday load ~36% above weekend (weekday factor 1.0 vs 0.72)
    wk_we = arr[:, dow < 5].mean() / arr[:, dow >= 5].mean()
    assert 1.25 < wk_we < 1.45, wk_we
    # daily peak/mean ratio of a diurnal trace with bursts
    daily = arr.reshape(28, -1, 24)
    pk = float((daily.max(-1) / daily.mean(-1)).mean())
    assert 1.35 < pk < 1.75, pk
    # mean utilization vs capacity C=1
    assert 0.40 < float(arr.mean()) < 0.52, arr.mean()
