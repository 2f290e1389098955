"""chip_smoke.py's phase functions at tiny shapes on the CPU backend (the
script itself runs them at real widths on the GPU), including the
four-card sharded phase on 4 virtual CPU devices."""
from __future__ import annotations

import os
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

TINY = ("--epochs", "1", "--minibatches", "2")


@pytest.mark.parametrize("name,env,kwargs,num_envs,rollout_len", [
    ("t_ev_ppo", "evcharging", {"project_action": True}, 4, 8),
    ("t_ma_ev_ppo", "evcharging-multiagent", cs.MA_EV, 2, 288),
])
def test_phase_ppo(name, env, kwargs, num_envs, rollout_len):
    r = cs.phase_ppo(name, env, kwargs, num_envs=num_envs,
                     rollout_len=rollout_len, hidden=16, iterations=3,
                     extra=TINY, card="cpu")
    assert r["iterations"] == 3 and len(set(r["param_norm"])) == 3
    assert r["warm_seconds_per_iter"] is not None


def test_phase_env_tier_agrees_with_itself_on_cpu():
    cpu = jax.devices("cpu")[0]
    cells = (("evcharging", {"project_action": True}, 8, 288, 1e-5),
             ("cogen", {}, 8, 96, 1e-5),
             ("datacenter", {}, 8, 672, 1e-5),
             ("electricitymarket", {"lp_iters": 20, "lp_warm_iters": 5},
              8, 288, 1e-2))
    rows = cs.phase_env_tier(cells, small_batch=2, device=cpu, cpu=cpu)
    assert [r["env"] for r in rows] == [c[0] for c in cells]
    assert all(r["device_vs_cpu_max_rel_err"] == 0.0 for r in rows)


def test_phase_precision_cpu():
    out = cs.phase_precision(proj_batch=64, market_batch=64, n_scipy=8,
                             n_ref=32, device=jax.devices("cpu")[0],
                             time_it=False)
    assert len(out["projection"]) == 2 and out["market"]["ok"]
    assert out["market_warm"]["ok"]


@pytest.mark.parametrize("env_name", ["evcharging", "cogen", "datacenter"])
def test_env_tier_rtol_catches_tf32_rounding(env_name):
    """A full-float32 cell's return tolerance fails when the env's float
    inputs are rounded to TF32 (10 mantissa bits, the operand rounding of
    a TF32 product): the slip the old 1e-2 tolerance let pass."""
    import jax.numpy as jnp
    import numpy as np

    from sustaingym_tpu import make

    (_, kwargs, _, steps, rtol), = [c for c in cs.ENV_TIER
                                    if c[0] == env_name]

    def tf32(x):
        if getattr(x, "dtype", None) != jnp.float32:
            return x
        bits = jax.lax.bitcast_convert_type(x, jnp.uint32)
        return jax.lax.bitcast_convert_type(
            bits & jnp.uint32(0xFFFFE000), jnp.float32)

    env, params = make(env_name, **kwargs)
    run = cs._episode_fn(env, 8, steps)
    key = jax.random.PRNGKey(0)
    ref = np.asarray(run(params, key)[0], np.float64)
    got = np.asarray(run(jax.tree.map(tf32, params), key)[0], np.float64)
    rel = np.abs(got - ref).max() / np.abs(ref).mean()
    assert rtol < rel < 1e-2, rel


def test_phase_four_cards_on_virtual_devices():
    assert len(jax.devices()) >= 4     # conftest: 8 virtual CPU devices
    r = cs.phase_four_cards(n_devices=4, envs_per_card=4, iters=1,
                            hidden=16)
    assert r["max_abs_diff"] < cs.EQUIV_ATOL
    assert r["collectives"]["all-reduce"] > 0
    assert set(r["steps_per_s"]) == {(1, 4), (1, 16), (4, 16)}
    assert set(r["efficiency"]) == {"weak", "strong"}


def test_main_refuses_without_gpu(capsys):
    assert cs.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "needs a GPU" in out.err


def test_profiler_refuses_without_gpu(capsys):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "profile_cells", os.path.join(ROOT, "tools", "profile_cells.py"))
    profile_cells = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(profile_cells)
    assert profile_cells.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "needs a GPU" in out.err


def test_phase_failure_is_recorded(capsys):
    failures = []

    def boom():
        raise cs.PhaseError("boom")

    cs._run("boom", boom, failures)
    assert failures == ["boom"]
    assert "FAILED" in capsys.readouterr().out
