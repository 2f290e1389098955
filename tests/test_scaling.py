"""Scaling-bench structure tests (BASELINE.md scaling metric).

On this CI host the 8 "devices" are virtual CPU devices sharing 2 physical
cores, so wall-clock scaling efficiency is meaningless (measured here: PPO
aggregate throughput ratio ~0.4x, SAC ~1.8x — both artifacts of core
contention, not the sharded program). These tests therefore check STRUCTURE:
every (algo, scaling-mode, device-count) combination builds, shards, runs,
and reports sane bookkeeping, with only a loose throughput floor to catch
pathological sharding overhead. Real efficiency numbers need real chips
(bench/scaling.py prints the same caveat).
"""
from __future__ import annotations

import json

import numpy as np
import pytest

from sustaingym_tpu.bench.scaling import main as scaling_main, measure


@pytest.mark.parametrize("algo", ["ppo", "sac"])
def test_scaling_measure_runs_all_device_counts(algo):
    rollout = 16 if algo == "ppo" else 8
    r1 = measure(1, "building", 128, rollout, 2, algo=algo, hidden=64)
    r8 = measure(8, "building", 1024, rollout, 2, algo=algo, hidden=64)
    assert r1["devices"] == 1 and r8["devices"] == 8
    assert np.isfinite(r1["env_steps_per_s"]) and r1["env_steps_per_s"] > 0
    assert np.isfinite(r8["env_steps_per_s"]) and r8["env_steps_per_s"] > 0
    # loose regression floor: sharding 8 ways must not collapse aggregate
    # throughput (a >4x slowdown would mean the mesh program serializes or
    # re-gathers the batch; virtual-device core contention alone costs ~2x)
    assert r8["env_steps_per_s"] > 0.25 * r1["env_steps_per_s"], (r1, r8)


def test_scaling_cli_weak_and_strong(capsys):
    scaling_main(["--devices", "1", "2", "--num-envs", "64",
                  "--rollout-len", "8", "--iters", "2"])
    weak = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    rows = [r for r in weak if "env_steps_per_s" in r]
    effs = [r for r in weak if "scaling_efficiency" in r]
    assert [r["devices"] for r in rows] == [1, 2]
    assert all(r["scaling"] == "weak" for r in rows)
    assert len(effs) == 1 and np.isfinite(effs[0]["scaling_efficiency"])

    scaling_main(["--devices", "1", "2", "--num-envs", "64",
                  "--rollout-len", "8", "--iters", "2", "--strong",
                  "--algo", "sac"])
    strong = [json.loads(line) for line in
              capsys.readouterr().out.strip().splitlines()]
    rows = [r for r in strong if "env_steps_per_s" in r]
    assert all(r["scaling"] == "strong" and r["algo"] == "sac"
               for r in rows)


def test_dp1_vs_dp8_metric_equivalence():
    """The scaling artifact's correctness signal (round-4 verdict item 5):
    one PPO train step from identical carries at dp=1 and dp=8 must agree
    to float-reassociation noise. tests/test_debug_distributed.py pins the
    stronger bit-identical claim for same-sharding multi-process runs."""
    from sustaingym_tpu.bench.scaling import equivalence

    eq = equivalence(8, "building", 64, 8)
    assert eq["devices"] == 8
    assert np.isfinite(eq["dp1_vs_dpN_metrics_max_abs_diff"])
    # vf_loss is the largest-magnitude metric (~1e3); 1e-2 absolute covers
    # reassociation noise across all metrics with 1e5 margin over measured
    # (1.8e-7) while still failing loudly on any real layout bug
    assert eq["dp1_vs_dpN_metrics_max_abs_diff"] < 1e-2, eq


@pytest.mark.parametrize("env_name,kwargs", [
    ("evcharging", {"project_action": False}),
    ("evcharging-multiagent", {"periods_delay": 0}),
])
def test_episodic_step_splits_env_batch_over_dp(env_name, kwargs):
    """The episodic rollouts build their env batch inside the step, so only
    the mesh given to make_train_step splits it: the dp=4 program must
    hold per-device (T, B/4) trajectories and collectives."""
    import jax

    from sustaingym_tpu import make
    from sustaingym_tpu.bench.scaling import collective_counts
    from sustaingym_tpu.parallel import PPOConfig, make_mesh
    from sustaingym_tpu.parallel.mesh import data_sharding, replicated
    from sustaingym_tpu.parallel.ppo import _shard_carry, make_train_step

    env, params = make(env_name, **kwargs)
    T, B = 288, 16
    cfg = PPOConfig(num_envs=B, rollout_len=T, hidden=16, epochs=1,
                    minibatches=2)
    mesh = make_mesh(4)
    init_state, train_step = make_train_step(env, params, cfg, mesh=mesh)
    assert train_step.episodic
    carry = _shard_carry(init_state(jax.random.PRNGKey(0)), mesh,
                         data_sharding(mesh), replicated(mesh))
    hlo = jax.jit(train_step).lower(carry, jax.random.PRNGKey(1)) \
        .compile().as_text()
    assert f"[{T},{B // 4}," in hlo or f"[{T},{B // 4}]" in hlo
    assert collective_counts(hlo)["all-reduce"] > 0
