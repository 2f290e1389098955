"""Train CLI end-to-end tests: CSV logging, npz checkpointing, resume.

Covers the checkpoint/resume contract of SURVEY.md §5 through the real
command-line surface for every learner family (the reference delegates
this to RLLib's algo.save/from_checkpoint,
/root/reference/examples/cogen/train_rllib.py:139,166).
"""
from __future__ import annotations

import csv
import os

import numpy as np
import pytest

import jax

from sustaingym_tpu.train import main, restore_checkpoint, save_checkpoint


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("algo,extra", [
    ("ppo", ["--epochs", "1", "--minibatches", "2"]),
    ("sac", []),
    ("ddpg", []),
])
def test_train_cli_runs_and_resumes(tmp_path, algo, extra):
    log_dir = str(tmp_path / algo)
    base = ["--env", "building", "--algo", algo, "--num-envs", "8",
            "--rollout-len", "4", "--hidden", "16", "--log-dir", log_dir,
            "--save-every", "2"]
    main(base + ["--iterations", "3"] + extra)

    rows = _read_csv(os.path.join(log_dir, "train_results.csv"))
    assert len(rows) == 3
    assert all(np.isfinite(float(r["mean_reward"])) for r in rows)
    ckpt_dir = os.path.join(log_dir, "checkpoints")
    steps = sorted(os.listdir(ckpt_dir))
    assert "step_3" in steps  # final checkpoint always written

    # resume from the final checkpoint: two more iterations append rows
    # numbered from the restored step
    main(base + ["--iterations", "2", "--restore", ckpt_dir] + extra)
    rows = _read_csv(os.path.join(log_dir, "train_results.csv"))
    assert len(rows) == 5
    assert int(rows[-1]["iteration"]) == 4


def test_train_cli_dqn_discrete_market(tmp_path):
    log_dir = str(tmp_path / "dqn")
    main(["--env", "electricitymarket",
          "--env-kwargs",
          '{"discrete": true, "horizon": 2, "lp_iters": 20,'
          ' "lp_warm_iters": 10}',
          "--algo", "dqn", "--num-envs", "4", "--rollout-len", "4",
          "--hidden", "16", "--reward-scale", "0.01",
          "--log-dir", log_dir, "--iterations", "2"])
    rows = _read_csv(os.path.join(log_dir, "train_results.csv"))
    assert len(rows) == 2


def test_checkpoint_roundtrip_exact(tmp_path):
    """save_checkpoint/restore_checkpoint round-trips every leaf exactly
    (including optax namedtuple state nodes via the leaf-list encoding)."""
    from sustaingym_tpu import make
    from sustaingym_tpu.parallel import SACConfig, make_sac_train_step

    env, params = make("evcharging", project_action=False)
    cfg = SACConfig(num_envs=4, rollout_len=2, capacity=8, batch_per_env=2,
                    updates=1, hidden=8)
    init_state, train_step = make_sac_train_step(env, params, cfg)
    carry = init_state(jax.random.PRNGKey(0))
    carry, _ = jax.jit(train_step)(carry, jax.random.PRNGKey(1))

    path = str(tmp_path / "ck")
    save_checkpoint(path, carry, 7)
    restored, step = restore_checkpoint(path, init_state(jax.random.PRNGKey(0)))
    assert step == 7
    for a, b in zip(jax.tree.leaves(carry), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("algo", ["ppo", "sac", "ddpg"])
def test_eval_callback_writes_breakdown_and_best_model(tmp_path, algo):
    """--eval-every runs deterministic-policy evaluations (the SB3
    EvalCallbackWithBreakdown analogue): eval_results.csv carries the mean
    return plus reward-breakdown columns, and the best policy is saved to
    <log-dir>/best_model."""
    log_dir = str(tmp_path / f"eval_{algo}")
    main(["--env", "building", "--algo", algo,
          "--num-envs", "4", "--rollout-len", "4", "--hidden", "16",
          "--minibatches", "2",
          "--eval-every", "2", "--eval-episodes", "2",
          "--log-dir", log_dir, "--iterations", "2",
          "--save-every", "100"])
    rows = _read_csv(os.path.join(log_dir, "eval_results.csv"))
    assert len(rows) == 1
    assert "mean_return" in rows[0]
    # building's reward breakdown (comfort/power) flows through info
    assert "comfort_level" in rows[0] and "power_consumption" in rows[0]
    assert np.isfinite(float(rows[0]["mean_return"]))
    assert os.path.isdir(os.path.join(log_dir, "best_model"))


def test_checkpoint_roundtrip_bf16_leaves(tmp_path):
    """bfloat16 carry leaves (PPO obs with --obs-bf16) survive the npz
    round trip bit for bit."""
    from sustaingym_tpu import make
    from sustaingym_tpu.parallel import PPOConfig, make_train_step

    env, params = make("evcharging", project_action=False)
    cfg = PPOConfig(num_envs=4, rollout_len=4, hidden=8, epochs=1,
                    minibatches=2, obs_bf16=True)
    init_state, train_step = make_train_step(env, params, cfg)
    carry, _ = jax.jit(train_step)(init_state(jax.random.PRNGKey(0)),
                                   jax.random.PRNGKey(1))
    assert carry["obs"].dtype == jax.numpy.bfloat16
    save_checkpoint(str(tmp_path), carry, 3)
    restored, step = restore_checkpoint(str(tmp_path),
                                        init_state(jax.random.PRNGKey(0)))
    assert step == 3
    for a, b in zip(jax.tree.leaves(carry), jax.tree.leaves(restored)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
