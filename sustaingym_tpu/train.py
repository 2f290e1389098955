"""Training CLI — the batched replacement for the reference's RLLib/SB3
example scripts (/root/reference/examples/evcharging/train_rllib.py:43-84,
train_stable_baselines.py:156-187, train_rllib_template.py:28).

    python -m sustaingym_tpu.train --env evcharging --iterations 50 \
        --num-envs 2048 --rollout-len 288 --obs-bf16 --log-dir runs/ev

Writes per-iteration metrics to ``train_results.csv`` (mirroring the
reference's CSV logging, train_rllib.py:170-190), checkpoints the full
learner carry (params, optimizer state, env states, obs) as an ``.npz`` of
its leaves every ``--save-every`` iterations, and resumes from
``--restore``. ``main`` also returns the logged rows, so scripts can drive
the CLI in-process.
"""
from __future__ import annotations

import argparse
import csv
import os
import time

_CKPT_FILE = "carry.npz"


def save_checkpoint(path: str, carry, step: int) -> None:
    """Writes the full learner carry to ``<path>/step_<step>/carry.npz``.

    The carry is stored as its flattened leaf list ("leaf_{i}") so restore
    is structure-agnostic (optax states carry namedtuple/EmptyState nodes).
    Leaves of dtypes numpy cannot name (bfloat16) are stored as raw
    unsigned integers beside their dtype name ("dtype_{i}")."""
    import jax
    import numpy as np

    payload = {}
    for i, leaf in enumerate(jax.device_get(jax.tree.leaves(carry))):
        leaf = np.asarray(leaf)
        if leaf.dtype.kind == "V":
            payload[f"dtype_{i}"] = np.asarray(leaf.dtype.name)
            leaf = leaf.view(f"u{leaf.dtype.itemsize}")
        payload[f"leaf_{i}"] = leaf
    step_dir = os.path.join(os.path.abspath(path), f"step_{step}")
    os.makedirs(step_dir, exist_ok=True)
    tmp = os.path.join(step_dir, _CKPT_FILE + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, os.path.join(step_dir, _CKPT_FILE))


def restore_checkpoint(path: str, carry_like):
    """Restores the newest ``step_<n>`` checkpoint under ``path`` into the
    structure of ``carry_like``; returns (carry, n)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    path = os.path.abspath(path)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(path)
                   if d.startswith("step_"))
    leaves, treedef = jax.tree.flatten(carry_like)
    with np.load(os.path.join(path, f"step_{steps[-1]}", _CKPT_FILE)) as raw:
        new_leaves = []
        for i, like in enumerate(leaves):
            leaf = raw[f"leaf_{i}"]
            if f"dtype_{i}" in raw:
                leaf = leaf.view(jnp.dtype(str(raw[f"dtype_{i}"])))
            new_leaves.append(jnp.asarray(leaf, like.dtype))
    return jax.tree.unflatten(treedef, new_leaves), steps[-1]


def main(argv: list[str] | None = None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--env", default="evcharging",
                        help="building|cogen|evcharging|electricitymarket|datacenter"
                             " (plus the *-multiagent views)")
    parser.add_argument("--env-kwargs", default=None,
                        help="JSON dict forwarded to make(env, **kwargs) — "
                             "the RLLib env_config analogue (reference "
                             "train_rllib.py:157), e.g. "
                             "'{\"site\": \"jpl\", \"discrete_bins\": 5}'")
    parser.add_argument("--algo", default="ppo", choices=["ppo", "a2c", "sac", "dqn", "ddpg"],
                        help="ppo/a2c (on-policy, fused rollout+update), "
                             "sac (off-policy, on-device replay ring), or "
                             "dqn (double-DQN for discrete/discretized "
                             "envs) / ddpg (TD3-style deterministic PG), "
                             "all off-policy with the same replay-ring design")
    parser.add_argument("--iterations", type=int, default=50)
    parser.add_argument("--num-envs", type=int, default=1024)
    parser.add_argument("--rollout-len", type=int, default=64)
    parser.add_argument("--hidden", type=int, default=256)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--gamma", type=float, default=0.99)
    parser.add_argument("--epochs", type=int, default=4)
    parser.add_argument("--minibatches", type=int, default=8,
                        help="PPO minibatch count")
    parser.add_argument("--obs-bf16", action="store_true",
                        help="PPO: store observations in bfloat16 "
                             "end-to-end (exact epoch-0 ratios; halves "
                             "the obs bytes moved for wide-obs envs)")
    parser.add_argument("--reward-scale", type=float, default=None,
                        help="reward multiplier before GAE (default: 1e-4 "
                             "for the 1e4-penalty-scale cogen envs, else 1)")
    parser.add_argument("--eval-every", type=int, default=0,
                        help="evaluate the deterministic policy every N "
                             "iterations (0 = off) — the SB3 "
                             "EvalCallbackWithBreakdown analogue "
                             "(reference train_stable_baselines.py:67-153): "
                             "writes eval_results.csv with the mean return "
                             "and per-term reward breakdown, and saves the "
                             "best policy to <log-dir>/best_model")
    parser.add_argument("--eval-episodes", type=int, default=5,
                        help="episodes per evaluation (SB3 default 5)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log-dir", default="runs/default")
    parser.add_argument("--save-every", type=int, default=10)
    parser.add_argument("--restore", default=None,
                        help="checkpoint dir to resume from")
    parser.add_argument("--mesh", type=int, default=0,
                        help="shard over the first N devices (0 = single)")
    parser.add_argument("--mp", type=int, default=1,
                        help="tensor-parallel width within the mesh")
    parser.add_argument("--profile", action="store_true",
                        help="capture a jax.profiler trace of iterations "
                             "2-4 (post-compile) to <log-dir>/profile; view "
                             "with tensorboard or xprof")
    args = parser.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from sustaingym_tpu import make
    from sustaingym_tpu.parallel import (DDPGConfig, DQNConfig, PPOConfig,
                                         SACConfig, init_distributed,
                                         make_ddpg_train_step, make_mesh,
                                         make_dqn_train_step,
                                         make_sac_train_step, make_train_step)

    # joins the jax.distributed process group on multi-host runs (no-op on
    # single-process runs); must precede any backend use
    init_distributed()
    from sustaingym_tpu.parallel.ppo import _shard_carry
    from sustaingym_tpu.parallel.sac import shard_sac_carry
    from sustaingym_tpu.parallel.mesh import data_sharding, replicated

    import json as _json
    env_kwargs = _json.loads(args.env_kwargs) if args.env_kwargs else {}
    env, env_params = make(args.env, **env_kwargs)
    mesh = make_mesh(args.mesh, mp=args.mp) if args.mesh else None
    if args.algo == "sac":
        cfg = SACConfig(num_envs=args.num_envs,
                        rollout_len=args.rollout_len,
                        hidden=args.hidden, lr=args.lr, gamma=args.gamma)
        init_state, train_step = make_sac_train_step(env, env_params, cfg)
    elif args.algo == "dqn":
        reward_scale = args.reward_scale
        if reward_scale is None:
            reward_scale = 1e-4 if args.env.startswith("cogen") else 1.0
        cfg = DQNConfig(num_envs=args.num_envs,
                        rollout_len=args.rollout_len,
                        hidden=args.hidden, lr=args.lr, gamma=args.gamma,
                        reward_scale=reward_scale)
        init_state, train_step = make_dqn_train_step(env, env_params, cfg)
    elif args.algo == "ddpg":
        cfg = DDPGConfig(num_envs=args.num_envs,
                         rollout_len=args.rollout_len,
                         hidden=args.hidden, lr=args.lr, gamma=args.gamma)
        init_state, train_step = make_ddpg_train_step(env, env_params, cfg)
    else:
        reward_scale = args.reward_scale
        if reward_scale is None:
            reward_scale = 1e-4 if args.env.startswith("cogen") else 1.0
        cfg = PPOConfig(algo=args.algo, num_envs=args.num_envs,
                        rollout_len=args.rollout_len,
                        hidden=args.hidden, lr=args.lr, gamma=args.gamma,
                        epochs=args.epochs, minibatches=args.minibatches,
                        reward_scale=reward_scale, obs_bf16=args.obs_bf16)
        init_state, train_step = make_train_step(env, env_params, cfg,
                                                 mesh=mesh)
        if getattr(train_step, "episodic", False):
            print("episodic fast path: whole-episode rollouts via "
                  "batch_unroll (rollout_len == episode length)")

    key = jax.random.PRNGKey(args.seed)
    carry = init_state(key)
    start_iter = 0
    if args.restore:
        carry, start_iter = restore_checkpoint(args.restore, carry)
        print(f"restored checkpoint at iteration {start_iter}")

    if mesh is not None:
        if args.algo in ("sac", "dqn", "ddpg"):
            carry = shard_sac_carry(carry, mesh)
        else:
            carry = _shard_carry(carry, mesh, data_sharding(mesh),
                                 replicated(mesh))
        print(f"mesh: {dict(mesh.shape)}")

    step = jax.jit(train_step, donate_argnums=0)
    os.makedirs(args.log_dir, exist_ok=True)
    csv_path = os.path.join(args.log_dir, "train_results.csv")
    ckpt_dir = os.path.join(args.log_dir, "checkpoints")

    evaluate = None
    if args.eval_every:
        from sustaingym_tpu.core import batch_rollout

        # every suite env (and MA view) reports its real fixed episode
        # length — a silent fallback here once let market eval correctness
        # rest on a coincidental 288 (ADVICE r04)
        ep_len = env.episode_steps(env_params)
        if not ep_len:
            raise SystemExit(
                f"--eval-every needs a fixed episode length, but "
                f"{args.env} reports episode_steps="
                f"{ep_len!r}; implement episode_steps on the env")
        actor_fn = train_step.actor_fn
        n_eval = args.eval_episodes

        def eval_policy(actor_params, obs, key):
            del key  # deterministic
            return actor_fn(actor_params, obs)

        @jax.jit
        def evaluate(actor_params, key):
            traj = batch_rollout(env, env_params, eval_policy, actor_params,
                                 key, n_eval, ep_len)
            rew = traj.reward
            if rew.ndim == 3:        # agent-axis: sum per-agent rewards
                rew = rew.sum(-1)    # (reference algorithms/base.py:80-88)
            returns = rew.sum(0)
            breakdown = {
                k: v.mean() for k, v in traj.info.items()
                if hasattr(v, "dtype") and v.dtype.kind == "f"}
            return returns.mean(), breakdown

    steps_per_iter = cfg.num_envs * cfg.rollout_len
    # global L2 norm of the acting parameters, logged beside the metrics so
    # a run shows that its policy moves from one iteration to the next
    param_norm = jax.jit(lambda p: jnp.sqrt(sum(
        jnp.sum(jnp.square(x.astype(jnp.float32)))
        for x in jax.tree.leaves(p))))
    history: list[dict] = []

    with open(csv_path, "a", newline="") as f:
        writer = None

        def log(i, metrics, dt):
            nonlocal writer
            # ONE batched device_get per iteration, one step lagged, so the
            # host round trip overlaps the next step's device compute
            # instead of serializing with it
            metrics = {k: float(v) for k, v in jax.device_get(metrics).items()}
            metrics.update(iteration=i, seconds=round(dt, 3),
                           env_steps_per_s=round(steps_per_iter / dt, 1))
            history.append(metrics)
            if writer is None:
                writer = csv.DictWriter(f, fieldnames=list(metrics))
                if f.tell() == 0:
                    writer.writeheader()
            writer.writerow(metrics)
            f.flush()
            print(f"iter {i}: reward={metrics['mean_reward']:.4f} "
                  f"({metrics['env_steps_per_s']:.0f} steps/s)")

        eval_csv = os.path.join(args.log_dir, "eval_results.csv")
        best_return = float("-inf")
        if evaluate and os.path.exists(eval_csv):
            # resuming: recover the best-so-far from the existing log so a
            # restarted run cannot clobber best_model with a worse policy
            with open(eval_csv, newline="") as prev:
                for row in csv.DictReader(prev):
                    try:
                        best_return = max(best_return,
                                          float(row["mean_return"]))
                    except (KeyError, ValueError):
                        pass
        eval_writer = None
        eval_f = open(eval_csv, "a", newline="") if evaluate else None

        def run_eval(i, carry):
            nonlocal best_return, eval_writer
            mean_ret, breakdown = jax.device_get(evaluate(
                carry[train_step.actor_key],
                jax.random.fold_in(key, 500_000 + i)))
            row = {"iteration": i, "mean_return": float(mean_ret),
                   **{k: float(v) for k, v in breakdown.items()}}
            if eval_writer is None:
                # appending into a log dir whose existing CSV has a
                # DIFFERENT header (other env/algo, changed info keys)
                # would misalign every appended row under the old columns
                # (ADVICE r04) — validate instead of assuming
                if eval_f.tell() > 0:
                    with open(eval_csv, newline="") as prev:
                        old = next(csv.reader(prev), None)
                    if old is not None and old != list(row):
                        raise SystemExit(
                            f"{eval_csv} exists with columns {old} but this "
                            f"run produces {list(row)}; use a fresh "
                            f"--log-dir (or delete the stale CSV)")
                eval_writer = csv.DictWriter(eval_f, fieldnames=list(row))
                if eval_f.tell() == 0:
                    eval_writer.writeheader()
            eval_writer.writerow(row)
            eval_f.flush()
            marker = ""
            if row["mean_return"] > best_return:
                best_return = row["mean_return"]
                save_checkpoint(os.path.join(args.log_dir, "best_model"),
                                carry, i)
                marker = " (new best — saved)"
            print(f"eval @ iter {i}: return={row['mean_return']:.4f}"
                  f"{marker}")

        pending = None
        # trace iterations 2-4 (post-compile); the stop index is clamped into
        # the loop's actual range [start_iter, start_iter + iterations - 1]
        # so the trace always closes before process exit
        profile_span = (start_iter + 1,
                        min(start_iter + 3, start_iter + args.iterations - 1))
        profiling = args.profile and profile_span[0] <= profile_span[1]
        if args.profile and not profiling:
            print("profiler: skipped (needs --iterations >= 2)")
        t_prev = time.perf_counter()
        for i in range(start_iter, start_iter + args.iterations):
            if profiling and i == profile_span[0]:
                jax.profiler.start_trace(os.path.join(args.log_dir, "profile"))
            carry, metrics = step(carry, jax.random.fold_in(key, 1000 + i))
            metrics = {**metrics,
                       "param_norm": param_norm(carry[train_step.actor_key])}
            if profiling and i == profile_span[1]:
                jax.block_until_ready(metrics)
                jax.profiler.stop_trace()
                print(f"profiler trace in {args.log_dir}/profile")
            if pending is not None:
                t_now = time.perf_counter()
                log(pending[0], pending[1], t_now - t_prev)
                t_prev = t_now
            pending = (i, metrics)
            if ((i + 1) % args.save_every == 0
                    or (evaluate is not None
                        and (i + 1) % args.eval_every == 0)):
                # blocking host work (checkpoint save, synchronous eval)
                # must not be charged to the pending iteration's
                # env_steps_per_s — a
                # 30s eval would otherwise masquerade as a throughput
                # regression in train_results.csv
                t_block = time.perf_counter()
                if (i + 1) % args.save_every == 0:
                    save_checkpoint(ckpt_dir, carry, i + 1)
                    print(f"checkpoint saved at iteration {i + 1}")
                if evaluate is not None and (i + 1) % args.eval_every == 0:
                    run_eval(i + 1, carry)
                t_prev += time.perf_counter() - t_block
        if pending is not None:
            log(pending[0], pending[1], time.perf_counter() - t_prev)
        if eval_f is not None:
            eval_f.close()

    save_checkpoint(ckpt_dir, carry, start_iter + args.iterations)
    print(f"done; logs in {csv_path}")
    return history


if __name__ == "__main__":
    main()
