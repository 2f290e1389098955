"""Benchmark CLI: env-steps/s per device for the batched engine.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

``vs_baseline`` compares against the reference (pure-Python gym) engine
stepping a single env instance on one CPU core of this machine, measured by
``python bench.py --measure-reference``. The reference publishes no perf
numbers (BASELINE.md), so these measured numbers are the baseline of record.
"""
from __future__ import annotations

import argparse
import json
import time

# Reference single-CPU single-env steps/s measured on this machine
# (see --measure-reference; reference BuildingEnv is one 6x6 numpy matmul
# per step, /root/reference/sustaingym/envs/building/env.py:266).
REF_BASELINE_STEPS_PER_S = {
    "building": 15182.0,
    "cogen": None,        # reference cannot run here (onnxruntime + model.onnx absent)
    # reference cannot run here (acnportal + cvxpy absent); its wall-time
    # notebook axis annotations imply ~1e2 steps/s with projection on 1 CPU
    # (examples/evcharging/wall_time_ev_charging.ipynb, BASELINE.md)
    "evcharging": 100.0,
}


def _time_best(run, repeats: int, profile_dir: str | None = None) -> float:
    """Best-of-N wall time of ``run(PRNGKey(i))``; optionally wraps the final
    (warm) repeat in a ``jax.profiler`` trace (SURVEY.md §5 "tracing") —
    inspect with tensorboard/xprof pointed at the directory."""
    import jax

    run(jax.random.PRNGKey(0)).block_until_ready()  # compile
    times = []
    for i in range(repeats):
        tracing = profile_dir is not None and i == repeats - 1
        if tracing:
            jax.profiler.start_trace(profile_dir)
        t0 = time.perf_counter()
        run(jax.random.PRNGKey(i)).block_until_ready()
        times.append(time.perf_counter() - t0)
        if tracing:
            jax.profiler.stop_trace()
    return min(times)


def bench_building(batch: int, steps: int, repeats: int = 3,
                   profile_dir: str | None = None) -> dict:
    import jax

    from sustaingym_tpu import make
    from sustaingym_tpu.core import batch_rollout, random_policy

    env, params = make("building")

    policy = random_policy(env, params, batch)

    @jax.jit
    def run(key):
        traj = batch_rollout(env, params, policy, None, key, batch, steps)
        return traj.reward.sum()

    best = _time_best(run, repeats, profile_dir)
    return {
        "metric": "building_env_steps_per_s_per_chip",
        "value": round(batch * steps / best, 1),
        "unit": "env-steps/s",
        "batch": batch,
        "scan_steps": steps,
        "device": str(jax.devices()[0]),
    }


def bench_cogen(batch: int, steps: int, repeats: int = 3,
                profile_dir: str | None = None) -> dict:
    import jax

    from sustaingym_tpu import make
    from sustaingym_tpu.core import batch_rollout, random_policy

    env, params = make("cogen")
    policy = random_policy(env, params, batch)

    @jax.jit
    def run(key):
        traj = batch_rollout(env, params, policy, None, key, batch, steps)
        return traj.reward.sum()

    best = _time_best(run, repeats, profile_dir)
    return {
        "metric": "cogen_env_steps_per_s_per_chip",
        "value": round(batch * steps / best, 1),
        "unit": "env-steps/s",
        "batch": batch,
        "scan_steps": steps,
        "device": str(jax.devices()[0]),
    }


def bench_generic(env_name: str, batch: int, steps: int, repeats: int = 3,
                  profile_dir: str | None = None, **make_kwargs) -> dict:
    import jax

    from sustaingym_tpu import make
    from sustaingym_tpu.core import batch_rollout, random_policy

    env, params = make(env_name, **make_kwargs)
    policy = random_policy(env, params, batch)

    @jax.jit
    def run(key):
        traj = batch_rollout(env, params, policy, None, key, batch, steps)
        return traj.reward.sum()

    best = _time_best(run, repeats, profile_dir)
    return {
        "metric": f"{env_name}_env_steps_per_s_per_chip",
        "value": round(batch * steps / best, 1),
        "unit": "env-steps/s",
        "batch": batch,
        "scan_steps": steps,
        "device": str(jax.devices()[0]),
    }


def bench_train(env_name: str = "evcharging", num_envs: int = 4096,
                rollout_len: int = 64, iters: int = 5,
                algo: str = "ppo", metric_name: str | None = None,
                minibatches: int | None = None, obs_bf16: bool = False,
                capacity: int | None = None,
                **make_kwargs) -> dict:
    """Fused train-step throughput (rollout + update as ONE program) — the
    learner-side counterpart of the env rollouts. ``algo``: 'ppo' (rollout
    + GAE + block-shuffled minibatch epochs), 'sac' (off-policy on-device
    replay ring + twin-critic gradient steps), 'dqn' (double-DQN) or
    'ddpg' (TD3-style). For agent-axis
    multi-agent envs the value is AGENT-steps/s (env-steps x n_agents),
    matching the RLLib multi-agent accounting the line replaces
    (reference examples/evcharging/train_rllib.py:157-160)."""
    import jax

    from sustaingym_tpu import make
    from sustaingym_tpu.parallel import (DDPGConfig, DQNConfig, PPOConfig,
                                         SACConfig, make_ddpg_train_step,
                                         make_dqn_train_step,
                                         make_sac_train_step,
                                         make_train_step)

    env, params = make(env_name, **make_kwargs)
    # off-policy ring capacity (slots per env): wide-obs agent-axis envs
    # (MA-EV DQN stores (cap, B, 54, 146) obs + next_obs) need a smaller
    # ring to fit HBM
    cap = {} if capacity is None else {"capacity": capacity}
    if algo == "sac":
        cfg = SACConfig(num_envs=num_envs, rollout_len=rollout_len, **cap)
        init_state, train_step = make_sac_train_step(env, params, cfg)
    elif algo == "dqn":
        cfg = DQNConfig(num_envs=num_envs, rollout_len=rollout_len, **cap)
        init_state, train_step = make_dqn_train_step(env, params, cfg)
    elif algo == "ddpg":
        cfg = DDPGConfig(num_envs=num_envs, rollout_len=rollout_len, **cap)
        init_state, train_step = make_ddpg_train_step(env, params, cfg)
    else:
        kw = {} if minibatches is None else {"minibatches": minibatches}
        cfg = PPOConfig(num_envs=num_envs, rollout_len=rollout_len,
                        obs_bf16=obs_bf16, **kw)
        init_state, train_step = make_train_step(env, params, cfg)
    carry = init_state(jax.random.PRNGKey(0))
    step = jax.jit(train_step, donate_argnums=0)
    carry, m = step(carry, jax.random.PRNGKey(1))
    jax.block_until_ready(m)
    t0 = time.perf_counter()
    for i in range(iters):
        carry, m = step(carry, jax.random.PRNGKey(2 + i))
    jax.block_until_ready(m)
    dt = (time.perf_counter() - t0) / iters
    # agent-axis views: action/obs spaces lead with the agent axis;
    # per-agent-policy envs (cogen-MA) expose the BASE flat action space,
    # so count agents from the padded per-agent layout instead
    if getattr(env, "per_agent_policy", False):
        n_agents = int(env.padded_action_space(params).shape[0])
    elif getattr(env, "agent_axis", False):
        n_agents = int(env.action_space(params).shape[0])
    else:
        n_agents = 1
    unit = "agent-steps/s" if n_agents > 1 else "env-steps/s"
    result = {
        "metric": (metric_name
                   or f"{algo}_{env_name}_train_env_steps_per_s_per_chip"),
        "value": round(num_envs * rollout_len * max(n_agents, 1) / dt, 1),
        "unit": unit,
        "batch": num_envs,
        "rollout_len": rollout_len,
        "device": str(jax.devices()[0]),
        "vs_baseline": None,
    }
    if n_agents > 1:
        result["n_agents"] = n_agents
    if algo == "ppo":
        result["episodic_rollout"] = bool(getattr(train_step, "episodic",
                                                  False))
        if getattr(train_step, "uma", False):
            result["uniform_obs_ma_fast_path"] = True
        if obs_bf16:
            result["obs_bf16"] = True
        if minibatches is not None:
            result["minibatches"] = minibatches
    return result


def measure_reference() -> None:
    """Measures the reference engine on this machine (requires the reference
    tree at /root/reference and the pvlib shim)."""
    import contextlib
    import io
    import sys

    sys.path.insert(0, "tests/_shims")
    sys.path.insert(0, "/root/reference")
    import numpy as np
    from sustaingym.envs.building import BuildingEnv as Ref
    from sustaingym.envs.building import ParameterGenerator as RefPG

    with contextlib.redirect_stdout(io.StringIO()):
        ref = Ref(RefPG(building="OfficeSmall", weather="Hot_Dry",
                        location="Tucson"))
    rng = np.random.default_rng(0)
    ref.reset(seed=0)
    a = rng.uniform(-1, 1, size=(ref.n,)).astype(np.float32)
    for _ in range(100):
        ref.step(a)
    n = 5000
    t0 = time.perf_counter()
    for i in range(n):
        _, _, done, _, _ = ref.step(a)
        if done:
            ref.reset(seed=i)
    dt = time.perf_counter() - t0
    print(json.dumps({"reference_building_steps_per_s": round(n / dt, 1)}))


def _bench_one(env_name: str, batch: int, steps: int | None,
               profile_dir: str | None = None, repeats: int = 3,
               project_action: bool = True) -> dict:
    steps = steps or {"cogen": 96, "datacenter": 672}.get(env_name, 288)
    if env_name == "building":
        result = bench_building(min(batch, 65536), steps, repeats=repeats,
                                profile_dir=profile_dir)
    elif env_name == "cogen":
        result = bench_cogen(min(batch, 65536), min(steps, 96),
                             repeats=repeats, profile_dir=profile_dir)
    elif env_name == "evcharging":
        result = bench_generic("evcharging", min(batch, 16384),
                               min(steps, 288), repeats=repeats,
                               profile_dir=profile_dir,
                               project_action=project_action)
        result["project_action"] = project_action
    elif env_name == "electricitymarket":
        result = bench_generic("electricitymarket", min(batch, 8192),
                               min(steps, 288), repeats=repeats,
                               profile_dir=profile_dir)
    elif env_name == "datacenter":
        result = bench_generic("datacenter", min(batch, 16384),
                               min(steps, 672), repeats=repeats,
                               profile_dir=profile_dir)
    else:
        raise SystemExit(f"unknown bench env {env_name}")

    baseline = REF_BASELINE_STEPS_PER_S.get(env_name)
    if env_name == "evcharging" and not project_action:
        # the measured reference baseline (~1e2 steps/s) is WITH the MOSEK
        # projection; an unprojected ratio would overstate the speedup
        baseline = None
    result["vs_baseline"] = (
        round(result["value"] / baseline, 1) if baseline else None)
    return result


# default per-env batch when benching the whole suite (--env all). The
# values are kept from an earlier sweep and are not yet re-swept on the
# H100 (ROADMAP item 1.6); _bench_one caps each env's batch. building is
# left out until its data is committed (make("building") needs the ASHRAE
# HTM and EPW files).
SUITE_BATCH = {
    "evcharging": 32768,
    "cogen": 262144,
    "datacenter": 262144,
    # BASELINE.json config 3 is "batch 4096"
    "electricitymarket": 4096,
}


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--env", default="all",
                        help="one env, or 'all' (default): one JSON line "
                             "per env so the driver records the whole suite")
    parser.add_argument("--batch", type=int, default=None,
                        help="env batch (default: per-env SUITE_BATCH)")
    parser.add_argument("--steps", type=int, default=None,
                        help="scan length (default: the env's episode "
                             "length: 288, cogen 96, datacenter 672)")
    parser.add_argument("--measure-reference", action="store_true")
    parser.add_argument("--algo", default="ppo",
                        choices=["ppo", "sac", "dqn", "ddpg"],
                        help="--env train only: which learner to bench "
                             "(the full suite emits all; dqn/ddpg bench "
                             "on the discrete/continuous market)")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="write a jax.profiler trace of the final timed "
                             "repeat to DIR")
    parser.add_argument("--project-action",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="evcharging only: --no-project-action benches "
                             "the unprojected env")
    args = parser.parse_args()

    if args.measure_reference:
        measure_reference()
        return

    if args.env == "train":
        if args.algo == "dqn":
            result = bench_train("electricitymarket", num_envs=4096,
                                 rollout_len=32, algo="dqn", discrete=True)
        elif args.algo == "ddpg":
            result = bench_train("electricitymarket", num_envs=4096,
                                 rollout_len=32, algo="ddpg")
        else:
            result = bench_train(algo=args.algo)
        print(json.dumps(result), flush=True)
        return

    envs = (list(SUITE_BATCH) if args.env == "all" else [args.env])
    for env_name in envs:
        batch = args.batch or SUITE_BATCH.get(env_name, 131072)
        result = _bench_one(env_name, batch, args.steps,
                            profile_dir=args.profile,
                            repeats=2 if args.env == "all" else 3,
                            project_action=args.project_action)
        print(json.dumps(result), flush=True)
    if args.env == "all":
        # learner-side lines: one fused train step program per config.
        # Minibatch counts are kept from an earlier sweep and are not yet
        # re-swept on the H100 (ROADMAP item 1.6).
        print(json.dumps(bench_train(
            "evcharging", num_envs=8192, rollout_len=288, minibatches=96,
            obs_bf16=True, algo="ppo", project_action=True)), flush=True)
        print(json.dumps(bench_train(
            "cogen", num_envs=8192, rollout_len=96, minibatches=24,
            algo="ppo")), flush=True)
        print(json.dumps(bench_train(
            "datacenter", num_envs=4096, rollout_len=672, minibatches=84,
            algo="ppo")), flush=True)
        # BASELINE.json configs[4]: multi-agent EV shared-policy PPO
        # (agent-steps/s; 512 envs x 54 station-agents). periods_delay=0
        # (the reference default) rides the uniform-obs fast path: every
        # agent's obs row is identical, so the trunk runs once per env —
        # gradient-exact (tests/test_ppo.py::test_uma_fast_path_matches_
        # generic_ma pins metric equality vs the generic agent-axis path)
        print(json.dumps(bench_train(
            "evcharging-multiagent", num_envs=512, rollout_len=288,
            minibatches=36, obs_bf16=True, algo="ppo",
            metric_name="ppo_ma_evcharging_train_agent_steps_per_s_per_chip",
            project_action=False, periods_delay=0)), flush=True)
        # the non-degenerate MA case (periods_delay=2: agents see distinct
        # stale-obs rows) exercises the full per-agent-obs episodic path
        print(json.dumps(bench_train(
            "evcharging-multiagent", num_envs=512, rollout_len=288,
            minibatches=36, obs_bf16=True, algo="ppo",
            metric_name=("ppo_ma_evcharging_delay2_train_agent_steps"
                         "_per_s_per_chip"),
            project_action=False, periods_delay=2)), flush=True)
        # heterogeneous per-agent stacked policies (cogen GT1/GT2/GT3/ST,
        # the reference's per-agent RLLib PolicySpec analogue)
        print(json.dumps(bench_train(
            "cogen-multiagent", num_envs=4096, rollout_len=96,
            minibatches=24, algo="ppo",
            metric_name="ppo_ma_cogen_train_agent_steps_per_s_per_chip"
            )), flush=True)
        # off-policy learners on the SCED market (the market doc's
        # algorithm set)
        print(json.dumps(bench_train(
            "electricitymarket", num_envs=4096, rollout_len=32,
            algo="dqn", discrete=True)), flush=True)
        print(json.dumps(bench_train(
            "electricitymarket", num_envs=4096, rollout_len=32,
            algo="ddpg")), flush=True)
        # SAC on the wide-obs unprojected EV env and on the market; DQN
        # on the discretized MA-EV view (54 agents x 5 bins; small ring)
        print(json.dumps(bench_train(
            "evcharging", num_envs=2048, rollout_len=64, algo="sac",
            project_action=False,
            metric_name="sac_evcharging_train_env_steps_per_s_per_chip"
            )), flush=True)
        print(json.dumps(bench_train(
            "electricitymarket", num_envs=4096, rollout_len=32,
            algo="sac",
            metric_name="sac_electricitymarket_train_env_steps_per_s_per_chip"
            )), flush=True)
        print(json.dumps(bench_train(
            "evcharging-multiagent", num_envs=128, rollout_len=32,
            algo="dqn", capacity=64, discrete_bins=5, project_action=False,
            metric_name="dqn_ma_evcharging_train_agent_steps_per_s_per_chip"
            )), flush=True)

if __name__ == "__main__":
    main()
