"""Profiles the smoke-test cells on the GPU: warm time, device idle share
and top device operations of each.

    python tools/profile_cells.py [--out runs/profile/summary.json]

Cells: EV PPO (2048 x 288, projection on) and multi-agent EV PPO (512 x
54 agents) through ``sustaingym_tpu.train`` with ``--profile`` (a trace of
three warm iterations), and one episode of each env tier of
``chip_smoke.ENV_TIER`` under ``jax.profiler.trace``. Traces stay under
``runs/profile/``; the reduction (``sustaingym_tpu.utils.trace``) prints
one JSON line per cell and writes them all to ``--out``. Like
``chip_smoke.py``, it exits 2 without a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
PROFILE_DIR = os.path.join(ROOT, "runs", "profile")


def profile_ppo(name: str, env: str, env_kwargs: dict, num_envs: int,
                rollout_len: int = 288) -> dict:
    from sustaingym_tpu import train
    from sustaingym_tpu.utils.trace import device_summary

    log_dir = os.path.join(PROFILE_DIR, name)
    shutil.rmtree(log_dir, ignore_errors=True)
    rows = train.main([
        "--env", env, "--env-kwargs", json.dumps(env_kwargs),
        "--num-envs", str(num_envs), "--rollout-len", str(rollout_len),
        "--hidden", "256", "--obs-bf16", "--iterations", "5",
        "--log-dir", log_dir, "--save-every", str(10 ** 6), "--profile"])
    warm = sorted(r["seconds"] for r in rows[1:])
    return {"cell": name, "num_envs": num_envs, "rollout_len": rollout_len,
            "warm_seconds_per_iter": warm[len(warm) // 2],
            "traced_iterations": 3,
            **device_summary(os.path.join(log_dir, "profile"))}


def profile_env(env_name: str, kwargs: dict, batch: int, steps: int) -> dict:
    import jax

    from chip_smoke import _episode_fn
    from sustaingym_tpu import make
    from sustaingym_tpu.utils.trace import device_summary

    env, params = make(env_name, **kwargs)
    run = _episode_fn(env, batch, steps)
    key = jax.random.PRNGKey(0)
    jax.block_until_ready(run(params, key))
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(run(params, jax.random.PRNGKey(i + 1)))
        times.append(time.perf_counter() - t0)
    trace_dir = os.path.join(PROFILE_DIR, env_name)
    shutil.rmtree(trace_dir, ignore_errors=True)
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(run(params, jax.random.PRNGKey(9)))
    warm = sorted(times)[1]
    return {"cell": f"env_{env_name}", "batch": batch, "steps": steps,
            "warm_seconds": warm, "env_steps_per_s": batch * steps / warm,
            **device_summary(trace_dir)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=os.path.join(PROFILE_DIR,
                                                      "summary.json"))
    args = parser.parse_args(argv)

    from chip_smoke import ENV_TIER, MA_EV, card_line, gpu_devices

    devices = gpu_devices()
    if devices is None:
        return 2
    dev = devices[0]
    card = card_line()
    results = []

    def emit(row):
        row.update(device=dev.device_kind, card=card)
        print(json.dumps(row), flush=True)
        results.append(row)

    emit(profile_ppo("ppo_ev", "evcharging",
                     {"site": "caltech", "date_period": "Summer 2021",
                      "project_action": True}, 2048))
    emit(profile_ppo("ppo_ma_ev", "evcharging-multiagent", MA_EV, 512))
    for env_name, kwargs, batch, steps, _ in ENV_TIER:
        emit(profile_env(env_name, kwargs, batch, steps))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
