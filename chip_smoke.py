#!/usr/bin/env python3
"""On-card smoke test of SustainGym-TPU on one NVIDIA GPU.

    python3 chip_smoke.py                # one card: phases 1-5
    python3 chip_smoke.py --four-cards   # four cards: phases 1 and 6 only

Phases, all in this one process (each prints its own lines):

1. device — requires ``jax.devices()[0].platform == "gpu"`` and prints the
   device kind and the card's name and power limit (``nvidia-smi``, run as
   a child process that does not import JAX);
2. EV PPO — ``python -m sustaingym_tpu.train`` in-process on
   EVChargingEnv (Caltech, real MOER traces, dual-FISTA projection on) at
   2048 envs x 288 steps, hidden 256, bf16 obs storage;
3. multi-agent EV PPO — 512 envs x 54 station agents, periods_delay 0 (the
   reference default);
4. env tier — one full batched episode of each env whose data is in the
   repository, and the same program at a small batch on the CPU backend;
5. precision — the EV projection and the market clearing prices on the
   card against float64 / scipy references, held to the CPU tests'
   tolerances (``sustaingym_tpu.checks``); the market's TF32 solve is
   also held against its full-float32 solve;
6. four cards (``--four-cards``) — multi-agent EV PPO on a (dp=4, mp=1)
   mesh: one step from identical carries at dp=1 and dp=4 (with the
   carry's sharding and the dp=4 program's collectives), and warm
   steps/s at 1 and 4 cards.

A phase that fails prints its traceback and the script exits 1 after the
remaining phases; only a run in which every phase passed prints the last
line ``{"ok": true, "device": {...}}``. Without a GPU it exits 2 before
any phase.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(ROOT, "runs", "chip_smoke")

# phase 4 cells: (env, make kwargs, batch, episode steps, rtol). rtol is
# the GPU-vs-CPU tolerance on each episode return, relative to the batch's
# mean |return|. EV, cogen and datacenter ask for full float32 products,
# so only summation order and last-bit transcendentals differ: they read
# 9e-8 to 2e-7 on an H100 80GB HBM3, and 1e-5 leaves a 50x margin while a
# TF32 product anywhere in their step fails it. The market's PDHG solver
# runs TF32 on the GPU by default (LP_MATMUL; full float32 on the CPU):
# its 288 warm-started clearings drift the returns by 3.6e-3 of their
# scale on the same card, hence 1e-2.
ENV_TIER = (
    ("evcharging", {"project_action": True}, 2048, 288, 1e-5),
    ("cogen", {}, 1024, 96, 1e-5),
    ("datacenter", {}, 1024, 672, 1e-5),
    ("electricitymarket", {}, 4096, 288, 1e-2),
)


class PhaseError(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    """``name, power.limit`` of every card, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(ln.strip() for ln in out.stdout.splitlines()
                     if ln.strip())


def _finite(row: dict) -> bool:
    return all(math.isfinite(v) for v in row.values()
               if isinstance(v, float))


# ---------------------------------------------------------------------------
# phases 2 and 3: PPO through the training CLI
# ---------------------------------------------------------------------------

def phase_ppo(name: str, env: str, env_kwargs: dict, num_envs: int,
              rollout_len: int, hidden: int = 256, iterations: int = 3,
              extra: tuple[str, ...] = (), card: str = "") -> dict:
    """Runs ``iterations`` PPO iterations through
    ``sustaingym_tpu.train.main``; checks every logged metric is finite and
    the policy's parameter norm changes from one iteration to the next."""
    from sustaingym_tpu import train

    log_dir = os.path.join(RUN_DIR, name)
    shutil.rmtree(log_dir, ignore_errors=True)
    rows = train.main([
        "--env", env, "--env-kwargs", json.dumps(env_kwargs),
        "--num-envs", str(num_envs), "--rollout-len", str(rollout_len),
        "--hidden", str(hidden), "--obs-bf16",
        "--iterations", str(iterations), "--log-dir", log_dir,
        "--save-every", str(10 ** 6), *extra])
    check(len(rows) == iterations,
          f"{name}: {len(rows)} logged iterations, expected {iterations}")
    for row in rows:
        check(_finite(row), f"{name}: non-finite metric in {row}")
    norms = [row["param_norm"] for row in rows]
    check(all(a != b for a, b in zip(norms, norms[1:])),
          f"{name}: policy did not change between iterations: {norms}")
    warm = sorted(row["seconds"] for row in rows[1:])
    result = {"phase": name, "iterations": iterations,
              "mean_reward": [row["mean_reward"] for row in rows],
              "param_norm": norms,
              "warm_seconds_per_iter": (warm[len(warm) // 2]
                                        if warm else None),
              "card": card}
    print(json.dumps(result), flush=True)
    return result


# ---------------------------------------------------------------------------
# phase 4: env tier
# ---------------------------------------------------------------------------

def _episode_fn(env, batch: int, steps: int):
    import jax

    from sustaingym_tpu.core import batch_rollout, random_policy

    def run(params, key):
        policy = random_policy(env, params, batch)
        traj = batch_rollout(env, params, policy, None, key, batch, steps)
        return traj.reward.sum(axis=0), traj.terminated[-1]

    return jax.jit(run)


def phase_env_tier(cells=ENV_TIER, small_batch: int = 8, device=None,
                   cpu=None, card: str = "") -> list[dict]:
    """One full batched episode per cell on ``device`` (timed warm), then
    the same program at ``small_batch`` on ``device`` and on ``cpu``; the
    episode returns must agree within the cell's rtol of their scale."""
    import jax
    import numpy as np

    from sustaingym_tpu import make

    device = device or jax.devices()[0]
    cpu = cpu or jax.devices("cpu")[0]
    key = jax.random.PRNGKey(0)
    results = []
    for env_name, kwargs, batch, steps, rtol in cells:
        env, params = make(env_name, **kwargs)
        p_dev = jax.device_put(params, device)
        k_dev = jax.device_put(key, device)
        run = _episode_fn(env, batch, steps)
        t0 = time.perf_counter()
        ret, done = jax.block_until_ready(run(p_dev, k_dev))
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        ret, done = jax.block_until_ready(run(p_dev, k_dev))
        warm = time.perf_counter() - t0
        ret = np.asarray(ret)
        check(ret.shape == (batch,), f"{env_name}: returns {ret.shape}")
        check(bool(np.isfinite(ret).all()), f"{env_name}: non-finite return")
        check(bool(np.asarray(done).all()),
              f"{env_name}: episode did not end at step {steps}")

        small = _episode_fn(env, small_batch, steps)
        r_dev = np.asarray(small(p_dev, k_dev)[0], np.float64)
        r_cpu = np.asarray(small(jax.device_put(params, cpu),
                                 jax.device_put(key, cpu))[0], np.float64)
        scale = max(float(np.abs(r_cpu).mean()), 1e-6)
        rel = float(np.abs(r_dev - r_cpu).max() / scale)
        row = {"phase": "env_tier", "env": env_name, "batch": batch,
               "steps": steps, "first_call_seconds": first,
               "warm_seconds": warm,
               "env_steps_per_s": batch * steps / warm,
               "mean_return": float(ret.mean()),
               "small_batch": small_batch,
               "device_vs_cpu_max_rel_err": rel, "rtol": rtol,
               "card": card}
        print(json.dumps(row), flush=True)
        check(rel <= rtol,
              f"{env_name}: device vs CPU returns differ by {rel:.3g} of "
              f"their scale (> {rtol})")
        results.append(row)
    return results


# ---------------------------------------------------------------------------
# phase 5: precision
# ---------------------------------------------------------------------------

def phase_precision(proj_batch: int = 2048, market_batch: int = 4096,
                    n_scipy: int = 32, n_ref: int = 256, device=None,
                    time_it: bool = True, card: str = "") -> dict:
    """The EV projection and the market clearing prices must pass their
    accuracy checks on ``device``; the market's full-float32 solve is
    measured (with times) beside its TF32 default."""
    from sustaingym_tpu import checks
    from sustaingym_tpu.envs.electricitymarket.env import LP_MATMUL

    out = {"projection": [], "market": None, "market_warm": None}
    for site in ("caltech", "jpl"):
        r = checks.projection_check(
            site, batch=proj_batch, device=device, n_ref=n_ref,
            time_steps=288 if time_it else 0)
        r.update(phase="precision", check="ev_projection", card=card)
        print(json.dumps(r), flush=True)
        out["projection"].append(r)
    m = checks.market_price_check(
        batch=market_batch, device=device, matmuls=("f32", LP_MATMUL),
        n_scipy=n_scipy, time_iters=40 if time_it else 0)
    m.update(phase="precision", check="market_prices", default=LP_MATMUL,
             card=card)
    print(json.dumps(m), flush=True)
    out["market"] = m
    w = checks.market_warm_check(device=device)
    w.update(phase="precision", check="market_warm_prices", card=card)
    print(json.dumps(w), flush=True)
    out["market_warm"] = w
    for r in out["projection"]:
        check(r["ok"], f"EV projection out of tolerance: {r}")
    check(m["ok"], f"market prices out of tolerance: {m}")
    check(w["ok"], f"warm-started market prices out of tolerance: {w}")
    return out


# ---------------------------------------------------------------------------
# phase 6: four cards
# ---------------------------------------------------------------------------

MA_EV = {"periods_delay": 0}
EQUIV_ATOL = 1e-2   # tests/test_scaling.py::test_dp1_vs_dp8_metric_equivalence


def phase_four_cards(n_devices: int = 4, envs_per_card: int = 512,
                     rollout_len: int = 288, iters: int = 5,
                     hidden: int = 256, card: str = "") -> dict:
    """Multi-agent EV PPO on a (dp=n, mp=1) mesh: the dp=1 vs dp=n
    one-step metric difference from identical carries, and warm steps/s
    on 1 card at ``envs_per_card`` and at n x ``envs_per_card`` envs and
    on n cards at n x ``envs_per_card`` (weak and strong scaling)."""
    import jax

    from sustaingym_tpu.bench.scaling import equivalence, measure
    from sustaingym_tpu.envs.evcharging import caltech_site

    check(len(jax.devices()) >= n_devices,
          f"needs {n_devices} devices, found {len(jax.devices())}")
    ppo = {"obs_bf16": True}
    eq = equivalence(n_devices, "evcharging-multiagent", envs_per_card,
                     rollout_len, env_kwargs=MA_EV,
                     ppo_kwargs={**ppo, "hidden": hidden})
    diff = eq["dp1_vs_dpN_metrics_max_abs_diff"]
    print(json.dumps({"phase": "four_cards", "check": "dp1_vs_dpN",
                      "devices": n_devices, "max_abs_diff": diff,
                      "atol": EQUIV_ATOL,
                      "env_batch_spec": eq["env_batch_spec"],
                      "env_batch_devices": eq["env_batch_devices"],
                      "collectives_dpN": eq["collectives_dpN"],
                      "metrics_dp1": eq["metrics_dp1"],
                      "metrics_dpN": eq["metrics_dpN"], "card": card}),
          flush=True)
    check(math.isfinite(diff) and diff < EQUIV_ATOL,
          f"dp=1 vs dp={n_devices} metrics differ by {diff}")
    check(len(eq["env_batch_devices"]) == n_devices,
          f"env batch spans {eq['env_batch_devices']}")
    check(sum(eq["collectives_dpN"].values()) > 0,
          f"the dp={n_devices} step has no collective: every device ran "
          f"the whole batch")
    rates = {}
    n_agents = caltech_site().num_stations
    for n, envs in ((1, envs_per_card), (1, envs_per_card * n_devices),
                    (n_devices, envs_per_card * n_devices)):
        r = measure(n, "evcharging-multiagent", envs, rollout_len, iters,
                    hidden=hidden, env_kwargs=MA_EV, ppo_kwargs=ppo)
        rates[n, envs] = r["env_steps_per_s"]
        print(json.dumps({"phase": "four_cards", "devices": n,
                          "num_envs": envs,
                          "env_steps_per_s": r["env_steps_per_s"],
                          "agent_steps_per_s": r["env_steps_per_s"]
                          * n_agents, "card": card}), flush=True)
    total = envs_per_card * n_devices
    eff = {"weak": rates[n_devices, total]
           / (n_devices * rates[1, envs_per_card]),
           "strong": rates[n_devices, total] / (n_devices * rates[1, total])}
    print(json.dumps({"phase": "four_cards",
                      "weak_scaling_efficiency": eff["weak"],
                      "strong_scaling_efficiency": eff["strong"]}),
          flush=True)
    return {"max_abs_diff": diff, "collectives": eq["collectives_dpN"],
            "steps_per_s": rates, "efficiency": eff}


# ---------------------------------------------------------------------------

def gpu_devices():
    """JAX's devices when the first is a GPU; otherwise prints what was
    found to stderr and returns None. Keeps the CPU backend available
    beside the GPU when JAX_PLATFORMS names only the accelerator (phase 4
    compares with it in this process)."""
    import jax

    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        jax.config.update("jax_platforms", platforms + ",cpu")
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"{os.path.basename(sys.argv[0])}: needs a GPU; JAX found "
              f"{devices[0].platform} ({devices[0].device_kind})",
              file=sys.stderr)
        return None
    return devices


def _run(name: str, fn, failures: list[str]):
    t0 = time.perf_counter()
    print(f"== phase {name}", flush=True)
    try:
        fn()
    except Exception:   # recorded; the script still exits 1 at the end
        traceback.print_exc()
        failures.append(name)
        print(f"== phase {name} FAILED", flush=True)
    else:
        print(f"== phase {name} ok ({time.perf_counter() - t0:.1f} s)",
              flush=True)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-card sharded phase")
    args = parser.parse_args(argv)

    devices = gpu_devices()
    if devices is None:
        return 2
    print(f"device: {devices[0].platform} {devices[0].device_kind} "
          f"x{len(devices)}", flush=True)
    card = card_line()
    print(f"card: {card}", flush=True)

    failures: list[str] = []
    if args.four_cards:
        _run("four_cards", lambda: phase_four_cards(card=card), failures)
    else:
        _run("ev_ppo", lambda: phase_ppo(
            "ev_ppo", "evcharging",
            {"site": "caltech", "date_period": "Summer 2021",
             "project_action": True},
            num_envs=2048, rollout_len=288, card=card), failures)
        _run("ma_ev_ppo", lambda: phase_ppo(
            "ma_ev_ppo", "evcharging-multiagent", MA_EV,
            num_envs=512, rollout_len=288, card=card), failures)
        _run("env_tier", lambda: phase_env_tier(card=card), failures)
        _run("precision", lambda: phase_precision(card=card), failures)
    if failures:
        print(f"chip_smoke: failed phases: {failures}", file=sys.stderr)
        return 1
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
