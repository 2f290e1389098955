"""Multi-device scaling benchmark: the fused PPO train step over a mesh.

Measures the engine's distributed layer (SURVEY.md §2.2 / §5): env batch +
trajectories sharded over the mesh's ``dp`` axis, optional Megatron-style
tensor parallelism over ``mp``, gradients all-reduced by XLA collectives.
Reports env-steps/s at each device count and scaling efficiency vs one
device (the BASELINE.md scaling metric).

On a machine with one device, rehearse it on virtual CPU devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python -m sustaingym_tpu.bench.scaling --devices 1 2 4 8

On a multi-GPU host it uses the available cards (and, under
``jax.distributed``, spans hosts with the same code — the mesh just grows).
Env shards are embarrassingly parallel; the PPO update gathers the
trajectory (NCCL over NVLink) and runs replicated on every device.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import time


def _force_cpu_if_virtual() -> None:
    if "xla_force_host_platform_device_count" in os.environ.get("XLA_FLAGS", ""):
        import jax
        try:
            jax.config.update("jax_platforms", "cpu")
        except RuntimeError:
            pass


def measure(n_devices: int, env_name: str, num_envs: int, rollout_len: int,
            iters: int, mp: int = 1, algo: str = "ppo",
            hidden: int = 256, env_kwargs: dict | None = None,
            ppo_kwargs: dict | None = None) -> dict:
    """Times ``iters`` warm train steps on an ``n_devices`` mesh.
    ``env_kwargs`` go to ``make``; ``ppo_kwargs`` to ``PPOConfig``."""
    import jax

    from .. import make
    from ..parallel import (PPOConfig, SACConfig, make_mesh,
                            make_sac_train_step)
    from ..parallel.mesh import data_sharding, replicated
    from ..parallel.ppo import _shard_carry, make_train_step
    from ..parallel.sac import shard_sac_carry

    env, params = make(env_name, **(env_kwargs or {}))
    mesh = make_mesh(n_devices, mp=mp)
    if algo == "sac":
        cfg = SACConfig(num_envs=num_envs, rollout_len=rollout_len,
                        hidden=hidden)
        init_state, train_step = make_sac_train_step(env, params, cfg)
        carry = init_state(jax.random.PRNGKey(0))
        carry = shard_sac_carry(carry, mesh)
    else:
        cfg = PPOConfig(num_envs=num_envs, rollout_len=rollout_len,
                        hidden=hidden, **(ppo_kwargs or {}))
        init_state, train_step = make_train_step(env, params, cfg,
                                                 mesh=mesh)
        carry = init_state(jax.random.PRNGKey(0))
        ds, rep = data_sharding(mesh), replicated(mesh)
        carry = _shard_carry(carry, mesh, ds, rep)

    step = jax.jit(train_step, donate_argnums=0)
    # the compile call, then one more untimed step: the first step after
    # compilation is not steady state (on 4 H100s it took 0.87 s against
    # 0.14 s for the next ones)
    for i in range(2):
        carry, _ = step(carry, jax.random.PRNGKey(100 + i))
        jax.block_until_ready(carry)
    t0 = time.perf_counter()
    for i in range(iters):
        carry, metrics = step(carry, jax.random.PRNGKey(2 + i))
    jax.block_until_ready(carry)
    dt = time.perf_counter() - t0
    steps = num_envs * rollout_len * iters
    return {"devices": n_devices, "env_steps_per_s": round(steps / dt, 1),
            "seconds": round(dt, 3)}


def equivalence(n_devices: int, env_name: str, num_envs: int,
                rollout_len: int, mp: int = 1,
                env_kwargs: dict | None = None,
                ppo_kwargs: dict | None = None) -> dict:
    """Correctness signal for the scaling artifact (round-4 verdict): run
    ONE PPO train step from IDENTICAL initial carries at dp=1 and at
    dp=``n_devices`` (same total batch, same keys) and report the max abs
    diff over the returned metrics. Sharding only changes XLA's reduction
    tree, so the diff is float-reassociation noise (~1e-6 relative) — a
    layout/collective bug would show up as a large value here. Also
    reports the carry's env-batch sharding and the dp=N program's
    collectives (none means every device ran the whole batch).
    ``tests/test_debug_distributed.py`` pins the stronger bit-identical
    claim for same-sharding multi-process runs."""
    import jax

    from .. import make
    from ..parallel import PPOConfig, make_mesh
    from ..parallel.mesh import data_sharding, replicated
    from ..parallel.ppo import _shard_carry, make_train_step

    env, params = make(env_name, **(env_kwargs or {}))
    cfg = PPOConfig(num_envs=num_envs, rollout_len=rollout_len,
                    **(ppo_kwargs or {}))

    metrics = {}
    for n in (1, n_devices):
        mesh = make_mesh(n, mp=mp)
        init_state, train_step = make_train_step(env, params, cfg,
                                                 mesh=mesh)
        carry = init_state(jax.random.PRNGKey(0))
        carry = _shard_carry(carry, mesh, data_sharding(mesh),
                             replicated(mesh))
        key = jax.random.PRNGKey(1)
        step = jax.jit(train_step, donate_argnums=0).lower(
            carry, key).compile()
        env_sharding = jax.tree.leaves(carry["env_states"])[0].sharding
        _, m = step(carry, key)
        metrics[n] = {k: float(v) for k, v in jax.device_get(m).items()}
    diff = max(abs(metrics[1][k] - metrics[n_devices][k])
               for k in metrics[1])
    return {"dp1_vs_dpN_metrics_max_abs_diff": diff,
            "devices": n_devices,
            "metrics_dp1": metrics[1],
            "metrics_dpN": metrics[n_devices],
            "env_batch_spec": str(env_sharding.spec),
            "env_batch_devices": [d.id for d in env_sharding.device_set],
            "collectives_dpN": collective_counts(step.as_text())}


def collective_counts(hlo_text: str) -> dict[str, int]:
    """Cross-device collectives in a compiled HLO module's text. A dp=N
    PPO step without any computes the whole batch on every device."""
    return {op: len(re.findall(rf"\b{op}(-start)?\(", hlo_text))
            for op in ("all-reduce", "all-gather", "reduce-scatter",
                       "all-to-all", "collective-permute")}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--env", default="evcharging")
    parser.add_argument("--devices", type=int, nargs="+", default=None,
                        help="device counts to sweep (default: 1..all)")
    parser.add_argument("--num-envs", type=int, default=512,
                        help="env batch PER DEVICE (weak scaling, the "
                             "standard throughput story); with "
                             "--strong it is the fixed TOTAL batch")
    parser.add_argument("--strong", action="store_true",
                        help="strong scaling: hold the total batch fixed")
    parser.add_argument("--rollout-len", type=int, default=32)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--mp", type=int, default=1)
    parser.add_argument("--algo", default="ppo", choices=["ppo", "sac"],
                        help="which fused learner to scale")
    parser.add_argument("--equivalence", action="store_true",
                        help="also run one PPO step at dp=1 and dp=max from "
                             "identical carries and print the metric "
                             "max-abs-diff (correctness signal for the "
                             "scaling artifact)")
    args = parser.parse_args(argv)

    _force_cpu_if_virtual()
    import jax
    avail = len(jax.devices())
    counts = args.devices or [d for d in (1, 2, 4, 8, 16, 32) if d <= avail]
    if jax.devices()[0].platform == "cpu":
        print(json.dumps({"note": "virtual CPU devices share physical "
                          "cores; this run validates the sharded program, "
                          "efficiency numbers are only meaningful on real "
                          "chips"}))

    results = []
    for n in counts:
        total = args.num_envs if args.strong else args.num_envs * n
        r = measure(n, args.env, total, args.rollout_len, args.iters,
                    mp=args.mp, algo=args.algo)
        r["algo"] = args.algo
        r["scaling"] = "strong" if args.strong else "weak"
        results.append(r)
        print(json.dumps(r))
    if len(results) > 1:
        base = results[0]["env_steps_per_s"] / results[0]["devices"]
        for r in results[1:]:
            if args.strong:
                # strong scaling: same total work, efficiency = speedup / n
                eff = (r["env_steps_per_s"]
                       / (results[0]["env_steps_per_s"] * r["devices"]
                          / results[0]["devices"]))
            else:
                eff = r["env_steps_per_s"] / (r["devices"] * base)
            print(json.dumps({"devices": r["devices"], "algo": args.algo,
                              "scaling": r["scaling"],
                              "scaling_efficiency": round(eff, 3)}))
    if args.equivalence:
        n_eq = max(counts)
        eq = equivalence(n_eq, args.env,
                         args.num_envs if args.strong
                         else args.num_envs * n_eq,
                         args.rollout_len, mp=args.mp)
        print(json.dumps(eq))


if __name__ == "__main__":
    main()
