"""Worker process for the multi-process ``jax.distributed`` CPU test.

Each process joins an explicit-coordinator process group (the CPU-CI harness
documented at sustaingym_tpu/parallel/distributed.py:init_distributed), builds
a GLOBAL 2-device mesh (1 CPU device per process), and executes one fused PPO
train step as a single SPMD program. Run with --nprocs 1 (and 2 local virtual
devices) it produces the single-process reference for the same global batch:
the seed contract promises identical results, which the parent test asserts.

Usage:
    python tests/_distributed_worker.py --rank R --nprocs N --port P
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--nprocs", type=int, required=True)
    parser.add_argument("--port", type=int, required=True)
    args = parser.parse_args()

    if args.nprocs == 1:
        # single-process reference: same 2-device global mesh, virtual
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=2").strip()

    import jax

    # this harness runs on host CPUs whatever backend the machine offers
    jax.config.update("jax_platforms", "cpu")

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    from sustaingym_tpu import make
    from sustaingym_tpu.parallel import PPOConfig, make_mesh
    from sustaingym_tpu.parallel.distributed import init_distributed
    from sustaingym_tpu.parallel.mesh import data_sharding, replicated
    from sustaingym_tpu.parallel.ppo import carry_shardings, make_train_step

    if args.nprocs > 1:
        init_distributed(f"127.0.0.1:{args.port}",
                         num_processes=args.nprocs, process_id=args.rank)
        assert jax.process_count() == args.nprocs, jax.process_count()

    assert len(jax.devices()) == 2, jax.devices()

    env, env_params = make("building")
    cfg = PPOConfig(num_envs=8, rollout_len=4, hidden=32,
                    epochs=1, minibatches=2)
    init_state, train_step = make_train_step(env, env_params, cfg)

    mesh = make_mesh(2, mp=1)
    key = jax.random.PRNGKey(0)
    # the global carry must be CREATED sharded (jit out_shardings): in
    # multi-process SPMD there is no host-side view of the global arrays to
    # device_put from
    shardings = carry_shardings(
        jax.eval_shape(init_state, key), mesh,
        data_sharding(mesh), replicated(mesh))
    carry = jax.jit(init_state, out_shardings=shardings)(key)

    step = jax.jit(train_step, donate_argnums=0)
    metrics = None
    for i in range(3):
        carry, metrics = step(carry, jax.random.fold_in(
            jax.random.PRNGKey(1), i))
    out = {k: float(v) for k, v in jax.device_get(metrics).items()}
    out["process_count"] = jax.process_count()
    print("METRICS " + json.dumps(out, sort_keys=True))


if __name__ == "__main__":
    main()
