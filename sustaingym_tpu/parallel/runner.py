"""Shared training-loop driver for all learners (PPO/A2C/SAC/DQN/DDPG).

One jitted train step per iteration with metrics fetched ONE step lagged
in a single batched device_get, so the host round trip overlaps the next
step's device compute instead of serializing with it.
"""
from __future__ import annotations

import jax

__all__ = ["run_train_loop"]


def run_train_loop(train_step, carry, key: jax.Array, num_iterations: int,
                   verbose: bool = True):
    """Runs ``train_step`` for ``num_iterations`` with per-iteration keys
    ``fold_in(key, i)``; returns (final_carry, history of metric dicts)."""
    step = jax.jit(train_step, donate_argnums=0)
    history = []

    def fetch(i, metrics):
        metrics = {k: float(v) for k, v in jax.device_get(metrics).items()}
        history.append(metrics)
        if verbose:
            print(f"iter {i}: " + ", ".join(
                f"{k}={v:.4f}" for k, v in metrics.items()))

    pending = None
    for i in range(num_iterations):
        carry, metrics = step(carry, jax.random.fold_in(key, i))
        if pending is not None:
            fetch(*pending)
        pending = (i, metrics)
    if pending is not None:
        fetch(*pending)
    return carry, history
