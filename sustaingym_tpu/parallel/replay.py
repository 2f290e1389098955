"""Shared on-device replay-ring machinery for the off-policy learners
(SAC / DQN / DDPG — parallel/{sac,dqn,ddpg}.py).

The ring is a fixed-size time axis over the vmapped env batch:
``(capacity, num_envs, ...)`` per field, with the env axis sharded over the
mesh's ``dp`` axis. One module owns the three operations every learner
needs — allocation, the rollout's slot write, and update-time sampling —
so a sampling fix lands once, not three times.

Sampling modes (``per_env_sample``):

- ``False`` (default): draw ``batch_per_env`` shared ring slots and take
  WHOLE ``(num_envs, ...)`` slices. Per-env time indices would make
  ``take_along_axis`` gather one feature-dim-wide run per (slot, env)
  pair; whole-slice rows gather at full width and stay local to each dp
  shard. The honest trade-off: functional autoreset keeps the
  batch in episode lockstep, so one slot holds every env at the SAME
  in-episode phase (envs differ by their day/epoch draw, not phase) —
  each update batch covers ``batch_per_env`` phases rather than
  ``batch_per_env * num_envs``. Across an iteration's ``updates``
  gradient steps and consecutive train steps the phase coverage mixes
  quickly, and every learning-improvement test passes with margin, but
  phase-sensitive consumers can opt out.
- ``True``: the original per-env time indices (maximal phase diversity
  per update, ~2x slower train step end to end).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["init_ring", "write_transition", "write_block",
           "sample_transitions"]


def init_ring(capacity: int, fields: dict[str, tuple[tuple, object]]
              ) -> dict[str, jax.Array]:
    """Allocates the ring: ``fields`` maps name -> (full per-slot shape
    incl. the env/agent lead, dtype)."""
    return {name: jnp.zeros((capacity,) + tuple(shape), dtype)
            for name, (shape, dtype) in fields.items()}


def write_transition(buffer: dict, tr: dict, written: jax.Array,
                     capacity: int) -> dict:
    """Writes one transition dict into slot ``written % capacity``."""
    slot = written % capacity
    return {k: jax.lax.dynamic_update_index_in_dim(
        buffer[k], tr[k].astype(buffer[k].dtype), slot, axis=0)
        for k in buffer}


def write_block(buffer: dict, block: dict, written: jax.Array,
                capacity: int) -> dict:
    """Writes a whole (T, ...) transition block starting at slot
    ``written % capacity`` with ONE dynamic_update_slice per field.

    Callers advance ``written`` by T per call and guarantee
    ``capacity % T == 0``, so the write never wraps. This replaces T
    per-step writes from inside the rollout scan: carrying the full ring
    through the scan made XLA materialize ring-sized copies/layout
    converts at the while-loop boundaries.

    A checkpoint resumed under a DIFFERENT --rollout-len can carry a
    ``written`` that is not a T-multiple; dynamic_update_slice would then
    clamp an out-of-bounds start and silently overwrite the wrong slots
    (ADVICE r04). The start is therefore rounded DOWN to the T-aligned
    slot — a no-op on every aligned call, and on a misaligned resume it
    overwrites the tail of the previous (partial) block instead of
    corrupting an arbitrary window at the clamp boundary.
    """
    T = next(iter(block.values())).shape[0]
    start = (written % capacity) // T * T
    return {k: jax.lax.dynamic_update_slice_in_dim(
        buffer[k], block[k].astype(buffer[k].dtype), start, axis=0)
        for k in buffer}


def sample_transitions(buffer: dict, written: jax.Array, capacity: int,
                       batch_per_env: int, key: jax.Array,
                       per_env_sample: bool = False) -> dict:
    """Samples ``batch_per_env`` steps per env (see module docstring for
    the two index modes)."""
    filled = jnp.minimum(written, capacity)
    if per_env_sample:
        lead = buffer["reward"].shape[1:]
        idx = jax.random.randint(
            key, (batch_per_env, lead[0]), 0, jnp.maximum(filled, 1))

        def take(x):
            ix = idx.reshape(idx.shape + (1,) * (x.ndim - 2))
            return jnp.take_along_axis(x, ix, axis=0)

        return {k: take(v) for k, v in buffer.items()}
    idx = jax.random.randint(
        key, (batch_per_env,), 0, jnp.maximum(filled, 1))
    return {k: v[idx] for k, v in buffer.items()}
