"""Per-episode exogenous-row prefetch.

The lockstep unrolls (building, cogen, datacenter) read, for each of B env
instances, the contiguous slice ``table[start_b : start_b + L]`` of a small
exogenous table once per episode segment instead of gathering one row per
env per step. Each env's slice is one contiguous ``dynamic_slice``, which
XLA lowers to a coalesced copy.

Replaces the reference's per-step pandas/np indexing of weather/ambient
series (reference sustaingym/envs/building/env.py:243-263) at batch scale.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["episode_slice_gather"]


def episode_slice_gather(table: jax.Array, starts: jax.Array, length: int
                         ) -> jax.Array:
    """``stack([table[e : e + length] for e in starts])``.

    table: (R, C); starts: (B,) integer row starts, the caller guarantees
    ``starts + length <= R``. Returns (B, length, C).
    """
    c = table.shape[1]
    return jax.vmap(
        lambda e: jax.lax.dynamic_slice(
            table, (e, jnp.zeros((), e.dtype)), (length, c)))(starts)
