"""Device-mesh helpers for the engine's SPMD layer.

The reference delegates all parallelism to Ray RLLib rollout workers and SB3
subprocess envs (SURVEY.md §2.2). Here the whole actor+learner system is ONE
SPMD program: the env batch axis is sharded over the mesh's ``dp`` axis, the
policy MLP's hidden dimension over ``mp``; XLA inserts the psum/all-gather
collectives, which run on NCCL across GPUs (every card of a host reaches
every other over NVLink, so the mesh shape follows the algorithm alone).
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "data_sharding", "replicated", "model_sharding", "P"]


def make_mesh(n_devices: int | None = None, mp: int = 1) -> Mesh:
    """Builds a (dp, mp) mesh over the first ``n_devices`` devices."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    assert n_devices % mp == 0, f"{n_devices=} not divisible by {mp=}"
    grid = np.asarray(devices[:n_devices]).reshape(n_devices // mp, mp)
    return Mesh(grid, ("dp", "mp"))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Leading (batch/env) axis sharded over dp, replicated over mp."""
    return NamedSharding(mesh, P("dp"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def model_sharding(mesh: Mesh, axis: int) -> NamedSharding:
    """Shards one tensor axis over the mp (tensor-parallel) mesh axis."""
    spec = [None] * (axis + 1)
    spec[axis] = "mp"
    return NamedSharding(mesh, P(*spec))
