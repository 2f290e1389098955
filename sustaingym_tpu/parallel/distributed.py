"""Multi-host bootstrap: ``jax.distributed`` process group + seed contract.

The reference's inter-process transport is Ray's object store and SB3's
subprocess pipes (SURVEY.md §5 "Distributed communication backend"); it has
no multi-host story at all. Here the communication backend is entirely XLA
collectives over a global mesh — the only host-side machinery needed is:

1. **Process-group init** (:func:`init_distributed`): one
   ``jax.distributed.initialize`` call per host, after which
   ``jax.devices()`` is the GLOBAL device list and meshes built by
   ``parallel.mesh.make_mesh`` span every process's GPUs (XLA hands the
   gradient psums to NCCL: NVLink between the cards of a host, the network
   between hosts — nothing to configure beyond the process group).

2. **A per-host seed contract** (:func:`host_fold`, :func:`host_env_keys`):
   env shards on different hosts must draw DISJOINT episode/trace streams
   while the run stays reproducible from one global seed (SURVEY.md §7 hard
   part 5). The contract: every host folds ``jax.process_index()`` into the
   global key, then splits locally. Same global seed ⇒ same global batch,
   bit-for-bit, regardless of how many hosts serve it — host h always owns
   rows [h·B/H, (h+1)·B/H) of the global batch.

3. **Host-local batch arithmetic** (:func:`process_local_batch`) for
   sizing per-host env shards under a globally-specified batch.

Single-process runs (tests, one-chip benches) skip initialize entirely —
every helper degrades to the trivial 1-host case.
"""
from __future__ import annotations

import os

import jax

__all__ = ["init_distributed", "is_distributed", "host_fold",
           "host_env_keys", "process_local_batch"]

_INITIALIZED = False


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Joins (or creates) the multi-host process group. Idempotent.

    With no arguments, joins only when a cluster is described: an explicit
    ``JAX_COORDINATOR_ADDRESS``, or a multi-node SLURM job that
    ``jax.distributed.initialize`` auto-detects. Otherwise pass the
    coordinator, process count and rank explicitly::

        init_distributed("localhost:9999", num_processes=2, process_id=rank)

    No-ops when the run is single-process and no coordinator is configured,
    so library code may call it unconditionally.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return
    explicit = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    auto_env = int(os.environ.get("SLURM_JOB_NUM_NODES", "1")) > 1
    if not explicit and not auto_env:
        return  # single-process run; jax.process_count() stays 1
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    except ValueError:
        if explicit:
            raise  # the caller asked for a specific cluster — surface it
        return  # auto-detection misfired on a single-host image; run solo
    _INITIALIZED = True


def is_distributed() -> bool:
    return jax.process_count() > 1


def host_fold(key: jax.Array, process_index: int | None = None) -> jax.Array:
    """Derives this host's key from the global key.

    Deterministic in (global key, process index) only — the stream a host
    draws does not depend on how many other hosts exist, so a 4-host run's
    host 0 replays a 1-host run's host 0 exactly.
    """
    idx = jax.process_index() if process_index is None else process_index
    return jax.random.fold_in(key, idx)


def host_env_keys(key: jax.Array, global_batch: int,
                  process_index: int | None = None,
                  process_count: int | None = None) -> jax.Array:
    """Per-env reset keys for this host's shard of a global env batch.

    Splits the GLOBAL key into ``global_batch`` per-env keys and returns the
    contiguous slice owned by this host — so the set of episodes simulated
    across the pod is identical to a single-host run of the same global
    batch (disjoint-by-construction, reproducible-by-construction).
    """
    h = jax.process_index() if process_index is None else process_index
    n = jax.process_count() if process_count is None else process_count
    if global_batch % n != 0:
        # not an assert: under ``python -O`` a silent pass here would hand
        # out truncated/overlapping shards
        raise ValueError(
            f"global_batch={global_batch} not divisible by process_count={n}")
    local = global_batch // n
    return jax.random.split(key, global_batch)[h * local:(h + 1) * local]


def process_local_batch(global_batch: int) -> int:
    """This host's share of a global env batch (must divide evenly)."""
    n = jax.process_count()
    if global_batch % n != 0:
        raise ValueError(
            f"global_batch={global_batch} not divisible by process_count={n}")
    return global_batch // n
