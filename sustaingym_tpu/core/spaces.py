"""JAX-native space definitions.

Deliberately NOT gymnasium spaces: these are lightweight descriptors used by
the pure functional envs (sampling is key-based and jittable/vmappable). The
``sustaingym_tpu.compat`` layer converts them to ``gymnasium`` /
``pettingzoo`` spaces at the host API edge.

Mirrors the observation/action structures of the reference suite
(e.g. /root/reference/sustaingym/envs/evcharging/env.py:143-172,
/root/reference/sustaingym/envs/cogen/env.py:114-143).
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["Space", "Box", "Discrete", "MultiDiscrete", "DictSpace", "flatdim", "flatten"]


class Space:
    """Base class for all spaces."""

    def sample(self, key: jax.Array) -> Any:
        raise NotImplementedError

    def sample_batch(self, key: jax.Array, batch: int) -> Any:
        """Samples ``batch`` independent points with ONE wide RNG op.

        Semantically equivalent to ``vmap(sample)(split(key, batch))``;
        spaces override it with a single threefry call over the whole
        (batch, ...) block instead of ``batch`` key splits + tiny samples.
        The random stream differs from the vmapped form (both are uniform).
        """
        return jax.vmap(self.sample)(jax.random.split(key, batch))

    def contains(self, x: Any) -> bool:
        raise NotImplementedError


class Box(Space):
    """Continuous box in R^shape with elementwise bounds."""

    def __init__(self, low, high, shape: tuple[int, ...] | None = None,
                 dtype=jnp.float32):
        low = np.asarray(low, dtype=np.float64)
        high = np.asarray(high, dtype=np.float64)
        if shape is None:
            shape = np.broadcast_shapes(low.shape, high.shape)
        self.shape = tuple(shape)
        self.low = np.broadcast_to(low, self.shape).astype(np.float64)
        self.high = np.broadcast_to(high, self.shape).astype(np.float64)
        self.dtype = dtype

    def sample(self, key: jax.Array) -> jax.Array:
        u = jax.random.uniform(key, self.shape, dtype=jnp.float32)
        low = jnp.asarray(self.low, dtype=jnp.float32)
        high = jnp.asarray(self.high, dtype=jnp.float32)
        return (low + u * (high - low)).astype(self.dtype)

    def sample_batch(self, key: jax.Array, batch: int) -> jax.Array:
        u = jax.random.uniform(key, (batch,) + self.shape, dtype=jnp.float32)
        low = jnp.asarray(self.low, dtype=jnp.float32)
        high = jnp.asarray(self.high, dtype=jnp.float32)
        return (low + u * (high - low)).astype(self.dtype)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return (x.shape == self.shape and np.all(x >= self.low - 1e-6)
                and np.all(x <= self.high + 1e-6))

    def __repr__(self) -> str:
        return f"Box(shape={self.shape}, dtype={self.dtype.__name__ if hasattr(self.dtype, '__name__') else self.dtype})"


class Discrete(Space):
    """{start, ..., start + n - 1}."""

    def __init__(self, n: int, start: int = 0, dtype=jnp.int32):
        self.n = int(n)
        self.start = int(start)
        self.shape = ()
        self.dtype = dtype

    def sample(self, key: jax.Array) -> jax.Array:
        return jax.random.randint(key, (), 0, self.n, dtype=self.dtype) + self.start

    def sample_batch(self, key: jax.Array, batch: int) -> jax.Array:
        return (jax.random.randint(key, (batch,), 0, self.n, dtype=self.dtype)
                + self.start)

    def contains(self, x) -> bool:
        xi = int(np.asarray(x))
        return self.start <= xi < self.start + self.n

    def __repr__(self) -> str:
        return f"Discrete({self.n}, start={self.start})"


class MultiDiscrete(Space):
    """Vector of independent discrete dims with per-dim cardinality."""

    def __init__(self, nvec, dtype=jnp.int32):
        self.nvec = np.asarray(nvec, dtype=np.int64)
        self.shape = self.nvec.shape
        self.dtype = dtype

    def sample(self, key: jax.Array) -> jax.Array:
        u = jax.random.uniform(key, self.shape)
        return jnp.floor(u * jnp.asarray(self.nvec)).astype(self.dtype)

    def sample_batch(self, key: jax.Array, batch: int) -> jax.Array:
        u = jax.random.uniform(key, (batch,) + self.shape)
        return jnp.floor(u * jnp.asarray(self.nvec)).astype(self.dtype)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape and np.all(x >= 0) and np.all(x < self.nvec)

    def __repr__(self) -> str:
        return f"MultiDiscrete({self.nvec.tolist()})"


class DictSpace(Space):
    """Ordered mapping of named sub-spaces (a pytree of spaces)."""

    def __init__(self, spaces: Mapping[str, Space]):
        self.spaces = dict(spaces)
        self.shape = None

    def sample(self, key: jax.Array) -> dict[str, Any]:
        keys = jax.random.split(key, len(self.spaces))
        return {name: sp.sample(k)
                for (name, sp), k in zip(self.spaces.items(), keys)}

    def sample_batch(self, key: jax.Array, batch: int) -> dict[str, Any]:
        keys = jax.random.split(key, len(self.spaces))
        return {name: sp.sample_batch(k, batch)
                for (name, sp), k in zip(self.spaces.items(), keys)}

    def contains(self, x) -> bool:
        return (isinstance(x, Mapping)
                and set(x.keys()) == set(self.spaces.keys())
                and all(sp.contains(x[name]) for name, sp in self.spaces.items()))

    def __getitem__(self, name: str) -> Space:
        return self.spaces[name]

    def items(self):
        return self.spaces.items()

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}: {v!r}" for k, v in self.spaces.items())
        return f"DictSpace({inner})"


def flatdim(space: Space) -> int:
    """Total number of scalar entries in a flattened point of ``space``."""
    if isinstance(space, Box):
        return int(np.prod(space.shape, dtype=np.int64)) if space.shape else 1
    if isinstance(space, Discrete):
        return space.n  # one-hot, matching gymnasium.spaces.flatten semantics
    if isinstance(space, MultiDiscrete):
        return int(space.nvec.sum())
    if isinstance(space, DictSpace):
        return sum(flatdim(sp) for sp in space.spaces.values())
    raise TypeError(f"unknown space {space}")


def flatten(space: Space, x: Any) -> jax.Array:
    """Flattens a sample of ``space`` to a 1-D float array (jit-compatible).

    Matches ``gymnasium.spaces.flatten`` ordering (dict keys in insertion
    order; Discrete one-hot), used by the multi-agent adapters, mirroring
    /root/reference/sustaingym/envs/evcharging/multiagent_env.py:115.
    """
    if isinstance(space, Box):
        return jnp.ravel(jnp.asarray(x, dtype=jnp.float32))
    if isinstance(space, Discrete):
        return jax.nn.one_hot(jnp.asarray(x) - space.start, space.n, dtype=jnp.float32)
    if isinstance(space, MultiDiscrete):
        parts = []
        flat_x = jnp.ravel(jnp.asarray(x))
        for i, n in enumerate(space.nvec.ravel()):
            parts.append(jax.nn.one_hot(flat_x[i], int(n), dtype=jnp.float32))
        return jnp.concatenate(parts)
    if isinstance(space, DictSpace):
        return jnp.concatenate([flatten(sp, x[name]) for name, sp in space.spaces.items()])
    raise TypeError(f"unknown space {space}")
