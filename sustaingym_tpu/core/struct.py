"""Pytree dataclass utilities for the engine's core runtime.

Every environment's ``Params``/``State`` is a frozen pytree dataclass so it can
flow through ``jax.jit`` / ``jax.vmap`` / ``jax.lax.scan`` and be sharded with
``jax.sharding``. The decorator below registers a frozen standard-library
dataclass with ``jax.tree_util.register_dataclass``: fields are pytree leaves
unless declared with :func:`static_field`, which makes them part of the
treedef (hashable, compared at trace time).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, TypeVar

import jax
import jax.numpy as jnp

__all__ = [
    "PyTreeNode",
    "dataclass",
    "field",
    "static_field",
    "tree_select",
    "tree_stack",
]

T = TypeVar("T")


def field(pytree_node: bool = True, **kwargs: Any):
    """A dataclass field; ``pytree_node=False`` makes it static."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def static_field(**kwargs: Any):
    """A field treated as static (part of the treedef, not traced)."""
    return field(pytree_node=False, **kwargs)


def _replace(self, **updates):
    return dataclasses.replace(self, **updates)


def dataclass(cls=None, **kwargs: Any):
    """Frozen dataclass registered as a pytree, with a ``.replace`` method."""
    if cls is None:
        return functools.partial(dataclass, **kwargs)
    if "__pytree_fields__" in cls.__dict__:
        return cls
    cls = dataclasses.dataclass(frozen=True, **kwargs)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = _replace
    cls.__pytree_fields__ = (tuple(data), tuple(meta))
    return cls


class PyTreeNode:
    """Base class whose subclasses become pytree dataclasses."""

    def __init_subclass__(cls, **kwargs: Any):
        super().__init_subclass__(**kwargs)
        dataclass(cls)


def tree_select(pred: jax.Array, on_true: T, on_false: T) -> T:
    """Elementwise ``jnp.where`` over matching pytrees.

    ``pred`` is broadcast against every leaf; used by the functional
    autoreset combinator to swap in freshly-reset state where ``done``.
    """

    def _sel(a, b):
        p = pred
        # broadcast pred over trailing dims of the leaf
        while p.ndim < jnp.ndim(a):
            p = p[..., None]
        return jnp.where(p, a, b)

    return jax.tree.map(_sel, on_true, on_false)


def tree_stack(trees: list[T], axis: int = 0) -> T:
    """Stacks a list of identical pytrees along ``axis``."""
    return jax.tree.map(lambda *xs: jnp.stack(xs, axis=axis), *trees)
