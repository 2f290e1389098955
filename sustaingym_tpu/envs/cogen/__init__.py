"""CogenEnv: combined-cycle cogeneration dispatch as a batched JAX program."""
from __future__ import annotations

from .env import (ACTION_KEYS, BINARY_IDX, CogenEnv, CogenParams, CogenState,
                  FORECAST_KEYS, make_params)
from .plant import plant_model, plant_model_batched


def make_env(dtype=None, **kwargs):
    import jax.numpy as jnp
    params = make_params(dtype=dtype or jnp.float32, **kwargs)
    return CogenEnv(), params


__all__ = [
    "CogenEnv", "CogenParams", "CogenState", "make_params", "make_env",
    "plant_model", "plant_model_batched", "ACTION_KEYS", "FORECAST_KEYS",
    "BINARY_IDX",
]
