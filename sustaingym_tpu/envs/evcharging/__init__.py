"""EVChargingEnv: ACN charging-network simulation as a batched JAX program."""
from __future__ import annotations

from .env import (EVChargingEnv, EVParams, EVState, battery_charge,
                  make_params, quantize_pilots)
from .sites import SiteSpec, caltech_site, jpl_site, load_site


def make_env(dtype=None, **kwargs):
    import jax.numpy as jnp
    params = make_params(dtype=dtype or jnp.float32, **kwargs)
    return EVChargingEnv(), params


__all__ = [
    "EVChargingEnv", "EVParams", "EVState", "make_params", "make_env",
    "quantize_pilots", "battery_charge",
    "SiteSpec", "caltech_site", "jpl_site", "load_site",
]
