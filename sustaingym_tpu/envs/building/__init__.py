"""BuildingEnv: multi-zone thermal RC control as a batched JAX program."""
from __future__ import annotations

from .env import BuildingEnv, BuildingParams, BuildingState, make_params
from .datadriven import fit_data_driven
from .params import (BUILDINGS, GROUND_TEMP, WEATHER, Ufactor, Zone,
                     generate_building_params)
from .stochastic import StochasticAmbientGenerator, generate_stochastic_ambients


def make_env(building: str = "OfficeSmall", weather: str = "Hot_Dry",
             location: str = "Tucson", dtype=None, **kwargs):
    """Factory: compile params on host and return (env, params)."""
    import jax.numpy as jnp
    p = generate_building_params(building, weather, location, **kwargs)
    params = make_params(p, dtype=dtype or jnp.float32)
    return BuildingEnv(), params


__all__ = [
    "BuildingEnv", "BuildingParams", "BuildingState", "make_params",
    "make_env", "generate_building_params",
    "BUILDINGS", "GROUND_TEMP", "WEATHER", "Ufactor", "Zone",
    "fit_data_driven", "StochasticAmbientGenerator",
    "generate_stochastic_ambients",
]
