"""SustainGym-TPU: a vectorized JAX engine for the SustainGym suite.

A from-scratch rebuild of chrisyeh96/sustaingym as pure, jittable JAX
environments that vmap to thousands of instances per device and shard over
a device mesh. See SURVEY.md for the layer map and design rules.

Quick start::

    import jax
    from sustaingym_tpu import make

    env, params = make("evcharging")
    state, ts = env.reset(params, jax.random.PRNGKey(0))
    action = env.action_space(params).sample(jax.random.PRNGKey(1))
    state, ts = env.step(params, state, action, jax.random.PRNGKey(2))
"""
from __future__ import annotations

import os
from typing import Any

__version__ = "0.1.0"

_REGISTRY: dict[str, Any] = {}

# persistent XLA compilation cache: ``$JAX_COMPILATION_CACHE_DIR`` when the
# caller sets it (JAX reads the variable itself), else a fixed directory in
# the checkout, listed in .gitignore (a fixed path keeps cache keys stable)
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")


def _enable_compilation_cache() -> None:
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)


_enable_compilation_cache()


def register(name: str, factory) -> None:
    """Registers an env factory. ``factory(**kwargs) -> (env, params)``."""
    _REGISTRY[name] = factory


def make(name: str, **kwargs):
    """Creates (env, params) for a registered environment.

    Registered names (mirroring /root/reference/sustaingym/__init__.py:3-29
    plus the two doc-spec envs):
      'building', 'cogen', 'evcharging', 'electricitymarket', 'datacenter'
    """
    if not _REGISTRY:
        _populate_registry()
    if name not in _REGISTRY:
        raise KeyError(f"unknown env {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def _populate_registry() -> None:
    import importlib

    for name in ("building", "cogen", "evcharging", "electricitymarket",
                 "datacenter"):
        mod = importlib.import_module(f".envs.{name}", __name__)
        register(name, mod.make_env)

    from .envs import multiagent as ma

    def _ma_ev(**kw):
        return ma.MultiAgentEVChargingEnv(), ma.make_ma_ev_params(**kw)

    def _ma_building(**kw):
        from .envs.building import make_env
        _, params = make_env(**kw)
        return ma.MultiAgentBuildingEnv(), params

    def _ma_cogen(**kw):
        from .envs.cogen import make_env
        _, params = make_env(**kw)
        return ma.MultiAgentCogenEnv(), params

    register("evcharging-multiagent", _ma_ev)
    register("building-multiagent", _ma_building)
    register("cogen-multiagent", _ma_cogen)
