"""Algorithm runner harness.

Mirrors the reference's episode-loop runner
(/root/reference/sustaingym/algorithms/base.py:16-143): run an agent over a
list of seeds, return a DataFrame with per-episode returns + info columns.
Two execution paths:

- ``BaseAlgorithm.run(seeds)``: classic imperative loop over a gymnasium /
  pettingzoo adapter (drop-in for the reference API);
- ``batch_run(env, params, policy_fn, seeds)``: the device path — all seeds
  stepped in lockstep under one jitted scan (replaces the reference's
  ProcessPool evaluation, examples/evcharging/run_baselines.py:105-117).
"""
from __future__ import annotations

from collections import defaultdict
from collections.abc import Sequence
from copy import deepcopy
from typing import Any, Callable

import numpy as np
import pandas as pd

import jax
import jax.numpy as jnp


class BaseAlgorithm:
    """Imperative runner over a gymnasium-style env (or pettingzoo adapter
    with ``multiagent=True``)."""

    def __init__(self, env, multiagent: bool = False):
        self.env = env
        self.multiagent = multiagent

    def get_action(self, observation: Any) -> Any:
        raise NotImplementedError

    def reset(self) -> None:
        """Called at the start of each episode."""

    def run(self, seeds: Sequence[int] | int) -> pd.DataFrame:
        if isinstance(seeds, int):
            seeds = list(range(seeds))
        results: dict[str, list] = defaultdict(list)
        for seed in seeds:
            results["seed"].append(seed)
            ep_return = 0.0
            obs, _ = self.env.reset(seed=seed)
            self.reset()
            done = False
            info: dict[str, Any] = {}
            while not done:
                action = self.get_action(obs)
                obs, reward, terminated, truncated, info = self.env.step(action)
                if self.multiagent:
                    reward = sum(reward.values())
                    done = any(terminated.values()) or any(truncated.values())
                else:
                    done = terminated or truncated
                ep_return += reward
            results["return"].append(ep_return)
            if self.multiagent and info:
                info = info[next(iter(info))]
            for key, value in info.items():
                results[key].append(deepcopy(value))
        return pd.DataFrame(dict(results))


class RandomAlgorithm(BaseAlgorithm):
    """Uniform-random actions from the env's action space."""

    def get_action(self, observation: Any) -> Any:
        if self.multiagent:
            return {a: self.env.action_spaces[a].sample()
                    for a in self.env.agents}
        return self.env.action_space.sample()


def batch_run(env, params, policy_fn: Callable, seeds: Sequence[int],
              num_steps: int, seed_reset_fn: Callable | None = None
              ) -> pd.DataFrame:
    """Evaluates a jax policy over all seeds at once.

    ``policy_fn(obs, key) -> action`` operates on UNBATCHED obs (vmapped
    here). ``seed_reset_fn(params, seed) -> (state, ts)`` defaults to the
    env's deterministic seed semantics when available.
    """
    if seed_reset_fn is None:
        def seed_reset_fn(params, seed):
            if hasattr(env, "day_from_seed"):
                return env.reset_at_day(params, env.day_from_seed(params, seed))
            if hasattr(env, "epoch_from_seed"):
                return env.reset_at_epoch(
                    params, env.epoch_from_seed(params, int(seed)))
            if hasattr(env, "month_from_seed"):
                return env.reset_at_month(
                    params, env.month_from_seed(params, int(seed)))
            return env.reset(params, jax.random.PRNGKey(int(seed)))

    states, tss = [], []
    for s in seeds:
        st, ts = seed_reset_fn(params, int(s))
        states.append(st)
        tss.append(ts)
    states = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
    obs0 = jax.tree.map(lambda *xs: jnp.stack(xs), *(ts.obs for ts in tss))

    vstep = jax.vmap(env.step, in_axes=(None, 0, 0, 0))
    vpolicy = jax.vmap(policy_fn)
    n = len(seeds)

    @jax.jit
    def run(states, obs0, key):
        def body(carry, key_t):
            states, obs = carry
            k_act, k_env = jax.random.split(key_t)
            actions = vpolicy(obs, jax.random.split(k_act, n))
            states, ts = vstep(params, states, actions,
                               jax.random.split(k_env, n))
            return (states, ts.obs), ts.reward

        keys = jax.random.split(key, num_steps)
        (_, _), rewards = jax.lax.scan(body, (states, obs0), keys)
        return rewards.sum(axis=0)

    returns = np.asarray(run(states, obs0, jax.random.PRNGKey(0)))
    return pd.DataFrame({"seed": list(seeds), "return": returns})
