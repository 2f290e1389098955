"""Functional environment protocol for the batched engine.

Design (SURVEY.md §7 design rule 1): every env is a pure function pair

    reset(params, key)                -> (state, timestep)
    step(params, state, action, key)  -> (state, timestep)

on fixed-shape pytrees. No host sync, no Python-level randomness, no
data-dependent shapes — so the whole episode rolls out under ``lax.scan``
and thousands of env instances step in lockstep under ``vmap``/``pjit``.

This replaces the reference's object-oriented Gymnasium API
(/root/reference/sustaingym/envs/building/env.py:205,314 et al.); the
``sustaingym_tpu.compat`` layer re-exposes the classic imperative API on top.
"""
from __future__ import annotations

from typing import Any, Callable, Generic, TypeVar

import jax
import jax.numpy as jnp

from .spaces import Space
from .struct import PyTreeNode, tree_select

P = TypeVar("P")  # params pytree
S = TypeVar("S")  # state pytree

__all__ = ["TimeStep", "FunctionalEnv", "autoreset_step",
           "autoreset_vstep", "RewardBreakdown"]


class TimeStep(PyTreeNode):
    """One transition's outputs. ``info`` is a flat dict of arrays so that it
    vmaps; reward-breakdown accounting lives here as a struct-of-arrays
    (mirroring the reference's ``info['reward_breakdown']`` dicts, e.g.
    /root/reference/sustaingym/envs/building/env.py:183)."""

    obs: Any
    reward: jax.Array
    terminated: jax.Array
    truncated: jax.Array
    info: dict[str, Any]

    @property
    def done(self) -> jax.Array:
        return jnp.logical_or(self.terminated, self.truncated)


RewardBreakdown = dict[str, jax.Array]


class FunctionalEnv(Generic[P, S]):
    """Base class: holds metadata + the pure ``reset``/``step`` functions.

    Subclasses implement ``reset`` and ``step`` as pure jittable functions of
    their pytree ``params``/``state`` and override the space constructors.
    Instances are lightweight descriptors — all numeric state flows through
    function arguments.
    """

    #: name used by the registry
    name: str = "abstract"

    #: True for multi-agent views whose obs carry an (n_agents, obs_dim)
    #: leading axis and rewards an (n_agents,) axis — shared-policy learners
    #: (parallel.ppo) then treat the agent axis as an extra batch dimension
    agent_axis: bool = False

    # ---- pure API -------------------------------------------------------
    def reset(self, params: P, key: jax.Array) -> tuple[S, TimeStep]:
        raise NotImplementedError

    def step(self, params: P, state: S, action: Any, key: jax.Array
             ) -> tuple[S, TimeStep]:
        raise NotImplementedError

    # ---- metadata -------------------------------------------------------
    def observation_space(self, params: P) -> Space:
        raise NotImplementedError

    def action_space(self, params: P) -> Space:
        raise NotImplementedError

    def episode_steps(self, params: P) -> int | None:
        """Static episode length, or None if variable. Envs with fixed
        lengths (all five in this suite) override this; the PPO learner's
        episodic fast path (whole-episode rollouts through the env's
        ``batch_unroll`` prefetcher) keys off it."""
        return None

    # ---- seeding parity -------------------------------------------------
    def key_from_seed(self, params: P, seed: int | None) -> jax.Array:
        """Maps a reference-style integer seed to a PRNG key. Envs with
        deterministic seed→episode semantics (e.g. building seed→epoch,
        /root/reference/sustaingym/envs/building/env.py:339-345) fold the
        seed into reset via this key."""
        return jax.random.PRNGKey(0 if seed is None else seed)


def autoreset_step(env: FunctionalEnv[P, S]
                   ) -> Callable[[P, S, Any, jax.Array], tuple[S, TimeStep]]:
    """Wraps ``env.step`` with functional auto-reset.

    When an episode ends, the returned state/obs are those of a freshly
    reset episode (keyed independently), while reward/terminated/truncated
    of the finishing step are preserved. This keeps ``vmap`` batches stepping
    in lockstep forever with no host round-trip — the device replacement for
    SubprocVecEnv/RLLib worker autoreset
    (/root/reference/examples/evcharging/train_stable_baselines.py:275).
    """

    def step(params: P, state: S, action: Any, key: jax.Array
             ) -> tuple[S, TimeStep]:
        key_step, key_reset = jax.random.split(key)
        next_state, ts = env.step(params, state, action, key_step)
        reset_state, reset_ts = env.reset(params, key_reset)
        done = ts.done
        new_state = tree_select(done, reset_state, next_state)
        new_obs = tree_select(done, reset_ts.obs, ts.obs)
        return new_state, ts.replace(obs=new_obs)

    return step


def autoreset_vstep(env: FunctionalEnv[P, S]
                    ) -> Callable[[P, S, Any, jax.Array], tuple[S, TimeStep]]:
    """Batched functional auto-reset: ``vmap(autoreset_step(env))`` with the
    reset computation gated behind a SCALAR ``lax.cond(any(done))``.

    Every env in the suite has a fixed episode length, so vmapped batches
    step in lockstep and the done row is all-false on all but the episode-
    boundary step — per-env ``vmap(reset)`` every step would be work the
    elementwise ``where`` then discards. The key derivation (per-env
    ``split(key) -> (key_step, key_reset)``) and all selected values are
    IDENTICAL to ``vmap(autoreset_step(env))`` — trajectories stay
    bit-exact; only the dead reset work is skipped.

    Envs can opt out with ``gate_autoreset = False`` (class attribute)
    when the per-step branch dispatch costs more than the dead reset work
    it skips (the cond also blocks XLA from CSEing work shared between
    step and reset). No suite env currently opts out; the escape hatch
    stays for fine-grained-step envs.

    Args are batched: states/actions/keys carry a leading batch axis;
    ``params`` is shared.
    """
    if not getattr(env, "gate_autoreset", True):
        return jax.vmap(autoreset_step(env), in_axes=(None, 0, 0, 0))
    vstep = jax.vmap(env.step, in_axes=(None, 0, 0, 0))
    vreset = jax.vmap(env.reset, in_axes=(None, 0))

    def step(params: P, states: S, actions: Any, keys: jax.Array
             ) -> tuple[S, TimeStep]:
        ks = jax.vmap(jax.random.split)(keys)        # (B, 2, 2)
        next_states, ts = vstep(params, states, actions, ks[:, 0])
        done = ts.done

        def with_reset(operand):
            next_states, obs, keys_reset = operand
            reset_states, reset_ts = vreset(params, keys_reset)
            return (tree_select(done, reset_states, next_states),
                    tree_select(done, reset_ts.obs, obs))

        def no_reset(operand):
            next_states, obs, _ = operand
            return next_states, obs

        new_states, new_obs = jax.lax.cond(
            jnp.any(done), with_reset, no_reset,
            (next_states, ts.obs, ks[:, 1]))
        return new_states, ts.replace(obs=new_obs)

    return step
