"""The main path's dependencies and compile-cache placement, each checked
in a fresh interpreter.

The main path (``make(...)`` and ``python -m sustaingym_tpu.train``)
needs only jax, numpy, scipy, optax, chex and the standard library: these
tests block the optional packages in ``sys.modules`` and run it."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("flax", "orbax", "pandas", "gymnasium", "pettingzoo")


def _run(body: str, env_extra: dict | None = None,
         drop: tuple[str, ...] = ()) -> str:
    prelude = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None      # any import of it raises
        import jax
        jax.config.update("jax_platforms", "cpu")
    """)
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=ROOT, **(env_extra or {}))
    out = subprocess.run([sys.executable, "-c",
                          prelude + textwrap.dedent(body)],
                         capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


@pytest.mark.parametrize("name,kwargs", [
    ("evcharging", {}),
    ("evcharging-multiagent", {"periods_delay": 0}),
    ("electricitymarket", {}),
    ("datacenter", {}),
    ("cogen", {}),
])
def test_make_without_optional_packages(name, kwargs):
    out = _run(f"""
        import jax
        from sustaingym_tpu import make
        env, params = make({name!r}, **{kwargs!r})
        state, ts = env.reset(params, jax.random.PRNGKey(0))
        a = env.action_space(params).sample(jax.random.PRNGKey(1))
        state, ts = env.step(params, state, a, jax.random.PRNGKey(2))
        print("OK", float(jax.numpy.sum(ts.reward)))
    """)
    assert "OK" in out


def test_train_cli_without_optional_packages(tmp_path):
    out = _run(f"""
        import json, os
        from sustaingym_tpu.train import main
        rows = main(["--env", "evcharging", "--num-envs", "2",
                     "--rollout-len", "4", "--hidden", "8", "--epochs", "1",
                     "--minibatches", "2", "--iterations", "2",
                     "--log-dir", {str(tmp_path)!r}])
        print(json.dumps(rows))
    """)
    rows = json.loads(out.strip().splitlines()[-1])
    assert [r["iteration"] for r in rows] == [0, 1]
    assert os.path.exists(tmp_path / "checkpoints" / "step_2" / "carry.npz")


def test_compile_cache_honours_env_var(tmp_path):
    out = _run("""
        import jax, sustaingym_tpu
        print(jax.config.jax_compilation_cache_dir)
    """, env_extra={"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert out.strip().splitlines()[-1] == str(tmp_path)


def test_compile_cache_default_is_in_checkout():
    out = _run("""
        import jax, sustaingym_tpu
        print(jax.config.jax_compilation_cache_dir)
        print(sustaingym_tpu.CACHE_DIR)
    """, drop=("JAX_COMPILATION_CACHE_DIR",))
    cfg, const = out.strip().splitlines()[-2:]
    assert cfg == const == os.path.join(ROOT, ".jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
