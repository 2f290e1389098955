"""Golden-trajectory regression tests.

The reference can only run BuildingEnv on this machine (acnportal, cvxpy,
onnxruntime absent), so building has true reference-parity tests
(tests/test_building.py) while the other envs are guarded by checked-in
golden trajectories: fixed-seed generic-path rollouts recorded on CPU.
Any optimization that changes episode content (not just speed) trips these.

Regenerate (only when a deliberate semantic change is made) — must run
under the exact test environment (CPU backend, 8 virtual devices, x64 on):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 python - <<'PY'
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    from sustaingym_tpu import make
    from sustaingym_tpu.core import batch_rollout, random_policy
    STEPS = {"evcharging": 120, "cogen": 24, "electricitymarket": 12,
             "datacenter": 48, "building": 24}
    golden = {}
    for name, steps in STEPS.items():
        env, params = make(name)
        traj = batch_rollout(env, params, random_policy(env, params, 4),
                             None, jax.random.PRNGKey(123), 4, steps,
                             fast=False)
        golden[f"{name}_reward"] = np.asarray(traj.reward, np.float64)
    np.savez("tests/golden_trajectories.npz", **golden)
    PY
"""
import os

import numpy as np
import pytest

import jax

from sustaingym_tpu import make
from sustaingym_tpu.core import batch_rollout, random_policy

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_trajectories.npz")
STEPS = {"evcharging": 120, "cogen": 24, "electricitymarket": 12,
         "datacenter": 48, "building": 24}


@pytest.mark.parametrize("name", sorted(STEPS))
def test_golden_rewards(name):
    # decided inside the test (never at import): xdist workers must all
    # collect the same tests
    if jax.devices()[0].platform != "cpu":
        pytest.skip("goldens recorded on CPU")
    data = np.load(GOLDEN)
    env, params = make(name)
    traj = batch_rollout(env, params, random_policy(env, params, 4), None,
                         jax.random.PRNGKey(123), 4, STEPS[name], fast=False)
    np.testing.assert_allclose(
        np.asarray(traj.reward, np.float64), data[f"{name}_reward"],
        rtol=1e-5, atol=1e-6,
        err_msg=f"{name} episode content changed vs recorded golden")
