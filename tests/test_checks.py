"""The shared solver accuracy checks (sustaingym_tpu/checks.py) at CPU
precision, and the profiler-trace reduction (utils/trace.py).

chip_smoke.py runs the same check functions on the GPU at real widths."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sustaingym_tpu import checks


@pytest.mark.parametrize("site", ["caltech", "jpl"])
def test_projection_check_passes(site):
    r = checks.projection_check(site, batch=256, n_ref=64,
                                device=jax.devices("cpu")[0])
    assert r["ok"], r
    assert r["max_abs_err"] < checks.PROJ_MAX_ERR
    assert r["max_cone_violation"] < checks.PROJ_MAX_VIOLATION
    assert r["max_box_violation"] <= 1e-6


def test_projection_reference_is_feasible_fixed_point():
    """The float64 reference lands in the feasible set, and projecting an
    already-feasible point returns it."""
    from sustaingym_tpu.envs.evcharging.sites import load_site
    from sustaingym_tpu.ops import qp

    spec = load_site("caltech")
    op = qp.make_dual_soc_projection(spec.constraint_matrix,
                                     spec.phase_angles, spec.magnitudes)
    C = np.asarray(op.C, np.float64)
    radii = np.asarray(op.radii, np.float64)
    A, UB = checks.projection_inputs(spec.num_stations, 16, seed=3)
    x = checks.projection_reference(C, radii, A, UB)
    cone = np.sqrt(((x @ C.T).reshape(16, -1, 2) ** 2).sum(-1))
    assert (cone <= radii + 1e-6).all()
    assert (x >= 0).all() and (x <= UB + 1e-12).all()
    x2 = checks.projection_reference(C, radii, x, UB, iters=2000)
    np.testing.assert_allclose(x2, x, atol=1e-6)


def test_market_price_check_passes():
    r = checks.market_price_check(batch=128, matmuls=("f32", "tf32"),
                                  n_scipy=12, device=jax.devices("cpu")[0])
    assert r["ok"], r
    for mode in ("f32", "tf32"):
        assert r[mode]["finite"]
        assert r[mode]["scipy_median_err"] < checks.PRICE_SCIPY_MEDIAN
    # TF32 is full float32 on a CPU
    assert r["tf32"]["vs_f32_max_err"] == 0.0


def test_lp_rejects_unknown_matmul_mode():
    from sustaingym_tpu.ops import lp
    with pytest.raises(ValueError, match="matmul"):
        lp.make_lp_operator(np.eye(2), np.zeros((0, 2)), matmul="bf16")


def test_trace_reduction_on_recorded_trace(tmp_path):
    """A trace recorded on the CPU reduces to consistent numbers when the
    host plane stands in for the device plane."""
    from sustaingym_tpu.utils.trace import device_summary

    f = jax.jit(lambda x: jnp.tanh(x @ x.T).sum())
    x = jnp.ones((128, 128))
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        for _ in range(3):
            f(x).block_until_ready()
    s = device_summary(str(tmp_path), plane_prefix="/host:CPU", top=5)
    assert s["planes"] == ["/host:CPU"]
    assert 0 < s["busy_ns"] <= s["span_ns"]
    assert 0.0 <= s["idle_share"] < 1.0
    assert 0 < len(s["top_ops"]) <= 5
    shares = [op["share"] for op in s["top_ops"]]
    assert shares == sorted(shares, reverse=True) and sum(shares) <= 1 + 1e-9
    assert device_summary(str(tmp_path))["planes"] == []   # no GPU here


@pytest.mark.parametrize("matmul", [None, "f32"])
def test_market_warm_check_passes(matmul):
    r = checks.market_warm_check(device=jax.devices("cpu")[0],
                                 matmul=matmul, steps=48)
    assert r["ok"], r
    assert r["mean_err"] < checks.PRICE_WARM_MEAN
