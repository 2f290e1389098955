"""Batched fixed-iteration solvers for the EV action-feasibility projection.

The reference calls MOSEK through cvxpy for the EV action-feasibility
projection (/root/reference/sustaingym/envs/evcharging/env.py:178-221 +
envs/utils.py:6-24) — a per-step, per-env CPU interior-point solve that
dominates its wall time. Here the projection is a fixed-iteration
first-order method, so a batch of thousands of projections is a handful of
(B, n) x (n, 2m) matmuls per iteration, with a deterministic iteration
count (no data-dependent control flow under jit).

Problem (projection):
    minimize    1/2 ||x - a||^2
    subject to  0 <= x <= ub                     (box, ub varies per instance)
                ||C_k x|| <= r_k, k = 1..m      (phase-aggregate SOC limits)

where each C_k stacks the real/imag parts of one row of the complex
constraint matrix A~ = constraint_matrix * exp(j * phase_angle)
(env.py:485-496).

Two operators are provided:

``DualSOCProjection`` (default, :func:`make_dual_soc_projection`) — FISTA on
the 2m-dimensional dual. Strong convexity of the primal makes the smooth
dual term differentiable with gradient -C clip(a - C' lam, 0, ub); the
nonsmooth term sum_k r_k ||lam_k|| has a block soft-threshold prox. Per-cone
diagonal preconditioning (block row sums of |CC'|) plus gradient-restart
Nesterov momentum converges in ~20 iterations where ADMM needs hundreds for
the same accuracy, and each iteration is two skinny (n x 2m) matmuls —
~4x fewer flops/iter than the ADMM x-step's dense (n, n) solve. The
method is a descent scheme on a 16-dim dual, so it tolerates
reduced-precision matmuls, where the ADMM operator's dual accumulators
integrate the rounding noise and return feasible-but-far points
(tools/proj_experiment.py). Its float32 products are pinned to full
float32 (``Precision.HIGHEST``): at TF32, the GPU's default for float32
products, the Caltech cone limits overshot by 0.087 (> the 0.05 bound of
``sustaingym_tpu.checks.projection_check``) on an H100.

``SOCProjection`` (:func:`make_soc_projection`) — the legacy over-relaxed
ADMM splitting with a host-prefactorized (n, n) system, kept for
comparison; its matmuls are pinned to float32 precision.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.struct import dataclass, static_field

__all__ = ["SOCProjection", "DualSOCProjection", "make_soc_projection",
           "make_dual_soc_projection", "project"]



@dataclass
class SOCProjection:
    """Prefactorized ADMM projection operator (legacy path)."""
    C: jax.Array          # (2m, n) stacked [Re; Im] rows, interleaved per cone
    K: jax.Array          # (n, n) inverse of ((1+rho) I + rho C^T C)
    radii: jax.Array      # (m,) cone radii (normalized units)
    rho: jax.Array        # scalar
    alpha: jax.Array      # over-relaxation factor (1.0 = plain ADMM)
    n: int = static_field()
    m: int = static_field()
    iters: int = static_field(default=50)


@dataclass
class DualSOCProjection:
    """Preconditioned dual-FISTA projection operator (default path)."""
    C: jax.Array          # (2m, n) stacked [Re; Im] rows, interleaved per cone
    radii: jax.Array      # (m,) cone radii (normalized units)
    step: jax.Array       # (m,) per-cone dual step sizes (scale included)
    n: int = static_field()
    m: int = static_field()
    iters: int = static_field(default=20)
    restart: bool = static_field(default=True)
    # store a/ub (and the xbar intermediate's inputs) as bfloat16 inside
    # the iteration: the loop re-reads a/ub every iteration, so this
    # halves the bytes it moves. Iterates/dots stay f32; the final
    # primal clip uses the exact f32 a/ub, so this solves a <=0.4%%-
    # perturbed problem exactly rather than the exact problem noisily —
    # measured max error vs float64 ground truth IMPROVES slightly
    # (0.0014 random / 0.0024 stress vs 0.003/0.03 bounds).
    inner_bf16: bool = static_field(default=True)


def _interleaved_C(constraint_matrix: np.ndarray,
                   phase_angles_deg: np.ndarray) -> np.ndarray:
    phase = np.exp(1j * np.deg2rad(np.asarray(phase_angles_deg)))
    a_tilde = np.asarray(constraint_matrix) * phase[None, :]
    m, n = a_tilde.shape
    C = np.empty((2 * m, n), dtype=np.float64)
    C[0::2] = a_tilde.real
    C[1::2] = a_tilde.imag
    return C


def make_soc_projection(constraint_matrix: np.ndarray,
                        phase_angles_deg: np.ndarray,
                        magnitudes: np.ndarray,
                        action_scale: float = 32.0,
                        rho: float = 2.0,
                        iters: int = 50,
                        alpha: float = 1.7,
                        dtype=jnp.float32) -> SOCProjection:
    """Builds the ADMM operator from network constants (same inputs as
    `magnitude_constraint`, env.py:473-500). ``alpha`` is ADMM
    over-relaxation (Boyd et al. §3.4.3)."""
    C = _interleaved_C(constraint_matrix, phase_angles_deg)
    m2, n = C.shape
    radii = np.asarray(magnitudes, dtype=np.float64) / action_scale
    K = np.linalg.inv((1.0 + rho) * np.eye(n) + rho * (C.T @ C))
    return SOCProjection(
        C=jnp.asarray(C, dtype), K=jnp.asarray(K, dtype),
        radii=jnp.asarray(radii, dtype), rho=jnp.asarray(rho, dtype),
        alpha=jnp.asarray(alpha, dtype),
        n=int(n), m=m2 // 2, iters=int(iters))


def make_dual_soc_projection(constraint_matrix: np.ndarray,
                             phase_angles_deg: np.ndarray,
                             magnitudes: np.ndarray,
                             action_scale: float = 32.0,
                             iters: int = 20,
                             step_scale: float | None = 2.0,
                             restart: bool = True,
                             inner_bf16: bool = True,
                             dtype=jnp.float32) -> DualSOCProjection:
    """Builds the preconditioned dual-FISTA operator.

    Per-cone base steps t_k = 1 / max-row block sum of |C C'| (generalized
    diagonal dominance => sqrt(T) C C' sqrt(T) has spectral norm <= 1, the
    provable FISTA step bound). ``step_scale`` multiplies them:

    - ``None``: exact spectral scaling 1 / ||sqrt(T) C||_2^2 (provably
      convergent for any geometry);
    - 2.0 (default): overstep beyond the provable bound. Diverges in
      general (3.0 measured to 2-cycle on an adversarial battery) but is
      validated CONVERGENT for both packaged site geometries by the
      adversarial stress test (tests/test_evcharging.py
      test_dual_projection_stress_battery) and roughly halves the
      iterations needed for a given accuracy.
    """
    if not restart and step_scale is not None and step_scale > 1.0:
        # the overstep is only validated stable WITH gradient restart (see
        # docstring); without it the 2x step can 2-cycle on adversarial
        # batteries — fall back to the provable spectral step instead of
        # silently building a divergent projector
        import warnings
        warnings.warn(
            f"make_dual_soc_projection: step_scale={step_scale} without "
            f"restart is not validated stable; falling back to the provable "
            f"spectral step (step_scale=None). Pass step_scale explicitly "
            f"<= 1.0 to silence.", stacklevel=2)
        step_scale = None
    C = _interleaved_C(constraint_matrix, phase_angles_deg)
    m = C.shape[0] // 2
    radii = np.asarray(magnitudes, dtype=np.float64) / action_scale
    G = np.abs(C @ C.T)
    t = 1.0 / np.maximum(G.reshape(m, 2, 2 * m).sum(-1).max(-1), 1e-12)
    if step_scale is None:
        sqT = np.sqrt(np.repeat(t, 2))
        t = t / (np.linalg.norm(sqT[:, None] * C, 2) ** 2)
    else:
        t = t * float(step_scale)
    return DualSOCProjection(
        C=jnp.asarray(C, dtype), radii=jnp.asarray(radii, dtype),
        step=jnp.asarray(t, dtype), n=int(C.shape[1]), m=int(m),
        iters=int(iters), restart=bool(restart),
        inner_bf16=bool(inner_bf16))


def _ball_project(v: jax.Array, radii: jax.Array) -> jax.Array:
    """Projects interleaved (re, im) pairs onto balls of given radii.

    v: (..., 2m) -> same shape.
    """
    shape = v.shape
    pairs = v.reshape(*shape[:-1], -1, 2)
    norm = jnp.sqrt(jnp.sum(pairs * pairs, axis=-1) + 1e-12)
    scale = jnp.minimum(1.0, radii / norm)
    return (pairs * scale[..., None]).reshape(shape)


def _dot(u: jax.Array, mat: jax.Array) -> jax.Array:
    """Both operators' float32 products, at full float32 (module
    docstring)."""
    return jnp.matmul(u, mat, precision=jax.lax.Precision.HIGHEST)


def _project_admm(op: SOCProjection, a: jax.Array, ub: jax.Array
                  ) -> jax.Array:
    rho = op.rho
    x = jnp.clip(a, 0.0, ub)
    z0 = x
    u0 = jnp.zeros_like(x)
    # float32-pinned matmuls (_dot): at reduced matmul precision the ADMM
    # dual accumulators integrate the rounding noise and the iteration
    # stalls ~0.9 away from the true projection (tools/proj_experiment.py)
    zc = _dot(x, op.C.T)
    uc = jnp.zeros_like(zc)

    alpha = op.alpha

    def body(_, carry):
        x, z0, u0, zc, uc = carry
        rhs = a + rho * (z0 - u0) + rho * _dot(zc - uc, op.C)
        x = _dot(rhs, op.K.T)
        cx = _dot(x, op.C.T)
        # over-relaxed consensus updates
        xh = alpha * x + (1.0 - alpha) * z0
        cxh = alpha * cx + (1.0 - alpha) * zc
        z0 = jnp.clip(xh + u0, 0.0, ub)
        zc = _ball_project(cxh + uc, op.radii)
        u0 = u0 + xh - z0
        uc = uc + cxh - zc
        return (x, z0, u0, zc, uc)

    x, z0, u0, zc, uc = jax.lax.fori_loop(
        0, op.iters, body, (x, z0, u0, zc, uc))
    # final feasibility polish: return the box-feasible iterate
    return jnp.clip(x, 0.0, ub)


def _project_dual(op: DualSOCProjection, a: jax.Array, ub: jax.Array
                  ) -> jax.Array:
    """FISTA on the dual  min_lam  f*(-C' lam) + sum_k r_k ||lam_k||
    with f(x) = 1/2 ||x - a||^2 + I_box(x):
        xbar      = clip(a - C' y, 0, ub)          (= grad f* at -C'y)
        lam_new   = blockshrink(y + T C xbar, T r)
        y         = lam_new + beta (lam_new - lam) (gradient-restart Nesterov)
    """
    batch = a.shape[:-1]
    dtype = a.dtype
    lam = jnp.zeros(batch + (2 * op.m,), dtype)
    lam_prev = lam
    tk = jnp.ones(batch, dtype)
    t2 = jnp.repeat(op.step, 2)
    tr = op.step * op.radii
    if op.inner_bf16:
        # the loop is HBM-bound re-reading a/ub and materializing the
        # (batch, n) xbar every iteration: keep the whole x-space chain in
        # bfloat16 (the cast must be INSIDE the elementwise chain — a
        # loop-invariant bf16->f32 pre-cast just gets hoisted back out by
        # XLA). The dual iterates and dot accumulations stay f32, and the
        # final clip below uses the exact f32 a/ub. Requires restart=True:
        # the 2.0x overstep is only stable with gradient restart
        # (divergence on the stress battery without it, bf16 or not).
        a_in = a.astype(jnp.bfloat16)
        ub_in = jnp.asarray(ub, a.dtype).astype(jnp.bfloat16)
        C16 = op.C.astype(jnp.bfloat16)
    else:
        a_in, ub_in = a, ub

    def shrink(w):
        pairs = w.reshape(*w.shape[:-1], op.m, 2)
        nr = jnp.sqrt(jnp.sum(pairs * pairs, -1) + 1e-12)
        sc = jnp.maximum(0.0, 1.0 - tr / nr)
        return (pairs * sc[..., None]).reshape(w.shape)

    def body(_, carry):
        lam, lam_prev, tk = carry
        tk1 = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * tk * tk))
        beta = (tk - 1.0) / tk1
        y = lam + beta[..., None] * (lam - lam_prev)
        ydot = _dot(y, op.C)
        if op.inner_bf16:
            # bf16 operands: exact products, f32 accumulation
            xbar = jnp.clip(a_in - ydot.astype(jnp.bfloat16),
                            jnp.bfloat16(0), ub_in)
            cx = jax.lax.dot_general(
                xbar, C16.T, (((xbar.ndim - 1,), (0,)), ((), ())),
                precision=jax.lax.Precision.DEFAULT,
                preferred_element_type=dtype)
        else:
            xbar = jnp.clip(a_in - ydot, 0.0, ub_in)
            cx = _dot(xbar, op.C.T)
        lam_new = shrink(y + t2 * cx)
        if op.restart:
            # gradient restart (O'Donoghue & Candes): momentum reset when
            # the step moves against the previous direction
            prog = jnp.sum((lam_new - lam) * (lam - lam_prev), -1)
            tk1 = jnp.where(prog < 0.0, 1.0, tk1)
        return (lam_new, lam, tk1)

    lam, _, _ = jax.lax.fori_loop(0, op.iters, body, (lam, lam_prev, tk))
    return jnp.clip(a - _dot(lam, op.C), 0.0, ub)


def project(op, a: jax.Array, ub: jax.Array) -> jax.Array:
    """Projects ``a`` onto {0 <= x <= ub} ∩ {||C_k x|| <= r_k}.

    Works on single vectors (n,) or batches (..., n); everything is
    elementwise/matmul so vmap/pjit are trivial. Dispatches on the operator
    type (DualSOCProjection -> FISTA, SOCProjection -> ADMM).
    """
    if isinstance(op, DualSOCProjection):
        return _project_dual(op, a, ub)
    return _project_admm(op, a, ub)
