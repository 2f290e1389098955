"""Batched fixed-iteration LP solver (PDHG / Chambolle-Pock) with duals.

Built for the ElectricityMarketEnv SCED clearing solve
(docs spec: /root/reference/docs/electricitymarketenv.md:3,18 — every 5-min
step the market operator solves a multi-timestep security-constrained
economic dispatch and the clearing PRICE is the dual of the power-balance
constraint). Interior-point/simplex solvers are control-flow-heavy and
host-bound; PDHG is pure matvecs with a deterministic iteration count, so
thousands of market instances clear in lockstep as batched matrix products
(BASELINE.json config: "batch 4096").

Problem form:
    minimize    c' x
    subject to  A x = b          (duals y -> prices)
                S x <= h_p  and  -S x <= h_m   (paired rows, optional)
                G x <= h_rest    (duals z >= 0)
                lb <= x <= ub

Iteration (with over-relaxation \bar{x} and diagonal step sizes):
    x+ = clip(x - tau * (c + A' y + S'(z_p - z_m) + G' z), lb, ub)
    y+ = y + sigma_A * (A (2 x+ - x) - b)
    z+ = max(0, z + sigma * (rows (2 x+ - x) - h))

The paired block exists because SCED line-flow limits are two-sided:
|PTDF x| <= rating contributes rows +S and -S. Solving the stacked form
computes S x twice per iteration; here the matvec is shared, which removes
~half the rows from the (batch, rows) x (rows, n) matmuls. Mathematically
the iterates are those of plain PDHG on the stacked matrix [A; S; -S; G]
up to float reassociation (same preconditioner, same step sizes —
|−S| = |S| row/col sums).

``matmul`` sets the precision of every matrix product in the iteration:
``"f32"`` (default, the reference solve) asks for full float32 products
(``Precision.HIGHEST``); ``"tf32"`` leaves float32 products at the
backend's DEFAULT precision, which is TF32 on an NVIDIA GPU and full
float32 on a CPU. Iterates and duals stay float32 in both modes.
Validated against scipy HiGHS duals in tests/test_electricitymarket.py
and ``sustaingym_tpu.checks``.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.struct import dataclass, static_field

__all__ = ["LPOperator", "make_lp_operator", "solve_lp", "LPSolution",
           "MATMUL_PRECISIONS"]

# matrix-product precision modes of the PDHG iteration (module docstring)
_PRECISION = {"f32": jax.lax.Precision.HIGHEST,
              "tf32": jax.lax.Precision.DEFAULT}
MATMUL_PRECISIONS = tuple(_PRECISION)


@dataclass
class LPOperator:
    """Static problem structure with host-precomputed step sizes.

    The [A; S; G] blocks are kept SEPARATE (not stacked) and the iteration
    runs one matmul per non-empty block, so the dual vector is never
    concatenated or sliced inside the loop.
    """
    A: jax.Array        # (me, n) equality rows
    S: jax.Array        # (ms, n) paired block: +/- S x <= (h_p, h_m)
    G: jax.Array        # (mg, n) residual one-sided rows
    tau: jax.Array      # (n,) primal step
    sigma_a: jax.Array  # (me,) dual step (equalities)
    sigma_s: jax.Array  # (ms,) dual step (paired rows; same for +/-)
    sigma_g: jax.Array  # (mg,) dual step (residual rows)
    n: int = static_field()
    me: int = static_field()
    ms: int = static_field(default=0)   # paired rows (each yields +/-)
    mg: int = static_field(default=0)   # residual one-sided rows
    iters: int = static_field(default=400)
    # matrix-product precision: "f32" | "tf32" (module docstring)
    matmul: str = static_field(default="f32")
    # over-relaxation on the full PDHG operator (z+ = z + rho (T z - z)):
    # PDHG is averaged nonexpansive, so any rho < 2 converges; 1.0 = plain
    relax: float = static_field(default=1.0)
    # stacked [A; S] and its transpose for the merged-matmul iteration
    # (one matmul for grad, one for both dual residuals): None when
    # mg > 0 or either block is empty
    AS: jax.Array | None = None
    AS_T: jax.Array | None = None
    # run the merged iteration (requires AS/AS_T; numerically identical
    # iterates up to float reassociation)
    merge_blocks: bool = static_field(default=False)

    @property
    def mi(self) -> int:
        """Total inequality-dual length: [z_plus(ms), z_minus(ms), z(mg)]."""
        return 2 * self.ms + self.mg


class LPSolution(NamedTuple):
    x: jax.Array   # primal
    y: jax.Array   # equality duals (prices)
    z: jax.Array   # inequality duals, ordered [z_plus(ms), z_minus(ms), z(mg)]


def make_lp_operator(A: np.ndarray, G: np.ndarray, iters: int = 400,
                     dtype=jnp.float32, sym: np.ndarray | None = None,
                     matmul: str = "f32", relax: float = 1.0,
                     precond_alpha: float = 1.0,
                     merge_blocks: bool = False) -> LPOperator:
    """Builds the operator with diagonal (Pock-Chambolle) preconditioning:
    tau_j = 1 / sum_i |K_ij|^(2-alpha), sigma_i = 1 / sum_j |K_ij|^alpha
    (Pock & Chambolle 2011, thm. 1 — convergent for any alpha in [0, 2];
    alpha trades primal vs dual step aggressiveness and is geometry-tuned).

    ``sym`` (ms, n), if given, adds the two-sided rows ±sym x <= (h_p, h_m);
    ``G`` keeps only the residual one-sided rows. The preconditioner is
    computed over the fully stacked K = [A; sym; -sym; G], so the iterates
    match plain PDHG on that stacked system.
    """
    A = np.atleast_2d(np.asarray(A, np.float64))
    G = np.atleast_2d(np.asarray(G, np.float64))
    if G.size == 0:
        G = G.reshape(0, A.shape[1])
    S = (np.zeros((0, A.shape[1])) if sym is None
         else np.atleast_2d(np.asarray(sym, np.float64)))
    K = np.vstack([A, S, -S, G])
    a_exp = float(precond_alpha)
    col = (np.abs(K) ** (2.0 - a_exp)).sum(axis=0)
    tau = 1.0 / np.maximum(col, 1e-6)

    def row_sigma(Mat):
        return 1.0 / np.maximum((np.abs(Mat) ** a_exp).sum(axis=1), 1e-6)

    if matmul not in MATMUL_PRECISIONS:
        raise ValueError(f"matmul must be one of {MATMUL_PRECISIONS}, "
                         f"got {matmul!r}")
    merged = bool(merge_blocks and A.shape[0] and S.shape[0]
                  and not G.shape[0])
    AS = np.vstack([A, S]) if merged else None
    return LPOperator(
        A=jnp.asarray(A, dtype), S=jnp.asarray(S, dtype),
        G=jnp.asarray(G, dtype),
        tau=jnp.asarray(tau, dtype),
        sigma_a=jnp.asarray(row_sigma(A), dtype),
        sigma_s=jnp.asarray(row_sigma(S), dtype),
        sigma_g=jnp.asarray(row_sigma(G), dtype),
        AS=None if AS is None else jnp.asarray(AS, dtype),
        AS_T=None if AS is None else jnp.asarray(AS.T.copy(), dtype),
        merge_blocks=merged,
        n=A.shape[1], me=A.shape[0], ms=S.shape[0], mg=G.shape[0],
        iters=int(iters), matmul=matmul, relax=float(relax))


def solve_lp(op: LPOperator, c: jax.Array, b: jax.Array, h: jax.Array,
             lb: jax.Array, ub: jax.Array,
             init: LPSolution | None = None,
             iters: jax.Array | int | None = None) -> LPSolution:
    """Solves one LP (or a batch: all args broadcast over leading dims).

    ``h`` is ordered [h_plus(ms), h_minus(ms), h_rest(mg)] when the operator
    has a paired block; the returned ``z`` follows the same ordering.

    ``init`` warm-starts the primal/dual iterates — for sequences of
    slowly-varying problems (receding-horizon SCED: each 5-min step shifts
    the horizon one interval) this cuts the iterations needed for a given
    tolerance several-fold.

    ``iters`` overrides ``op.iters`` and may be a TRACED scalar (e.g.
    cold-vs-warm budgets selected on episode step): the fori_loop then
    lowers to a while loop instead of being unrolled/scanned, which costs
    nothing here (the body is matmul-dominated).
    """
    me, ms, mg = op.me, op.ms, op.mg
    if init is None:
        x = jnp.clip(jnp.zeros_like(c), lb, ub)
        y = jnp.zeros_like(b)
        z = jnp.zeros_like(h)
    else:
        x = jnp.clip(init.x, lb, ub)
        y = init.y
        z = jnp.maximum(init.z, 0.0)

    h_p = h[..., :ms]
    h_m = h[..., ms:2 * ms]
    h_g = h[..., 2 * ms:]
    def matmul(u, mat):
        return jax.lax.dot_general(
            u, mat, (((u.ndim - 1,), (0,)), ((), ())),
            precision=_PRECISION[op.matmul],
            preferred_element_type=jnp.result_type(u.dtype, mat.dtype))

    # the dual blocks stay SEPARATE carry elements with one matmul each
    rho = op.relax

    merged = op.merge_blocks

    def body(_, carry):
        x, y, zp, zm, zg = carry
        if merged:
            # ONE matmul for the gradient and ONE for both dual
            # residuals instead of one per block. Iterates are identical
            # up to float reassociation.
            yz = jnp.concatenate([y, zp - zm], axis=-1)
            grad = c + matmul(yz, op.AS)
        else:
            grad = c
            if me:
                grad = grad + matmul(y, op.A)
            if ms:
                grad = grad + matmul(zp - zm, op.S)
            if mg:
                grad = grad + matmul(zg, op.G)
        x_new = jnp.clip(x - op.tau * grad, lb, ub)
        x_bar = 2.0 * x_new - x
        if merged:
            t = matmul(x_bar, op.AS_T)      # (B, me + ms)
            y_new = y + op.sigma_a * (t[..., :me] - b)
            s = t[..., me:]
            zp_new = jnp.maximum(0.0, zp + op.sigma_s * (s - h_p))
            zm_new = jnp.maximum(0.0, zm + op.sigma_s * (-s - h_m))
            zg_new = zg
        else:
            if me:
                y_new = y + op.sigma_a * (matmul(x_bar, op.A.T) - b)
            else:
                y_new = y
            if ms:
                s = matmul(x_bar, op.S.T)       # shared +/- matvec
                zp_new = jnp.maximum(0.0, zp + op.sigma_s * (s - h_p))
                zm_new = jnp.maximum(0.0, zm + op.sigma_s * (-s - h_m))
            else:
                zp_new, zm_new = zp, zm
            if mg:
                zg_new = jnp.maximum(0.0, zg + op.sigma_g * (
                    matmul(x_bar, op.G.T) - h_g))
            else:
                zg_new = zg
        if rho != 1.0:
            # Relaxed combination of the previous and new iterates. NOTE:
            # the extra re-projection below (maximum(0,.) on duals, clip on
            # x) makes this a HEURISTIC variant, not the plain
            # Krasnosel'skii-Mann iteration of the averaged PDHG operator —
            # the textbook "any rho in (0,2) converges" guarantee does not
            # strictly apply for rho > 1. Dead by default (rho=1.0) and
            # measured no-gain; kept only for experimentation.
            x_new = x + rho * (x_new - x)
            y_new = y + rho * (y_new - y)
            zp_new = jnp.maximum(0.0, zp + rho * (zp_new - zp)) if ms else zp
            zm_new = jnp.maximum(0.0, zm + rho * (zm_new - zm)) if ms else zm
            zg_new = jnp.maximum(0.0, zg + rho * (zg_new - zg)) if mg else zg
            x_new = jnp.clip(x_new, lb, ub)
        return (x_new, y_new, zp_new, zm_new, zg_new)

    carry0 = (x, y, z[..., :ms], z[..., ms:2 * ms], z[..., 2 * ms:])
    n_iters = op.iters if iters is None else iters
    x, y, zp, zm, zg = jax.lax.fori_loop(0, n_iters, body, carry0)
    return LPSolution(x=x, y=y,
                      z=jnp.concatenate([zp, zm, zg], axis=-1))
