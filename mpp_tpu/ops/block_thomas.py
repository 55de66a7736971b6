"""Batched block-tridiagonal solver (block Thomas algorithm).

The reference's canopy systems are block-tridiagonal per column once the
unknowns are grouped by level: MLC couples [T_air, q_air, T_leaf...] at
each canopy level to the adjacent levels only (the 4-block DMComposite
fill of ``soe/SystemOfEquationsMLCType.F90:333-455`` has no couplings
beyond level k±1), and the radiation two-stream systems couple [Iup, Idn]
between adjacent layers (``ge/GoveqnShortwave.F90:421-560``).  PETSc
solves them with GMRES+ILU(0); here the exact block LU sweep is both
faster and deterministic: each scan step is an [ncol, m, m] batched
small-matrix factor/solve, with columns as the batch axis.

All functions are pure jnp, jit/vmap/shard_map compatible.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def block_thomas(L, D, U, b):
    """Solve batched block-tridiagonal systems.

    Args:
      L: [..., n, m, m] sub-diagonal blocks (L[..., 0, :, :] unused)
      D: [..., n, m, m] diagonal blocks
      U: [..., n, m, m] super-diagonal blocks (U[..., n-1] unused)
      b: [..., n, m]    right-hand side
    Returns x with shape [..., n, m].

    Forward elimination with dense [m, m] solves per level (m is small:
    2-8 for the canopy systems), then back-substitution; both are
    ``lax.scan`` over levels with the batch axes vectorized.

    The tiny matmuls run at HIGHEST precision: a reduced-precision
    default (bf16 passes, or TF32 on a GPU) loses ~3 decimal digits per
    level and visibly corrupts the recurrence over ~100 levels; at m<=8
    full f32 costs nothing.
    """
    with jax.default_matmul_precision("highest"):
        return _block_thomas_impl(L, D, U, b)


def small_solve(A, B):
    """Solve A @ X = B for batched tiny blocks: A [..., m, m],
    B [..., m, k] with m static and small.

    ``jnp.linalg.solve`` lowers each solve to a pivoted LAPACK-style LU
    whose row-pivot loop serializes per level; here m<=2 uses the
    closed-form adjugate (no pivoting: the blocks must be
    well-conditioned, as the diagonally dominant TH, canopy and
    radiation blocks are) and
    3<=m<=8 an UNROLLED Gauss-Jordan with per-batch partial pivoting
    (m static steps of vectorized ops: argmax + take_along_axis row
    swap, rank-1 elimination).  Larger m falls back to linalg.solve.
    """
    m = A.shape[-1]
    if m == 1:
        return B / A[..., 0:1, :]
    if m == 2:
        a, b_ = A[..., 0, 0], A[..., 0, 1]
        c, d = A[..., 1, 0], A[..., 1, 1]
        det = a * d - b_ * c
        x0 = d[..., None] * B[..., 0, :] - b_[..., None] * B[..., 1, :]
        x1 = -c[..., None] * B[..., 0, :] + a[..., None] * B[..., 1, :]
        return jnp.stack([x0, x1], axis=-2) / det[..., None, None]
    if m > 8:
        return jnp.linalg.solve(A, B)
    M = jnp.concatenate([A, B], axis=-1)            # [..., m, m+k]
    rows = jnp.arange(m)
    for j in range(m):
        # partial pivot: the largest |entry| in column j at row >= j
        colj = jnp.abs(M[..., :, j])
        colj = jnp.where(rows >= j, colj, -jnp.inf)
        p = jnp.argmax(colj, axis=-1)               # [...]
        idx = jnp.where(rows == j, p[..., None],
                        jnp.where(rows == p[..., None], j, rows))
        M = jnp.take_along_axis(M, idx[..., None], axis=-2)
        piv = M[..., j, :]                          # [..., m+k]
        fac = M[..., :, j] / piv[..., j][..., None]
        fac = jnp.where(rows == j, 0.0, fac)        # keep row j
        M = M - fac[..., None] * piv[..., None, :]
    diag = jnp.diagonal(M[..., :m], axis1=-2, axis2=-1)
    return M[..., m:] / diag[..., None]


def _block_thomas_impl(L, D, U, b):
    # move level axis to front for scan: [n, ..., m, m]
    nd = b.ndim
    Lt = jnp.moveaxis(L, nd - 2, 0)
    Dt = jnp.moveaxis(D, nd - 2, 0)
    Ut = jnp.moveaxis(U, nd - 2, 0)
    bt = jnp.moveaxis(b, nd - 2, 0)

    m = b.shape[-1]
    eye = jnp.eye(m, dtype=b.dtype)

    def fwd(carry, inp):
        Cp_prev, dp_prev = carry              # [..., m, m], [..., m]
        L_k, D_k, U_k, b_k = inp
        denom = D_k - L_k @ Cp_prev
        rhs = jnp.concatenate(
            [U_k, (b_k - (L_k @ dp_prev[..., None])[..., 0])[..., None]],
            axis=-1)
        sol = small_solve(denom, rhs)         # [..., m, m+1]
        Cp = sol[..., :m]
        dp = sol[..., m]
        return (Cp, dp), (Cp, dp)

    zC = jnp.zeros_like(Dt[0]) + 0.0 * eye
    zd = jnp.zeros_like(bt[0])
    (_, _), (Cp, dp) = lax.scan(fwd, (zC, zd), (Lt, Dt, Ut, bt))

    def back(x_next, inp):
        Cp_k, dp_k = inp
        x = dp_k - (Cp_k @ x_next[..., None])[..., 0]
        return x, x

    _, x_rev = lax.scan(back, zd, (Cp, dp), reverse=True)
    return jnp.moveaxis(x_rev, 0, nd - 2)


def block_tridiag_matvec(L, D, U, x):
    """y = T x for batched block-tridiagonal T.

    Shapes as in :func:`block_thomas`; x is [..., n, m].  Full f32
    precision (no TF32 products), as in :func:`block_thomas`.
    """
    with jax.default_matmul_precision("highest"):
        return _block_tridiag_matvec_impl(L, D, U, x)


def _block_tridiag_matvec_impl(L, D, U, x):
    y = (D @ x[..., None])[..., 0]
    lo = (L[..., 1:, :, :] @ x[..., :-1, :, None])[..., 0]
    hi = (U[..., :-1, :, :] @ x[..., 1:, :, None])[..., 0]
    y = y.at[..., 1:, :].add(lo)
    y = y.at[..., :-1, :].add(hi)
    return y
