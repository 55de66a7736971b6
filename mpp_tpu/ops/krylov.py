"""Krylov linear solvers: CG, BiCGStab, GMRES(m) — the KSP replacement.

Replaces PETSc KSP (``soe/SystemOfEquationsBaseType.F90:555-647`` consumes
KSPSolve) with pure-JAX iterations built on ``lax.while_loop`` so they jit
on the CPU and the GPU.  All solvers take a ``matvec`` closure (CSR SpMV, batched
tridiagonal, or dense) and an optional left preconditioner ``M`` (a
closure y = M^{-1} r).

Convergence: ||r||_2 <= max(rtol*||b||_2, atol), PETSc
KSPConvergedDefault semantics.  The reference's regression answers were
produced with solves that converged to machine precision on its small
systems, so the default rtol here is tight (1e-12).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

HIGHEST = lax.Precision.HIGHEST


class KrylovResult(NamedTuple):
    x: jnp.ndarray
    iters: jnp.ndarray
    resnorm: jnp.ndarray
    converged: jnp.ndarray


def _identity(r):
    return r


def cg(matvec: Callable, b: jnp.ndarray, x0: Optional[jnp.ndarray] = None,
       M: Optional[Callable] = None, rtol: float = 1e-12, atol: float = 0.0,
       maxiter: int = 10000) -> KrylovResult:
    """Preconditioned conjugate gradients for SPD systems."""
    M = M or _identity
    x0 = jnp.zeros_like(b) if x0 is None else x0
    bnorm = jnp.linalg.norm(b)
    tol = jnp.maximum(rtol * bnorm, atol)

    r0 = b - matvec(x0)
    z0 = M(r0)
    p0 = z0
    rz0 = jnp.vdot(r0, z0, precision=HIGHEST)

    def cond(state):
        x, r, p, rz, k = state
        return jnp.logical_and(jnp.linalg.norm(r) > tol, k < maxiter)

    def body(state):
        x, r, p, rz, k = state
        Ap = matvec(p)
        alpha = rz / jnp.vdot(p, Ap, precision=HIGHEST)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = jnp.vdot(r, z, precision=HIGHEST)
        beta = rz_new / rz
        p = z + beta * p
        return (x, r, p, rz_new, k + 1)

    x, r, p, rz, k = lax.while_loop(cond, body, (x0, r0, p0, rz0, 0))
    rn = jnp.linalg.norm(r)
    return KrylovResult(x=x, iters=k, resnorm=rn, converged=rn <= tol)


def bicgstab(matvec: Callable, b: jnp.ndarray,
             x0: Optional[jnp.ndarray] = None, M: Optional[Callable] = None,
             rtol: float = 1e-12, atol: float = 0.0,
             maxiter: int = 10000) -> KrylovResult:
    """Preconditioned BiCGStab for general (nonsymmetric) systems."""
    M = M or _identity
    x0 = jnp.zeros_like(b) if x0 is None else x0
    bnorm = jnp.linalg.norm(b)
    tol = jnp.maximum(rtol * bnorm, atol)

    r0 = b - matvec(x0)
    rhat = r0
    eps = jnp.finfo(b.dtype).tiny

    def cond(state):
        x, r, p, v, rho, alpha, omega, k = state
        return jnp.logical_and(jnp.linalg.norm(r) > tol, k < maxiter)

    def body(state):
        x, r, p, v, rho, alpha, omega, k = state
        rho_new = jnp.vdot(rhat, r, precision=HIGHEST)
        beta = (rho_new / jnp.where(rho == 0, eps, rho)) * (
            alpha / jnp.where(omega == 0, eps, omega))
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = matvec(phat)
        alpha = rho_new / jnp.vdot(rhat, v, precision=HIGHEST)
        s = r - alpha * v
        shat = M(s)
        t = matvec(shat)
        tt = jnp.vdot(t, t, precision=HIGHEST)
        omega = (jnp.vdot(t, s, precision=HIGHEST)
                 / jnp.where(tt == 0, eps, tt))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        return (x, r, p, v, rho_new, alpha, omega, k + 1)

    zeros = jnp.zeros_like(b)
    one = jnp.ones((), b.dtype)
    x, r, p, v, rho, alpha, omega, k = lax.while_loop(
        cond, body, (x0, r0, zeros, zeros, one, one, one, 0))
    rn = jnp.linalg.norm(r)
    return KrylovResult(x=x, iters=k, resnorm=rn, converged=rn <= tol)


def gmres(matvec: Callable, b: jnp.ndarray, x0: Optional[jnp.ndarray] = None,
          M: Optional[Callable] = None, restart: int = 30,
          rtol: float = 1e-12, atol: float = 0.0,
          maxiter: int = 1000) -> KrylovResult:
    """Left-preconditioned restarted GMRES(m) with modified Gram-Schmidt.

    ``maxiter`` counts outer restarts.
    """
    M = M or _identity
    x0 = jnp.zeros_like(b) if x0 is None else x0
    n = b.shape[0]
    m = min(restart, n)
    dtype = b.dtype
    Mb = M(b)
    bnorm = jnp.linalg.norm(Mb)
    tol = jnp.maximum(rtol * bnorm, atol)

    def inner(x):
        r = M(b - matvec(x))
        beta = jnp.linalg.norm(r)
        V = jnp.zeros((m + 1, n), dtype).at[0].set(
            r / jnp.where(beta == 0, 1.0, beta))
        H = jnp.zeros((m + 1, m), dtype)
        # Givens rotation accumulators
        cs = jnp.zeros(m, dtype)
        sn = jnp.zeros(m, dtype)
        g = jnp.zeros(m + 1, dtype).at[0].set(beta)

        def arnoldi_step(j, carry):
            V, H, cs, sn, g, done = carry
            w = M(matvec(V[j]))
            # modified Gram-Schmidt against v_0..v_j
            def mgs(i, wh):
                w, h = wh
                hij = jnp.where(i <= j,
                                jnp.vdot(V[i], w, precision=HIGHEST), 0.0)
                w = w - hij * V[i]
                h = h.at[i].set(hij)
                return (w, h)
            w, hcol = lax.fori_loop(0, m + 1, mgs, (w, jnp.zeros(m + 1, dtype)))
            hlast = jnp.linalg.norm(w)
            hcol = hcol.at[j + 1].set(hlast)
            V = V.at[j + 1].set(w / jnp.where(hlast == 0, 1.0, hlast))
            # apply existing Givens rotations to the new column
            def rot(i, hc):
                t = cs[i] * hc[i] + sn[i] * hc[i + 1]
                hc = hc.at[i + 1].set(-sn[i] * hc[i] + cs[i] * hc[i + 1])
                return jnp.where(i < j, hc.at[i].set(t), hc)
            hcol = lax.fori_loop(0, m, rot, hcol)
            # new rotation to zero hcol[j+1]
            denom = jnp.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            denom = jnp.where(denom == 0, 1.0, denom)
            c, s = hcol[j] / denom, hcol[j + 1] / denom
            hcol = hcol.at[j].set(c * hcol[j] + s * hcol[j + 1]).at[j + 1].set(0.0)
            cs = cs.at[j].set(c)
            sn = sn.at[j].set(s)
            g = g.at[j + 1].set(-s * g[j]).at[j].set(c * g[j])
            H = H.at[:, j].set(hcol[:m + 1])
            done = jnp.abs(g[j + 1]) <= tol
            return (V, H, cs, sn, g, done)

        def astep(j, carry):
            # run every step (static m); steps after convergence are harmless
            return arnoldi_step(j, carry)

        V, H, cs, sn, g, done = lax.fori_loop(
            0, m, astep, (V, H, cs, sn, g, jnp.array(False)))

        # back-substitution  H[:m,:m] y = g[:m]  (upper triangular)
        def backsub(i, y):
            j = m - 1 - i
            num = g[j] - jnp.dot(H[j, :], y, precision=HIGHEST)
            hjj = H[j, j]
            y = y.at[j].set(num / jnp.where(hjj == 0, 1.0, hjj))
            return y
        y = lax.fori_loop(0, m, backsub, jnp.zeros(m, dtype))
        dx = jnp.einsum("i,in->n", y, V[:m], precision=HIGHEST)
        return x + dx

    def cond(state):
        x, k = state
        r = M(b - matvec(x))
        return jnp.logical_and(jnp.linalg.norm(r) > tol, k < maxiter)

    def body(state):
        x, k = state
        return (inner(x), k + 1)

    x, k = lax.while_loop(cond, body, (x0, 0))
    rn = jnp.linalg.norm(M(b - matvec(x)))
    return KrylovResult(x=x, iters=k, resnorm=rn, converged=rn <= tol)


def jacobi_preconditioner(diag: jnp.ndarray) -> Callable:
    inv = 1.0 / diag
    return lambda r: inv * r


def dense_solve(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Direct dense solve — exact answer for small systems."""
    return jnp.linalg.solve(A, b)
