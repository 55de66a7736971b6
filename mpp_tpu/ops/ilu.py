"""ILU(0) preconditioner and PETSc-default-compatible GMRES (numpy path).

The reference's KSP problems are solved by PETSc's defaults: GMRES(30),
left-preconditioned with ILU(0) in natural ordering, classical
Gram-Schmidt, rtol=1e-5/atol=1e-50, zero initial guess
(``MultiPhysicsProbBaseType.F90:1309-1317`` sets nothing beyond defaults).
Its golden regression answers therefore embed the *iterate* GMRES stops
at.  This module replicates that algorithm deterministically in f64 so our
answers agree with the goldens to the printed 13 digits.

This numpy implementation is the correctness/regression path (small
serial systems).  The batched production path uses batched per-column
tridiagonal factorizations (for which ILU(0) is the exact LU) and the
JAX Krylov solvers in ``ops/krylov.py``.
"""
from __future__ import annotations

import numpy as np


class CSRMatrix:
    """Minimal CSR container for the numpy solver path."""

    def __init__(self, n, indptr, indices, data):
        self.n = n
        self.indptr = np.asarray(indptr, np.int64)
        self.indices = np.asarray(indices, np.int64)
        self.data = np.asarray(data, np.float64)

    def matvec(self, x):
        y = np.zeros(self.n)
        for i in range(self.n):
            s = 0.0
            for p in range(self.indptr[i], self.indptr[i + 1]):
                s += self.data[p] * x[self.indices[p]]
            y[i] = s
        return y

    def matvec_fast(self, x):
        prod = self.data * x[self.indices]
        return np.add.reduceat(
            np.concatenate([prod, [0.0]]),
            self.indptr[:-1])* (np.diff(self.indptr) > 0)


def csr_matvec(indptr, indices, data, x):
    """Row-major CSR SpMV with per-row left-to-right accumulation —
    the same op order as PETSc's MatMult_SeqAIJ."""
    n = len(indptr) - 1
    y = np.empty(n)
    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        y[i] = np.dot(data[lo:hi], x[indices[lo:hi]])
    return y


class ILU0:
    """ILU(0) in natural ordering on a fixed CSR sparsity (PETSc PCILU
    defaults: levels=0, no shift, natural ordering).

    Symbolic phase precomputes, per row i and each lower entry (i,k), the
    aligned column pairs between row i and row k used in the IKJ update.
    """

    def __init__(self, indptr, indices):
        self.indptr = np.asarray(indptr, np.int64)
        self.indices = np.asarray(indices, np.int64)
        self.n = len(indptr) - 1
        n = self.n
        # per-row sorted assumed (csr_template produces sorted columns)
        self.diag_pos = np.empty(n, np.int64)
        for i in range(n):
            lo, hi = self.indptr[i], self.indptr[i + 1]
            cols = self.indices[lo:hi]
            d = np.searchsorted(cols, i)
            if d == hi - lo or cols[d] != i:
                raise ValueError(f"row {i} missing diagonal")
            self.diag_pos[i] = lo + d
        # schedule: list over rows of (pos_ik, diag_k, [(pos_ij, pos_kj)...])
        sched = []
        for i in range(n):
            lo, hi = self.indptr[i], self.indptr[i + 1]
            row_updates = []
            for p in range(lo, hi):
                k = self.indices[p]
                if k >= i:
                    break
                klo, khi = self.indptr[k], self.indptr[k + 1]
                kcols = self.indices[klo:khi]
                pairs = []
                for q in range(p + 1, hi):
                    j = self.indices[q]
                    r = np.searchsorted(kcols, j)
                    if r < khi - klo and kcols[r] == j and j > k:
                        pairs.append((q, klo + r))
                row_updates.append((p, self.diag_pos[k],
                                    np.array(pairs, np.int64).reshape(-1, 2)))
            sched.append(row_updates)
        self.schedule = sched

    def factor(self, data):
        """Numeric IKJ factorization; returns LU values on the sparsity."""
        f = np.array(data, np.float64, copy=True)
        for row_updates in self.schedule:
            for pos_ik, diag_k, pairs in row_updates:
                m = f[pos_ik] / f[diag_k]
                f[pos_ik] = m
                if len(pairs):
                    f[pairs[:, 0]] -= m * f[pairs[:, 1]]
        return f

    def solve(self, f, b):
        """(LU)^-1 b: unit-lower forward solve then upper back solve."""
        n = self.n
        y = np.array(b, np.float64, copy=True)
        indptr, indices, diag = self.indptr, self.indices, self.diag_pos
        for i in range(n):
            lo = indptr[i]
            d = diag[i]
            if d > lo:
                y[i] -= np.dot(f[lo:d], y[indices[lo:d]])
        x = y
        for i in range(n - 1, -1, -1):
            d = diag[i]
            hi = indptr[i + 1]
            if hi > d + 1:
                x[i] -= np.dot(f[d + 1:hi], x[indices[d + 1:hi]])
            x[i] /= f[d]
        return x


def petsc_gmres(indptr, indices, data, b, pc: ILU0 = None, pc_data=None,
                rtol=1e-5, atol=1e-50, restart=30, maxiter=10000):
    """GMRES(m) replicating PETSc KSPGMRES defaults.

    Left preconditioning, classical Gram-Schmidt (no refinement), Givens
    rotations, convergence on the recurrence-estimated preconditioned
    residual: rnorm <= max(rtol*rnorm0, atol).  Zero initial guess.
    Returns (x, iters, converged).
    """
    n = len(b)
    x = np.zeros(n)

    def amult(v):
        return csr_matvec(indptr, indices, data, v)

    def M(r):
        return pc.solve(pc_data, r) if pc is not None else r

    it = 0
    rnorm0 = None
    while True:
        r = M(b - amult(x))
        beta = np.linalg.norm(r)
        if rnorm0 is None:
            rnorm0 = beta
            tol = max(rtol * rnorm0, atol)
        if beta <= tol:
            return x, it, True
        m = restart
        V = np.zeros((m + 1, n))
        H = np.zeros((m + 1, m))
        V[0] = r / beta
        g = np.zeros(m + 1)
        g[0] = beta
        cs = np.zeros(m)
        sn = np.zeros(m)
        converged = False
        mj = 0
        for j in range(m):
            w = M(amult(V[j]))
            h = V[:j + 1] @ w
            w = w - V[:j + 1].T @ h
            hlast = np.linalg.norm(w)
            if hlast != 0.0:
                V[j + 1] = w / hlast
            col = np.zeros(j + 2)
            col[:j + 1] = h
            col[j + 1] = hlast
            for i in range(j):
                t = cs[i] * col[i] + sn[i] * col[i + 1]
                col[i + 1] = -sn[i] * col[i] + cs[i] * col[i + 1]
                col[i] = t
            d = np.hypot(col[j], col[j + 1])
            if d == 0.0:
                c, s = 1.0, 0.0
            else:
                c, s = col[j] / d, col[j + 1] / d
            cs[j], sn[j] = c, s
            col[j] = c * col[j] + s * col[j + 1]
            col[j + 1] = 0.0
            H[:j + 2, j] = col[:j + 2]
            g[j + 1] = -s * g[j]
            g[j] = c * g[j]
            it += 1
            mj = j + 1
            if abs(g[j + 1]) <= tol:
                converged = True
                break
            if it >= maxiter:
                break
        # back substitution H[:mj,:mj] y = g[:mj]
        y = np.zeros(mj)
        for i in range(mj - 1, -1, -1):
            y[i] = (g[i] - H[i, i + 1:mj] @ y[i + 1:mj]) / H[i, i]
        x = x + V[:mj].T @ y
        if converged:
            return x, it, True
        if it >= maxiter:
            return x, it, False
