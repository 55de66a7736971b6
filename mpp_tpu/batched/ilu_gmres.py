"""Batched ILU(0) + PETSc-default GMRES(30) in pure JAX.

The reference's SNES/KSP inner solves are PETSc defaults: GMRES(30),
left-preconditioned with ILU(0) in natural ordering, classical
Gram-Schmidt, Givens rotations, convergence on the recurrence-estimated
preconditioned residual (``MultiPhysicsProbBaseType.F90:1309-1317`` sets
nothing beyond defaults).  The golden regression answers embed the
*iterate* this algorithm stops at — an exact solver lands elsewhere
within the Newton stop-criterion's determinacy band (e.g. 2.5e-5 Pa for
vsfm_vchannel vs its 1e-12 tolerance).  This module replicates the
algorithm of ``ops/ilu.py`` (the serial numpy parity engine) as pure
jitted JAX with a batch axis, so facade-built problems solved on the
compiled batched path reproduce the goldens.

Everything static (sparsity, schedules) is padded numpy baked at trace
time; the numeric phases are ``lax.scan`` row sweeps (factorization,
triangular solves) and fixed-shape Arnoldi cycles with per-column
convergence tracking (a column that converges at inner step ``mj`` gets
the mj-truncated correction even though the batch runs the full cycle —
H[:mj,:mj] and g[:mj] are unaffected by later Arnoldi steps).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

HIGHEST = lax.Precision.HIGHEST


class BatchedILU0:
    """ILU(0) on a fixed CSR sparsity, batched over a leading axis.

    Mirrors ``ops/ilu.py:ILU0`` (PETSc PCILU defaults: levels=0, natural
    ordering, no shift): same IKJ update order, same triangular-solve
    sweeps; the batch axis vectorizes columns."""

    def __init__(self, indptr, indices):
        indptr = np.asarray(indptr, np.int64)
        indices = np.asarray(indices, np.int64)
        self.n = n = len(indptr) - 1
        self.nnz = int(indices.size)
        diag_pos = np.empty(n, np.int64)
        for i in range(n):
            lo, hi = indptr[i], indptr[i + 1]
            cols = indices[lo:hi]
            d = np.searchsorted(cols, i)
            if d == hi - lo or cols[d] != i:
                raise ValueError(f"row {i} missing diagonal")
            diag_pos[i] = lo + d
        self.diag_pos = diag_pos

        # ---- factor schedule, padded ----------------------------------
        rows_low, rows_pairs = [], []
        maxL = maxP = 0
        for i in range(n):
            lo, hi = indptr[i], indptr[i + 1]
            lows = []
            for p in range(lo, hi):
                k = indices[p]
                if k >= i:
                    break
                klo, khi = indptr[k], indptr[k + 1]
                kcols = indices[klo:khi]
                pairs = []
                for q in range(p + 1, hi):
                    j = indices[q]
                    r = np.searchsorted(kcols, j)
                    if r < khi - klo and kcols[r] == j and j > k:
                        pairs.append((q, klo + r))
                lows.append((p, diag_pos[k], pairs))
                maxP = max(maxP, len(pairs))
            rows_low.append(lows)
            maxL = max(maxL, len(lows))
        self.maxL, self.maxP = maxL, maxP
        low_pos = np.zeros((n, maxL), np.int32)
        low_diag = np.zeros((n, maxL), np.int32)
        low_valid = np.zeros((n, maxL), bool)
        pair_ij = np.zeros((n, maxL, maxP), np.int32)
        pair_kj = np.zeros((n, maxL, maxP), np.int32)
        pair_valid = np.zeros((n, maxL, maxP), bool)
        for i, lows in enumerate(rows_low):
            for l, (p, dk, pairs) in enumerate(lows):
                low_pos[i, l] = p
                low_diag[i, l] = dk
                low_valid[i, l] = True
                for t, (qij, qkj) in enumerate(pairs):
                    pair_ij[i, l, t] = qij
                    pair_kj[i, l, t] = qkj
                    pair_valid[i, l, t] = True
        self._fact_xs = (jnp.asarray(low_pos), jnp.asarray(low_diag),
                         jnp.asarray(low_valid), jnp.asarray(pair_ij),
                         jnp.asarray(pair_kj), jnp.asarray(pair_valid))

        # ---- triangular-solve schedules, padded -----------------------
        Wl = max((int(diag_pos[i] - indptr[i]) for i in range(n)), default=0)
        Wu = max((int(indptr[i + 1] - diag_pos[i] - 1) for i in range(n)),
                 default=0)
        self.Wl, self.Wu = Wl, Wu
        lpos = np.zeros((n, max(Wl, 1)), np.int32)
        lcol = np.zeros((n, max(Wl, 1)), np.int32)
        lval = np.zeros((n, max(Wl, 1)), bool)
        upos = np.zeros((n, max(Wu, 1)), np.int32)
        ucol = np.zeros((n, max(Wu, 1)), np.int32)
        uval = np.zeros((n, max(Wu, 1)), bool)
        for i in range(n):
            lo, hi, d = indptr[i], indptr[i + 1], diag_pos[i]
            for w, p in enumerate(range(lo, d)):
                lpos[i, w] = p
                lcol[i, w] = indices[p]
                lval[i, w] = True
            for w, p in enumerate(range(d + 1, hi)):
                upos[i, w] = p
                ucol[i, w] = indices[p]
                uval[i, w] = True
        self._lsolve_xs = (jnp.arange(n, dtype=jnp.int32), jnp.asarray(lpos),
                           jnp.asarray(lcol), jnp.asarray(lval))
        self._usolve_xs = (jnp.arange(n, dtype=jnp.int32), jnp.asarray(upos),
                           jnp.asarray(ucol), jnp.asarray(uval),
                           jnp.asarray(diag_pos.astype(np.int32)))

    def factor(self, data):
        """Numeric IKJ factorization.  data [..., nnz] -> LU values."""
        maxL = self.maxL

        def row_step(f, xs):
            low_pos, low_diag, low_valid, pair_ij, pair_kj, pair_valid = xs
            for l in range(maxL):
                m = f[..., low_pos[l]] / f[..., low_diag[l]]
                m = jnp.where(low_valid[l], m, 0.0)
                f = f.at[..., low_pos[l]].set(
                    jnp.where(low_valid[l], m, f[..., low_pos[l]]))
                if self.maxP:
                    upd = m[..., None] * f[..., pair_kj[l]]
                    upd = jnp.where(pair_valid[l], upd, 0.0)
                    f = f.at[..., pair_ij[l]].add(-upd)
            return f, None

        if maxL == 0:
            return jnp.asarray(data)
        f, _ = lax.scan(row_step, jnp.asarray(data), self._fact_xs)
        return f

    def solve(self, f, b):
        """(LU)^-1 b, batched: f [..., nnz], b [..., n]."""
        def fwd(y, xs):
            i, lpos, lcol, lval = xs
            s = jnp.sum(jnp.where(lval, f[..., lpos] * y[..., lcol], 0.0),
                        axis=-1)
            y = y.at[..., i].add(-s)
            return y, None

        y, _ = lax.scan(fwd, jnp.asarray(b), self._lsolve_xs)

        def back(x, xs):
            i, upos, ucol, uval, dpos = xs
            s = jnp.sum(jnp.where(uval, f[..., upos] * x[..., ucol], 0.0),
                        axis=-1)
            x = x.at[..., i].set((x[..., i] - s) / f[..., dpos])
            return x, None

        x, _ = lax.scan(back, y, self._usolve_xs, reverse=True)
        return x


def make_ell_matvec(indptr, indices):
    """Padded-row (ELL) CSR SpMV closure: matvec(data, x) batched over a
    leading axis of both."""
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    n = len(indptr) - 1
    W = int(np.diff(indptr).max(initial=0))
    pos = np.zeros((n, max(W, 1)), np.int32)
    col = np.zeros((n, max(W, 1)), np.int32)
    val = np.zeros((n, max(W, 1)), bool)
    for i in range(n):
        for w, p in enumerate(range(indptr[i], indptr[i + 1])):
            pos[i, w] = p
            col[i, w] = indices[p]
            val[i, w] = True
    posj, colj, valj = jnp.asarray(pos), jnp.asarray(col), jnp.asarray(val)

    def matvec(data, x):
        prod = jnp.where(valj, data[..., posj] * x[..., colj], 0.0)
        return jnp.sum(prod, axis=-1)

    return matvec


def petsc_gmres_batched(matvec, data, b, ilu: BatchedILU0 = None,
                        pc_data=None, rtol=1e-5, atol=1e-50, restart=30,
                        maxcycles=100):
    """Batched GMRES(m) replicating ``ops/ilu.py:petsc_gmres`` semantics.

    ``matvec(data, x)``: batched SpMV.  ``b`` [ncol, n].  Per-column
    convergence on the recurrence-estimated preconditioned residual; a
    column converged at inner step mj receives the mj-truncated
    correction.  Returns (x, cycles, converged[ncol]) — the convergence
    mask mirrors KSPGetConvergedReason as surfaced by the reference's
    KSP stepper (SystemOfEquationsBaseType.F90:625-645)."""
    ncol, n = b.shape
    m = min(restart, n)
    dtype = b.dtype

    def M(r):
        return ilu.solve(pc_data, r) if ilu is not None else r

    x0 = jnp.zeros_like(b)
    r0 = M(b - matvec(data, x0))
    rnorm0 = jnp.linalg.norm(r0, axis=-1)
    tol = jnp.maximum(rtol * rnorm0, atol)

    def cycle(x):
        r = M(b - matvec(data, x))
        beta = jnp.linalg.norm(r, axis=-1)
        already = beta <= tol
        V = jnp.zeros((ncol, m + 1, n), dtype)
        V = V.at[:, 0].set(r / jnp.where(beta == 0, 1.0, beta)[:, None])
        H = jnp.zeros((ncol, m + 1, m), dtype)
        cs = jnp.zeros((ncol, m), dtype)
        sn = jnp.zeros((ncol, m), dtype)
        g = jnp.zeros((ncol, m + 1), dtype).at[:, 0].set(beta)
        mj = jnp.where(already, 0, m).astype(jnp.int32)
        found = already

        def astep(j, carry):
            V, H, cs, sn, g, mj, found = carry
            w = M(matvec(data, V[:, j]))
            # classical Gram-Schmidt: unset V rows are zero, so the full
            # contraction equals V[:j+1] @ w
            h = jnp.einsum("cin,cn->ci", V, w, precision=HIGHEST)
            w = w - jnp.einsum("ci,cin->cn", h, V, precision=HIGHEST)
            hlast = jnp.linalg.norm(w, axis=-1)
            V2 = V.at[:, j + 1].set(
                w / jnp.where(hlast == 0, 1.0, hlast)[:, None])
            col = h.at[:, j + 1].set(hlast)

            def rot(i, c_):
                t = cs[:, i] * c_[:, i] + sn[:, i] * c_[:, i + 1]
                nxt = -sn[:, i] * c_[:, i] + cs[:, i] * c_[:, i + 1]
                apply = i < j
                c_ = c_.at[:, i + 1].set(jnp.where(apply, nxt, c_[:, i + 1]))
                c_ = c_.at[:, i].set(jnp.where(apply, t, c_[:, i]))
                return c_
            col = lax.fori_loop(0, m, rot, col)
            cj, cj1 = col[:, j], col[:, j + 1]
            d = jnp.hypot(cj, cj1)
            c = jnp.where(d == 0, 1.0, cj / jnp.where(d == 0, 1.0, d))
            s = jnp.where(d == 0, 0.0, cj1 / jnp.where(d == 0, 1.0, d))
            col = col.at[:, j].set(c * cj + s * cj1).at[:, j + 1].set(0.0)
            cs2 = cs.at[:, j].set(c)
            sn2 = sn.at[:, j].set(s)
            g2 = g.at[:, j + 1].set(-s * g[:, j]).at[:, j].set(c * g[:, j])
            H2 = H.at[:, :, j].set(col[:, :m + 1])
            conv = jnp.abs(g2[:, j + 1]) <= tol
            mj2 = jnp.where(~found & conv, j + 1, mj).astype(jnp.int32)
            return (V2, H2, cs2, sn2, g2, mj2, found | conv)

        V, H, cs, sn, g, mj, found = lax.fori_loop(
            0, m, astep, (V, H, cs, sn, g, mj, found))

        # mj-truncated back-substitution: y_k = 0 for k >= mj
        def backsub(i, y):
            jrow = m - 1 - i
            num = g[:, jrow] - jnp.einsum("ck,ck->c", H[:, jrow, :m], y,
                                          precision=HIGHEST)
            hjj = H[:, jrow, jrow]
            yi = num / jnp.where(hjj == 0, 1.0, hjj)
            yi = jnp.where(jrow < mj, yi, 0.0)
            return y.at[:, jrow].set(yi)
        y = lax.fori_loop(0, m, backsub, jnp.zeros((ncol, m), dtype))
        dx = jnp.einsum("ci,cin->cn", y, V[:, :m], precision=HIGHEST)
        return x + dx, found

    def cond(state):
        x, k, done = state
        return jnp.any(~done) & (k < maxcycles)

    def body(state):
        x, k, done = state
        x2, found = cycle(x)
        x2 = jnp.where(done[:, None], x, x2)
        return (x2, k + 1, done | found)

    x, k, done = lax.while_loop(
        cond, body, (x0, jnp.zeros((), jnp.int32), rnorm0 <= tol))
    return x, k, done
