"""Compiled batched VSFM: facade-built problems on the batched production path.

This module closes the gap between the two stacks: a problem built through
the ``VSFMMPP`` facade (meshes, connection sets, conditions, per-cell
constitutive parameters, coupled multi-GE networks — the full physics of
``ge/RichardsMod.F90:118-340,651-858`` + ``util/EOSWaterMod.F90:38-78``)
is *compiled* into one pure, jitted, batched Newton timestep:

* the SAME assembly code as the serial regression-parity path
  (``models/richards.py`` residual/jacobian_values, called with explicit
  dynamic inputs) — one physics implementation, two drivers;
* coupled-GE auxvar exchange (``SystemOfEquationsVSFMType.F90:1117-1168``)
  becomes a pure gather of the partner GE's unknowns into the coupled-BC
  value slots;
* the linear solve is chosen from the discovered sparsity: batched Thomas
  (exact LU) when the global matrix is tridiagonal — the common vertical-
  column case — else batched dense LU (problem sizes built through the
  facade are tens-to-hundreds of cells; the batch axis supplies the
  device-level parallelism);
* Newton replicates PETSc SNES NEWTONLS + SNESLineSearchBT (cubic
  backtracking) + SNESConvergedDefault semantics (ops/snes.py), batched
  with per-column masks, and the SOEBaseStepDT_SNES timestep-cut ladder
  (``soe/SystemOfEquationsBaseType.F90:368-552``) with per-column dt
  ladders so a stiff column never serializes the batch.

Batching model: the compiled problem has ``n`` unknowns; the batch axis
replicates the problem over ``ncol`` independent columns (the reference's
rank-per-column process parallelism, SURVEY §2.8) with per-column state
and per-column BC/SS forcing.  Constitutive parameters default to the
trace-time staged values; the ``dyn`` argument of :meth:`step_batched`
promotes them to batched dynamic inputs [ncol, ...] — per-column
heterogeneous CLM soils, the ALM production contract
(``MPPVSFMALM_Initialize.F90:986-992``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from mpp_tpu.ops.snes import (CONVERGED_FNORM_ABS, CONVERGED_FNORM_RELATIVE,
                              CONVERGED_SNORM_RELATIVE, DIVERGED_FNORM_NAN,
                              DIVERGED_LINE_SEARCH, DIVERGED_MAX_IT,
                              DIVERGED_DTOL)
from mpp_tpu.ops import pallas_kernels
from mpp_tpu.ops.tridiag import tridiag_matvec
from mpp_tpu.constants import FMWH2O


class SNESParams(NamedTuple):
    """SNESConvergedDefault + SNESLineSearchBT constants (ops/snes.py)."""
    atol: float = 1e-50
    rtol: float = 1e-8
    stol: float = 1e-10
    max_it: int = 50
    divtol: float = 1e4
    ls_alpha: float = 1e-4
    ls_maxstep: float = 1e8
    ls_steptol: float = 1e-12
    ls_max_it: int = 40
    ls_damping: float = 1.0
    ksp_rtol: float = 1e-5
    ksp_atol: float = 1e-50
    ksp_restart: int = 30


class CompiledVSFM:
    """A facade-built VSFM problem frozen into a jitted batched stepper.

    Drop-in serial use (regression parity, ncol=1)::

        comp = compile_vsfm(mpp)
        converged, reason = comp.step_dt(dt, istep)   # instead of soe.step_dt

    Batched use (production)::

        X, iters, ok, reason = comp.step_batched(X, bc_values, ss_values, dt)
    """

    def __init__(self, mpp, snes: SNESParams = None, max_cuts: int = 20,
                 linear_solver: str = "petsc",
                 linesearch_jac: str = "separate"):
        """``linear_solver``: "petsc" (default) replicates the reference's
        inner solve — batched ILU(0)+GMRES(30) at rtol 1e-5 — so golden
        trajectories are reproduced; "direct" uses the exact batched
        solver (Thomas / block-Thomas / dense LU) — faster, lands within
        the Newton stop criterion's determinacy band of the goldens.
        Tridiagonal problems always use Thomas (= ILU(0) exactly).

        ``linesearch_jac``: "separate" (default) evaluates the Jacobian
        at the start of each Newton iteration (the reference shape);
        "fused" evaluates residual+Jacobian together at the line
        search's full-step trial and carries the accepted bands into the
        next iteration — one constitutive chain per iteration instead
        of two when full steps are accepted; on batches where many
        columns backtrack, the carry/merge overhead and the Jacobian
        re-evaluations for backtracked columns can eat the saving.
        Identical iteration map either way (pinned by the golden suites
        passing in both modes)."""
        self.linear_solver = linear_solver
        if linesearch_jac not in ("separate", "fused"):
            raise ValueError(linesearch_jac)
        self._ls_fused = linesearch_jac == "fused"
        self.mpp = mpp
        soe = mpp.soe
        soe._ensure_template()
        self.template = soe.template
        self.offsets = soe.offsets
        self.goveqns = list(soe.goveqns)
        self.n = soe.n_total
        self.snes = snes or SNESParams(stol=soe.snes_stol)
        # f32 production runs cannot satisfy the f64 PETSc defaults
        # (rtol 1e-8 / stol 1e-10 are below f32 resolution on ~1e5 Pa
        # state); dtype selects the parameter set at trace time
        # rtol 2e-4: sharp-front f32 residuals stall at ~1e-4 relative
        # (the f32 evaluation floor); tighter settings only burn the
        # dt-cut ladder.  The ALM-style mass audit (column_bc_flux /
        # column_storage; bench f32_stress) measures the resulting drift
        # directly rather than inferring it from the stop criterion.
        self.snes_f32 = SNESParams(rtol=2e-4, atol=1e-8, stol=1e-6,
                                   ls_steptol=1e-8,
                                   ksp_rtol=self.snes.ksp_rtol)
        self.max_cuts = max_cuts
        # straggler-compaction divisor (see _snes_batched); 0 disables
        self.compact_frac = 8

        # coupled-BC staging maps: for each GE, the bc_value slots that are
        # COND_DIRICHLET_FRM_OTR_GOVEQ and the global solution index whose
        # value they take (VSFMSOEGovEqnExchangeAuxVars as a pure gather)
        self._otr_slots, self._otr_src = [], []
        for g in self.goveqns:
            slots, src = [], []
            for cond, off, other, cells in g.coupled_bc_slices():
                slots.append(np.arange(off, off + cells.size))
                src.append(self.offsets[other] + cells)
            self._otr_slots.append(
                np.concatenate(slots).astype(np.int32) if slots
                else np.zeros(0, np.int32))
            self._otr_src.append(
                np.concatenate(src).astype(np.int32) if src
                else np.zeros(0, np.int32))

        self._plan_solver()
        self._step_jit = jax.jit(self._step_dt_batched)

    # ---- solver plan -----------------------------------------------------
    def _plan_solver(self):
        """Choose the exact linear solver from the discovered sparsity:

        * bandwidth ≤ 1 → batched Thomas (the vertical-column case);
        * banded with a block size b ≥ bandwidth dividing n → batched
          block-Thomas over n/b levels of b×b blocks (structured 2/3-D
          meshes whose cells are level-major, e.g. vchannel);
        * otherwise batched dense LU (small coupled networks: SPAC trees,
          multi-GE composites).
        """
        t = self.template
        rows, cols = t.row_ids(), t.indices
        bw = int(np.abs(rows.astype(np.int64) - cols).max(initial=0))
        self.is_tridiag = bw <= 1
        self.block_size = None
        self._ilu = None
        from mpp_tpu.batched.ilu_gmres import make_ell_matvec
        self._matvec = make_ell_matvec(t.indptr, t.indices)
        if not self.is_tridiag:
            if self.linear_solver == "petsc":
                from mpp_tpu.batched.ilu_gmres import BatchedILU0
                self._ilu = BatchedILU0(t.indptr, t.indices)
                return
            r64 = rows.astype(np.int64)
            c64 = cols.astype(np.int64)
            for b in range(bw, min(self.n // 2, 1024) + 1):
                # a candidate block size must both divide n AND give a
                # true block-tridiagonal cover: every entry within one
                # block row of the diagonal (a non-level-major ordering
                # can satisfy the bandwidth test yet scatter entries
                # outside the blocks)
                if self.n % b == 0 and \
                        (np.abs(r64 // b - c64 // b) <= 1).all():
                    self.block_size = b
                    break
            if self.block_size is not None:
                from mpp_tpu.ops.block_structure import BlockTridiagTemplate
                self._bt = BlockTridiagTemplate(
                    1, self.n // self.block_size, self.block_size,
                    rows, cols)
            elif self.n > 4096:
                raise ValueError(
                    f"no banded structure found and n={self.n} too large "
                    "for batched dense LU")
        if self.is_tridiag:
            # direct-diagonal assembly: each COO contribution (in the
            # exact order _jac_one's concatenated jacobian_values emits)
            # maps statically to (band, row); assembly is then three
            # scatter-adds straight into (dl, d, du) — no CSR data array,
            # no post-assembly gathers (saves ~3 passes per iteration)
            rows_l, cols_l = [], []
            for g, off in zip(self.goveqns, self.offsets[:-1]):
                r, c = g.coo_coords(off, off)
                rows_l += [r.astype(np.int64)]
                cols_l += [c.astype(np.int64)]
                rc, cc = g.coupling_coords(off, self.offsets[:-1])
                rows_l += [rc]
                cols_l += [cc]
            coo_r = np.concatenate(rows_l)
            coo_c = np.concatenate(cols_l)
            band = coo_c - coo_r + 1        # 0 = dl, 1 = d, 2 = du
            self._tri_idx = [np.nonzero(band == b)[0].astype(np.int32)
                             for b in (0, 1, 2)]
            self._tri_rows = [coo_r[i].astype(np.int32)
                              for i in self._tri_idx]
            # CSR slot of each (i,i-1)/(i,i)/(i,i+1) entry; missing slots
            # point at entry 0 — their value is ignored by the Thomas sweep
            # (dl[0] multiplies a zero carry; du[-1] multiplies x_{n}=0).
            def slot_of(i, j):
                out = np.zeros(self.n, np.int32)
                for r in range(self.n):
                    c = r + j
                    if 0 <= c < self.n:
                        s = np.nonzero(cols[t.indptr[r]:t.indptr[r + 1]] == c)[0]
                        if s.size:
                            out[r] = t.indptr[r] + s[0]
                return out
            self._dl_slots = slot_of(0, -1)
            self._d_slots = slot_of(0, 0)
            self._du_slots = slot_of(0, +1)

            # the Jacobian action for the BT initslope
            self._matvec = lambda data, x: tridiag_matvec(*data, x)
            # mask out slots that don't exist (value would alias another)
            self._dl_mask = np.array(
                [np.any(cols[t.indptr[r]:t.indptr[r + 1]] == r - 1)
                 for r in range(self.n)])
            self._du_mask = np.array(
                [np.any(cols[t.indptr[r]:t.indptr[r + 1]] == r + 1)
                 for r in range(self.n)])

    def _solve(self, data, F):
        """Newton direction Y with J Y = F (exact).  data [ncol, nnz],
        F [ncol, n]."""
        if self.is_tridiag:
            dl, d, du = data          # _jac_one_tridiag's diagonal tuple
            return pallas_kernels.tridiag_solve(dl, d, du, F)
        if self._ilu is not None:
            from mpp_tpu.batched.ilu_gmres import petsc_gmres_batched
            lu = self._ilu.factor(data)
            sp = self.snes
            x, _, _ = petsc_gmres_batched(self._matvec, data, F,
                                          ilu=self._ilu, pc_data=lu,
                                          rtol=sp.ksp_rtol,
                                          atol=sp.ksp_atol,
                                          restart=sp.ksp_restart)
            return x
        if self.block_size is not None:
            from mpp_tpu.ops.block_thomas import block_thomas
            nlev = self.n // self.block_size

            def one(d, f):
                L, D, U = self._bt.assemble(d)
                x = block_thomas(L, D, U,
                                 f.reshape(1, nlev, self.block_size))
                return x.reshape(-1)
            return jax.vmap(one)(data, F)
        dense = jax.vmap(self.template.to_dense)(data)
        return jnp.linalg.solve(dense, F[..., None])[..., 0]

    # ---- pure single-column evaluation ------------------------------------
    def _residual_one(self, X, bc_values, ss_values, accum_prevs, dt,
                      src, dyn):
        """``src``: optional per-cell mass source [n] (kmol/s, positive =
        source) — the operator-split lateral flux staged as a source term
        (SystemOfEquationsVSFMType.F90:848-891).  ``dyn``: tuple of per-GE
        dynamic-parameter dicts (RichardsGE dyn contract) — per-column
        heterogeneous soils as batched inputs."""
        Fs = []
        for k, (g, off) in enumerate(zip(self.goveqns, self.offsets[:-1])):
            bc = bc_values[k]
            if self._otr_slots[k].size:
                bc = bc.at[jnp.asarray(self._otr_slots[k])].set(
                    X[jnp.asarray(self._otr_src[k])])
            F = g.residual(X[off:off + g.mesh.ncells_local], dt,
                           bc_value=bc, ss_value=ss_values[k],
                           accum_prev=accum_prevs[k], dyn=dyn[k])
            if src is not None:
                F = F - src[off:off + g.mesh.ncells_local]
            Fs.append(F)
        # assembly constants are f64; keep the evaluation in the state's
        # dtype so f32 production runs stay f32 under jax_enable_x64
        return jnp.concatenate(Fs).astype(X.dtype)

    def _jac_one(self, X, bc_values, ss_values, dt, dyn):
        vals = []
        for k, (g, off) in enumerate(zip(self.goveqns, self.offsets[:-1])):
            bc = bc_values[k]
            if self._otr_slots[k].size:
                bc = bc.at[jnp.asarray(self._otr_slots[k])].set(
                    X[jnp.asarray(self._otr_src[k])])
            vals.append(g.jacobian_values(X[off:off + g.mesh.ncells_local],
                                          dt, bc_value=bc,
                                          ss_value=ss_values[k],
                                          dyn=dyn[k]))
        return self.template.assemble(jnp.concatenate(vals)).astype(X.dtype)

    def _tri_assemble(self, v, dtype):
        """COO contribution values -> (dl, d, du) bands (tridiag plans)."""
        out = []
        for i, rows in zip(self._tri_idx, self._tri_rows):
            out.append(jnp.zeros(self.n, dtype)
                       .at[jnp.asarray(rows)].add(v[jnp.asarray(i)]))
        return tuple(out)

    def _jac_one_tridiag(self, X, bc_values, ss_values, dt, dyn):
        """(dl, d, du) assembled directly from the COO contributions
        (tridiagonal plans only)."""
        vals = []
        for k, (g, off) in enumerate(zip(self.goveqns, self.offsets[:-1])):
            bc = bc_values[k]
            if self._otr_slots[k].size:
                bc = bc.at[jnp.asarray(self._otr_slots[k])].set(
                    X[jnp.asarray(self._otr_src[k])])
            vals.append(g.jacobian_values(X[off:off + g.mesh.ncells_local],
                                          dt, bc_value=bc,
                                          ss_value=ss_values[k],
                                          dyn=dyn[k]))
        v = jnp.concatenate(vals).astype(X.dtype)
        return self._tri_assemble(v, X.dtype)

    def _resjac_one(self, X, bc_values, ss_values, accum_prevs, dt, src,
                    dyn):
        """(F, A) from ONE constitutive/flux evaluation per GE
        (``residual_and_jac_values``): the flux kernels return values AND
        derivatives together, so fusing halves the dominant constitutive
        cost per accepted Newton iterate (VERDICT r4 item 3).  Identical
        math to `_residual_one` + `_jac_one(_tridiag)`."""
        Fs, vals = [], []
        for k, (g, off) in enumerate(zip(self.goveqns, self.offsets[:-1])):
            bc = bc_values[k]
            if self._otr_slots[k].size:
                bc = bc.at[jnp.asarray(self._otr_slots[k])].set(
                    X[jnp.asarray(self._otr_src[k])])
            F, v = g.residual_and_jac_values(
                X[off:off + g.mesh.ncells_local], dt, bc_value=bc,
                ss_value=ss_values[k], accum_prev=accum_prevs[k],
                dyn=dyn[k])
            if src is not None:
                F = F - src[off:off + g.mesh.ncells_local]
            Fs.append(F)
            vals.append(v)
        F = jnp.concatenate(Fs).astype(X.dtype)
        v = jnp.concatenate(vals).astype(X.dtype)
        if self.is_tridiag:
            return F, self._tri_assemble(v, X.dtype)
        return F, self.template.assemble(v).astype(X.dtype)

    def _accum_prev_one(self, X, dt, dyn):
        out = []
        for k, (g, off) in enumerate(zip(self.goveqns, self.offsets[:-1])):
            P = X[off:off + g.mesh.ncells_local]
            active = jnp.asarray(g.mesh.is_active)
            out.append(jnp.where(active, g.accum(P, dyn=dyn[k]) / dt,
                                 0.0).astype(X.dtype))
        return tuple(out)

    # ---- batched Newton (SNES NEWTONLS + BT linesearch) --------------------
    def _snes_batched(self, X0, bc, ss, accum_prev, dt, src, dyn, tols):
        """Returns (X, iters[scalar], reason[ncol]) — reason uses the
        PETSc SNESConvergedReason codes of ops/snes.py.

        ``tols`` = (rtol, stol) dynamic scalars so the ALM retry ladder
        (MPPVSFMALM_Driver.F90:886-905 rtol/stol tightening) re-solves
        without recompiling.

        Straggler compaction: a handful of stiff columns (sharp ponded
        fronts) need 5-10x the Newton iterations of the batch median,
        and with plain per-column masks every extra iteration still pays
        full-batch assembly/solve cost.  Once at most ncol/compact_frac
        columns remain unconverged, they are gathered (argsort of the
        done mask) into a narrow batch that continues Newton alone and
        scatters its results back — the stiff tail costs 1/compact_frac
        of full-batch time per iteration instead of serializing
        everyone (the batched analog of the reference's per-rank
        independence, SURVEY §2.8)."""
        sp = self.snes if X0.dtype == jnp.float64 else self.snes_f32
        rtol, stol, mass_tol = tols
        ncol = X0.shape[0]
        compact = self.compact_frac
        K = (ncol // compact) if compact and ncol >= 4096 else 0

        def colnorm(A):
            return jnp.sqrt(jnp.sum(A * A, axis=-1))

        def make_res(bc, ss, accum_prev, dtl, src, dyn):
            res_one = jax.vmap(self._residual_one,
                               in_axes=(0, 0, 0, 0, 0, 0, 0))
            return lambda X: res_one(X, bc, ss, accum_prev, dtl, src, dyn)

        def make_resjac(bc, ss, accum_prev, dtl, src, dyn):
            rj_one = jax.vmap(self._resjac_one,
                              in_axes=(0, 0, 0, 0, 0, 0, 0))
            return lambda X: rj_one(X, bc, ss, accum_prev, dtl, src, dyn)

        def make_body(bc, ss, accum_prev, dtl, src, dyn, res, resjac,
                      fnorm0, ttol):
            jac_one = (self._jac_one_tridiag if self.is_tridiag
                       else self._jac_one)
            jacv = jax.vmap(jac_one, in_axes=(0, 0, 0, 0, 0))
            jacf = lambda X: jacv(X, bc, ss, dtl, dyn)
            ncol = dtl.shape[0]
            kbt = max(1, ncol // 8)

            def bt_linesearch(X, F, fnorm, Y, initslope, done):
                """Batched SNESLineSearchBT (cubic), per-column lambda.

                ``initslope`` = F·(J Y) sign-normalized, computed by the
                caller with the actual Jacobian SpMV (PETSc
                linesearchbt.c).  The FIRST (full-step) trial evaluates
                residual AND Jacobian in one fused constitutive pass
                (`_resjac_one`) — when every column accepts it (the
                common case), the next Newton iteration's Jacobian is
                already assembled and each iteration costs ONE
                constitutive-chain evaluation instead of two (VERDICT r4
                item 3); if any column backtracks, further trials are
                residual-only and the Jacobian is recomputed once at the
                final iterate.  Returns (ok, X_new, G, A_new, gnorm,
                snorm)."""
                ynorm0 = colnorm(Y)
                zero = ynorm0 == 0.0
                safe_y = jnp.where(zero, 1.0, ynorm0)
                clampf = jnp.where(ynorm0 > sp.ls_maxstep,
                                   sp.ls_maxstep / safe_y, 1.0)
                Y = Y * clampf[:, None]
                ynorm = jnp.minimum(ynorm0, sp.ls_maxstep)
                minlam = sp.ls_steptol / safe_y

                def accept_of(lam, gnorm):
                    return (0.5 * gnorm * gnorm
                            <= 0.5 * fnorm * fnorm
                            + lam * sp.ls_alpha * initslope)

                lam = jnp.full_like(fnorm, sp.ls_damping)
                Xw = jnp.where(done[:, None], X, X - lam[:, None] * Y)
                if self._ls_fused:
                    G, A_try = resjac(Xw)
                else:
                    G, A_try = res(Xw), None
                gnorm = colnorm(G)
                acc = accept_of(lam, gnorm) | zero | done
                fail = ~acc & ~jnp.isfinite(gnorm)
                settled_first = acc | fail

                # quadratic backtrack for the not-yet-accepted columns —
                # skipped entirely (lax.cond) when every column accepted
                # the full step, which is the common case: saves one
                # batched residual evaluation per Newton iteration
                lamprev, gnormprev = lam, gnorm

                def quad_step(_):
                    denom = (gnorm * gnorm - fnorm * fnorm
                             - 2.0 * lam * initslope)
                    lamq = -initslope / jnp.where(denom == 0.0, 1.0, denom)
                    lamq = jnp.where(lamq > 0.5 * lam, 0.5 * lam, lamq)
                    lamq = jnp.where(lamq <= 0.1 * lam, 0.1 * lam, lamq)
                    lamq = jnp.where(jnp.isfinite(lamq), lamq, 0.1 * lam)
                    lam2 = jnp.where(acc | fail, lam, lamq)
                    Xw2 = jnp.where((acc | fail | done)[:, None], Xw,
                                    X - lam2[:, None] * Y)
                    G2 = res(Xw2)
                    gnorm2 = jnp.where(acc | fail, gnorm, colnorm(G2))
                    Xw2 = jnp.where((acc | fail)[:, None], Xw, Xw2)
                    G2 = jnp.where((acc | fail)[:, None], G, G2)
                    return lam2, Xw2, G2, gnorm2

                def no_quad(_):
                    return lam, Xw, G, gnorm

                lam2, Xw2, G2, gnorm2 = lax.cond(jnp.all(acc | fail),
                                                 no_quad, quad_step,
                                                 operand=None)

                def cond(s):
                    lam, lamprev, gnorm, gnormprev, Xw, G, acc, fail, it = s
                    return jnp.any(~acc & ~fail) & (it < sp.ls_max_it)

                def body(s):
                    lam, lamprev, gnorm, gnormprev, Xw, G, acc, fail, it = s
                    newly = accept_of(lam, gnorm) & ~fail
                    acc2 = acc | newly
                    fail2 = fail | (~acc2 & ((lam <= minlam)
                                             | ~jnp.isfinite(gnorm)))
                    active = ~acc2 & ~fail2
                    # cubic model (linesearchbt.c)
                    t1 = (0.5 * (gnorm * gnorm - fnorm * fnorm)
                          - lam * initslope)
                    t2 = (0.5 * (gnormprev * gnormprev - fnorm * fnorm)
                          - lamprev * initslope)
                    dl_ = jnp.where(lam == lamprev, 1.0, lam - lamprev)
                    a = (t1 / (lam * lam)
                         - t2 / (lamprev * lamprev)) / dl_
                    b = (-lamprev * t1 / (lam * lam)
                         + lam * t2 / (lamprev * lamprev)) / dl_
                    dsc = jnp.maximum(b * b - 3.0 * a * initslope, 0.0)
                    lamt = jnp.where(a == 0.0, -initslope / (2.0 * b),
                                     (-b + jnp.sqrt(dsc)) / (3.0 * a))
                    lamn = jnp.where(lamt > 0.5 * lam, 0.5 * lam, lamt)
                    lamn = jnp.where(lamn <= 0.1 * lam, 0.1 * lam, lamn)
                    lamn = jnp.where(jnp.isfinite(lamn), lamn, 0.1 * lam)
                    lamprev2 = jnp.where(active, lam, lamprev)
                    gnormprev2 = jnp.where(active, gnorm, gnormprev)
                    lam3 = jnp.where(active, lamn, lam)
                    Xw3 = jnp.where(active[:, None], X - lam3[:, None] * Y,
                                    Xw)
                    G3 = res(Xw3)
                    gnorm3 = jnp.where(active, colnorm(G3), gnorm)
                    G3 = jnp.where(active[:, None], G3, G)
                    return (lam3, lamprev2, gnorm3, gnormprev2, Xw3, G3,
                            acc2, fail2, it + 1)

                lam, lamprev, gnorm, gnormprev, Xw, G, acc, fail, _ = \
                    lax.while_loop(cond, body,
                                   (lam2, lamprev, gnorm2, gnormprev, Xw2,
                                    G2, acc, fail,
                                    jnp.zeros((), jnp.int32)))
                # final accept check for the last evaluation
                newly = accept_of(lam, gnorm) & ~fail
                acc = acc | newly
                fail = fail | ~acc
                snorm = jnp.abs(lam) * ynorm
                # next iteration's Jacobian: the fused first-trial bands
                # are exact for every column settled at the full step
                # (accepted / failed / done — their Xw did not move);
                # only columns that ENTERED backtracking need a fresh
                # evaluation, gathered into a narrow <= ncol//8 batch
                # (assembly cost scales with batch width), falling back
                # to a full-batch recompute for a mass-backtrack
                # iteration
                if not self._ls_fused:
                    return acc & ~fail, Xw, G, None, gnorm, snorm
                stale = ~settled_first
                n_st = jnp.sum(stale)
                if kbt < ncol:
                    def fix_narrow(_):
                        idx = jnp.argsort(~stale)[:kbt]   # stale first
                        Af = jacv(Xw[idx],
                                  tuple(b[idx] for b in bc),
                                  tuple(v[idx] for v in ss), dtl[idx],
                                  jax.tree_util.tree_map(
                                      lambda a: a[idx], dyn))
                        return jax.tree_util.tree_map(
                            lambda at, af: at.at[idx].set(af), A_try, Af)

                    def slow(_):
                        return lax.cond(n_st <= kbt, fix_narrow,
                                        lambda __: jacf(Xw), operand=None)
                else:
                    slow = lambda _: jacf(Xw)
                A_new = lax.cond(n_st == 0, lambda _: A_try, slow,
                                 operand=None)
                return acc & ~fail, Xw, G, A_new, gnorm, snorm

            def body(s):
                if self._ls_fused:
                    X, F, A, fnorm, it, done, reason = s
                else:
                    X, F, fnorm, it, done, reason = s
                    # the reference shape: Jacobian at the iteration's
                    # start point (SOEBaseStepDT_SNES -> SNESSolve)
                    A = jacf(X)
                Y = self._solve(A, F)
                # BT initslope from the true Jacobian action
                # (ops/snes.py:91-95)
                W = self._matvec(A, Y)
                islope = jnp.sum(F * W, axis=-1)
                islope = jnp.where(islope > 0.0, -islope, islope)
                islope = jnp.where(islope == 0.0, -1.0, islope)
                ok, Xn, Gn, An, gnormn, snorm = bt_linesearch(X, F, fnorm,
                                                              Y, islope,
                                                              done)
                # PETSc SNESSolve_NEWTONLS failure path: a failed line
                # search with stol*xnorm > ynorm means the Newton update
                # is already negligible — declare SNORM convergence at
                # the pre-step iterate instead of divergence (ls.c
                # checkresult; near-equilibrium solves exit this way).
                ynorm_full = colnorm(Y)
                xnorm_pre = colnorm(X)
                tiny = ~ok & (stol * xnorm_pre > ynorm_full)
                keep = done | tiny
                ok = ok | tiny
                X2 = jnp.where(keep[:, None], X, Xn)
                F2 = jnp.where(keep[:, None], F, Gn)
                fnorm2 = jnp.where(keep, fnorm, gnormn)
                xnorm = colnorm(X2)
                # SNESConvergedDefault ordering (ops/snes.py:291-308)
                nan = ~jnp.isfinite(fnorm2)
                r = jnp.where(~ok, DIVERGED_LINE_SEARCH, 0)
                r = jnp.where(tiny, CONVERGED_SNORM_RELATIVE, r)
                r = jnp.where(nan, DIVERGED_FNORM_NAN, r)
                r = jnp.where((r == 0) & (fnorm2 < sp.atol),
                              CONVERGED_FNORM_ABS, r)
                r = jnp.where((r == 0) & (snorm < stol * xnorm),
                              CONVERGED_SNORM_RELATIVE, r)
                r = jnp.where((r == 0) & (fnorm2 <= ttol),
                              CONVERGED_FNORM_RELATIVE, r)
                r = jnp.where((r == 0) & (fnorm2 >= sp.divtol * fnorm0),
                              DIVERGED_DTOL, r)
                # mass-closure gate (production audit contract,
                # MPPVSFMALM_Driver.F90:861-863): |sum F| * dt * FMWH2O
                # is exactly the per-column audit integrand; with
                # mass_tol > 0 a column may not declare convergence while
                # its own mass balance is open — f32 arithmetic closes it
                # to ~1e-7 kg, the loose f32 rtol just stops too early
                msum_kg = jnp.abs(jnp.sum(F2, axis=-1)) \
                    * dtl[:, 0] * FMWH2O
                mass_ok = (mass_tol <= 0.0) | (msum_kg <= mass_tol)
                r = jnp.where((r > 0) & ~mass_ok, 0, r)
                newly = (r != 0) & ~done
                reason2 = jnp.where(newly, r, reason).astype(jnp.int32)
                it2 = it + 1
                done2 = done | newly
                # max_it exhaustion
                reason2 = jnp.where(~done2 & (it2 >= sp.max_it),
                                    DIVERGED_MAX_IT, reason2) \
                    .astype(jnp.int32)
                if self._ls_fused:
                    # An needs no keep-merge: done columns' trial point
                    # is X itself (their A is re-evaluated in place),
                    # and tiny/failed columns become done this
                    # iteration, so their A is never consumed again
                    return (X2, F2, An, fnorm2, it2, done2, reason2)
                return (X2, F2, fnorm2, it2, done2, reason2)

            return body

        # ---- phase A: full batch (until all done or only the stiff
        # tail of <= K columns remains) ----
        resA = make_res(bc, ss, accum_prev, dt, src, dyn)
        resjacA = make_resjac(bc, ss, accum_prev, dt, src, dyn)
        if self._ls_fused:
            F0, A0 = resjacA(X0)
        else:
            F0, A0 = resA(X0), None
        fnorm0 = colnorm(F0)
        ttol = fnorm0 * rtol
        nan0 = ~jnp.isfinite(fnorm0)
        done0 = nan0 | (fnorm0 < sp.atol)
        reason0 = jnp.where(nan0, DIVERGED_FNORM_NAN,
                            jnp.where(fnorm0 < sp.atol, CONVERGED_FNORM_ABS,
                                      0)).astype(jnp.int32)
        bodyA = make_body(bc, ss, accum_prev, dt, src, dyn, resA, resjacA,
                          fnorm0, ttol)

        def condA(s):
            done_, it_ = s[-2], s[-3]
            go = jnp.any(~done_) & (it_ < sp.max_it)
            if K:
                go = go & (jnp.sum(~done_) > K)
            return go

        s0A = ((X0, F0, A0, fnorm0, jnp.zeros((), jnp.int32), done0,
                reason0) if self._ls_fused else
               (X0, F0, fnorm0, jnp.zeros((), jnp.int32), done0, reason0))
        stA = lax.while_loop(condA, bodyA, s0A)

        if K:
            def compact_phase(st):
                if self._ls_fused:
                    X, F, A, fnorm, it, done, reason = st
                else:
                    X, F, fnorm, it, done, reason = st
                    A = None
                idx = jnp.argsort(done)[:K]      # not-done first (stable)
                bcK = tuple(b[idx] for b in bc)
                ssK = tuple(v[idx] for v in ss)
                apK = tuple(a[idx] for a in accum_prev)
                dtK = dt[idx]
                srcK = src[idx]
                dynK = jax.tree_util.tree_map(lambda a: a[idx], dyn)
                resB = make_res(bcK, ssK, apK, dtK, srcK, dynK)
                resjacB = make_resjac(bcK, ssK, apK, dtK, srcK, dynK)
                bodyB = make_body(bcK, ssK, apK, dtK, srcK, dynK, resB,
                                  resjacB, fnorm0[idx], ttol[idx])

                def condB(s):
                    db, itb = s[-2], s[-3]
                    return jnp.any(~db) & (itb < sp.max_it)

                if self._ls_fused:
                    AK = jax.tree_util.tree_map(lambda a: a[idx], A)
                    s0B = (X[idx], F[idx], AK, fnorm[idx], it, done[idx],
                           reason[idx])
                else:
                    s0B = (X[idx], F[idx], fnorm[idx], it, done[idx],
                           reason[idx])
                stB = lax.while_loop(condB, bodyB, s0B)
                if self._ls_fused:
                    Xb, Fb, Ab, fnb, itb, db, rb = stB
                    return (X.at[idx].set(Xb), F.at[idx].set(Fb), A,
                            fnorm.at[idx].set(fnb), itb,
                            done.at[idx].set(db), reason.at[idx].set(rb))
                Xb, Fb, fnb, itb, db, rb = stB
                return (X.at[idx].set(Xb), F.at[idx].set(Fb),
                        fnorm.at[idx].set(fnb), itb,
                        done.at[idx].set(db), reason.at[idx].set(rb))

            st = lax.cond(jnp.any(~stA[-2]), compact_phase, lambda s: s,
                          stA)
        else:
            st = stA
        X, F, fnorm, iters, done, reason = (
            (st[0], st[1], st[3], st[4], st[5], st[6]) if self._ls_fused
            else st)
        reason = jnp.where(reason == 0, DIVERGED_MAX_IT, reason)
        return X, iters, reason

    # ---- StepDT ladder (SOEBaseStepDT_SNES, per-column) --------------------
    def _step_dt_batched(self, X_prev, bc, ss, dt, src, dyn, tols):
        """One driver timestep ``dt``: per-column Newton with per-column
        dt-cut ladders (×0.5, up to max_cuts, restoring the column's
        previous solution on divergence)."""
        dtype = X_prev.dtype
        zcol = X_prev[:, 0] * 0.0
        dt_total = jnp.asarray(dt, dtype) + zcol

        def cond(s):
            X, t, dtc, ncuts, failed, iters, reason = s
            return jnp.any((t < dt_total) & ~failed)

        def body(s):
            X, t, dtc, ncuts, failed, iters, reason = s
            active = (t < dt_total) & ~failed
            dte = jnp.minimum(dtc, dt_total - t)
            dte = jnp.where(active, dte, dt_total)
            accum_prev = jax.vmap(self._accum_prev_one,
                                  in_axes=(0, 0, 0))(X, dte[:, None], dyn)
            Xn, nits, rsn = self._snes_batched(X, bc, ss, accum_prev,
                                               dte[:, None], src, dyn, tols)
            conv = rsn > 0
            ok = active & conv
            div = active & ~conv
            X = jnp.where(ok[:, None], Xn, X)
            t = jnp.where(ok, t + dte, t)
            ncuts = jnp.where(div, ncuts + 1, ncuts)
            dtc = jnp.where(div, 0.5 * dtc, dtc)
            failed = failed | (ncuts > self.max_cuts)
            reason = jnp.where(active, rsn, reason)
            return (X, t, dtc, ncuts, failed, iters + nits, reason)

        s0 = (X_prev, zcol, dt_total, zcol.astype(jnp.int32), zcol < -1.0,
              jnp.zeros((), jnp.int32), zcol.astype(jnp.int32))
        X, t, dtc, ncuts, failed, iters, reason = lax.while_loop(cond, body,
                                                                 s0)
        return X, iters, (t >= dt_total) & ~failed, reason

    # ---- mass-balance audit (ALM-style, MPPVSFMALM_Driver.F90:~660) -------
    def column_storage(self, X, dyn=None):
        """Total water storage per column [kmol]: sum of por*den*sat*vol
        over all cells (X [ncol, n])."""
        dyn = self._dyn_or_empty(dyn)

        def one(x, dy):
            tot = 0.0
            for k, (g, off) in enumerate(zip(self.goveqns,
                                             self.offsets[:-1])):
                P = x[off:off + g.mesh.ncells_local]
                active = jnp.asarray(g.mesh.is_active)
                tot = tot + jnp.sum(jnp.where(active,
                                              g.accum(P, dyn=dy[k]), 0.0))
            return tot
        return jax.vmap(one)(X, dyn)

    def column_bc_flux(self, X, bc_values, dyn=None):
        """Net assembled BC flux per column [kmol/s], with the residual's
        sign convention (F_cell += flux): storage change per implicit
        step satisfies ΔS = -dt * column_bc_flux(X_new, bc) + dt*sources
        at exact convergence."""
        if not any(len(g._bc_concat()[0]) for g in self.goveqns):
            return jnp.zeros(X.shape[0], X.dtype)
        dyn = self._dyn_or_empty(dyn)

        def one(x, bcs, dy):
            tot = 0.0
            for k, (g, off) in enumerate(zip(self.goveqns,
                                             self.offsets[:-1])):
                P = x[off:off + g.mesh.ncells_local]
                aux = g._cell_aux(P, dy[k])
                bc_ids, flux_b, _, _ = g._bc_fluxes(P, aux, bcs[k], dy[k])
                if bc_ids.size:
                    tot = tot + jnp.sum(flux_b)
            return tot
        return jax.vmap(one)(X, bc_values, dyn)

    # ---- public API --------------------------------------------------------
    def _dyn_or_empty(self, dyn):
        if dyn is None:
            return tuple({} for _ in self.goveqns)
        dyn = tuple(dict(d) for d in dyn)
        if any(("sat" in d or "perm" in d or "por_base" in d) for d in dyn) \
                and any(s.size for s in self._otr_slots):
            raise NotImplementedError(
                "dynamic constitutive parameters are not supported on "
                "problems with coupled-GE BCs (update_connections swaps "
                "BC-side parameters between GEs; the dyn gather assumes "
                "own-cell inheritance)")
        return dyn

    def step_batched(self, X, bc_values, ss_values, dt, src=None, dyn=None,
                     rtol=None, stol=None, mass_tol_kg=None):
        """Batched step: X [ncol, n]; bc_values/ss_values tuples of
        [ncol, nbc_g]/[ncol, nss_g] per GE; optional ``src`` [ncol, n]
        per-cell mass source (operator-split lateral coupling); optional
        ``dyn`` tuple of per-GE dynamic-parameter dicts with leading
        [ncol] batch axes (per-column heterogeneous soils — the ALM
        production contract); optional ``rtol``/``stol`` scalar overrides
        (dynamic: the retry ladder re-solves without recompiling);
        optional ``mass_tol_kg``: per-column mass-closure convergence
        gate — a column keeps iterating until |sum F|*dt*FMWH2O is under
        this bound (the ALM audit integrand), so the f32 path meets the
        production audit without escalating healthy columns.
        Returns (X, total_newton_iters, success[ncol], reason[ncol])."""
        if src is None:
            src = jnp.zeros_like(X)
        dyn = self._dyn_or_empty(dyn)
        sp = self.snes if X.dtype == jnp.float64 else self.snes_f32
        tols = (jnp.asarray(sp.rtol if rtol is None else rtol, X.dtype),
                jnp.asarray(sp.stol if stol is None else stol, X.dtype),
                jnp.asarray(0.0 if mass_tol_kg is None else mass_tol_kg,
                            X.dtype))
        return self._step_jit(X, tuple(bc_values), tuple(ss_values), dt,
                              src, dyn, tols)

    def gather_inputs(self, ncol=1):
        """Current staged BC/SS condition values, broadcast to ncol."""
        bc = tuple(jnp.broadcast_to(g.bc_value, (ncol,) + g.bc_value.shape)
                   for g in self.goveqns)
        ss = tuple(jnp.broadcast_to(g.ss_value, (ncol,) + g.ss_value.shape)
                   for g in self.goveqns)
        return bc, ss

    def install(self):
        """Route the SoE's ``step_dt`` through the compiled path, so
        existing facade problem drivers run on the batched production path
        without modification."""
        self.mpp.soe.step_dt = self.step_dt
        return self

    def step_dt(self, dt, istep=1):
        """Drop-in replacement for ``soe.step_dt`` running the compiled
        batched path at ncol=1; updates the SoE solution state."""
        soe = self.mpp.soe
        bc, ss = self.gather_inputs(1)
        X = soe.soln[None, :]
        Xn, iters, ok, reason = self.step_batched(X, bc, ss, dt)
        converged = bool(ok[0])
        if converged:
            soe.cumulative_newton_iterations += int(iters)
            soe.soln = Xn[0]
            soe.soln_prev = soe.soln
            for g, off in zip(self.goveqns, self.offsets[:-1]):
                g.pressure = soe.soln[off:off + g.mesh.ncells_local]
        if soe.metrics is not None:
            soe.metrics.record(step=istep, dt=dt, converged=converged,
                               reason=int(reason[0]),
                               newton_iterations=int(iters))
        return converged, int(reason[0])


def compile_vsfm(mpp, **kw) -> CompiledVSFM:
    """Freeze a fully-staged ``VSFMMPP`` into a compiled batched stepper.

    Call after the 8-step builder sequence, property staging, and (for
    coupled problems) ``update_connections()``.  Constitutive parameters
    default to the staged trace-time values; BC/SS condition values are
    always dynamic inputs, and per-column parameter arrays can be passed
    per step via ``step_batched(..., dyn=...)``."""
    return CompiledVSFM(mpp, **kw)
