"""Compiled batched KSP: facade-built linear problems on the batched path.

The analog of :mod:`~mpp_tpu.batched.vsfm_compiled` for the reference's
KSP stack (``SOEBaseStepDT_KSP``, SystemOfEquationsBaseType.F90:555-647
— one code path for every KSP SoE): a problem built through a KSP facade
(thermal 3-media today; the SoE only needs the ``contributions``
contract below) is frozen into one pure, jitted, batched
assemble+solve timestep:

* the SAME assembly code as the serial regression-parity path
  (``models/thermal.py`` ``contributions``, called with explicit dynamic
  inputs) — one physics implementation, two drivers;
* the cross-GE auxvar exchange (``ThermalSOEGovEqnExchangeAuxVars``,
  SystemOfEquationsThermalType.F90:770-919) becomes a pure gather of the
  partner GE's temperature/conductivity into per-connection slots;
* MATPREALLOCATOR's per-step sparsity re-discovery (:593-613) is
  amortized to trace time: the COO coordinates are static, assembly is a
  scatter-add;
* the linear solve is chosen from the discovered sparsity: batched
  Thomas when the global matrix is tridiagonal (single vertical chains),
  batched block-Thomas for level-major banded composites (the 3-media
  thermal problem: snow ⊕ ssw ⊕ soil with inter-GE Dirichlet coupling),
  else batched ILU(0)+GMRES(30) replicating the PETSc defaults.

Batching model matches ``CompiledVSFM``: the compiled problem has ``n``
unknowns; the batch axis replicates it over ``ncol`` independent columns
with per-column dynamic state (BC/SS values and the per-GE ``dyn``
dicts: liq/ice areal densities, snow state, surface fractions, dhsdT —
everything ELM stages per step through ``MPPThermalTBasedALM_Driver``).

GE contract consumed here (satisfied by ``ThermalSoilGE`` and its
snow/ssw subclasses): ``coo_coords``, ``coupling_coords``, ``aux(T,
dyn)``, ``contributions(T, dt, cnfac, ss_values, bc_value, exch_T,
exch_k, dyn) -> (vals, rhs, coupling_vals)``, plus the staged
``bc_value``/``ss_values`` attributes for the serial wrapper.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from mpp_tpu.constants import Cond


class CompiledKSP:
    """A facade-built KSP problem frozen into a jitted batched stepper.

    Drop-in serial use (regression parity, ncol=1)::

        comp = compile_ksp(mpp)
        comp.install()                  # soe.step_dt now runs compiled
        converged = soe.step_dt(dt)

    Batched use (production)::

        T, ok, iters = comp.step_batched(T, bc_values, ss_values, dt, dyn=dyn)
    """

    def __init__(self, mpp, linear_solver: str = "direct",
                 ksp_rtol: float = 1e-5, ksp_restart: int = 30):
        """``linear_solver``: "direct" (default) uses the exact batched
        solver (Thomas / block-Thomas / dense LU); "petsc" replicates the
        reference's GMRES(30)+ILU(0) at rtol 1e-5.  For tridiagonal
        operators the two coincide (ILU(0) of a tridiagonal matrix is its
        exact LU)."""
        self.mpp = mpp
        soe = mpp.soe
        if soe.template is None:
            soe.setup()
        self.soe = soe
        self.template = soe.template
        self.offsets = soe.offsets
        self.goveqns = list(soe.goveqns)
        self.n = soe.n_total
        self.cnfac = soe.cnfac
        self.linear_solver = linear_solver
        self.ksp_rtol = ksp_rtol
        self.ksp_restart = ksp_restart

        # pure-exchange plan: for each GE, the bc slots that are FRM_OTR
        # and the partner GE's global cell index they gather from
        self._exch_slots, self._exch_src = [], []
        for g in self.goveqns:
            slots, src = [], []
            off = 0
            for cond in g.boundary_conditions:
                m = cond.conn_set.num_connections
                if cond.itype == int(Cond.DIRICHLET_FRM_OTR_GOVEQ):
                    rank = cond.other_geq_rank
                    ids = np.asarray(cond.conn_set.id_up, np.int64)
                    slots.append(np.arange(off, off + m))
                    src.append(self.offsets[rank - 1] + ids)
                off += m
            self._exch_slots.append(
                np.concatenate(slots).astype(np.int32) if slots
                else np.zeros(0, np.int32))
            self._exch_src.append(
                np.concatenate(src).astype(np.int32) if src
                else np.zeros(0, np.int32))

        self._plan_solver()
        self._step_jit = jax.jit(self._step_batched_impl)

    # ---- solver plan ------------------------------------------------------
    def _coo(self):
        """Global COO coordinates in the exact order the concatenated
        ``contributions`` values are emitted: per-GE [diag, internal,
        bc-diag], then per-GE coupling tails (ThermalSOE.setup order)."""
        col_off_by_rank = {i + 1: self.offsets[i]
                           for i in range(len(self.goveqns))}
        rows_l, cols_l = [], []
        for g, off in zip(self.goveqns, self.offsets[:-1]):
            r, c = g.coo_coords(off, off)
            rows_l.append(np.asarray(r, np.int64))
            cols_l.append(np.asarray(c, np.int64))
        for g, off in zip(self.goveqns, self.offsets[:-1]):
            r, c = g.coupling_coords(off, col_off_by_rank)
            rows_l.append(np.asarray(r, np.int64))
            cols_l.append(np.asarray(c, np.int64))
        return np.concatenate(rows_l), np.concatenate(cols_l)

    def _plan_solver(self):
        coo_r, coo_c = self._coo()
        bw = int(np.abs(coo_r - coo_c).max(initial=0))
        self.is_tridiag = bw <= 1
        self.block_size = None
        self._ilu = None
        self._bt = None
        from mpp_tpu.batched.ilu_gmres import make_ell_matvec
        self._matvec = make_ell_matvec(self.template.indptr,
                                       self.template.indices)
        if self.is_tridiag:
            # direct-diagonal assembly: scatter each COO contribution
            # straight into (dl, d, du)
            band = coo_c - coo_r + 1
            self._tri_idx = [np.nonzero(band == b)[0].astype(np.int32)
                             for b in (0, 1, 2)]
            self._tri_rows = [coo_r[i].astype(np.int32)
                              for i in self._tri_idx]
            return
        if self.linear_solver == "petsc":
            from mpp_tpu.batched.ilu_gmres import BatchedILU0
            self._ilu = BatchedILU0(self.template.indptr,
                                    self.template.indices)
            return
        for b in range(bw, min(self.n // 2, 1024) + 1):
            # a candidate block size must both divide n AND give a true
            # block-tridiagonal cover: every entry within one block row of
            # the diagonal (a non-level-major ordering can satisfy the
            # bandwidth test yet scatter entries outside the blocks)
            if self.n % b == 0 and \
                    (np.abs(coo_r // b - coo_c // b) <= 1).all():
                self.block_size = b
                break
        if self.block_size is not None:
            from mpp_tpu.ops.block_structure import BlockTridiagTemplate
            self._bt = BlockTridiagTemplate(1, self.n // self.block_size,
                                            self.block_size, coo_r, coo_c)
        elif self.n > 4096:
            raise ValueError(
                f"no banded structure found and n={self.n} too large for "
                "batched dense LU")

    # ---- pure single-column evaluation ------------------------------------
    def _assemble_one(self, T, bc_values, ss_values, dt, dyn):
        """(concatenated A values in _coo order, rhs b) — pure."""
        ks = []
        for k, (g, off) in enumerate(zip(self.goveqns, self.offsets[:-1])):
            Tg = T[off:off + g.mesh.ncells_local]
            k_cell, _cap = g.aux(Tg, dyn[k])
            ks.append(k_cell)
        vals_l, b_l, cpl_l = [], [], []
        for k, (g, off) in enumerate(zip(self.goveqns, self.offsets[:-1])):
            Tg = T[off:off + g.mesh.ncells_local]
            nbc = sum(c.num_connections for c in g.boundary_conditions)
            exch_T = jnp.zeros(nbc, T.dtype)
            exch_k = jnp.ones(nbc, T.dtype)
            if self._exch_slots[k].size:
                slots = jnp.asarray(self._exch_slots[k])
                src = jnp.asarray(self._exch_src[k])
                exch_T = exch_T.at[slots].set(T[src])
                k_all = jnp.concatenate(ks)
                exch_k = exch_k.at[slots].set(k_all[src])
            v, b, cpl = g.contributions(Tg, dt, self.cnfac, ss_values[k],
                                        bc_value=bc_values[k],
                                        exch_T=exch_T, exch_k=exch_k,
                                        dyn=dyn[k])
            vals_l.append(v)
            b_l.append(b)
            cpl_l.append(cpl)
        vals = jnp.concatenate(vals_l + cpl_l).astype(T.dtype)
        b = jnp.concatenate(b_l).astype(T.dtype)
        return vals, b

    def _solve_one_direct_blocks(self, vals, b):
        L, D, U = self._bt.assemble(vals)
        from mpp_tpu.ops.block_thomas import block_thomas
        nlev = self.n // self.block_size
        x = block_thomas(L, D, U, b.reshape(1, nlev, self.block_size))
        return x.reshape(-1)

    def _step_batched_impl(self, T, bc, ss, dt, dyn):
        asm = jax.vmap(self._assemble_one, in_axes=(0, 0, 0, None, 0))
        vals, b = asm(T, bc, ss, dt, dyn)
        if self.is_tridiag:
            diags = []
            for i, rows in zip(self._tri_idx, self._tri_rows):
                diags.append(jnp.zeros((T.shape[0], self.n), T.dtype)
                             .at[:, jnp.asarray(rows)]
                             .add(vals[:, jnp.asarray(i)]))
            from mpp_tpu.ops.pallas_kernels import tridiag_solve
            x = tridiag_solve(*diags, b)
            return x, jnp.all(jnp.isfinite(x), axis=-1), jnp.ones((), jnp.int32)
        if self._ilu is not None:
            from mpp_tpu.batched.ilu_gmres import petsc_gmres_batched
            data = jax.vmap(self.template.assemble)(vals)
            lu = self._ilu.factor(data)
            x, cycles, conv = petsc_gmres_batched(self._matvec, data, b,
                                                  ilu=self._ilu, pc_data=lu,
                                                  rtol=self.ksp_rtol,
                                                  restart=self.ksp_restart)
            return x, conv & jnp.all(jnp.isfinite(x), axis=-1), cycles
        if self._bt is not None:
            x = jax.vmap(self._solve_one_direct_blocks)(vals, b)
            return x, jnp.all(jnp.isfinite(x), axis=-1), jnp.ones((), jnp.int32)
        data = jax.vmap(self.template.assemble)(vals)
        dense = jax.vmap(self.template.to_dense)(data)
        x = jnp.linalg.solve(dense, b[..., None])[..., 0]
        return x, jnp.all(jnp.isfinite(x), axis=-1), jnp.ones((), jnp.int32)

    # ---- public API -------------------------------------------------------
    def step_batched(self, T, bc_values, ss_values, dt, dyn=None):
        """Batched KSP step: T [ncol, n] (previous solution — the KSP
        path assembles operators AND rhs from it, SOEBaseStepDT_KSP);
        bc_values/ss_values tuples of [ncol, nbc_g]/[ncol, nss_g] per GE;
        ``dyn`` tuple of per-GE dynamic-state dicts with leading [ncol]
        axes.  Returns (T_new, ok[ncol], linear_iterations) — ``ok`` is
        the real per-column KSP convergence (GMRES residual-ratio test on
        the Krylov path; finite-solution check on direct solves), the
        batched analog of KSPGetConvergedReason
        (SystemOfEquationsBaseType.F90:625-645)."""
        if dyn is None:
            dyn = tuple({} for _ in self.goveqns)
        return self._step_jit(T, tuple(bc_values), tuple(ss_values), dt,
                              tuple(dict(d) for d in dyn))

    def gather_inputs(self, ncol=1):
        """Current staged BC/SS condition values, broadcast to ncol."""
        bc = tuple(jnp.broadcast_to(g.bc_value, (ncol,) + g.bc_value.shape)
                   for g in self.goveqns)
        ss = tuple(jnp.broadcast_to(g.ss_values,
                                    (ncol,) + g.ss_values.shape)
                   for g in self.goveqns)
        return bc, ss

    def install(self):
        """Route the SoE's ``step_dt`` through the compiled path, so
        existing facade problem drivers run on the batched production path
        without modification."""
        self.soe.step_dt = self.step_dt
        return self

    def step_dt(self, dt, solver=None, nstep: int = 1):
        """Drop-in replacement for the SoE's KSP ``step_dt`` at ncol=1;
        updates the SoE solution state (PostSolve semantics)."""
        soe = self.soe
        bc, ss = self.gather_inputs(1)
        T = soe.soln_prev[None, :]
        Tn, ok, iters = self.step_batched(T, bc, ss, dt)
        converged = bool(ok[0])
        soe.soln = Tn[0]
        soe.cumulative_linear_iterations += int(iters)
        soe.soln_prev = soe.soln
        for g, off in zip(self.goveqns, self.offsets[:-1]):
            g.temperature = soe.soln[off:off + g.mesh.ncells_local]
        if soe.metrics is not None:
            soe.metrics.record(step=nstep, dt=dt, converged=converged,
                               solver="compiled",
                               linear_iterations=int(iters))
        return converged


def compile_ksp(mpp, **kw) -> CompiledKSP:
    """Freeze a fully-staged KSP facade problem (ThermalMPP today) into a
    compiled batched stepper.

    Call after the 8-step builder sequence and property staging.  Static
    properties are baked in at trace time; BC/SS condition values and the
    per-GE ``dyn`` state dicts remain dynamic inputs."""
    return CompiledKSP(mpp, **kw)


class CompiledRadiation:
    """Compiled single-GE canopy radiation KSP step (longwave /
    shortwave facades, GoveqnLongwave/Shortwave KSP path).

    The radiation GEs' ``matrix_values``/``rhs`` are already pure
    vectorized jnp over the staged auxvars (no per-cell Python), so the
    compiled step jits assembly + the batched GMRES(30)+ILU(0) PETSc
    replication — the same golden-fidelity Krylov semantics as the
    serial ``_solve_ksp``, one XLA program per step."""

    def __init__(self, mpp, ksp_rtol: float = 1e-5, ksp_restart: int = 30):
        from mpp_tpu.ops.sparse import csr_template
        from mpp_tpu.batched.ilu_gmres import BatchedILU0, make_ell_matvec
        self.mpp = mpp
        ge = mpp.goveqns[0]
        r, c = ge.coo_coords()
        n = ge.mesh.ncells_local * ge.dof
        self.template = csr_template(n, n, r, c)
        self._ilu = BatchedILU0(self.template.indptr, self.template.indices)
        self._matvec = make_ell_matvec(self.template.indptr,
                                       self.template.indices)
        self.ksp_rtol = ksp_rtol
        self.ksp_restart = ksp_restart

        @jax.jit
        def solve(vals, b):
            from mpp_tpu.batched.ilu_gmres import petsc_gmres_batched
            data = self.template.assemble(vals)[None, :]
            lu = self._ilu.factor(data)
            x, cycles, conv = petsc_gmres_batched(
                self._matvec, data, b[None, :], ilu=self._ilu, pc_data=lu,
                rtol=self.ksp_rtol, restart=self.ksp_restart)
            return x[0], cycles, conv[0]
        self._jit = solve

    def install(self):
        self.mpp.step_dt = self.step_dt
        return self

    def step_dt(self, dt, istep=1, solver=None):
        m = self.mpp
        ge = m.goveqns[0]
        x, cycles, conv = self._jit(ge.matrix_values(), ge.rhs())
        converged = bool(conv)
        m.cumulative_linear_iterations += int(cycles)
        ge.save_soln(x)
        if hasattr(ge, "post_solve"):
            ge.post_solve()
        if m.metrics is not None:
            m.metrics.record(step=istep, dt=dt, converged=converged,
                             solver="compiled",
                             linear_iterations=int(cycles))
        return converged, 0


def compile_radiation(mpp, **kw) -> CompiledRadiation:
    """Freeze a staged Longwave/Shortwave facade problem into a
    compiled jitted assemble+solve."""
    return CompiledRadiation(mpp, **kw)
