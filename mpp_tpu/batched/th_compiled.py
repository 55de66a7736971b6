"""Compiled batched TH / thermal-enthalpy: the SNES thermal family on the
batched production path.

Closes the last "two stacks" gap of the SNES SoE families: a problem built
through the ``THMPP`` facade (coupled Richards mass + enthalpy energy,
``soe/SystemOfEquationsTHType.F90:736-1005``) or the standalone
``ThermalEnthalpyMPP`` (``soe/SystemOfEquationsThermalEnthalpyType.F90``)
is *compiled* into pure, jitted, batched steppers:

* :class:`CompiledTH` — proper Newton on X=[P;T] with the 2x2 block
  Jacobian (J11=dF_m/dP, J12=dF_m/dT, J21=dF_e/dP, J22=dF_e/dT), the
  pairwise auxvar exchange (mass GE receives T, energy GE receives P)
  as pure argument passing, SNES NEWTONLS + BT line search + per-column
  dt-cut ladders — all inherited from the CompiledVSFM machinery
  (batched/vsfm_compiled.py), with the SAME GE assembly code as the
  serial regression-parity path (models/thermal_enthalpy.py): one
  physics implementation, two drivers.
* :class:`CompiledThermalEnthalpy` — the standalone enthalpy SoE, whose
  reference residual callback freezes auxvars at soln_prev
  (``SystemOfEquationsThermalEnthalpyType.F90:352``) so each StepDT is
  exactly one linearized implicit-Euler update solved by the PETSc
  default ILU(0)+GMRES(30); here that whole step (accum_prev, residual,
  Jacobian assembly, batched ILU factor, batched GMRES, update) is one
  jitted program batched over columns.

The inner linear solve for the TH block system is the batched
PETSc-replica ILU(0)+GMRES(30) at rtol 1e-5 (batched/ilu_gmres.py), so
golden trajectories are reproduced through the compiled path.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from mpp_tpu.batched.vsfm_compiled import CompiledVSFM, SNESParams
from mpp_tpu.models.thermal_enthalpy import richards_offdiag_t_values


class CompiledTH(CompiledVSFM):
    """A facade-built TH problem frozen into a jitted batched stepper.

    Drop-in serial use (regression parity, ncol=1)::

        comp = compile_th(mpp).install()
        converged, reason = mpp.soe.step_dt(dt, istep)

    Batched use: ``step_batched(X, bc_values, ss_values, dt, dyn=...)``
    with X [ncol, 2n] = [P-block; T-block] per column, bc/ss tuples per
    GE (mass, energy), and ``dyn = (dyn_mass, dyn_energy)`` carrying the
    per-step staged cross-data: ``dyn_mass["bc_temperature"]`` [ncol,
    nbc_m] (mass-GE BC auxvar temperature) and
    ``dyn_energy["bc_pressure"]`` [ncol, nbc_e] (energy-GE BC auxvar
    pressure), the reference's driver-staged BC auxvar fields
    (mass_and_heat_model_problem.F90:556-652).
    """

    def __init__(self, mpp, snes: SNESParams = None, max_cuts: int = 20,
                 linear_solver: str = "petsc"):
        self.linear_solver = linear_solver
        self.mpp = mpp
        soe = mpp.soe
        if soe.template is None:
            soe.setup()
        self.ge_mass = soe.ge_mass
        self.ge_energy = soe.ge_energy
        self.goveqns = [self.ge_mass, self.ge_energy]
        if self.ge_mass.mesh.ncells_all != self.ge_mass.mesh.ncells_local:
            raise NotImplementedError("ghost cells in compiled TH")
        self.nh = soe.n                    # cells per GE
        self.n = 2 * soe.n                 # system size [P; T]
        self.offsets = [0, self.nh, self.n]
        self.template = soe.template
        self.snes = snes or SNESParams(stol=soe.snes_stol)
        self.snes_f32 = SNESParams(rtol=2e-4, atol=1e-8, stol=1e-6,
                                   ls_steptol=1e-8,
                                   ksp_rtol=self.snes.ksp_rtol)
        self.max_cuts = max_cuts
        self.compact_frac = 8
        self._ls_fused = False        # TH has no fused resjac form
        # no COND_DIRICHLET_FRM_OTR_GOVEQ coupling in the TH SoE: the
        # inter-GE coupling is the internal-auxvar exchange
        self._otr_slots = [np.zeros(0, np.int32)] * 2
        self._otr_src = [np.zeros(0, np.int32)] * 2
        self._plan_solver()
        self._step_jit = jax.jit(self._step_dt_batched)

    # ---- interleaved 2x2 block-tridiagonal direct solve -------------------
    def _plan_solver(self):
        """Batched direct solve for the TH 2x2 block system.

        The SoE template orders unknowns [P-block; T-block] (the
        reference's DMComposite layout, MultiPhysicsProbBaseType.F90:
        1120-1184); interleaving them per cell, x~ = [P_0, T_0, P_1,
        T_1, ...], turns the 2x2 block Jacobian (J11 tridiagonal,
        J12/J21/J22 at-most-tridiagonal — every TH coupling is a
        nearest-neighbor two-point flux) into a block-tridiagonal
        system with 2x2 blocks, solved exactly by the batched
        block-Thomas sweep (ops/block_thomas) in O(n) work per column
        — instead of a batched dense LU (O(n^3), and a pivoted LU
        serializes on its row pivots).  ``linear_solver=
        "petsc"`` (the default) keeps the reference-replica
        ILU(0)+GMRES(30) for golden-trajectory parity; "direct" is the
        production path (exact solve, so Newton trajectories match
        the f64 goldens to solver tolerance)."""
        t = self.template
        from mpp_tpu.batched.ilu_gmres import make_ell_matvec
        self.is_tridiag = False
        self.block_size = None
        self._ilu = None
        self._th_blk = None
        self._matvec = make_ell_matvec(t.indptr, t.indices)
        if self.linear_solver == "petsc":
            from mpp_tpu.batched.ilu_gmres import BatchedILU0
            self._ilu = BatchedILU0(t.indptr, t.indices)
            return
        nh = self.nh
        rows = t.row_ids().astype(np.int64)
        cols = t.indices.astype(np.int64)
        lev_r, slot_r = rows % nh, rows // nh
        lev_c, slot_c = cols % nh, cols // nh
        band = lev_c - lev_r
        if np.abs(band).max(initial=0) > 1:
            super()._plan_solver()      # not nearest-neighbor: generic plan
            return
        # CSR slot of each (band B, level i, rowslot a, colslot b) entry;
        # absent entries gather slot 0 and are masked to zero
        slots = np.zeros((3, nh, 2, 2), np.int64)
        mask = np.zeros((3, nh, 2, 2), np.float64)
        for s in range(rows.size):
            B = int(band[s]) + 1
            slots[B, lev_r[s], slot_r[s], slot_c[s]] = s
            mask[B, lev_r[s], slot_r[s], slot_c[s]] = 1.0
        self._th_blk = (jnp.asarray(slots), jnp.asarray(mask))

    def _solve(self, data, F):
        if getattr(self, "_th_blk", None) is None:
            return super()._solve(data, F)
        slots, mask = self._th_blk
        from mpp_tpu.ops.pallas_kernels import block_tridiag2_solve
        blk = data[:, slots] * mask.astype(data.dtype)  # [ncol,3,nh,2,2]
        b = jnp.stack([F[:, :self.nh], F[:, self.nh:]], axis=-1)
        x = block_tridiag2_solve(blk[:, 0], blk[:, 1], blk[:, 2], b)
        return jnp.concatenate([x[..., 0], x[..., 1]], axis=-1)

    # ---- pure single-column evaluation (the TH exchange + 2x2 blocks) ----
    def _dyn_mass(self, dyn, T):
        """Mass-GE dyn dict with the exchanged internal temperature
        (SOETHGovEqnExchangeAuxVars: mass GE receives T)."""
        d = dict(dyn[0])
        d["temperature"] = T
        return d

    def _residual_one(self, X, bc_values, ss_values, accum_prevs, dt,
                      src, dyn):
        P, T = X[:self.nh], X[self.nh:]
        F1 = self.ge_mass.residual(
            P, dt, bc_value=bc_values[0], ss_value=ss_values[0],
            accum_prev=accum_prevs[0], dyn=self._dyn_mass(dyn, T))
        F2 = self.ge_energy.residual_e(
            T, P, dt, bc_value=bc_values[1], ss_value=ss_values[1],
            accum_prev=accum_prevs[1],
            bc_pressure=dyn[1].get("bc_pressure"))
        F = jnp.concatenate([F1, F2]).astype(X.dtype)
        if src is not None:
            F = F - src
        return F

    def _jac_one(self, X, bc_values, ss_values, dt, dyn):
        """2x2 block Jacobian values in the SoE template's COO order
        [J11, J12, J21, J22] (SystemOfEquationsTHType.F90:853-1005)."""
        P, T = X[:self.nh], X[self.nh:]
        bcp = dyn[1].get("bc_pressure")
        v1 = self.ge_mass.jacobian_values(
            P, dt, bc_value=bc_values[0], ss_value=ss_values[0],
            dyn=self._dyn_mass(dyn, T))
        v12 = richards_offdiag_t_values(self.ge_mass, P, T, dt)
        v21 = self.ge_energy.offdiag_p_values(T, P, dt,
                                              bc_value=bc_values[1],
                                              bc_pressure=bcp)
        v2 = self.ge_energy.jacobian_e_values(T, P, dt,
                                              bc_value=bc_values[1],
                                              bc_pressure=bcp)
        return self.template.assemble(
            jnp.concatenate([v1, v12, v21, v2])).astype(X.dtype)

    def _resjac_one(self, X, bc_values, ss_values, accum_prevs, dt, src,
                    dyn):
        """TH evaluates residual and 2x2-block Jacobian separately (the
        energy GE + off-diagonal blocks have no fused form yet)."""
        F = self._residual_one(X, bc_values, ss_values, accum_prevs, dt,
                               src, dyn)
        A = self._jac_one(X, bc_values, ss_values, dt, dyn)
        return F, A

    def _accum_prev_one(self, X, dt, dyn):
        P, T = X[:self.nh], X[self.nh:]
        am_active = jnp.asarray(self.ge_mass.mesh.is_active)
        ae_active = jnp.asarray(self.ge_energy.mesh.is_active)
        am = jnp.where(am_active,
                       self.ge_mass.accum(P, dyn=self._dyn_mass(dyn, T))
                       / dt, 0.0)
        ae = jnp.where(ae_active, self.ge_energy.accum_e(T, P) / dt, 0.0)
        return (am.astype(X.dtype), ae.astype(X.dtype))

    # ---- audits: TH mass storage lives in the mass GE only ---------------
    def column_storage(self, X, dyn=None):
        dyn = self._dyn_or_empty(dyn)

        def one(x, dy):
            P, T = x[:self.nh], x[self.nh:]
            active = jnp.asarray(self.ge_mass.mesh.is_active)
            return jnp.sum(jnp.where(
                active, self.ge_mass.accum(P, dyn=self._dyn_mass(dy, T)),
                0.0))
        return jax.vmap(one)(X, dyn)

    def column_bc_flux(self, X, bc_values, dyn=None):
        raise NotImplementedError("TH BC flux audit")

    # ---- serial drop-in ---------------------------------------------------
    def _serial_dyn(self, ncol):
        bt = self.ge_mass.bc_temperature
        bp = self.ge_energy.bc_pressure
        return ({"bc_temperature": jnp.broadcast_to(bt, (ncol,) + bt.shape)},
                {"bc_pressure": jnp.broadcast_to(bp, (ncol,) + bp.shape)})

    def step_dt(self, dt, istep=1):
        soe = self.mpp.soe
        bc, ss = self.gather_inputs(1)
        X = soe.soln[None, :]
        Xn, iters, ok, reason = self.step_batched(X, bc, ss, dt,
                                                  dyn=self._serial_dyn(1))
        converged = bool(ok[0])
        if converged:
            soe.cumulative_newton_iterations += int(iters)
            soe.soln = Xn[0]
            soe.soln_prev = soe.soln
            self.ge_mass.pressure = soe.soln[:self.nh]
            self.ge_energy.temperature = soe.soln[self.nh:]
        if soe.metrics is not None:
            soe.metrics.record(step=istep, dt=dt, converged=converged,
                               reason=int(reason[0]),
                               newton_iterations=int(iters))
        return converged, int(reason[0])


class CompiledThermalEnthalpy:
    """Standalone enthalpy SoE compiled: one jitted linearized
    implicit-Euler update per step, batched over columns.

    The reference's SNES callbacks freeze auxvars at soln_prev
    (SystemOfEquationsThermalEnthalpyType.F90:352,285), so StepDT is a
    single inexact-Newton update T <- T_prev - (ILU-GMRES)(J, F) with J
    and F evaluated at T_prev; this class fuses accum_prev + residual +
    Jacobian assembly + batched ILU(0) factor + batched GMRES(30) into
    one program.
    """

    def __init__(self, mpp):
        from mpp_tpu.batched.ilu_gmres import BatchedILU0, make_ell_matvec
        self.mpp = mpp
        soe = mpp.soe
        if soe.template is None:
            soe.setup()
        self.ge = soe.ge
        self.template = soe.template
        self.n = soe.n
        t = self.template
        self._ilu = BatchedILU0(t.indptr, t.indices)
        self._matvec = make_ell_matvec(t.indptr, t.indices)
        self._step_jit = jax.jit(self._step_impl)

    def _step_impl(self, T_prev, P, bc_value, dt):
        ge = self.ge
        active = jnp.asarray(ge.mesh.is_active)

        def one(Tp, Pp, bcv):
            accum_prev = jnp.where(active, ge.accum_e(Tp, Pp) / dt, 0.0)
            F = ge.residual_e(Tp, Pp, dt, bc_value=bcv,
                              accum_prev=accum_prev)
            vals = ge.jacobian_e_values(Tp, Pp, dt, bc_value=bcv)
            return F, self.template.assemble(vals)

        F, data = jax.vmap(one)(T_prev, P, bc_value)
        from mpp_tpu.batched.ilu_gmres import petsc_gmres_batched
        lu = self._ilu.factor(data)
        dx, cycles, conv = petsc_gmres_batched(self._matvec, data, -F,
                                               ilu=self._ilu, pc_data=lu)
        return T_prev + dx, cycles, conv

    def step_batched(self, T_prev, P, bc_value, dt):
        """T_prev/P [ncol, n]; bc_value [ncol, nbc].  Returns
        (T_new, gmres_cycles, converged[ncol])."""
        return self._step_jit(T_prev, P, bc_value, dt)

    def install(self):
        self.mpp.soe.step_dt = self.step_dt_serial
        return self

    def step_dt_serial(self, dt, nstep=1):
        soe = self.mpp.soe
        ge = self.ge
        Tn, cycles, conv = self.step_batched(
            soe.soln_prev[None, :], ge.pressure[None, :self.n],
            ge.bc_value[None, :], dt)
        soe.soln = Tn[0]
        soe.soln_prev = soe.soln
        soe.cumulative_newton_iterations += 1
        soe.cumulative_linear_iterations += int(cycles)
        converged = bool(conv[0])
        if soe.metrics is not None:
            soe.metrics.record(step=nstep, dt=dt, converged=converged,
                               reason=2 if converged else -3,
                               newton_iterations=1,
                               linear_iterations=int(cycles))
        return converged, 2 if converged else -3


def compile_th(mpp, **kw) -> CompiledTH:
    """Freeze a fully-staged ``THMPP`` into a compiled batched stepper."""
    return CompiledTH(mpp, **kw)


def compile_thermal_enthalpy(mpp, **kw) -> CompiledThermalEnthalpy:
    """Freeze a fully-staged ``ThermalEnthalpyMPP`` into a compiled
    batched single-update stepper."""
    return CompiledThermalEnthalpy(mpp, **kw)
