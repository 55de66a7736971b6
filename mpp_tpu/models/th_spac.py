"""Multi-mesh coupled TH system of equations (SPAC network).

Generalizes the 2-GE single-mesh ``THSoE`` to the reference's
th_manoli2014 configuration (``src/driver/standalone/thermal-e/
th_manoli2014_problem.F90``): N meshes, each carrying a Richards mass GE
and an enthalpy energy GE (:818-861), pairwise-coupled internally
(mass<->energy share P and T on each mesh, :865-890) and across meshes
at coupling connections (soil<->root over every root layer,
root<->xylem at the junction; b_cpl_data :891-967).

Batched design decisions (deviations from the reference mechanics,
same physics):

* Cross-mesh coupling fluxes are computed ONCE per connection at the
  SoE level with internal-connection weighting (harmonic permeability /
  thermal conductivity, distance-weighted density) and scatter-added
  with opposite signs to both sides — the reference evaluates the same
  flux twice through per-GE COND_DIRICHLET_FRM_OTR_GOVEQ boundary
  conditions with a swap_order re-evaluation (RichardsMod.F90:96-113),
  which is not exactly antisymmetric (see KNOWN_GAPS.md #7).  The
  single-evaluation form is exactly conservative.
* The Jacobian of the full coupled residual is obtained by COLORED
  forward-mode autodiff: the structural sparsity (per-mesh two-point
  stencils in the 2x2 P/T variable blocks + cross-mesh coupling entries)
  is built once at setup, its columns are distance-2 greedy-colored
  (~10-20 colors independent of n), and each Newton iteration evaluates
  ``ncolors`` JVPs of the jitted residual into a compressed Jacobian
  whose entries scatter into a CSR template — memory and compute LINEAR
  in n, replacing both the reference's 6x6 grid of hand-written
  off-diagonal blocks (SystemOfEquationsTHType.F90:853-1005) and the
  round-2 dense ``jax.jacfwd`` (O(n²)).  The linear solve is the
  framework's ILU(0)+GMRES at tight tolerance.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mpp_tpu.constants import SOEType
from mpp_tpu.dtypes.mpp_base import MPPBase
from mpp_tpu.constants import GEType
from mpp_tpu.models.richards import RichardsGE, darcy_flux
from mpp_tpu.models.thermal_enthalpy import (ThermalEnthalpyGE,
                                             enthalpy_flux)


@dataclasses.dataclass
class CouplingConnSet:
    """A cross-mesh two-point coupling set between mesh pair (ia, ib).

    Flux is evaluated with side b in the 'up' slot and side a in the
    'dn' slot; ``unit_z`` is the up->dn unit vector's z-component (the
    b->a direction), so gravity enters exactly as for an internal
    connection."""
    ia: int
    ib: int
    cells_a: np.ndarray
    cells_b: np.ndarray
    dist_a: np.ndarray     # dn-side half distance
    dist_b: np.ndarray     # up-side half distance
    area: np.ndarray
    unit_z: np.ndarray


class THSpacSoE:
    """N-pair coupled TH Newton solve on X = [P_1..P_N; T_1..T_N]."""

    def __init__(self):
        self.mass_ges: List[RichardsGE] = []
        self.energy_ges: List[ThermalEnthalpyGE] = []
        self.couplings: List[CouplingConnSet] = []
        self.itype = int(SOEType.TH)
        self.soln = None
        self.soln_prev = None
        self.use_dynamic_linesearch = False
        self.snes_stol = 1e-10
        self.rtol = 1e-8
        self.atol = 1e-50
        self.max_it = 50
        self.cumulative_newton_iterations = 0
        self.cumulative_linear_iterations = 0
        self.metrics = None

    @property
    def goveqns(self):
        return list(self.mass_ges) + list(self.energy_ges)

    def setup(self):
        sizes = [g.mesh.ncells_local for g in self.mass_ges]
        self.sizes = sizes
        self.offsets = np.concatenate([[0], np.cumsum(sizes)])
        self.ntot = int(self.offsets[-1])
        self.soln = jnp.zeros(2 * self.ntot)
        self.soln_prev = jnp.zeros(2 * self.ntot)
        self._jac_plan = None

    # -- sparse Jacobian plan (built lazily after couplings exist) ---------
    def _build_jac_plan(self):
        """Structural sparsity + distance-2 column coloring + CSR template.

        Cell-level adjacency: each mesh's two-point stencil (the mass GE's
        COO pattern, which covers the energy GE on the same mesh) plus the
        cross-mesh coupling pairs; expanded to the 2n unknowns as the 2x2
        {P,T} variable blocks (every flux/accumulation term depends on
        both P and T of its stencil cells)."""
        from mpp_tpu.ops.sparse import csr_template
        from mpp_tpu.ops.ilu import ILU0

        rows, cols = [], []
        for i, (gm, ge) in enumerate(zip(self.mass_ges, self.energy_ges)):
            off = int(self.offsets[i])
            for g in (gm, ge):
                r, c = g.coo_coords(off, off)
                rows.append(r.astype(np.int64))
                cols.append(c.astype(np.int64))
        for c_ in self.couplings:
            a = self.offsets[c_.ia] + np.asarray(c_.cells_a, np.int64)
            b = self.offsets[c_.ib] + np.asarray(c_.cells_b, np.int64)
            rows += [a, b]
            cols += [b, a]
        rows = np.concatenate(rows)
        cols = np.concatenate(cols)
        n = self.ntot
        R = np.concatenate([rows, rows, rows + n, rows + n])
        C = np.concatenate([cols, cols + n, cols, cols + n])
        tpl = csr_template(2 * n, 2 * n, R, C)

        # distance-2 greedy coloring of columns (two columns conflict if
        # any row contains both); colors ~ max row degree, not n
        nn = 2 * n
        row_ids = tpl.row_ids()
        cols_csr = tpl.indices
        rows_of_col = [[] for _ in range(nn)]
        for e in range(cols_csr.size):
            rows_of_col[cols_csr[e]].append(row_ids[e])
        cols_of_row = [cols_csr[tpl.indptr[r]:tpl.indptr[r + 1]]
                       for r in range(nn)]
        color = np.full(nn, -1, np.int64)
        for j in range(nn):
            forbidden = set()
            for r in rows_of_col[j]:
                for j2 in cols_of_row[r]:
                    if color[j2] >= 0:
                        forbidden.add(int(color[j2]))
            k = 0
            while k in forbidden:
                k += 1
            color[j] = k
        ncolors = int(color.max()) + 1
        seeds = np.zeros((ncolors, nn))
        seeds[color, np.arange(nn)] = 1.0
        self._jac_plan = {
            "tpl": tpl,
            "entry_row": jnp.asarray(row_ids.astype(np.int32)),
            "entry_color": jnp.asarray(color[cols_csr].astype(np.int32)),
            "seeds": jnp.asarray(seeds),
            "ncolors": ncolors,
            "ilu": ILU0(tpl.indptr, tpl.indices),
        }

    def _sparse_jac_data(self, res, X):
        """CSR data of J = dres/dX via ``ncolors`` JVPs (compressed
        Jacobian; exact under the distance-2 coloring)."""
        plan = self._jac_plan
        compressed = jax.vmap(
            lambda s: jax.jvp(res, (X,), (s,))[1])(plan["seeds"])
        return compressed[plan["entry_color"], plan["entry_row"]]

    # -- functional pieces -------------------------------------------------
    def _split(self, X):
        P = [X[self.offsets[i]:self.offsets[i + 1]]
             for i in range(len(self.sizes))]
        T = [X[self.ntot + self.offsets[i]:self.ntot + self.offsets[i + 1]]
             for i in range(len(self.sizes))]
        return P, T

    def _mass_coupling_flux(self, c: CouplingConnSet, P, T):
        """Internal-style Darcy flux between the coupled cells."""
        ga, gb = self.mass_ges[c.ia], self.mass_ges[c.ib]
        ga.temperature = T[c.ia]
        gb.temperature = T[c.ib]
        aux_a = ga._cell_aux(P[c.ia])
        aux_b = gb._cell_aux(P[c.ib])
        (sat_a, _, kr_a, dkr_a, den_a, dden_a, vis_a, dvis_a, _, _) = aux_a
        (sat_b, _, kr_b, dkr_b, den_b, dden_b, vis_b, dvis_b, _, _) = aux_b
        ca, cb = jnp.asarray(c.cells_a), jnp.asarray(c.cells_b)
        perm_a = jnp.asarray(ga.perm[c.cells_a, 2])
        perm_b = jnp.asarray(gb.perm[c.cells_b, 2])
        flux, _, _ = darcy_flux(
            P[c.ib][cb], P[c.ia][ca], kr_b[cb], kr_a[ca], dkr_b[cb],
            dkr_a[ca], den_b[cb], den_a[ca], dden_b[cb], dden_a[ca],
            vis_b[cb], vis_a[ca], dvis_b[cb], dvis_a[ca], perm_b, perm_a,
            jnp.asarray(c.dist_b), jnp.asarray(c.dist_a),
            jnp.asarray(c.area), jnp.asarray(c.unit_z), internal=True)
        return flux

    def _energy_coupling_flux(self, c: CouplingConnSet, P, T):
        """Advective + conductive enthalpy flux between coupled cells."""
        ga, gb = self.energy_ges[c.ia], self.energy_ges[c.ib]
        a = ga._cell_aux_e(T[c.ia], P[c.ia])
        b = gb._cell_aux_e(T[c.ib], P[c.ib])
        ca, cb = jnp.asarray(c.cells_a), jnp.asarray(c.cells_b)
        perm_a = jnp.asarray(ga.perm[c.cells_a, 2])
        perm_b = jnp.asarray(gb.perm[c.cells_b, 2])
        mflux, _, _ = darcy_flux(
            P[c.ib][cb], P[c.ia][ca], b["kr"][cb], a["kr"][ca],
            b["dkr_dP"][cb], a["dkr_dP"][ca], b["den"][cb], a["den"][ca],
            b["dden_dP"][cb], a["dden_dP"][ca], b["vis"][cb], a["vis"][ca],
            b["dvis_dP"][cb], a["dvis_dP"][ca], perm_b, perm_a,
            jnp.asarray(c.dist_b), jnp.asarray(c.dist_a),
            jnp.asarray(c.area), jnp.asarray(c.unit_z), internal=True)
        eflux, _, _ = enthalpy_flux(
            T[c.ib][cb], T[c.ia][ca], b["hl"][cb], a["hl"][ca],
            b["tc"][cb], a["tc"][ca], jnp.asarray(c.dist_b),
            jnp.asarray(c.dist_a), jnp.asarray(c.area), mflux,
            internal=True)
        return eflux

    def _residual_pure(self, X, accum_prev_m, accum_prev_e, dt):
        P, T = self._split(X)
        Fm, Fe = [], []
        for i, (gm, ge) in enumerate(zip(self.mass_ges, self.energy_ges)):
            gm.temperature = T[i]
            gm.accum_prev = accum_prev_m[i]
            Fm.append(gm.residual(P[i], dt))
            ge.accum_prev = accum_prev_e[i]
            Fe.append(ge.residual_e(T[i], P[i], dt))
        for c in self.couplings:
            mflux = self._mass_coupling_flux(c, P, T)
            ca, cb = jnp.asarray(c.cells_a), jnp.asarray(c.cells_b)
            Fm[c.ia] = Fm[c.ia].at[ca].add(mflux)
            Fm[c.ib] = Fm[c.ib].at[cb].add(-mflux)
            eflux = self._energy_coupling_flux(c, P, T)
            Fe[c.ia] = Fe[c.ia].at[ca].add(eflux)
            Fe[c.ib] = Fe[c.ib].at[cb].add(-eflux)
        return jnp.concatenate(Fm + Fe)

    # -- solver ------------------------------------------------------------
    def _accums(self, X, dt):
        P, T = self._split(jnp.asarray(X))
        am, ae = [], []
        for i, (gm, ge) in enumerate(zip(self.mass_ges, self.energy_ges)):
            gm.temperature = T[i]
            act = jnp.asarray(gm.mesh.is_active)
            am.append(jnp.where(act, gm.accum(P[i]) / dt, 0.0))
            ae.append(jnp.where(jnp.asarray(ge.mesh.is_active),
                                ge.accum_e(T[i], P[i]) / dt, 0.0))
        return am, ae

    def step_dt(self, dt, nstep=1):
        """Newton with backtracking on the full coupled system; dt-cut
        ladder with SOEBaseStepDT_SNES semantics."""
        time = 0.0
        dt_iter = float(dt)
        num_time_cuts = 0
        converged = False
        reason = 0
        while True:
            ok, its = self._newton(dt_iter)
            if not ok:
                num_time_cuts += 1
                dt_iter *= 0.5
                self.soln = self.soln_prev
                reason = -3
            else:
                converged = True
                reason = 3
                time += dt_iter
                self.cumulative_newton_iterations += its
                self.soln_prev = self.soln
            if num_time_cuts > 20:
                if self.metrics is not None:
                    self.metrics.record(step=nstep, dt=dt, converged=False,
                                        reason=int(reason),
                                        dt_cuts=num_time_cuts)
                return False, reason
            if time >= dt * (1.0 - 1e-12):
                break
        if self.metrics is not None:
            self.metrics.record(step=nstep, dt=dt, dt_used=dt_iter,
                                converged=converged, reason=int(reason),
                                dt_cuts=num_time_cuts,
                                newton_iterations=int(its))
        return converged, reason

    def _newton(self, dt):
        from mpp_tpu.ops.ilu import petsc_gmres
        am, ae = self._accums(self.soln_prev, dt)
        res = partial(self._residual_pure, accum_prev_m=am,
                      accum_prev_e=ae, dt=dt)
        if self._jac_plan is None:
            self._build_jac_plan()
        plan = self._jac_plan
        tpl = plan["tpl"]
        X = jnp.asarray(self.soln)
        F = res(X)
        fnorm = float(jnp.linalg.norm(F))
        if not np.isfinite(fnorm):
            return False, 0
        ttol = max(fnorm * self.rtol, self.atol)
        for it in range(self.max_it):
            data = np.asarray(self._sparse_jac_data(res, X))
            lu = plan["ilu"].factor(data)
            dx, lin_its, _ = petsc_gmres(tpl.indptr, tpl.indices, data,
                                         -np.asarray(F), pc=plan["ilu"],
                                         pc_data=lu, rtol=1e-12, atol=1e-50)
            self.cumulative_linear_iterations += int(lin_its)
            lam = 1.0
            for _ in range(12):          # simple backtracking
                Xn = X + lam * jnp.asarray(dx)
                Fn = res(Xn)
                fn = float(jnp.linalg.norm(Fn))
                if np.isfinite(fn) and fn <= fnorm * (1.0 - 1e-4 * lam) \
                        or fn < ttol:
                    break
                lam *= 0.5
            else:
                return False, it + 1
            snorm = lam * float(np.linalg.norm(dx))
            X, F, fnorm = Xn, Fn, fn
            xnorm = float(jnp.linalg.norm(X))
            if fnorm < ttol or snorm < self.snes_stol * xnorm:
                self.soln = X
                return True, it + 1
        return False, self.max_it


class THSpacMPP(MPPBase):
    """Facade for the multi-mesh TH SPAC problem (MPP_TH_SNES_CLM)."""

    def __init__(self):
        super().__init__()
        self.soe = THSpacSoE()

    def add_goveqn(self, ge_type, name, mesh_index):
        mesh = self.meshes[mesh_index]
        if ge_type == GEType.RE:
            self.soe.mass_ges.append(RichardsGE(name=name, mesh=mesh))
            return len(self.soe.mass_ges)
        if ge_type == GEType.THERM_SOIL_EBASED:
            self.soe.energy_ges.append(ThermalEnthalpyGE(name=name,
                                                         mesh=mesh))
            return len(self.soe.energy_ges)
        raise NotImplementedError(ge_type)

    def add_coupling(self, ia, ib, cells_a, cells_b, dist_a, dist_b, area,
                     unit_z):
        self.soe.couplings.append(CouplingConnSet(
            ia=ia, ib=ib,
            cells_a=np.asarray(cells_a, np.int64),
            cells_b=np.asarray(cells_b, np.int64),
            dist_a=np.asarray(dist_a, np.float64),
            dist_b=np.asarray(dist_b, np.float64),
            area=np.asarray(area, np.float64),
            unit_z=np.asarray(unit_z, np.float64)))

    def restart(self, press_1d, temp_1d):
        soe = self.soe
        X = jnp.concatenate([jnp.asarray(np.asarray(press_1d, np.float64)),
                             jnp.asarray(np.asarray(temp_1d, np.float64))])
        soe.soln = X
        soe.soln_prev = X
