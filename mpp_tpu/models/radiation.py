"""Canopy radiation transfer: shortwave and longwave GEs (KSP path).

JAX reimplementation of:

* ``ge/GoveqnShortwave.F90`` — two-band (vis/nir) two-stream canopy
  shortwave: dof=4 per cell [Iup_vis, Idn_vis, Iup_nir, Idn_nir]; auxvar
  coefficients e/f/rad_source per band (``auxvar/ShortwaveAuxType.F90:
  131-169``); post-solve absorbed-radiation recovery (:532-602).
* ``ge/GoveqnLongwave.F90`` — single-band longwave with absorbed flux as a
  third dof [Iup, Idn, Iabs]; auxvar coefficients
  (``auxvar/LongwaveAuxType.F90:89-137``).

The layer graph is a vertical column (soil cell at the bottom, canopy
layers above, Dirichlet sky forcing at the top).  Both systems assemble a
banded CSR matrix solved with the PETSc-default-compatible GMRES+ILU(0)
(ops/ilu.py) so answers match the reference goldens.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import jax.numpy as jnp

from mpp_tpu.constants import (Cond, GEType, SOEType, Var, AuxVarKind,
                               STEFAN_BOLTZMAN_CONSTANT)
from mpp_tpu.dtypes.mesh import Mesh, ConnectionSet, concat_connection_sets
from mpp_tpu.dtypes.conditions import Condition
from mpp_tpu.dtypes.mpp_base import MPPBase
from mpp_tpu.ops.sparse import csr_template, CSRTemplate
from mpp_tpu.ops.ilu import ILU0, petsc_gmres


def _solve_ksp(template: CSRTemplate, coo_vals, b, ilu_cache):
    data = np.asarray(template.assemble(jnp.asarray(coo_vals)))
    if ilu_cache.get("ilu") is None:
        ilu_cache["ilu"] = ILU0(template.indptr, template.indices)
    ilu = ilu_cache["ilu"]
    lu = ilu.factor(data)
    x, iters, conv = petsc_gmres(template.indptr, template.indices, data,
                                 np.asarray(b), pc=ilu, pc_data=lu)
    return x, iters, conv


def _top_bot(mesh: Mesh, cs: ConnectionSet):
    """Per-connection (bottom cell, top cell) by z comparison
    (GoveqnShortwave.F90:400-417)."""
    z = mesh.zc
    up, dn = cs.id_up, cs.id_dn
    up_is_top = z[up] > z[dn]
    bot = np.where(up_is_top, dn, up)
    top = np.where(up_is_top, up, dn)
    return bot, top


@dataclasses.dataclass
class ShortwaveGE:
    """GE_SHORTWAVE (dof=4: [Iup_b1, Idn_b1, Iup_b2, Idn_b2])."""
    name: str
    mesh: Mesh
    itype: int = int(GEType.SHORTWAVE)
    dof: int = 4
    nband: int = 2
    nleaf: int = 2
    boundary_conditions: List[Condition] = dataclasses.field(default_factory=list)

    def allocate_auxvars(self):
        n = self.mesh.ncells_all
        nb = self.nband
        self.is_soil = np.zeros(n, bool)
        z = lambda *s: jnp.zeros(s)
        self.Iskyb = z(n, nb)
        self.Iskyd = z(n, nb)
        self.leaf_rho = z(n, nb)
        self.leaf_tau = z(n, nb)
        self.leaf_omega = z(n, nb)
        self.leaf_td = z(n)
        self.leaf_tb = z(n)
        self.leaf_tbcum = z(n)
        self.leaf_dpai = z(n)
        self.leaf_fssh = z(n, self.nleaf)
        self.soil_albedo_b = z(n, nb)
        self.soil_albedo_d = z(n, nb)
        nbc = sum(c.num_connections for c in self.boundary_conditions)
        self.bc_Iskyb = z(nbc, nb)
        self.bc_Iskyd = z(nbc, nb)
        self.Iup = z(n, nb)
        self.Idn = z(n, nb)
        self.Iabs_leaf = z(n, self.nleaf * nb)
        self.Iabs_soil = z(n, nb)

    def aux(self):
        """e, f, rad_source [n, nband] (ShortwaveAuxVarCompute)."""
        soil = jnp.asarray(self.is_soil)[:, None]
        aa = (1.0 - self.leaf_td)[:, None] * self.leaf_rho
        bb = (1.0 - self.leaf_td)[:, None] * self.leaf_tau + self.leaf_td[:, None]
        aa_safe = jnp.where(aa == 0, 1.0, aa)
        f_leaf = aa - bb * bb / aa_safe
        e_leaf = bb / aa_safe
        rs_leaf = self.Iskyb * (self.leaf_tbcum * (1.0 - self.leaf_tb))[:, None]
        f_soil = self.soil_albedo_b
        e_soil = jnp.zeros_like(f_soil)
        rs_soil = self.Iskyb * self.leaf_tbcum[:, None] * self.soil_albedo_d
        e = jnp.where(soil, e_soil, e_leaf)
        f = jnp.where(soil, f_soil, f_leaf)
        rs = jnp.where(soil, rs_soil, rs_leaf)
        return e, f, rs

    # dof helpers: 0-based dof index of (cell, band, which) with which 0=Iup,1=Idn
    def _idx(self, cells, band, which):
        return cells * self.dof + band * self.nband + which

    def coo_coords(self):
        n = self.mesh.ncells_local
        ic = concat_connection_sets(self.mesh.intrn_conn_sets)
        bot, top = _top_bot(self.mesh, ic)
        rows, cols = [np.arange(n * self.dof)], [np.arange(n * self.dof)]
        soil_cells = np.nonzero(self.is_soil)[0]
        for band in range(self.nband):
            r = self._idx(soil_cells, band, 0)
            rows.append(r)
            cols.append(r + 1)
            # connection entries (4 per conn per band)
            rows += [self._idx(bot, band, 1), self._idx(top, band, 0),
                     self._idx(bot, band, 1), self._idx(top, band, 0)]
            cols += [self._idx(bot, band, 0), self._idx(top, band, 1),
                     self._idx(top, band, 0), self._idx(bot, band, 1)]
        return np.concatenate(rows), np.concatenate(cols)

    def matrix_values(self):
        n = self.mesh.ncells_local
        e, f, rs = self.aux()
        ic = concat_connection_sets(self.mesh.intrn_conn_sets)
        bot, top = _top_bot(self.mesh, ic)
        vals = [jnp.ones(n * self.dof)]
        soil_cells = np.nonzero(self.is_soil)[0]
        topj = jnp.asarray(top)
        for band in range(self.nband):
            vals.append(-f[jnp.asarray(soil_cells), band])
            ftop = -f[topj, band]
            etop = -e[topj, band]
            vals += [ftop, ftop, etop, etop]
        return jnp.concatenate(vals)

    def rhs(self):
        n = self.mesh.ncells_local
        e, f, rs = self.aux()
        b = jnp.zeros(n * self.dof)
        cells = jnp.arange(n)
        soil = jnp.asarray(self.is_soil)
        for band in range(self.nband):
            up_idx = np.arange(n) * self.dof + band * self.nband
            val = jnp.where(soil, rs[:, band],
                            rs[:, band] * (self.leaf_rho[:, band]
                                           - self.leaf_tau[:, band] * e[:, band]))
            b = b.at[jnp.asarray(up_idx)].set(val)
        ic = concat_connection_sets(self.mesh.intrn_conn_sets)
        bot, top = _top_bot(self.mesh, ic)
        topj = jnp.asarray(top)
        for band in range(self.nband):
            dn_idx = bot * self.dof + band * self.nband + 1
            val = rs[topj, band] * (self.leaf_tau[topj, band]
                                    - self.leaf_rho[topj, band] * e[topj, band])
            b = b.at[jnp.asarray(dn_idx)].set(val)
        off = 0
        for cond in self.boundary_conditions:
            cs = cond.conn_set
            m = cs.num_connections
            for band in range(self.nband):
                idx = cs.id_dn * self.dof + band * self.nband + 1
                b = b.at[jnp.asarray(idx)].set(self.bc_Iskyd[off:off + m, band])
            off += m
        return b

    def save_soln(self, x):
        n = self.mesh.ncells_local
        x = jnp.asarray(x).reshape(n, self.dof)
        self.Iup = x[:, 0::2]
        self.Idn = x[:, 1::2]

    def post_solve(self):
        """Absorbed radiation recovery (ShortwavePostSolve:532-602)."""
        n = self.mesh.ncells_local
        soil = jnp.asarray(self.is_soil)[:, None]
        # diffuse absorbed: soil: (1-albedo_d)*Idn ; leaf: (1-td)(1-omega)*
        # (Idn_self + Iup_below)
        ic = concat_connection_sets(self.mesh.intrn_conn_sets)
        bot, top = _top_bot(self.mesh, ic)
        Iup_below = jnp.zeros((n, self.nband))
        Iup_below = Iup_below.at[jnp.asarray(top)].set(self.Iup[jnp.asarray(bot)])
        diffuse_soil = (1.0 - self.soil_albedo_d) * self.Idn
        diffuse_leaf = ((1.0 - self.leaf_td)[:, None]
                        * (1.0 - self.leaf_omega)
                        * (self.Idn + Iup_below))
        diffuse = jnp.where(soil, diffuse_soil, diffuse_leaf)
        direct_soil = (self.Iskyb * self.leaf_tbcum[:, None]
                       * (1.0 - self.soil_albedo_b))
        direct_leaf = (self.Iskyb * (self.leaf_tbcum * (1.0 - self.leaf_tb))[:, None]
                       * (1.0 - self.leaf_omega))
        self.Iabs_soil = jnp.where(soil, diffuse_soil + direct_soil, 0.0)
        sun = diffuse_leaf * self.leaf_fssh[:, 0:1] + direct_leaf
        shade = diffuse_leaf * self.leaf_fssh[:, 1:2]
        denom_sun = self.leaf_fssh[:, 0:1] * self.leaf_dpai[:, None]
        denom_shade = self.leaf_fssh[:, 1:2] * self.leaf_dpai[:, None]
        abs_sun = jnp.where(denom_sun > 0, sun / jnp.where(denom_sun == 0, 1, denom_sun), 0.0)
        abs_shade = jnp.where(denom_shade > 0, shade / jnp.where(denom_shade == 0, 1, denom_shade), 0.0)
        # layout [band0_sun, band0_shade, band1_sun, band1_shade]
        iabs = jnp.stack([abs_sun[:, 0], abs_shade[:, 0],
                          abs_sun[:, 1], abs_shade[:, 1]], axis=1)
        self.Iabs_leaf = jnp.where(soil, 0.0, iabs)


@dataclasses.dataclass
class LongwaveGE:
    """GE_LONGWAVE (dof=3: [Iup, Idn, Iabs])."""
    name: str
    mesh: Mesh
    itype: int = int(GEType.LONGWAVE)
    dof: int = 3
    nleaf: int = 1  # GoveqnLongwave.F90:66
    boundary_conditions: List[Condition] = dataclasses.field(default_factory=list)

    def allocate_auxvars(self):
        n = self.mesh.ncells_all
        z = lambda *s: jnp.zeros(s)
        self.is_soil = np.zeros(n, bool)
        self.trans = z(n)
        self.leaf_rho = z(n)
        self.leaf_tau = z(n)
        self.leaf_emiss = z(n)
        self.leaf_temperature = z(n, self.nleaf)
        self.leaf_fssh = z(n, self.nleaf)
        self.leaf_dpai = z(n, self.nleaf)
        self.ground_temperature = z(n)
        self.ground_emiss = z(n)
        nbc = sum(c.num_connections for c in self.boundary_conditions)
        self.bc_Idn = z(nbc)
        self.Iup = z(n)
        self.Idn = z(n)
        self.Iabs = z(n)

    def aux(self):
        """(e, f, rad_source) per cell (LongwaveAuxVarCompute)."""
        soil = jnp.asarray(self.is_soil)
        aa = (1.0 - self.trans) * self.leaf_tau + self.trans
        bb = (1.0 - self.trans) * self.leaf_rho
        bb_safe = jnp.where(bb == 0, 1.0, bb)
        e = aa / bb_safe
        f_leaf = bb - aa * aa / bb_safe
        f_soil = 1.0 - self.ground_emiss
        rs_soil = (STEFAN_BOLTZMAN_CONSTANT * self.ground_emiss
                   * self.ground_temperature ** 4.0)
        rs_leaf = jnp.sum(self.leaf_emiss[:, None] * STEFAN_BOLTZMAN_CONSTANT
                          * self.leaf_temperature ** 4.0 * self.leaf_fssh,
                          axis=1) * (1.0 - self.trans)
        f = jnp.where(soil, f_soil, f_leaf)
        rs = jnp.where(soil, rs_soil, rs_leaf)
        return e, f, rs

    def coo_coords(self):
        n = self.mesh.ncells_local
        ic = concat_connection_sets(self.mesh.intrn_conn_sets)
        bot, top = _top_bot(self.mesh, ic)
        d = self.dof
        soil_cells = np.nonzero(self.is_soil[:n])[0]
        leaf_cells = np.nonzero(~self.is_soil[:n])[0]
        rows = [np.arange(n * d)]
        cols = [np.arange(n * d)]
        # soil: (Iup,Idn), (Iabs,Iup), (Iabs,Idn)
        rows += [soil_cells * d, soil_cells * d + 2, soil_cells * d + 2]
        cols += [soil_cells * d + 1, soil_cells * d, soil_cells * d + 1]
        # leaf: (Iabs, Idn)
        rows += [leaf_cells * d + 2]
        cols += [leaf_cells * d + 1]
        # conns: (Idn_bot, Iup_bot), (Iup_top, Idn_top),
        #        (Idn_bot, Iup_top), (Iup_top, Idn_bot), (Iabs_top, Iup_bot)
        rows += [bot * d + 1, top * d, bot * d + 1, top * d, top * d + 2]
        cols += [bot * d, top * d + 1, top * d, bot * d + 1, bot * d]
        return np.concatenate(rows), np.concatenate(cols)

    def matrix_values(self):
        n = self.mesh.ncells_local
        e, f, rs = self.aux()
        ic = concat_connection_sets(self.mesh.intrn_conn_sets)
        bot, top = _top_bot(self.mesh, ic)
        soil_cells = jnp.asarray(np.nonzero(self.is_soil[:n])[0])
        leaf_cells = jnp.asarray(np.nonzero(~self.is_soil[:n])[0])
        topj = jnp.asarray(top)
        em_t = -self.leaf_emiss * (1.0 - self.trans)
        vals = [jnp.ones(n * self.dof),
                -f[soil_cells],
                jnp.ones(soil_cells.shape[0]),
                -jnp.ones(soil_cells.shape[0]),
                em_t[leaf_cells],
                -f[topj], -f[topj], -e[topj], -e[topj],
                em_t[topj]]
        return jnp.concatenate(vals)

    def rhs(self):
        n = self.mesh.ncells_local
        e, f, rs = self.aux()
        soil = jnp.asarray(self.is_soil[:n])
        b = jnp.zeros(n * self.dof)
        up_idx = jnp.asarray(np.arange(n) * self.dof)
        b = b.at[up_idx].set(jnp.where(soil, rs, (1.0 - e) * rs))
        b = b.at[up_idx + 2].set(jnp.where(soil, 0.0, -2.0 * rs))
        ic = concat_connection_sets(self.mesh.intrn_conn_sets)
        bot, top = _top_bot(self.mesh, ic)
        topj = jnp.asarray(top)
        b = b.at[jnp.asarray(bot * self.dof + 1)].set((1.0 - e[topj]) * rs[topj])
        off = 0
        for cond in self.boundary_conditions:
            cs = cond.conn_set
            m = cs.num_connections
            b = b.at[jnp.asarray(cs.id_dn * self.dof + 1)].set(
                self.bc_Idn[off:off + m])
            off += m
        return b

    def save_soln(self, x):
        n = self.mesh.ncells_local
        x = jnp.asarray(x).reshape(n, self.dof)
        self.Iup, self.Idn, self.Iabs = x[:, 0], x[:, 1], x[:, 2]


class _RadiationMPPBase(MPPBase):
    """Shared facade for the single-GE KSP canopy problems."""

    GE_CLS = None
    MPP_ID = 0

    def __init__(self):
        super().__init__()
        self.goveqns = []
        self._ilu_cache = {}
        self.template: Optional[CSRTemplate] = None
        self.block_template = None
        self.cumulative_linear_iterations = 0
        self.metrics = None

    @property
    def soe(self):
        return self

    def _goveqns(self):
        return self.goveqns

    def add_goveqn(self, name="ge", mesh_index=None):
        idx = mesh_index if mesh_index is not None else len(self.goveqns)
        ge = self.GE_CLS(name=name, mesh=self.meshes[idx])
        self.goveqns.append(ge)
        return len(self.goveqns)

    def setup_problem(self):
        pass

    def step_dt(self, dt, istep=1, solver="ksp"):
        """One KSP step.  ``solver="ksp"`` is the golden-parity path
        (GMRES+ILU(0) iterate, as PETSc records it); ``solver="block"``
        is the batched production path — the same COO values scattered
        into per-column block-tridiagonal form and solved exactly with the
        batched block-Thomas sweep (ops/block_structure.py)."""
        ge = self.goveqns[0]
        vals = ge.matrix_values()
        b = ge.rhs()
        if solver == "block":
            if self.block_template is None:
                from mpp_tpu.ops.block_structure import BlockTridiagTemplate
                r, c = ge.coo_coords()
                nlev = ge.mesh.nlev
                ncol = ge.mesh.ncells_local // nlev
                self.block_template = BlockTridiagTemplate(ncol, nlev,
                                                           ge.dof, r, c)
            x = self.block_template.solve(vals, b).reshape(-1)
            conv, iters = True, 1
        else:
            if self.template is None:
                r, c = ge.coo_coords()
                n = ge.mesh.ncells_local * ge.dof
                self.template = csr_template(n, n, r, c)
            x, iters, conv = _solve_ksp(self.template, vals, b,
                                        self._ilu_cache)
        self.cumulative_linear_iterations += iters
        ge.save_soln(x)
        if hasattr(ge, "post_solve"):
            ge.post_solve()
        if self.metrics is not None:
            self.metrics.record(step=istep, dt=dt, converged=bool(conv),
                                solver=solver, linear_iterations=int(iters))
        return bool(conv), 0


class ShortwaveMPP(_RadiationMPPBase):
    GE_CLS = ShortwaveGE


class LongwaveMPP(_RadiationMPPBase):
    GE_CLS = LongwaveGE
