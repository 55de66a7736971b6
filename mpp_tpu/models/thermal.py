"""Temperature-based soil heat transport (KSP path) — GE + SoE + MPP facade.

JAX reimplementation of the reference's thermal-T stack:

* auxvar constitutive update: ``ThermalKSPTemperatureSoilAuxType.F90:72-172``
  (CLM soil thermal conductivity / heat capacity model)
* assembly: ``GoveqnThermalKSPTemperatureSoilType.F90`` — Accum (:671-714),
  Divergence (:718-972), DiffHeatFlux (:976-1003), OperatorsDiag
  (:1007-1229)
* KSP stepper: ``SystemOfEquationsBaseType.F90:555-647`` (we solve the
  assembled system tightly instead of replaying PETSc GMRES; the
  reference's golden answers are converged to machine precision on its
  suites)
* soil property staging: ``MultiPhysicsProbThermal.F90:76-208``
  (MPPThermalSetSoils), including the copy of cell properties onto BC
  auxvars
* facade builder: ``MultiPhysicsProbBaseType.F90:32-74`` 8-step contract.

Design: per-cell state is SoA jnp arrays; topology and property model
selection are static numpy; one jitted function assembles CSR values + rhs
and solves.  The matrix is SPD -> CG with Jacobi preconditioning (dense
direct solve for small systems).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from mpp_tpu import constants as C
from mpp_tpu.constants import Cond, GEType, Var, AuxVarKind
from mpp_tpu.dtypes.mesh import Mesh, ConnectionSet
from mpp_tpu.dtypes.conditions import Condition
from mpp_tpu.dtypes.mpp_base import MPPBase
from mpp_tpu.ops.sparse import csr_template, CSRTemplate
from mpp_tpu.ops.ilu import ILU0, petsc_gmres


def thermal_soil_aux(T, liq, ice, snow_water, num_snow_layer, tuning,
                     lun_type, is_shallow, por, tkmg, tkdry, csol, dz):
    """Vectorized ``ThermKSPTempSoilAuxVarCompute``
    (ThermalKSPTemperatureSoilAuxType.F90:72-172).

    Returns (therm_cond, heat_cap_pva).  ``lun_type``/``is_shallow`` are
    static numpy; everything else may be traced.
    """
    lun_type = np.asarray(lun_type)
    is_shallow = np.asarray(is_shallow, bool)
    is_soil = np.isin(lun_type, (C.IST_SOIL, C.IST_CROP))
    is_wet = lun_type == C.IST_WET
    is_ice_lu = np.isin(lun_type, (C.IST_ICE, C.IST_ICE_MEC))

    # --- soil/crop branch ---------------------------------------------------
    satw = (liq / C.DENH2O + ice / C.DENICE) / (dz * por)
    satw = jnp.minimum(1.0, satw)
    wet_enough = satw > 0.1e-6
    satw_safe = jnp.where(wet_enough, satw, 1.0)
    dke_unfrozen = jnp.maximum(0.0, jnp.log10(satw_safe) + 1.0)
    dke = jnp.where(T >= C.TFRZ, dke_unfrozen, satw_safe)
    liq_frac_num = liq / (C.DENH2O * dz)
    ice_frac_num = ice / (C.DENICE * dz)
    denom = liq_frac_num + ice_frac_num
    fl = liq_frac_num / jnp.where(denom == 0, 1.0, denom)
    dksat = tkmg * C.TKWAT ** (fl * por) * C.TKICE ** ((1.0 - fl) * por)
    k_soil_shallow = jnp.where(wet_enough,
                               dke * dksat + (1.0 - dke) * tkdry, tkdry)
    k_soil = jnp.where(jnp.asarray(is_shallow), k_soil_shallow, C.THK_BEDROCK)
    cap = csol * (1.0 - por) * dz + ice * C.CPICE + liq * C.CPLIQ
    cap = cap + jnp.where(num_snow_layer == 0, snow_water * C.CPICE, 0.0)
    cap_soil = jnp.where(jnp.asarray(is_shallow), cap,
                         csol * (1.0 - por) * dz + ice * C.CPICE + liq * C.CPLIQ)
    cap_soil = cap_soil / dz

    # --- wetland / land-ice branches ---------------------------------------
    k_water = jnp.where(T < C.TFRZ, C.TKICE, C.TKWAT)
    cap_wi = (ice * C.CPICE + liq * C.CPLIQ
              + jnp.where(num_snow_layer == 0, snow_water * C.CPICE, 0.0)) / dz
    k_wet = jnp.where(jnp.asarray(is_shallow), k_water, C.THK_BEDROCK)
    cap_wet = jnp.where(jnp.asarray(is_shallow), cap_wi, csol)

    therm_cond = jnp.where(jnp.asarray(is_soil), k_soil,
                           jnp.where(jnp.asarray(is_wet), k_wet,
                                     jnp.where(jnp.asarray(is_ice_lu),
                                               k_water, 0.0)))
    heat_cap = jnp.where(jnp.asarray(is_soil), cap_soil,
                         jnp.where(jnp.asarray(is_wet), cap_wet,
                                   jnp.where(jnp.asarray(is_ice_lu),
                                             cap_wi, 0.0)))
    return therm_cond, heat_cap


_THIN_SFCLAYER = 1.0e-6  # thin-surface-layer threshold (Snow/SSW aux types)


def thermal_snow_aux(liq, ice, frac, dz):
    """Vectorized ``ThermKSPTempSnowAuxVarCompute``
    (ThermalKSPTemperatureSnowAuxType.F90:55-86): snow bulk-density
    conductivity and per-volume heat capacity."""
    frac_safe = jnp.where(frac > 0.0, frac, 1.0)
    bw = (ice + liq) / (frac_safe * dz)
    k = C.TKAIR + (7.75e-5 * bw + 1.105e-6 * bw * bw) * (C.TKICE - C.TKAIR)
    cap = jnp.where(frac > 0.0,
                    jnp.maximum(_THIN_SFCLAYER,
                                (C.CPLIQ * liq + C.CPICE * ice) / frac_safe),
                    _THIN_SFCLAYER)
    return k, cap / dz


def thermal_ssw_aux(frac, dz):
    """Vectorized ``ThermKSPTempSSWAuxVarCompute``
    (ThermalKSPTemperatureSSWAuxType.F90:45-74): standing surface water."""
    k = jnp.full_like(frac, C.TKWAT)
    thick = (dz * frac * 1.0e3 > _THIN_SFCLAYER) & (frac > _THIN_SFCLAYER)
    cap = jnp.where(thick, max(_THIN_SFCLAYER, C.CPLIQ * C.DENH2O),
                    _THIN_SFCLAYER)
    return k, cap


def _harmonic(k_up, k_dn, d_up, d_dn):
    """Distance-weighted harmonic mean conductivity
    (GoveqnThermalKSPTemperatureSoilType.F90:997-999)."""
    dist = d_up + d_dn
    return k_up * k_dn * dist / (k_up * d_dn + k_dn * d_up)


@dataclasses.dataclass
class ThermalSoilGE:
    """Soil thermal governing equation (GE_THERM_SOIL_TBASED)."""
    name: str
    mesh: Mesh
    itype: int = int(GEType.THERM_SOIL_TBASED)
    dof: int = 1
    boundary_conditions: List[Condition] = dataclasses.field(default_factory=list)
    source_sinks: List[Condition] = dataclasses.field(default_factory=list)

    # static per-cell soil properties (MPPThermalSetSoils)
    lun_type: np.ndarray = None
    is_shallow: np.ndarray = None
    por: np.ndarray = None
    tkmg: np.ndarray = None
    tkdry: np.ndarray = None
    csol: np.ndarray = None
    # dynamic per-cell state
    temperature: jnp.ndarray = None
    liq_areal_den: jnp.ndarray = None
    ice_areal_den: jnp.ndarray = None
    snow_water: jnp.ndarray = None
    num_snow_layer: jnp.ndarray = None
    tuning_factor: jnp.ndarray = None
    # BC aux state: per bc-connection
    bc_is_active: np.ndarray = None
    bc_frac: jnp.ndarray = None
    bc_value: jnp.ndarray = None       # condition value (Dirichlet T / flux)
    bc_dhsdT: jnp.ndarray = None

    def allocate_auxvars(self) -> None:
        n = self.mesh.ncells_all
        self.lun_type = np.zeros(n, np.int32)
        self.is_shallow = np.ones(n, bool)
        self.por = np.zeros(n)
        self.tkmg = np.zeros(n)
        self.tkdry = np.zeros(n)
        self.csol = np.zeros(n)
        self.temperature = jnp.zeros(n)
        self.liq_areal_den = jnp.zeros(n)
        self.ice_areal_den = jnp.zeros(n)
        self.snow_water = jnp.zeros(n)
        self.num_snow_layer = jnp.zeros(n, jnp.int32)
        self.tuning_factor = jnp.ones(n)
        nbc = sum(c.num_connections for c in self.boundary_conditions)
        self.bc_is_active = np.ones(nbc, bool)
        self.bc_frac = jnp.ones(nbc)
        self.bc_value = jnp.zeros(nbc)
        self.bc_dhsdT = jnp.zeros(nbc)
        nss = sum(c.num_connections for c in self.source_sinks)
        self.ss_values = jnp.zeros(nss)
        # exchanged state for COND_DIRICHLET_FRM_OTR_GOVEQ conns
        # (ThermalSOEGovEqnExchangeAuxVars copies VAR_TEMPERATURE /
        # VAR_THERMAL_COND from the coupled GE's cells)
        self.bc_exch_T = jnp.zeros(nbc)
        self.bc_exch_k = jnp.ones(nbc)
        # BC auxvar property copies (filled by set_soils)
        self.bc_lun_type = np.zeros(nbc, np.int32)
        self.bc_is_shallow = np.ones(nbc, bool)
        self.bc_por = np.zeros(nbc)
        self.bc_tkmg = np.zeros(nbc)
        self.bc_tkdry = np.zeros(nbc)
        self.bc_csol = np.zeros(nbc)

    # -- static topology helpers --------------------------------------------
    def _internal(self) -> ConnectionSet:
        from mpp_tpu.dtypes.mesh import concat_connection_sets
        return concat_connection_sets(self.mesh.intrn_conn_sets)

    def _bc_concat(self):
        """(cell ids, dist_up, dist_dn, area, itype codes) over all BCs in
        condition order — the reference walks BCs accumulating sum_conn."""
        ids, dup, ddn, ar, code = [], [], [], [], []
        for cond in self.boundary_conditions:
            cs = cond.conn_set
            ids.append(cs.id_dn)
            dup.append(cs.dist_up)
            ddn.append(cs.dist_dn)
            ar.append(cs.area)
            code.append(np.full(cs.num_connections, cond.itype, np.int32))
        if not ids:
            z = np.zeros(0)
            return z.astype(np.int32), z, z, z, z.astype(np.int32)
        return (np.concatenate(ids).astype(np.int32), np.concatenate(dup),
                np.concatenate(ddn), np.concatenate(ar),
                np.concatenate(code))

    def _ss_concat(self):
        ids, code = [], []
        for cond in self.source_sinks:
            ids.append(cond.conn_set.id_dn)
            code.append(np.full(cond.conn_set.num_connections, cond.itype,
                                np.int32))
        if not ids:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        return np.concatenate(ids).astype(np.int32), np.concatenate(code)

    def coo_coords(self, row_off: int = 0, col_off: int = 0):
        """Static COO coordinates of every A contribution, in assembly order:
        diag accum, internal (4/conn), BC diag (1/conn)."""
        n = self.mesh.ncells_local
        ic = self._internal()
        bc_ids, _, _, _, _ = self._bc_concat()
        rows = [np.arange(n)]
        cols = [np.arange(n)]
        rows += [ic.id_up, ic.id_up, ic.id_dn, ic.id_dn]
        cols += [ic.id_up, ic.id_dn, ic.id_up, ic.id_dn]
        rows += [bc_ids]
        cols += [bc_ids]
        return (np.concatenate(rows) + row_off, np.concatenate(cols) + col_off)

    def coupling_coords(self, row_off: int, col_off_by_rank: dict):
        """Off-diagonal COO coordinates for cross-GE Dirichlet coupling
        (ComputeOperatorsOffDiag, GoveqnThermalKSPTemperatureSnowType.F90:
        1202-1300): row = this GE's conn cell (id_dn), col = the coupled
        GE's cell (id_up), in _bc_concat order over FRM_OTR conns."""
        rows, cols = [], []
        for cond in self.boundary_conditions:
            if cond.itype != int(Cond.DIRICHLET_FRM_OTR_GOVEQ):
                continue
            other = getattr(cond, "other_geq_rank", None)
            if other is None:
                raise ValueError(f"coupling condition {cond.name} lacks "
                                 "other_geq_rank")
            cs = cond.conn_set
            rows.append(np.asarray(cs.id_dn, np.int64) + row_off)
            cols.append(np.asarray(cs.id_up, np.int64)
                        + col_off_by_rank[other])
        if not rows:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(rows), np.concatenate(cols)

    # ``dyn`` (optional dict) promotes per-step dynamic state from staged
    # attributes to explicit inputs — the compiled/batched KSP path
    # (batched/ksp_compiled.py) passes them so the whole assembly is a
    # pure function of its arguments.  Recognized keys: "liq", "ice",
    # "snow_water", "num_snow_layer", "tuning", "frac" (snow/ssw),
    # "bc_frac", "bc_dhsdT".
    def aux(self, T, dyn=None):
        """Internal-cell aux update (UpdateAuxVarsIntrn)."""
        d = dyn or {}
        return thermal_soil_aux(
            T, d.get("liq", self.liq_areal_den),
            d.get("ice", self.ice_areal_den),
            d.get("snow_water", self.snow_water),
            d.get("num_snow_layer", self.num_snow_layer),
            d.get("tuning", self.tuning_factor),
            self.lun_type, self.is_shallow, jnp.asarray(self.por),
            jnp.asarray(self.tkmg), jnp.asarray(self.tkdry),
            jnp.asarray(self.csol), jnp.asarray(self.mesh.dz))

    def bc_aux(self, T, bc_value=None, exch_T=None, exch_k=None, dyn=None):
        """BC auxvar update (UpdateAuxVarsBC): Dirichlet BCs take the
        condition value as temperature, flux BCs mirror the internal cell,
        cross-GE Dirichlet conns take the exchanged temperature AND
        conductivity; conductivity otherwise evaluated with the BC
        auxvar's own property copies and the adjacent cell's dz."""
        bc_ids, _, _, _, code = self._bc_concat()
        if bc_ids.size == 0:
            z = jnp.zeros(0)
            return z, z
        if bc_value is None:
            bc_value = self.bc_value
        if exch_T is None:
            exch_T = self.bc_exch_T
        if exch_k is None:
            exch_k = self.bc_exch_k
        is_dirichlet = np.isin(code, (int(Cond.DIRICHLET),))
        is_otr = code == int(Cond.DIRICHLET_FRM_OTR_GOVEQ)
        T_bc = jnp.where(jnp.asarray(is_dirichlet), bc_value,
                         T[jnp.asarray(bc_ids)])
        T_bc = jnp.where(jnp.asarray(is_otr), exch_T, T_bc)
        k_bc = self._bc_own_conductivity(T_bc, bc_ids, dyn)
        k_bc = jnp.where(jnp.asarray(is_otr), exch_k, k_bc)
        return T_bc, k_bc

    def _bc_own_conductivity(self, T_bc, bc_ids, dyn=None):
        dz_bc = jnp.asarray(self.mesh.dz)[jnp.asarray(bc_ids)]
        k_bc, _cap = thermal_soil_aux(
            T_bc,
            jnp.zeros_like(T_bc), jnp.zeros_like(T_bc), jnp.zeros_like(T_bc),
            jnp.zeros_like(T_bc, dtype=jnp.int32), jnp.ones_like(T_bc),
            self.bc_lun_type, self.bc_is_shallow, jnp.asarray(self.bc_por),
            jnp.asarray(self.bc_tkmg), jnp.asarray(self.bc_tkdry),
            jnp.asarray(self.bc_csol), dz_bc)
        return k_bc

    def contributions(self, T, dt, cnfac, ss_values, bc_value=None,
                      exch_T=None, exch_k=None, dyn=None):
        """A-values (ordered per coo_coords) and rhs b.

        Implements Accum + Divergence (rhs) and OperatorsDiag (matrix) for
        the non-MATCH_CLM formulation (factor = 1), with per-connection
        areas (the reference's stale-``area``/``factor`` variables in its
        BC branches are benign in its test suites — all areas equal).
        """
        d = dyn or {}
        n = self.mesh.ncells_local
        vol = jnp.asarray(self.mesh.vol)
        active = jnp.asarray(self.mesh.is_active)
        k_cell, cap = self.aux(T, dyn)

        # accumulation diag + rhs (Accum, OperatorsDiag diagonal)
        accum = cap * vol / (dt * d.get("tuning", self.tuning_factor))
        diag_vals = jnp.where(active, accum, 1.0)
        b = jnp.where(active, accum * T, 0.0)

        # internal connections
        ic = self._internal()
        iu, idn = jnp.asarray(ic.id_up), jnp.asarray(ic.id_dn)
        both_active = active[iu] & active[idn]
        kavg = _harmonic(k_cell[iu], k_cell[idn], jnp.asarray(ic.dist_up),
                         jnp.asarray(ic.dist_dn))
        dist = jnp.asarray(ic.dist_up + ic.dist_dn)
        area = jnp.asarray(ic.area)
        val = jnp.where(both_active, (1.0 - cnfac) * kavg / dist * area, 0.0)
        intr_vals = jnp.concatenate([val, -val, -val, val])
        flux = -kavg * (T[iu] - T[idn]) / dist
        add = jnp.where(both_active, cnfac * flux * area, 0.0)
        b = b.at[iu].add(add).at[idn].add(-add)

        # boundary conditions
        bc_ids, bdup, bddn, barea, bcode = self._bc_concat()
        if bc_ids.size:
            bids = jnp.asarray(bc_ids)
            if bc_value is None:
                bc_value = self.bc_value
            bc_frac = d.get("bc_frac", self.bc_frac)
            bc_dhsdT = d.get("bc_dhsdT", self.bc_dhsdT)
            T_bc, k_bc = self.bc_aux(T, bc_value, exch_T, exch_k, dyn)
            bc_active = jnp.asarray(self.bc_is_active) & active[bids]
            kavg_b = _harmonic(k_bc, k_cell[bids], jnp.asarray(bdup),
                               jnp.asarray(bddn))
            dist_b = jnp.asarray(bdup + bddn)
            area_b = jnp.asarray(barea)
            is_dir = jnp.asarray(np.isin(bcode, (int(Cond.DIRICHLET),
                                                 int(Cond.DIRICHLET_FRM_OTR_GOVEQ))))
            is_dir_otr = jnp.asarray(bcode == int(Cond.DIRICHLET_FRM_OTR_GOVEQ))
            is_hflux = jnp.asarray(bcode == int(Cond.HEAT_FLUX))
            # matrix diagonal (OperatorsDiag:1161-1218)
            dir_diag = bc_frac * (1.0 - cnfac) * kavg_b / dist_b * area_b
            hflux_diag = -bc_frac * bc_dhsdT * area_b
            bc_diag = jnp.where(bc_active,
                                jnp.where(is_dir, dir_diag,
                                          jnp.where(is_hflux, hflux_diag, 0.0)),
                                0.0)
            # rhs (Divergence:816-935)
            flux_b = -kavg_b * (T_bc - T[bids]) / dist_b
            rhs_dir = kavg_b / dist_b * T_bc * area_b
            rhs_dir_otr = -bc_frac * cnfac * flux_b * area_b
            # HEAT_FLUX rhs carries H - dhsdT*T_prev (the staged
            # cur_cond%value, GoveqnThermalKSPTemperatureSoilType.F90:
            # 344-348) so with the -frac*dhsdT diag the net surface flux
            # is H + dhsdT*(T_new - T_prev)
            rhs_hflux = (bc_value - bc_dhsdT * T[bids]) \
                * bc_frac * area_b
            bc_rhs = jnp.where(bc_active,
                               jnp.where(is_dir_otr, rhs_dir_otr,
                                         jnp.where(is_hflux, rhs_hflux,
                                                   jnp.where(is_dir, rhs_dir,
                                                             0.0))),
                               0.0)
            b = b.at[bids].add(bc_rhs)
            # implicit cross-GE off-diagonal (-d flux/d T_other), aligned
            # with coupling_coords' FRM_OTR subset
            otr_mask = bcode == int(Cond.DIRICHLET_FRM_OTR_GOVEQ)
            cpl_all = jnp.where(bc_active,
                                -bc_frac * (1.0 - cnfac) * kavg_b
                                / dist_b * area_b, 0.0)
            cpl_vals = cpl_all[jnp.asarray(np.nonzero(otr_mask)[0])]
        else:
            bc_diag = jnp.zeros(0)
            cpl_vals = jnp.zeros(0)

        # source sinks: COND_HEAT_RATE adds the raw value (Divergence:937-970)
        ss_ids, ss_code = self._ss_concat()
        if ss_ids.size:
            sids = jnp.asarray(ss_ids)
            b = b.at[sids].add(jnp.where(active[sids], ss_values, 0.0))

        vals = jnp.concatenate([diag_vals, intr_vals, bc_diag])
        return vals, b, cpl_vals

    # -- property staging (MPPThermalSetSoils) -------------------------------
    def set_soils(self, filter_thermal, lun_type, watsat, csol, tkmg, tkdry,
                  nlevsoi: Optional[int] = None):
        """Stage soil thermal properties.

        Args are CLM-shaped [ncol] / [ncol, nlevgrnd]; cells are ordered
        column-major (all levels of col 0, then col 1, ...), matching
        MultiPhysicsProbThermal.F90:154-185.  BC auxvars receive copies of
        the adjacent cell's properties (:187-206).
        """
        watsat = np.asarray(watsat)
        ncol, nlev = watsat.shape
        nlevsoi = nlev if nlevsoi is None else nlevsoi
        icell = 0
        first_active = int(np.nonzero(np.asarray(filter_thermal) == 1)[0][0])
        active = np.ones(ncol * nlev, bool)
        for c in range(ncol):
            src = c if filter_thermal[c] == 1 else first_active
            for j in range(nlev):
                active[icell] = filter_thermal[c] == 1
                self.is_shallow[icell] = j < nlevsoi
                self.lun_type[icell] = lun_type[src]
                self.por[icell] = watsat[src, j]
                self.tkmg[icell] = tkmg[src, j]
                self.tkdry[icell] = tkdry[src, j]
                self.csol[icell] = csol[src, j]
                icell += 1
        self.mesh.set_grid_cell_filter(active)
        bc_ids, _, _, _, _ = self._bc_concat()
        self.bc_lun_type = self.lun_type[bc_ids]
        self.bc_is_shallow = self.is_shallow[bc_ids]
        self.bc_por = self.por[bc_ids]
        self.bc_tkmg = self.tkmg[bc_ids]
        self.bc_tkdry = self.tkdry[bc_ids]
        self.bc_csol = self.csol[bc_ids]


@dataclasses.dataclass
class ThermalSnowGE(ThermalSoilGE):
    """Snow thermal governing equation (GE_THERM_SNOW_TBASED,
    GoveqnThermalKSPTemperatureSnowType.F90).  Same assembly skeleton as
    the soil GE; the constitutive model is the snow bulk-density law and
    the media couple through COND_DIRICHLET_FRM_OTR_GOVEQ conns."""
    itype: int = int(GEType.THERM_SNOW_TBASED)

    def allocate_auxvars(self) -> None:
        super().allocate_auxvars()
        n = self.mesh.ncells_all
        self.frac = jnp.ones(n)

    def aux(self, T, dyn=None):
        d = dyn or {}
        return thermal_snow_aux(d.get("liq", self.liq_areal_den),
                                d.get("ice", self.ice_areal_den),
                                d.get("frac", self.frac),
                                jnp.asarray(self.mesh.dz))

    def _bc_own_conductivity(self, T_bc, bc_ids, dyn=None):
        k_cell, _ = self.aux(None, dyn)
        return k_cell[jnp.asarray(bc_ids)]

    def update_top_flux_conn(self):
        """Rewire the top heat-flux BC to the topmost ACTIVE snow layer of
        each column (ThermKSPTempSnowUpdateBoundaryConn :680-689: snow
        layers fill bottom-up, so the connection lands at
        nlevsno - num_snow_layer)."""
        nlev = self.mesh.nlev
        nsl = np.asarray(self.num_snow_layer).reshape(-1, nlev)[:, -1]
        for cond in self.boundary_conditions:
            if cond.itype == int(Cond.HEAT_FLUX):
                ncols = cond.conn_set.num_connections
                base = np.arange(ncols) * nlev
                cond.conn_set.id_dn = (base + nlev
                                       - np.minimum(nsl, nlev)).astype(
                    cond.conn_set.id_dn.dtype)


@dataclasses.dataclass
class ThermalSSWGE(ThermalSoilGE):
    """Standing-surface-water thermal GE (GE_THERM_SSW_TBASED,
    GoveqnThermalKSPTemperatureSSWType.F90)."""
    itype: int = int(GEType.THERM_SSW_TBASED)

    def allocate_auxvars(self) -> None:
        super().allocate_auxvars()
        n = self.mesh.ncells_all
        self.frac = jnp.ones(n)

    def aux(self, T, dyn=None):
        d = dyn or {}
        return thermal_ssw_aux(d.get("frac", self.frac),
                               jnp.asarray(self.mesh.dz))

    def _bc_own_conductivity(self, T_bc, bc_ids, dyn=None):
        k_cell, _ = self.aux(None, dyn)
        return k_cell[jnp.asarray(bc_ids)]


class ThermalSOE:
    """System of equations for SOE_THERMAL_TBASED (KSP).

    Holds the GE list, the composite solution vector and the solver, and
    implements PreStepDT / StepDT / PostSolve semantics
    (SystemOfEquationsThermalType.F90 + SystemOfEquationsBaseType.F90).
    """

    def __init__(self):
        self.goveqns: List[ThermalSoilGE] = []
        self.soln = None
        self.soln_prev = None
        self.soln_prev_clm = None
        self.cnfac = C.CNFAC
        self.template: Optional[CSRTemplate] = None
        self._jit_step = None
        self._ilu = None
        self._block_tpl = None
        self.cumulative_linear_iterations = 0
        self.metrics = None

    @property
    def n_total(self) -> int:
        return sum(g.mesh.ncells_local for g in self.goveqns)

    def setup(self):
        offs = np.cumsum([0] + [g.mesh.ncells_local for g in self.goveqns])
        col_off_by_rank = {i + 1: offs[i] for i in range(len(self.goveqns))}
        rows, cols = [], []
        for g, off in zip(self.goveqns, offs[:-1]):
            r, c = g.coo_coords(off, off)
            rows.append(r)
            cols.append(c)
        # cross-GE off-diagonal blocks (ComputeOperatorsOffDiag)
        for g, off in zip(self.goveqns, offs[:-1]):
            r, c = g.coupling_coords(off, col_off_by_rank)
            rows.append(r)
            cols.append(c)
        n = self.n_total
        self.offsets = offs
        self.template = csr_template(n, n, np.concatenate(rows),
                                     np.concatenate(cols))
        self.soln = jnp.zeros(n)
        self.soln_prev = jnp.zeros(n)
        self.soln_prev_clm = jnp.zeros(n)

    def rebuild_template(self):
        """Re-discover the sparsity after condition connections were
        rewired (e.g. snow-top flux retargeting with variable snl) — the
        KSP path's MATPREALLOCATOR re-discovery
        (SystemOfEquationsBaseType.F90:593-613 runs it every StepDT;
        we amortize and rebuild only on topology change)."""
        soln, prev, prev_clm = self.soln, self.soln_prev, self.soln_prev_clm
        self.setup()
        self.soln, self.soln_prev, self.soln_prev_clm = soln, prev, prev_clm
        self._ilu = None
        self._block_tpl = None

    def exchange_auxvars(self, T):
        """Cross-GE BC staging (ThermalSOEGovEqnExchangeAuxVars,
        SystemOfEquationsThermalType.F90:770-919): every FRM_OTR condition
        receives the coupled GE's cell temperature and thermal
        conductivity at the conn's id_up cells."""
        ks = []
        for g, off in zip(self.goveqns, self.offsets[:-1]):
            Tg = T[off:off + g.mesh.ncells_local]
            k, _cap = g.aux(Tg)
            ks.append(k)
        for g, off in zip(self.goveqns, self.offsets[:-1]):
            if not g.boundary_conditions:
                continue
            exch_T = []
            exch_k = []
            for cond in g.boundary_conditions:
                m = cond.conn_set.num_connections
                if cond.itype == int(Cond.DIRICHLET_FRM_OTR_GOVEQ):
                    rank = cond.other_geq_rank
                    other = self.goveqns[rank - 1]
                    ooff = self.offsets[rank - 1]
                    ids = jnp.asarray(np.asarray(cond.conn_set.id_up,
                                                 np.int64))
                    exch_T.append(T[ooff:ooff
                                    + other.mesh.ncells_local][ids])
                    exch_k.append(ks[rank - 1][ids])
                else:
                    exch_T.append(jnp.zeros(m))
                    exch_k.append(jnp.ones(m))
            g.bc_exch_T = jnp.concatenate(exch_T)
            g.bc_exch_k = jnp.concatenate(exch_k)

    def set_soln_prev_clm(self, data):
        self.soln_prev_clm = jnp.asarray(data, dtype=jnp.float64)

    def pre_step_dt(self):
        """ThermalSOEPreStepDT (SystemOfEquationsThermalType.F90:391-409)."""
        self.soln_prev = self.soln_prev_clm
        self.soln = self.soln_prev_clm

    def step_dt(self, dt: float, solver: str = "ksp",
                nstep: int = 1) -> bool:
        """KSP step (SOEBaseStepDT_KSP): assemble from soln_prev, solve,
        PostSolve copies soln -> soln_prev.

        ``solver="ksp"`` is the golden-parity GMRES+ILU(0) path;
        ``solver="block"`` is the batched production path for
        column-chain meshes — the identical COO values scattered into
        per-column tridiagonal blocks and solved with the exact batched
        Thomas sweep (ops/block_structure.py)."""
        tpl = self.template
        T = self.soln_prev
        self.exchange_auxvars(T)
        vals_list, b_list, cpl_list = [], [], []
        for g, off in zip(self.goveqns, self.offsets[:-1]):
            Tg = T[off:off + g.mesh.ncells_local]
            ss_vals = getattr(g, "ss_values", jnp.zeros(0))
            v, b, cpl = g.contributions(Tg, dt, self.cnfac, ss_vals)
            vals_list.append(v)
            b_list.append(b)
            cpl_list.append(cpl)
        if solver == "block":
            if any(int(c.shape[0]) for c in cpl_list):
                raise NotImplementedError(
                    "block solver does not support cross-GE coupling yet; "
                    "use solver='ksp'")
            if self._block_tpl is None:
                from mpp_tpu.ops.block_structure import (
                    BlockTridiagTemplate, chain_shape)
                rows, cols = [], []
                for g, off in zip(self.goveqns, self.offsets[:-1]):
                    r, c = g.coo_coords(off, off)
                    rows.append(r)
                    cols.append(c)
                rows = np.concatenate(rows)
                cols = np.concatenate(cols)
                ncol, nlev = chain_shape(self.n_total, rows, cols)
                self._block_tpl = BlockTridiagTemplate(ncol, nlev, 1,
                                                       rows, cols)
            x = self._block_tpl.solve(jnp.concatenate(vals_list),
                                      jnp.concatenate(b_list))
            self.soln = x.reshape(-1)
            self.cumulative_linear_iterations += 1
            converged = True
            self.soln_prev = self.soln
            for g, off in zip(self.goveqns, self.offsets[:-1]):
                g.temperature = self.soln[off:off + g.mesh.ncells_local]
            if self.metrics is not None:
                self.metrics.record(step=nstep, dt=dt, converged=True,
                                    solver="block", linear_iterations=1)
            return True
        vals_list += cpl_list
        data = np.asarray(tpl.assemble(jnp.concatenate(vals_list)))
        b = np.asarray(jnp.concatenate(b_list))
        # PETSc-default KSP: GMRES(30) + ILU(0), rtol 1e-5 — the golden
        # regression answers embed this iterate (see ops/ilu.py docstring).
        if self._ilu is None:
            self._ilu = ILU0(tpl.indptr, tpl.indices)
        lu = self._ilu.factor(data)
        x, iters, converged = petsc_gmres(tpl.indptr, tpl.indices, data, b,
                                          pc=self._ilu, pc_data=lu)
        self.soln = jnp.asarray(x)
        self.cumulative_linear_iterations += int(iters)
        # PostSolve
        self.soln_prev = self.soln
        for g, off in zip(self.goveqns, self.offsets[:-1]):
            g.temperature = self.soln[off:off + g.mesh.ncells_local]
        if self.metrics is not None:
            self.metrics.record(step=nstep, dt=dt, converged=bool(converged),
                                solver="ksp", linear_iterations=int(iters))
        return bool(converged)

    def get_soln(self) -> np.ndarray:
        return np.asarray(self.soln)


class ThermalMPP(MPPBase):
    """Problem facade (mpp_thermal_type) with the 8-step builder contract
    (MultiPhysicsProbBaseType.F90:32-74)."""

    GE_CLASSES = {GEType.THERM_SOIL_TBASED: ThermalSoilGE,
                  GEType.THERM_SNOW_TBASED: ThermalSnowGE,
                  GEType.THERM_SSW_TBASED: ThermalSSWGE}
    SS_COND_TYPES = ()   # routing by COND_BC/COND_SS alone

    def __init__(self):
        super().__init__()
        self.soe = ThermalSOE()

    def add_goveqn(self, ge_type, name, mesh_itype=None, mesh_index=None):
        return super().add_goveqn(ge_type, name, mesh_index)

    def add_coupling_condition(self, ieqn_1, ieqn_2, iregion_1, iregion_2):
        """MPPGovEqnAddCouplingCondition + ThermalMPPUpdatCouplingBCConnections
        (MultiPhysicsProbBaseType.F90:1017-1056,
        MultiPhysicsProbThermal.F90:443-570): a COND_DIRICHLET_FRM_OTR_GOVEQ
        BC on EACH GE whose conn set pairs this GE's region cells (id_dn)
        with the coupled GE's region cells (id_up)."""
        from mpp_tpu.dtypes.regions import region_connection_set
        from mpp_tpu.dtypes.mesh import ConnectionSet

        ge1 = self.soe.goveqns[ieqn_1 - 1]
        ge2 = self.soe.goveqns[ieqn_2 - 1]
        cs1 = region_connection_set(ge1.mesh, iregion_1)
        cs2 = region_connection_set(ge2.mesh, iregion_2)
        if cs1.num_connections != cs2.num_connections:
            raise ValueError("coupling regions differ in size")

        def make(cs_mine, cs_other, other_rank):
            cs = ConnectionSet(
                id_up=np.asarray(cs_other.id_dn, np.int32),
                id_dn=np.asarray(cs_mine.id_dn, np.int32),
                dist_up=np.asarray(cs_other.dist_dn),
                dist_dn=np.asarray(cs_mine.dist_dn),
                area=np.asarray(cs_mine.area),
                itype=np.asarray(cs_mine.itype),
                unit_vec=cs_mine.unit_vec)
            cond = Condition(
                name=f"BC_for_coupling_with_equation_{other_rank}",
                units="[K]", itype=int(Cond.DIRICHLET_FRM_OTR_GOVEQ),
                conn_set=cs)
            cond.ensure_value()
            cond.other_geq_rank = other_rank
            return cond

        ge1.boundary_conditions.append(make(cs1, cs2, ieqn_2))
        ge2.boundary_conditions.append(make(cs2, cs1, ieqn_1))

    def update_condition_conn_distances(self):
        """Refresh every BC/coupling connection's face distances from the
        CURRENT mesh dz (the reference restages VAR_DIST_UP/DN each CLM
        step and rebuilds condition connections,
        MPPThermalTBasedALM_Driver.F90:359-372 + UpdateConditionConnSet).
        Must be called after mesh dz arrays change (variable snow layers,
        standing-water film thickness)."""
        for g in self.soe.goveqns:
            for cond in g.boundary_conditions:
                cs = cond.conn_set
                if cond.itype == int(Cond.DIRICHLET_FRM_OTR_GOVEQ):
                    other = self.soe.goveqns[cond.other_geq_rank - 1]
                    cs.dist_up[:] = 0.5 * other.mesh.dz[cs.id_up]
                    cs.dist_dn[:] = 0.5 * g.mesh.dz[cs.id_dn]
                else:
                    cs.dist_dn[:] = 0.5 * g.mesh.dz[cs.id_dn]

    # CLM-style data staging -------------------------------------------------
    def set_soils(self, filter_thermal, lun_type, watsat, csol, tkmg, tkdry,
                  nlevsoi=None):
        found = [g for g in self.soe.goveqns
                 if g.itype == int(GEType.THERM_SOIL_TBASED)]
        if not found:
            raise RuntimeError("no soil thermal GE")
        found[0].set_soils(filter_thermal, lun_type, watsat, csol, tkmg,
                           tkdry, nlevsoi)

    def set_r_data(self, auxvar_kind, var_type, goveqn_id, data):
        """ThermalSOESetRDataFromCLM analog for the single-GE case."""
        g = self.soe.goveqns[goveqn_id - 1]
        data = jnp.asarray(data, dtype=jnp.float64)
        if auxvar_kind == AuxVarKind.INTERNAL:
            if var_type == Var.TUNING_FACTOR:
                g.tuning_factor = data
            elif var_type == Var.LIQ_AREAL_DEN:
                g.liq_areal_den = data
            elif var_type == Var.ICE_AREAL_DEN:
                g.ice_areal_den = data
            elif var_type == Var.FRAC:
                g.frac = data
            elif var_type == Var.SNOW_WATER:
                g.snow_water = data
            elif var_type == Var.NUM_SNOW_LYR:
                g.num_snow_layer = jnp.asarray(np.asarray(data), jnp.int32)
            elif var_type == Var.ACTIVE:
                g.mesh.set_grid_cell_filter(np.asarray(data) != 0)
            else:
                raise NotImplementedError(var_type)
        elif auxvar_kind == AuxVarKind.BC:
            if var_type == Var.BC_SS_CONDITION:
                g.bc_value = data
            elif var_type == Var.ACTIVE:
                g.bc_is_active = np.asarray(data) != 0
            elif var_type == Var.FRAC:
                g.bc_frac = data
            elif var_type == Var.DHS_DT:
                g.bc_dhsdT = data
            else:
                raise NotImplementedError(var_type)
        elif auxvar_kind == AuxVarKind.SS:
            if var_type == Var.BC_SS_CONDITION:
                g.ss_values = data
            else:
                raise NotImplementedError(var_type)
        else:
            raise NotImplementedError(auxvar_kind)
