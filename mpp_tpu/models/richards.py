"""Richards equation (VSFM) — GE assembly + SoE + MPP facade (SNES path).

JAX reimplementation of the reference's VSFM stack:

* auxvar constitutive chain sat/kr/den/vis/por:
  ``auxvar/RichardsODEPressureAuxType.F90:237-294``
* two-point Darcy flux with upwinded mobility, distance-weighted harmonic
  permeability, gravity term and seepage clamp + analytic derivatives:
  ``ge/RichardsMod.F90:118-340`` (note: the reference returns the
  *negative* of d(flux)/dP and compensates at assembly; we return the true
  derivative and assemble J = dF/dP directly — identical matrices)
* residual F = Accum(P) - Accum(P_prev) + Divergence(P):
  ``ge/GoveqnRichardsODEPressureType.F90:388-421,1603-1938``
* Jacobian: ibid :1638-1693 (accum) and :1941-2200 (divergence), with
  identity rows for inactive cells
* SNES stepper with line-search rotation and timestep cutting:
  ``soe/SystemOfEquationsBaseType.F90:368-552``
* soil staging incl. BC/SS auxvar property copies:
  ``mpp/MultiPhysicsProbVSFM.F90:249-475`` (VSFMMPPSetSoilsCLM)
* restart seeding: ibid :603-707 (VSFMMPPRestart)

State is SoA jnp arrays; topology/properties static numpy.  The
residual/Jacobian-value functions are pure and jitted once; the serial
SNES driver (ops/snes.py) consumes them for regression parity, and the
batched Newton path reuses the same assembly.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from mpp_tpu import constants as C
from mpp_tpu.constants import (Cond, GEType, SOEType, Var, AuxVarKind,
                               FluxType, PRESSURE_REF, GRAVITY_CONSTANT,
                               FMWH2O)
from mpp_tpu.dtypes.mesh import Mesh, ConnectionSet, concat_connection_sets
from mpp_tpu.dtypes.conditions import Condition
from mpp_tpu.dtypes.regions import region_connection_set
from mpp_tpu.dtypes.mpp_base import MPPBase
from mpp_tpu.ops.sparse import csr_template, CSRTemplate
from mpp_tpu.ops import eos, satfunc as sf
from mpp_tpu.ops.porosity import PorosityParams, porosity
from mpp_tpu.ops.snes import (SNESOptions, snes_solve, LS_BT, LS_L2,
                              LS_BASIC, LS_CP)


def richards_aux(P, params: sf.SatParams, por_params: PorosityParams,
                 temperature, frac_liq, density_type: int):
    """RichODEPressureAuxVarCompute: (sat, dsat, kr, dkr, den, dden_dP,
    vis, dvis_dP, por, dpor_dP)."""
    sat, dsat = sf.press_to_sat(params, P)
    kr, dkr = sf.press_to_relperm(params, P, frac_liq)
    den, dden_dP, _dden_dT = eos.density(P, temperature, density_type)
    vis, dvis_dP, _ = eos.viscosity(P, temperature)
    por, dpor_dP = porosity(por_params, P)
    return sat, dsat, kr, dkr, den, dden_dP, vis, dvis_dP, por, dpor_dP


def darcy_flux(P_up, P_dn, kr_up, kr_dn, dkr_up, dkr_dn, den_up, den_dn,
               dden_up, dden_dn, vis_up, vis_dn, dvis_up, dvis_dn,
               perm_up, perm_dn, dist_up, dist_dn, area, unit_z,
               internal: bool, cond_kind=None, seepage_mask=None):
    """Vectorized RichardsFlux_Internal (RichardsMod.F90:118-340).

    Returns (flux, dflux_dP_up, dflux_dP_dn) with TRUE derivatives.
    ``cond_kind`` (static numpy codes per conn) selects BC weighting;
    ``seepage_mask`` marks seepage BCs.
    """
    dist = dist_up + dist_dn
    if internal:
        upweight = dist_up / dist
        Dq = (perm_up * perm_dn) / (dist_up * perm_dn + dist_dn * perm_up)
        mass_flux = None
    else:
        is_dirichlet_like = np.isin(cond_kind, (int(Cond.DIRICHLET),
                                                int(Cond.MASS_FLUX),
                                                int(Cond.SEEPAGE_BC)))
        is_otr = cond_kind == int(Cond.DIRICHLET_FRM_OTR_GOVEQ)
        if not (is_dirichlet_like | is_otr).all():
            raise ValueError("RichardsFlux: unknown cond_type")
        w_int = dist_up / dist
        Dq_int = (perm_up * perm_dn) / (dist_up * perm_dn + dist_dn * perm_up)
        upweight = jnp.where(jnp.asarray(is_otr), w_int, 0.0)
        Dq = jnp.where(jnp.asarray(is_otr), Dq_int, perm_dn / dist)
        mass_flux = jnp.asarray(cond_kind == int(Cond.MASS_FLUX))

    udist_dot_ugrav = unit_z * (-GRAVITY_CONSTANT)
    dist_gravity = dist * udist_dot_ugrav
    den_ave = upweight * den_up + (1.0 - upweight) * den_dn
    gravityterm = den_ave * FMWH2O * dist_gravity
    dphi = P_up - P_dn + gravityterm

    if not internal and seepage_mask is not None and seepage_mask.any():
        clamp = (jnp.asarray(seepage_mask) & (dphi > 0.0)
                 & (P_up <= PRESSURE_REF))
    else:
        clamp = jnp.zeros_like(dphi, dtype=bool)
    dphi = jnp.where(clamp, 0.0, dphi)

    up_wind = dphi >= 0.0
    ukvr = jnp.where(up_wind, kr_up / vis_up, kr_dn / vis_dn)
    v_darcy = -Dq * ukvr * dphi
    if mass_flux is not None:
        v_darcy = jnp.where(mass_flux, 0.0, v_darcy)
    q = v_darcy * area
    flux = q * den_ave

    # true derivatives
    dden_ave_up = upweight * dden_up
    dden_ave_dn = (1.0 - upweight) * dden_dn
    dphi_dP_up = 1.0 + upweight * dist_gravity * FMWH2O * dden_up
    dphi_dP_dn = -1.0 + (1.0 - upweight) * dist_gravity * FMWH2O * dden_dn
    dphi_dP_dn = jnp.where(clamp, 0.0, dphi_dP_dn)
    dukvr_up = jnp.where(up_wind,
                         dkr_up / vis_up - kr_up / (vis_up * vis_up) * dvis_up,
                         0.0)
    dukvr_dn = jnp.where(up_wind, 0.0,
                         dkr_dn / vis_dn - kr_dn / (vis_dn * vis_dn) * dvis_dn)
    dq_up = -Dq * (dukvr_up * dphi + ukvr * dphi_dP_up) * area
    dq_dn = -Dq * (dukvr_dn * dphi + ukvr * dphi_dP_dn) * area
    dflux_up = dq_up * den_ave + q * dden_ave_up
    dflux_dn = dq_dn * den_ave + q * dden_ave_dn
    if mass_flux is not None:
        dflux_up = jnp.where(mass_flux, 0.0, dflux_up)
        dflux_dn = jnp.where(mass_flux, 0.0, dflux_dn)
    return flux, dflux_up, dflux_dn


def conductance_krg(P_up, P_dn, sp_up: sf.SatParams, sp_dn: sf.SatParams,
                    cond_type, conductance, cond_up, cond_dn, upwind_weight):
    """Vectorized ``RichODEPressureConnAuxVarCompute``
    (RichardsODEPressureConnAuxType.F90:185-299): per-connection effective
    conductance krg and d(krg)/dP_up, dP_dn for the Campbell and Manoli
    conductance models.  ``cond_type`` and the relperm-set masks are
    static numpy."""
    ones = jnp.ones_like(P_up)
    kr_up_raw, dkr_up_raw = sf.press_to_relperm(sp_up, P_up, ones)
    kr_dn_raw, dkr_dn_raw = sf.press_to_relperm(sp_dn, P_dn, ones)
    up_set = sp_up.relperm_func_type != 0
    dn_set = sp_dn.relperm_func_type != 0
    # Campbell: upwind-weighted kr times a scalar conductance; a side with
    # no relperm function contributes kr=1 via weight collapse
    w_eff = np.where(up_set & dn_set, np.asarray(upwind_weight),
                     np.where(up_set, 1.0, 0.0))
    w_eff = jnp.asarray(w_eff)
    kr = w_eff * kr_up_raw + (1.0 - w_eff) * kr_dn_raw
    dkr_up = w_eff * dkr_up_raw
    dkr_dn = (1.0 - w_eff) * dkr_dn_raw
    krg_c = kr * conductance
    dkrg_c_up = dkr_up * conductance
    dkrg_c_dn = dkr_dn * conductance
    # Manoli: series combination of the two sides
    krg_up = kr_up_raw * cond_up
    krg_dn = kr_dn_raw * cond_dn
    denom = krg_up + krg_dn
    denom = jnp.where(denom == 0, 1.0, denom)
    krg_m = krg_up * krg_dn / denom
    dkrg_m_up = (krg_dn / denom) ** 2.0 * dkr_up_raw * cond_up
    dkrg_m_dn = (krg_up / denom) ** 2.0 * dkr_dn_raw * cond_dn
    is_manoli = jnp.asarray(np.asarray(cond_type)
                            == int(FluxType.CONDUCTANCE_MANOLI))
    krg = jnp.where(is_manoli, krg_m, krg_c)
    dkrg_up = jnp.where(is_manoli, dkrg_m_up, dkrg_c_up)
    dkrg_dn = jnp.where(is_manoli, dkrg_m_dn, dkrg_c_dn)
    return krg, dkrg_up, dkrg_dn


def conductance_flux(P_up, P_dn, den_up, den_dn, dden_up, dden_dn,
                     krg, dkrg_up, dkrg_dn, area):
    """Vectorized ``RichardsFluxConductanceModel_Internal``
    (RichardsMod.F90:746-856) with TRUE derivatives.

    flux = -den_ave * krg * (P_up - P_dn) * area, upweight = 0.5."""
    den_ave = 0.5 * den_up + 0.5 * den_dn
    dphi = P_up - P_dn
    flux = -den_ave * krg * dphi * area
    dflux_up = -(0.5 * dden_up * krg * dphi + den_ave * dkrg_up * dphi
                 + den_ave * krg) * area
    dflux_dn = -(0.5 * dden_dn * krg * dphi + den_ave * dkrg_dn * dphi
                 - den_ave * krg) * area
    return flux, dflux_up, dflux_dn


@dataclasses.dataclass
class ConnAuxVars:
    """SoA of ``rich_ode_pres_conn_auxvar_type`` static configuration."""
    flux_type: np.ndarray        # DARCY / CONDUCTANCE
    cond_type: np.ndarray        # CAMPBELL / MANOLI
    conductance: np.ndarray
    conductance_up: np.ndarray
    conductance_dn: np.ndarray
    upwind_weight: np.ndarray
    sp_up: sf.SatParams
    sp_dn: sf.SatParams

    @staticmethod
    def create(n: int) -> "ConnAuxVars":
        return ConnAuxVars(
            flux_type=np.full(n, int(FluxType.DARCY), np.int32),
            cond_type=np.full(n, int(FluxType.CONDUCTANCE_CAMPBELL), np.int32),
            conductance=np.zeros(n), conductance_up=np.zeros(n),
            conductance_dn=np.zeros(n), upwind_weight=np.zeros(n),
            sp_up=sf.SatParams.zeros(n), sp_dn=sf.SatParams.zeros(n))

    @property
    def any_conductance(self) -> bool:
        return bool((self.flux_type == int(FluxType.CONDUCTANCE)).any())


@dataclasses.dataclass
class RichardsGE:
    """GE_RE: Richards equation over one mesh."""
    name: str
    mesh: Mesh
    itype: int = int(GEType.RE)
    dof: int = 1
    boundary_conditions: List[Condition] = dataclasses.field(default_factory=list)
    source_sinks: List[Condition] = dataclasses.field(default_factory=list)

    # static per-cell parameters
    sat_params: sf.SatParams = None
    por_params: PorosityParams = None
    perm: np.ndarray = None               # [n,3]
    # auxvar-init default is DENSITY_CONSTANT (RichODEPressureAuxVarInit:120);
    # problems that want TGDPB01/IFC67 set it via set_soils
    density_type: int = eos.DENSITY_CONSTANT
    # BC/SS auxvar parameter copies (VSFMMPPSetSoilsCLM:422-471)
    bc_sat_params: sf.SatParams = None
    bc_por_params: PorosityParams = None
    bc_perm: np.ndarray = None
    ss_sat_params: sf.SatParams = None
    ss_pot_sink_pressure: np.ndarray = None
    ss_pot_sink_exponent: np.ndarray = None
    # connection auxvars (flux-model selection per connection)
    conn_in: ConnAuxVars = None
    conn_bc: ConnAuxVars = None

    # dynamic state
    temperature: jnp.ndarray = None
    frac_liq_sat: jnp.ndarray = None
    pressure: jnp.ndarray = None
    pressure_prev: jnp.ndarray = None
    bc_value: jnp.ndarray = None          # condition values per bc conn
    bc_temperature: jnp.ndarray = None
    ss_value: jnp.ndarray = None          # mass rates per ss conn
    accum_prev: jnp.ndarray = None

    def allocate_auxvars(self):
        n = self.mesh.ncells_all
        self.sat_params = sf.SatParams.zeros(n)
        self.por_params = PorosityParams.constant(np.zeros(n))
        self.perm = np.zeros((n, 3))
        self.temperature = jnp.full(n, 273.15 + 25.0)
        self.frac_liq_sat = jnp.ones(n)
        self.pressure = jnp.zeros(n)
        self.pressure_prev = jnp.full(n, 3.5355e3)
        nbc = sum(c.num_connections for c in self.boundary_conditions)
        self.bc_sat_params = sf.SatParams.zeros(nbc)
        self.bc_por_params = PorosityParams.constant(np.zeros(nbc))
        self.bc_perm = np.zeros((nbc, 3))
        self.bc_value = jnp.zeros(nbc)
        self.bc_temperature = jnp.full(nbc, 273.15 + 25.0)
        nss = sum(c.num_connections for c in self.source_sinks)
        self.ss_sat_params = sf.SatParams.zeros(nss)
        self.ss_pot_sink_pressure = np.zeros(nss)
        self.ss_pot_sink_exponent = np.zeros(nss)
        self.ss_value = jnp.zeros(nss)
        self.accum_prev = jnp.zeros(self.mesh.ncells_local)
        self.conn_in = ConnAuxVars.create(self._internal().num_connections)
        self.conn_bc = ConnAuxVars.create(nbc)

    # ---- static topology ---------------------------------------------------
    def _internal(self) -> ConnectionSet:
        cs = concat_connection_sets(self.mesh.intrn_conn_sets)
        if cs.unit_vec is None:
            # unit vector from centroid difference (MeshType.F90:932-938)
            dx = self.mesh.xc[cs.id_dn] - self.mesh.xc[cs.id_up]
            dy = self.mesh.yc[cs.id_dn] - self.mesh.yc[cs.id_up]
            dz = self.mesh.zc[cs.id_dn] - self.mesh.zc[cs.id_up]
            dist = np.sqrt(dx ** 2 + dy ** 2 + dz ** 2)
            # coincident centroids (conductance-type connections in SPAC
            # networks) get a zero unit vector: no gravity contribution
            safe = np.where(dist > 0.0, dist, 1.0)
            cs.unit_vec = np.where(
                dist[:, None] > 0.0,
                np.stack([dx / safe, dy / safe, dz / safe], axis=1), 0.0)
        return cs

    def _bc_concat(self):
        ids, dup, ddn, ar, uvz, code = [], [], [], [], [], []
        for cond in self.boundary_conditions:
            cset = cond.conn_set
            ids.append(cset.id_dn)
            dup.append(cset.dist_up)
            ddn.append(cset.dist_dn)
            ar.append(cset.area)
            uvz.append(cset.unit_vec[:, 2] if cset.unit_vec is not None
                       else np.zeros(cset.num_connections))
            code.append(np.full(cset.num_connections, cond.itype, np.int32))
        if not ids:
            z = np.zeros(0)
            return (z.astype(np.int32), z, z, z, z, z.astype(np.int32))
        return (np.concatenate(ids).astype(np.int32), np.concatenate(dup),
                np.concatenate(ddn), np.concatenate(ar), np.concatenate(uvz),
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

    def _bc_unit_vecs(self):
        """Concatenated [nbc, 3] BC-connection unit vectors."""
        out = []
        for cond in self.boundary_conditions:
            cs = cond.conn_set
            out.append(cs.unit_vec if cs.unit_vec is not None
                       else np.zeros((cs.num_connections, 3)))
        return np.concatenate(out) if out else np.zeros((0, 3))

    def _bc_perms(self):
        """Directional permeabilities on BC connections: BC auxvar side and
        adjacent-cell side (|unit| . perm)."""
        bc_ids = self._bc_concat()[0]
        perm_b = np.zeros(bc_ids.size)
        perm_cell = np.zeros(bc_ids.size)
        off = 0
        for cond in self.boundary_conditions:
            cs = cond.conn_set
            m = cs.num_connections
            uv = (cs.unit_vec if cs.unit_vec is not None
                  else np.zeros((m, 3)))
            cid = cs.id_dn
            perm_b[off:off + m] = (
                np.abs(uv[:, 0]) * self.bc_perm[off:off + m, 0]
                + np.abs(uv[:, 1]) * self.bc_perm[off:off + m, 1]
                + np.abs(uv[:, 2]) * self.bc_perm[off:off + m, 2])
            perm_cell[off:off + m] = (
                np.abs(uv[:, 0]) * self.perm[cid, 0]
                + np.abs(uv[:, 1]) * self.perm[cid, 1]
                + np.abs(uv[:, 2]) * self.perm[cid, 2])
            off += m
        return perm_b, perm_cell

    def coo_coords(self, row_off=0, col_off=0):
        """A-contribution coordinates: internal 4/conn, bc diag, ss diag,
        accum diag."""
        n = self.mesh.ncells_local
        ic = self._internal()
        bc_ids = self._bc_concat()[0]
        ss_ids = self._ss_concat()[0]
        rows = [ic.id_up, ic.id_up, ic.id_dn, ic.id_dn, bc_ids, ss_ids,
                np.arange(n)]
        cols = [ic.id_up, ic.id_dn, ic.id_up, ic.id_dn, bc_ids, ss_ids,
                np.arange(n)]
        return (np.concatenate(rows) + row_off, np.concatenate(cols) + col_off)

    # ---- aux + assembly (pure, jittable) ----------------------------------
    # The dynamic inputs (bc_value, ss_value, accum_prev) default to the
    # staged attributes (the serial SoE path); the compiled/batched
    # path (batched/vsfm_compiled.py) passes them explicitly so the whole
    # evaluation is a pure function of its arguments.
    #
    # ``dyn`` (optional dict) promotes constitutive parameters from
    # trace-time constants to dynamic inputs — the per-column
    # heterogeneous-soil contract of the ALM production path
    # (MPPVSFMALM_Initialize.F90:986-992 stages per-column CLM soils).
    # Recognized keys (all optional; arrays sized like the staged
    # attribute they override):
    #   "sat"          dict of SatParams real-field overrides [n]
    #   "por_base"     porosity base [n]
    #   "perm"         permeability [n, 3]
    #   "temperature"  [n]            "frac_liq" [n]
    #   "vol"          cell volume [n] (per-column geometry)
    #   "in_dist_up"/"in_dist_dn"/"in_area"   internal-conn geometry
    #   "bc_dist_up"/"bc_dist_dn"/"bc_area"   BC-conn geometry
    # BC-side parameters are gathered from the adjacent cell's dynamic
    # values (the _copy_params_to_bc_ss contract, VSFMMPPSetSoilsCLM:
    # 422-471); coupled-GE parameter swaps (update_connections) are NOT
    # supported with dyn — the compiled path rejects that combination.
    def _dyn_cell_params(self, dyn):
        if not dyn:
            return (self.sat_params, self.por_params, self.temperature,
                    self.frac_liq_sat)
        sp = self.sat_params
        if "sat" in dyn:
            sp = dataclasses.replace(sp, **dyn["sat"])
        pp = self.por_params
        if "por_base" in dyn:
            pp = dataclasses.replace(pp, porosity_base=dyn["por_base"])
        temp = dyn.get("temperature", self.temperature)
        fl = dyn.get("frac_liq", self.frac_liq_sat)
        return sp, pp, temp, fl

    def _dyn_bc_params(self, dyn, bc_ids):
        """BC-side constitutive params: adjacent-cell dynamic values."""
        if not dyn:
            return (self.bc_sat_params, self.bc_por_params,
                    self.bc_temperature)
        bids = jnp.asarray(bc_ids)
        sp = self.bc_sat_params
        if "sat" in dyn:
            sp = dataclasses.replace(
                sp, **{k: v[bids] for k, v in dyn["sat"].items()})
        pp = self.bc_por_params
        if "por_base" in dyn:
            pp = dataclasses.replace(pp, porosity_base=dyn["por_base"][bids])
        if "bc_temperature" in dyn:
            # TH exchange contract: internal auxvars take the energy GE's
            # dynamic T while BC auxvars keep the staged/driver-set value
            # (SystemOfEquationsTHType.F90 exchanges internal auxvars only)
            temp = dyn["bc_temperature"]
        elif "temperature" in dyn:
            temp = dyn["temperature"][bids]
        else:
            temp = self.bc_temperature
        return sp, pp, temp

    def _cell_aux(self, P, dyn=None):
        sp, pp, temp, fl = self._dyn_cell_params(dyn)
        return richards_aux(P, sp, pp, temp, fl, self.density_type)

    def _bc_aux_pressure(self, P, bc_value=None):
        """UpdateAuxVarsBC: Dirichlet/seepage take the condition value;
        mass rate/flux mirror the internal cell; coupled BCs take the
        other GE's pressure, staged into ``bc_value`` by the SoE exchange
        (GoveqnRichardsODEPressureType.F90:1508-1550,
        SystemOfEquationsVSFMType.F90:1117-1168)."""
        if bc_value is None:
            bc_value = self.bc_value
        bc_ids, _, _, _, _, code = self._bc_concat()
        takes_value = np.isin(code, (int(Cond.DIRICHLET),
                                     int(Cond.SEEPAGE_BC),
                                     int(Cond.DIRICHLET_FRM_OTR_GOVEQ)))
        return jnp.where(jnp.asarray(takes_value), bc_value,
                         P[jnp.asarray(bc_ids)])

    def _bc_swap_mask(self):
        """Per-BC-connection swap_order flags (set by the coupling rewiring,
        SystemOfEquationsVSFMType.F90:1349-1354)."""
        out = []
        for cond in self.boundary_conditions:
            out.append(np.full(cond.num_connections, bool(cond.swap_order)))
        return np.concatenate(out) if out else np.zeros(0, bool)

    def coupled_bc_slices(self):
        """[(cond, bc_offset, other_geq_index_0based, coupled_cells)] for
        COND_DIRICHLET_FRM_OTR_GOVEQ conditions."""
        out = []
        off = 0
        for cond in self.boundary_conditions:
            if cond.itype == int(Cond.DIRICHLET_FRM_OTR_GOVEQ):
                out.append((cond, off, cond.rank_of_other_goveqs[0] - 1,
                            np.asarray(cond.coupled_cells, np.int64)))
            off += cond.num_connections
        return out

    def coupling_coords(self, row_off, col_offs):
        """Off-diagonal Jacobian coordinates for coupled BCs
        (OffDiagJacobian_Pressure, GoveqnRichardsODEPressureType.F90:
        2203-2330): row = own cell, col = coupled GE's cell."""
        rows, cols = [], []
        for cond, off, other, cells in self.coupled_bc_slices():
            rows.append(cond.conn_set.id_dn.astype(np.int64) + row_off)
            cols.append(cells + col_offs[other])
        if not rows:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(rows), np.concatenate(cols)

    def accum(self, P, dyn=None):
        """por*den*sat*vol/dt — without dt: caller divides."""
        sat, _, _, _, den, _, _, _, por, _ = self._cell_aux(P, dyn)
        vol = (dyn["vol"] if dyn and "vol" in dyn
               else jnp.asarray(self.mesh.vol))
        return por * den * sat * vol

    def _internal_fluxes(self, P, aux, dyn=None):
        """(flux, dflux_up, dflux_dn) over internal connections, blending
        Darcy and conductance flux models by the static per-conn type."""
        (sat, dsat, kr, dkr, den, dden, vis, dvis, por, dpor) = aux
        ic = self._internal()
        iu, idn = jnp.asarray(ic.id_up), jnp.asarray(ic.id_dn)
        if dyn and "perm" in dyn:
            uva = jnp.asarray(np.abs(ic.unit_vec))
            pv = dyn["perm"]
            perm_up = (uva[:, 0] * pv[iu, 0] + uva[:, 1] * pv[iu, 1]
                       + uva[:, 2] * pv[iu, 2])
            perm_dn = (uva[:, 0] * pv[idn, 0] + uva[:, 1] * pv[idn, 1]
                       + uva[:, 2] * pv[idn, 2])
        else:
            perm_up = jnp.asarray(
                np.abs(ic.unit_vec[:, 0]) * self.perm[ic.id_up, 0]
                + np.abs(ic.unit_vec[:, 1]) * self.perm[ic.id_up, 1]
                + np.abs(ic.unit_vec[:, 2]) * self.perm[ic.id_up, 2])
            perm_dn = jnp.asarray(
                np.abs(ic.unit_vec[:, 0]) * self.perm[ic.id_dn, 0]
                + np.abs(ic.unit_vec[:, 1]) * self.perm[ic.id_dn, 1]
                + np.abs(ic.unit_vec[:, 2]) * self.perm[ic.id_dn, 2])
        d_up = (dyn["in_dist_up"] if dyn and "in_dist_up" in dyn
                else jnp.asarray(ic.dist_up))
        d_dn = (dyn["in_dist_dn"] if dyn and "in_dist_dn" in dyn
                else jnp.asarray(ic.dist_dn))
        ar = (dyn["in_area"] if dyn and "in_area" in dyn
              else jnp.asarray(ic.area))
        flux, dfu, dfd = darcy_flux(
            P[iu], P[idn], kr[iu], kr[idn], dkr[iu], dkr[idn], den[iu],
            den[idn], dden[iu], dden[idn], vis[iu], vis[idn], dvis[iu],
            dvis[idn], perm_up, perm_dn,
            d_up, d_dn, ar, jnp.asarray(ic.unit_vec[:, 2]),
            internal=True)
        ca = self.conn_in
        if ca is not None and ca.any_conductance:
            krg, dkrg_up, dkrg_dn = conductance_krg(
                P[iu], P[idn], ca.sp_up, ca.sp_dn, ca.cond_type,
                jnp.asarray(ca.conductance), jnp.asarray(ca.conductance_up),
                jnp.asarray(ca.conductance_dn), ca.upwind_weight)
            cflux, cdfu, cdfd = conductance_flux(
                P[iu], P[idn], den[iu], den[idn], dden[iu], dden[idn],
                krg, dkrg_up, dkrg_dn, ar)
            is_cond = jnp.asarray(ca.flux_type == int(FluxType.CONDUCTANCE))
            flux = jnp.where(is_cond, cflux, flux)
            dfu = jnp.where(is_cond, cdfu, dfu)
            dfd = jnp.where(is_cond, cdfd, dfd)
        return ic, flux, dfu, dfd

    def _bc_fluxes(self, P, aux, bc_value=None, dyn=None):
        """(bc cell ids, flux, dflux_dn, dflux_up) over BC connections.

        ``swap_order`` connections (coupled-GE BCs on the higher-rank side)
        reproduce the reference's argument swap in
        ``RichardsFluxConductanceModel`` (RichardsMod.F90:707-742): the flux
        value is unchanged (symmetric 0.5/0.5 density average) but the
        conn-auxvar kr-derivative sides exchange roles, so the own-cell
        (diag) entry carries dkrg_dP_up and the coupled-cell (off-diag)
        entry carries dkrg_dP_dn."""
        (sat, dsat, kr, dkr, den, dden, vis, dvis, por, dpor) = aux
        bc_ids, bdup, bddn, barea, buvz, bcode = self._bc_concat()
        if not bc_ids.size:
            return bc_ids, jnp.zeros(0), jnp.zeros(0), jnp.zeros(0)
        bids = jnp.asarray(bc_ids)
        P_bc = self._bc_aux_pressure(P, bc_value)
        sp_b, pp_b, temp_b = self._dyn_bc_params(dyn, bc_ids)
        (sat_b, dsat_b, kr_b, dkr_b, den_b, dden_b, vis_b, dvis_b,
         por_b, dpor_b) = richards_aux(
            P_bc, sp_b, pp_b, temp_b, jnp.ones_like(P_bc),
            self.density_type)
        if dyn and "perm" in dyn:
            # directional perm on both sides from the adjacent cell's
            # dynamic values (BC auxvars inherit the cell's parameters)
            uva = jnp.asarray(np.abs(self._bc_unit_vecs()))
            pv = dyn["perm"]
            perm_cell = (uva[:, 0] * pv[bids, 0] + uva[:, 1] * pv[bids, 1]
                         + uva[:, 2] * pv[bids, 2])
            perm_b = perm_cell
        else:
            perm_b, perm_cell = self._bc_perms()
            perm_b = jnp.asarray(perm_b)
            perm_cell = jnp.asarray(perm_cell)
        bdup_e = (dyn["bc_dist_up"] if dyn and "bc_dist_up" in dyn
                  else jnp.asarray(bdup))
        bddn_e = (dyn["bc_dist_dn"] if dyn and "bc_dist_dn" in dyn
                  else jnp.asarray(bddn))
        barea_e = (dyn["bc_area"] if dyn and "bc_area" in dyn
                   else jnp.asarray(barea))
        seep = bcode == int(Cond.SEEPAGE_BC)
        flux, _dfu, dfd = darcy_flux(
            P_bc, P[bids], kr_b, kr[bids], dkr_b, dkr[bids], den_b,
            den[bids], dden_b, dden[bids], vis_b, vis[bids], dvis_b,
            dvis[bids], perm_b, perm_cell,
            bdup_e, bddn_e, barea_e,
            jnp.asarray(buvz), internal=False, cond_kind=bcode,
            seepage_mask=seep)
        # Darcy-coupled BCs (COND_DIRICHLET_FRM_OTR_GOVEQ): the up-side
        # pressure is the partner GE's unknown, so dflux/dP_up is a live
        # off-diagonal Jacobian entry; for true Dirichlet data it is zero.
        # The swap_order side reproduces RichardsFlux (RichardsMod.F90:
        # 96-113): evaluate with up/dn exchanged, then negate value and
        # derivatives (and exchange their roles).  Deviation from the
        # reference: the swapped evaluation also flips unit_z so the
        # gravity term follows the exchanged orientation — the reference
        # reuses the conn's up->dn unit vector with swapped aux args,
        # which gives the swapped side's gravity term the wrong sign and
        # makes vertical Darcy coupling fluxes non-antisymmetric (mass
        # drift).  Benign in every shipped regression suite (their coupled
        # conns are horizontal or conductance-type); required for mass
        # conservation in vsfm_manoli2014-style vertical junctions.  See
        # KNOWN_GAPS.md.
        is_otr = np.asarray(bcode == int(Cond.DIRICHLET_FRM_OTR_GOVEQ))
        dfu = jnp.where(jnp.asarray(is_otr), _dfu, 0.0)
        swap_np = self._bc_swap_mask() & is_otr
        if swap_np.any():
            flux2, dfu2, dfd2 = darcy_flux(
                P[bids], P_bc, kr[bids], kr_b, dkr[bids], dkr_b,
                den[bids], den_b, dden[bids], dden_b, vis[bids], vis_b,
                dvis[bids], dvis_b, perm_cell,
                perm_b, bdup_e, bddn_e,
                barea_e, -jnp.asarray(buvz), internal=False,
                cond_kind=bcode, seepage_mask=seep)
            swapj = jnp.asarray(swap_np)
            flux = jnp.where(swapj, -flux2, flux)
            dfd = jnp.where(swapj, -dfu2, dfd)
            dfu = jnp.where(swapj, -dfd2, dfu)
        ca = self.conn_bc
        if ca is not None and ca.any_conductance:
            krg, dkrg_up, dkrg_dn = conductance_krg(
                P_bc, P[bids], ca.sp_up, ca.sp_dn, ca.cond_type,
                jnp.asarray(ca.conductance), jnp.asarray(ca.conductance_up),
                jnp.asarray(ca.conductance_dn), ca.upwind_weight)
            swap = jnp.asarray(self._bc_swap_mask())
            dkrg_up_eff = jnp.where(swap, dkrg_dn, dkrg_up)
            dkrg_dn_eff = jnp.where(swap, dkrg_up, dkrg_dn)
            cflux, cdfu, cdfd = conductance_flux(
                P_bc, P[bids], den_b, den[bids], dden_b, dden[bids],
                krg, dkrg_up_eff, dkrg_dn_eff, barea_e)
            is_cond = jnp.asarray(ca.flux_type == int(FluxType.CONDUCTANCE))
            flux = jnp.where(is_cond, cflux, flux)
            dfd = jnp.where(is_cond, cdfd, dfd)
            dfu = jnp.where(is_cond, cdfu, dfu)
        return bc_ids, flux, dfd, dfu

    def residual(self, P, dt, bc_value=None, ss_value=None, accum_prev=None,
                 dyn=None):
        """F (length ncells_local)."""
        if ss_value is None:
            ss_value = self.ss_value
        if accum_prev is None:
            accum_prev = self.accum_prev
        n = self.mesh.ncells_local
        active = jnp.asarray(self.mesh.is_active)
        aux = self._cell_aux(P, dyn)
        (sat, dsat, kr, dkr, den, dden, vis, dvis, por, dpor) = aux
        vol = (dyn["vol"] if dyn and "vol" in dyn
               else jnp.asarray(self.mesh.vol))
        F = jnp.where(active, por * den * sat * vol / dt, 0.0)
        F = F - accum_prev

        ic, flux, _, _ = self._internal_fluxes(P, aux, dyn)
        iu, idn = jnp.asarray(ic.id_up), jnp.asarray(ic.id_dn)
        both = active[iu] & active[idn]
        flux = jnp.where(both, flux, 0.0)
        F = F.at[iu].add(-flux).at[idn].add(flux)

        bc_ids, flux_b, _, _ = self._bc_fluxes(P, aux, bc_value, dyn)
        if bc_ids.size:
            bids = jnp.asarray(bc_ids)
            flux_b = jnp.where(active[bids], flux_b, 0.0)
            F = F.at[bids].add(flux_b)

        ss_ids, ss_code = self._ss_concat()
        if ss_ids.size:
            sids = jnp.asarray(ss_ids)
            dP = P[sids] - PRESSURE_REF
            Pc = jnp.asarray(self.ss_pot_sink_pressure)
            nn = jnp.asarray(self.ss_pot_sink_exponent)
            is_camp = np.asarray(ss_code == int(Cond.DOWNREG_MASS_RATE_CAMPBELL))
            is_fetch = np.asarray(ss_code == int(Cond.DOWNREG_MASS_RATE_FETCH2))
            dP_neg = dP <= 0.0
            dP_safe = jnp.where(dP_neg, dP, -1.0)
            ratio = jnp.where(jnp.asarray(is_camp | is_fetch),
                              dP_safe / Pc, 1.0)
            pw = ratio ** nn
            f_camp = jnp.where(dP_neg, 1.0 + pw, 1.0)
            f_fetch = jnp.where(dP_neg, jnp.exp(-pw), 1.0)
            val = ss_value / FMWH2O
            contrib = jnp.where(jnp.asarray(is_camp), val / f_camp,
                                jnp.where(jnp.asarray(is_fetch),
                                          val * f_fetch, val))
            F = F.at[sids].add(-contrib)
        return F

    def residual_and_jac_values(self, P, dt, bc_value=None, ss_value=None,
                                accum_prev=None, dyn=None):
        """(F, jacobian values) from ONE constitutive/flux evaluation.

        ``residual`` and ``jacobian_values`` each call the full auxvar
        chain and the flux kernels (which already return values AND
        derivatives together); the batched Newton calls them back-to-back
        every iteration, so the merged form halves the dominant
        constitutive cost (TGDPB01/VG transcendental evaluations) on the
        compiled batched path.  Identical math to the two separate calls."""
        if ss_value is None:
            ss_value = self.ss_value
        if accum_prev is None:
            accum_prev = self.accum_prev
        n = self.mesh.ncells_local
        active = jnp.asarray(self.mesh.is_active)
        aux = self._cell_aux(P, dyn)
        (sat, dsat, kr, dkr, den, dden, vis, dvis, por, dpor) = aux
        vol = (dyn["vol"] if dyn and "vol" in dyn
               else jnp.asarray(self.mesh.vol))
        F = jnp.where(active, por * den * sat * vol / dt, 0.0) - accum_prev

        ic, flux, dfu, dfd = self._internal_fluxes(P, aux, dyn)
        iu, idn = jnp.asarray(ic.id_up), jnp.asarray(ic.id_dn)
        both = active[iu] & active[idn]
        flux = jnp.where(both, flux, 0.0)
        dfu = jnp.where(both, dfu, 0.0)
        dfd = jnp.where(both, dfd, 0.0)
        F = F.at[iu].add(-flux).at[idn].add(flux)
        intr_vals = jnp.concatenate([-dfu, -dfd, dfu, dfd])

        bc_ids, flux_b, dfd_b, dfu_b = self._bc_fluxes(P, aux, bc_value, dyn)
        if bc_ids.size:
            bids = jnp.asarray(bc_ids)
            flux_b = jnp.where(active[bids], flux_b, 0.0)
            F = F.at[bids].add(flux_b)
            bc_vals = jnp.where(active[bids], dfd_b, 0.0)
        else:
            bc_vals = jnp.zeros(0)
        cpl_tails = []
        for cond, off, other, cells in self.coupled_bc_slices():
            m = cond.num_connections
            cpl_tails.append(dfu_b[off:off + m])

        ss_ids, ss_code = self._ss_concat()
        if ss_ids.size:
            sids = jnp.asarray(ss_ids)
            dP = P[sids] - PRESSURE_REF
            Pc = jnp.asarray(self.ss_pot_sink_pressure)
            nn = jnp.asarray(self.ss_pot_sink_exponent)
            is_camp = np.asarray(ss_code
                                 == int(Cond.DOWNREG_MASS_RATE_CAMPBELL))
            is_fetch = np.asarray(ss_code
                                  == int(Cond.DOWNREG_MASS_RATE_FETCH2))
            dP_neg = dP <= 0.0
            dP_safe = jnp.where(dP_neg, dP, -1.0)
            ratio = jnp.where(jnp.asarray(is_camp | is_fetch),
                              dP_safe / Pc, 1.0)
            pw = ratio ** nn
            f_camp_r = jnp.where(dP_neg, 1.0 + pw, 1.0)
            f_fetch_r = jnp.where(dP_neg, jnp.exp(-pw), 1.0)
            val = ss_value / FMWH2O
            contrib = jnp.where(jnp.asarray(is_camp), val / f_camp_r,
                                jnp.where(jnp.asarray(is_fetch),
                                          val * f_fetch_r, val))
            F = F.at[sids].add(-contrib)
            f_camp = 1.0 + pw
            f_fetch = jnp.exp(-pw)
            v_camp = val * (nn * pw) / (dP_safe * f_camp ** 2.0)
            v_fetch = val * (nn * pw) * f_fetch / dP_safe
            ss_vals = jnp.where(
                jnp.asarray(is_camp) & dP_neg, v_camp,
                jnp.where(jnp.asarray(is_fetch) & dP_neg, v_fetch, 0.0))
        else:
            ss_vals = jnp.zeros(0)

        accum_deriv = ((dpor * den * sat + por * dden * sat
                        + por * den * dsat) * vol / dt)[:n]
        diag_vals = jnp.where(active[:n], accum_deriv, 1.0)
        vals = jnp.concatenate([intr_vals, bc_vals, ss_vals, diag_vals]
                               + cpl_tails)
        return F, vals

    def jacobian_values(self, P, dt, bc_value=None, ss_value=None, dyn=None):
        """A-contribution values in coo_coords order."""
        if ss_value is None:
            ss_value = self.ss_value
        n = self.mesh.ncells_local
        active = jnp.asarray(self.mesh.is_active)
        aux = self._cell_aux(P, dyn)
        (sat, dsat, kr, dkr, den, dden, vis, dvis, por, dpor) = aux
        vol = (dyn["vol"] if dyn and "vol" in dyn
               else jnp.asarray(self.mesh.vol))

        ic, _, dfu, dfd = self._internal_fluxes(P, aux, dyn)
        iu, idn = jnp.asarray(ic.id_up), jnp.asarray(ic.id_dn)
        both = active[iu] & active[idn]
        dfu = jnp.where(both, dfu, 0.0)
        dfd = jnp.where(both, dfd, 0.0)
        # F_up -= flux ; F_dn += flux
        intr_vals = jnp.concatenate([-dfu, -dfd, dfu, dfd])

        bc_ids, _, dfd_b, dfu_b = self._bc_fluxes(P, aux, bc_value, dyn)
        if bc_ids.size:
            bids = jnp.asarray(bc_ids)
            # F_cell += flux  -> J[c,c] += dflux_dP_dn
            bc_vals = jnp.where(active[bids], dfd_b, 0.0)
        else:
            bc_vals = jnp.zeros(0)
        # off-diagonal coupling tail: J[c, other] += dflux_dP_up for
        # COND_DIRICHLET_FRM_OTR_GOVEQ conns (order matches coupling_coords)
        cpl_tails = []
        for cond, off, other, cells in self.coupled_bc_slices():
            m = cond.num_connections
            cpl_tails.append(dfu_b[off:off + m])

        ss_ids, ss_code = self._ss_concat()
        if ss_ids.size:
            sids = jnp.asarray(ss_ids)
            dP = P[sids] - PRESSURE_REF
            Pc = jnp.asarray(self.ss_pot_sink_pressure)
            nn = jnp.asarray(self.ss_pot_sink_exponent)
            is_camp = np.asarray(ss_code == int(Cond.DOWNREG_MASS_RATE_CAMPBELL))
            is_fetch = np.asarray(ss_code == int(Cond.DOWNREG_MASS_RATE_FETCH2))
            dP_neg = dP <= 0.0
            dP_safe = jnp.where(dP_neg, dP, -1.0)
            ratio = jnp.where(jnp.asarray(is_camp | is_fetch),
                              dP_safe / Pc, 1.0)
            pw = ratio ** nn
            f_camp = 1.0 + pw
            f_fetch = jnp.exp(-pw)
            val = ss_value / FMWH2O
            v_camp = val * (nn * pw) / (dP_safe * f_camp ** 2.0)
            v_fetch = val * (nn * pw) * f_fetch / dP_safe
            ss_vals = jnp.where(
                jnp.asarray(is_camp) & dP_neg, v_camp,
                jnp.where(jnp.asarray(is_fetch) & dP_neg, v_fetch, 0.0))
        else:
            ss_vals = jnp.zeros(0)

        accum_deriv = ((dpor * den * sat + por * dden * sat
                        + por * den * dsat) * vol / dt)[:n]
        diag_vals = jnp.where(active[:n], accum_deriv, 1.0)
        return jnp.concatenate([intr_vals, bc_vals, ss_vals, diag_vals]
                               + cpl_tails)

    # ---- staging (VSFMMPPSetSoilsCLM) -------------------------------------
    def set_soils(self, filter_vsfmc, watsat, hksat, bsw, sucsat,
                  residual_sat, satfunc_type: str, density_type: int,
                  grav=C.GRAV_CLM, denh2o=C.DENH2O):
        vish2o = 0.001002
        watsat = np.asarray(watsat)
        ncol, nlev = watsat.shape
        self.density_type = density_type
        first = int(np.nonzero(np.asarray(filter_vsfmc) == 1)[0][0])
        for c in range(ncol):
            src = c if filter_vsfmc[c] == 1 else first
            for j in range(nlev):
                icell = c * nlev + j
                perm = hksat[src, j] * vish2o / (denh2o * grav) * 0.001
                alpha = 1.0 / (sucsat[src, j] * grav)
                lam = 1.0 / bsw[src, j]
                sat_res = residual_sat[src, j]
                self.perm[icell, :] = perm
                self.por_params.porosity_base[icell] = watsat[src, j]
                if satfunc_type == "brooks_corey":
                    self.sat_params.set_bc(icell, sat_res, alpha, lam)
                elif satfunc_type == "smooth_brooks_corey_bz2":
                    self.sat_params.set_sbc_bz2(icell, sat_res, alpha, lam,
                                                -0.9 / alpha)
                elif satfunc_type == "smooth_brooks_corey_bz3":
                    self.sat_params.set_sbc_bz3(icell, sat_res, alpha, lam,
                                                -0.9 / alpha)
                elif satfunc_type == "van_genuchten":
                    self.sat_params.set_vg(icell, sat_res, alpha, lam)
                else:
                    raise ValueError(f"Unknown satfunc {satfunc_type}")
        self._copy_params_to_bc_ss()

    def set_soil_permeability(self, perm_x, perm_y, perm_z):
        """RichardsODESetSoilPermeability incl. BC/SS auxvar copies
        (GoveqnRichardsODEPressureType.F90:3087-3113,
        RichardsODEPressureAuxMod.F90:108-194)."""
        n = len(np.asarray(perm_x))
        self.perm[:n, 0] = perm_x
        self.perm[:n, 1] = perm_y
        self.perm[:n, 2] = perm_z
        self.bc_perm[:] = self.perm[self._bc_concat()[0]]

    def set_soil_porosity(self, por):
        """RichardsODEPressureAuxVarSetPorosity incl. BC/SS copies
        (RichardsODEPressureAuxMod.F90:286-377)."""
        self.por_params.porosity_base[:self.mesh.ncells_all] = por
        bc_ids = self._bc_concat()[0]
        self.bc_por_params.porosity_base[:] = self.por_params.porosity_base[bc_ids]

    def set_saturation_function(self, satfunc_type, alpha, lam, sat_res):
        """RichardsODEPressureAuxVarSetSatFunc + SetSatFunc dispatch
        (SaturationFunction.F90:1392-1428), with BC/SS auxvar copies."""
        for icell in range(len(np.asarray(alpha))):
            t = int(np.asarray(satfunc_type)[icell]) \
                if np.ndim(satfunc_type) else int(satfunc_type)
            a, l_, s = (float(np.asarray(alpha)[icell]),
                        float(np.asarray(lam)[icell]),
                        float(np.asarray(sat_res)[icell]))
            if t == sf.SAT_FUNC_BROOKS_COREY:
                self.sat_params.set_bc(icell, s, a, l_)
            elif t == sf.SAT_FUNC_SMOOTHED_BROOKS_COREY_BZ2:
                self.sat_params.set_sbc_bz2(icell, s, a, l_, -0.9 / a)
            elif t == sf.SAT_FUNC_SMOOTHED_BROOKS_COREY_BZ3:
                self.sat_params.set_sbc_bz3(icell, s, a, l_, -0.9 / a)
            elif t == sf.SAT_FUNC_VAN_GENUCHTEN:
                self.sat_params.set_vg(icell, s, a, l_)
            elif t == sf.SAT_FUNC_FETCH2:
                self.sat_params.set_fetch2(icell, a, l_)
            elif t == sf.SAT_FUNC_CHUANG:
                self.sat_params.set_chuang(icell, a, l_)
            else:
                raise ValueError(f"Unknown satfunc type {t}")
        self._copy_params_to_bc_ss()

    def set_relative_permeability(self, relperm_type, p1, p2):
        """VSFMMPPSetRelativePermeability (MultiPhysicsProbVSFM.F90:
        1216-1300): override the per-cell relperm model (Weibull d/c or
        Campbell he/n), with BC/SS auxvar copies."""
        relperm_type = np.asarray(relperm_type)
        for icell in range(relperm_type.size):
            t = int(relperm_type[icell])
            if t <= 0:
                continue
            if t == sf.RELPERM_FUNC_WEIBULL:
                self.sat_params.set_weibull_relperm(icell, p1[icell],
                                                    p2[icell])
            elif t == sf.RELPERM_FUNC_CAMPBELL:
                self.sat_params.set_campbell_relperm(icell, p1[icell],
                                                     p2[icell])
            elif t == sf.RELPERM_FUNC_MUALEM:
                self.sat_params.relperm_func_type[icell] = t
            else:
                raise ValueError(t)
        self._copy_params_to_bc_ss()

    def set_ss_auxvar(self, var_type, values):
        """VSFMMPPSetSourceSinkAuxVarRealValue
        (MultiPhysicsProbVSFM.F90:1437-1520)."""
        if var_type == Var.POT_MASS_SINK_PRESSURE:
            self.ss_pot_sink_pressure[:] = values
        elif var_type == Var.POT_MASS_SINK_EXPONENT:
            self.ss_pot_sink_exponent[:] = values
        else:
            raise NotImplementedError(var_type)

    def _conn_aux(self, kind) -> ConnAuxVars:
        return self.conn_in if kind == AuxVarKind.CONN_INTERNAL else self.conn_bc

    def set_conn_int_value(self, kind, var_type, values):
        """VSFMMPPSetAuxVarConnIntValue."""
        ca = self._conn_aux(kind)
        if var_type == Var.FLUX_TYPE:
            ca.flux_type[:] = values
        elif var_type == Var.CONDUCTANCE_TYPE:
            vals = np.asarray(values)
            ca.cond_type[:] = np.where(vals == 0, ca.cond_type, vals)
        else:
            raise NotImplementedError(var_type)

    def set_conn_real_value(self, kind, var_type, values):
        """VSFMMPPSetAuxVarConnRealValue."""
        ca = self._conn_aux(kind)
        if var_type == Var.CONDUCTANCE:
            ca.conductance[:] = values
        elif var_type == Var.CONDUCTANCE_UP:
            ca.conductance_up[:] = values
        elif var_type == Var.CONDUCTANCE_DN:
            ca.conductance_dn[:] = values
        else:
            raise NotImplementedError(var_type)

    def set_conn_relperm(self, kind, set_upwind, relperm_itype, p1, p2):
        """RichardsODESetRelativePermeabilityAuxVarConn
        (GoveqnRichardsODEPressureType.F90:3318-3424)."""
        ca = self._conn_aux(kind)
        relperm_itype = np.asarray(relperm_itype)
        for i in range(relperm_itype.size):
            if relperm_itype[i] <= 0:
                continue
            sp = ca.sp_up if set_upwind[i] else ca.sp_dn
            t = int(relperm_itype[i])
            if t == sf.RELPERM_FUNC_WEIBULL:
                sp.set_weibull_relperm(i, p1[i], p2[i])
            elif t == sf.RELPERM_FUNC_CAMPBELL:
                sp.set_campbell_relperm(i, p1[i], p2[i])
            elif t == sf.RELPERM_FUNC_MUALEM:
                pass
            else:
                raise ValueError(t)

    def set_conn_satfunc(self, kind, set_upwind, satfunc_itype, p1, p2, p3):
        """RichardsODESetSaturationFunctionAuxVarConn."""
        ca = self._conn_aux(kind)
        satfunc_itype = np.asarray(satfunc_itype)
        for i in range(satfunc_itype.size):
            if satfunc_itype[i] <= 0:
                continue
            sp = ca.sp_up if set_upwind[i] else ca.sp_dn
            t = int(satfunc_itype[i])
            if t == sf.SAT_FUNC_VAN_GENUCHTEN:
                sp.set_vg(i, p3[i], p1[i], p2[i])
            elif t == sf.SAT_FUNC_BROOKS_COREY:
                sp.set_bc(i, p3[i], p1[i], p2[i])
            elif t == sf.SAT_FUNC_FETCH2:
                sp.set_fetch2(i, p1[i], p2[i])
            elif t == sf.SAT_FUNC_CHUANG:
                sp.set_chuang(i, p1[i], p2[i])
            else:
                raise ValueError(t)

    def _copy_params_to_bc_ss(self):
        """BC/SS auxvars inherit the adjacent cell's parameters
        (VSFMMPPSetSoilsCLM:422-471)."""
        bc_ids = self._bc_concat()[0]
        for fld in dataclasses.fields(sf.SatParams):
            getattr(self.bc_sat_params, fld.name)[:] = np.asarray(
                getattr(self.sat_params, fld.name))[bc_ids]
        self.bc_por_params.porosity_base[:] = \
            self.por_params.porosity_base[bc_ids]
        self.bc_perm[:] = self.perm[bc_ids]
        ss_ids = self._ss_concat()[0]
        if ss_ids.size:
            for fld in dataclasses.fields(sf.SatParams):
                getattr(self.ss_sat_params, fld.name)[:] = np.asarray(
                    getattr(self.sat_params, fld.name))[ss_ids]


class VSFMSoE:
    """SOE_RE_ODE: VSFM system of equations (SNES).

    Single- or multi-GE; implements VSFMSOEResidual/VSFMJacobian structure
    and the SOEBaseStepDT_SNES stepper with dynamic line-search rotation
    and dt cutting (SystemOfEquationsBaseType.F90:368-552).
    """

    def __init__(self):
        self.goveqns: List[RichardsGE] = []
        self.itype = int(SOEType.RE_ODE)
        self.soln = None
        self.soln_prev = None
        self.soln_prev_clm = None
        self.template: Optional[CSRTemplate] = None
        self.use_dynamic_linesearch = False
        self.default_linesearch = LS_BT
        self.snes_stol = 1e-10
        self.cumulative_newton_iterations = 0
        self.cumulative_linear_iterations = 0
        self.metrics = None          # optional io.metrics.MetricsStream
        self._jit_res = None
        self._jit_jac = None

    @property
    def n_total(self):
        return sum(g.mesh.ncells_local for g in self.goveqns)

    def setup(self):
        offs = np.cumsum([0] + [g.mesh.ncells_local for g in self.goveqns])
        self.offsets = offs
        n = self.n_total
        # The CSR template is built lazily: coupled-BC sparsity needs the
        # pairing done by update_connections(), which the builder contract
        # runs after SetupProblem (vsfm_spac_campbell_problem.F90:166-180).
        self.template = None
        self.soln = jnp.zeros(n)
        self.soln_prev = jnp.zeros(n)
        self.soln_prev_clm = jnp.zeros(n)

    def _ensure_template(self):
        if self.template is not None:
            return
        offs = self.offsets
        rows, cols = [], []
        for g, off in zip(self.goveqns, offs[:-1]):
            r, c = g.coo_coords(off, off)
            rows.append(r)
            cols.append(c)
            rc, cc = g.coupling_coords(off, offs[:-1])
            rows.append(rc)
            cols.append(cc)
        n = self.n_total
        self.template = csr_template(n, n, np.concatenate(rows),
                                     np.concatenate(cols))

    # SNES callbacks ---------------------------------------------------------
    def _stage_coupled_bcs(self, Xj) -> None:
        """VSFMSOEGovEqnExchangeAuxVars (SystemOfEquationsVSFMType.F90:
        1117-1168): stage the coupled GE's pressures into the coupled-BC
        value slots before each residual/Jacobian evaluation."""
        for g in self.goveqns:
            for cond, off, other, cells in g.coupled_bc_slices():
                src = self.offsets[other] + cells
                g.bc_value = g.bc_value.at[off:off + cells.size].set(
                    Xj[jnp.asarray(src)])

    def _residual(self, X: np.ndarray, dt: float) -> np.ndarray:
        Xj = jnp.asarray(X)
        self._stage_coupled_bcs(Xj)
        Fs = []
        for g, off in zip(self.goveqns, self.offsets[:-1]):
            Fs.append(g.residual(Xj[off:off + g.mesh.ncells_local], dt))
        return np.asarray(jnp.concatenate(Fs))

    def _jacobian(self, X: np.ndarray, dt: float):
        self._ensure_template()
        Xj = jnp.asarray(X)
        self._stage_coupled_bcs(Xj)
        vals = []
        for g, off in zip(self.goveqns, self.offsets[:-1]):
            vals.append(g.jacobian_values(Xj[off:off + g.mesh.ncells_local],
                                          dt))
        data = np.asarray(self.template.assemble(jnp.concatenate(vals)))
        return self.template.indptr, self.template.indices, data

    def pre_step_dt(self):
        """VSFMSoePreStepDT: rotate soln -> soln_prev_clm
        (SystemOfEquationsVSFMType.F90:892-916)."""
        self.soln_prev_clm = self.soln

    def pre_solve(self, dt):
        """VSFMSOEPreSolve: aux pressure from soln_prev; accum_prev."""
        for g, off in zip(self.goveqns, self.offsets[:-1]):
            Pprev = self.soln_prev[off:off + g.mesh.ncells_local]
            g.pressure = Pprev
            active = jnp.asarray(g.mesh.is_active)
            g.accum_prev = jnp.where(active, g.accum(Pprev) / dt, 0.0)

    def step_dt(self, dt: float, nstep: int = 1):
        """SOEBaseStepDT_SNES semantics."""
        time = 0.0
        dt_iter = dt
        num_time_cuts = 0
        max_num_time_cuts = 20
        linesearch_iter = 0
        if self.default_linesearch in (LS_BT, LS_L2):
            ls_list = ([LS_BT, LS_L2] if self.default_linesearch == LS_BT
                       else [LS_L2, LS_BT])
        else:
            ls_list = [self.default_linesearch, LS_L2, LS_BT]

        converged = False
        reason = 0
        while True:
            self.pre_solve(dt_iter)
            opts = SNESOptions(stol=self.snes_stol,
                               linesearch=ls_list[linesearch_iter])
            res = snes_solve(partial(self._residual, dt=dt_iter),
                             partial(self._jacobian, dt=dt_iter),
                             np.asarray(self.soln), opts)
            reason = res.reason
            if res.reason < 0:
                linesearch_iter += 1
                if not (self.use_dynamic_linesearch
                        and linesearch_iter < len(ls_list)):
                    linesearch_iter = 0
                    num_time_cuts += 1
                    dt_iter = 0.5 * dt_iter
                self.soln = self.soln_prev
            else:
                converged = True
                time += dt_iter
                self.cumulative_newton_iterations += res.iterations
                self.cumulative_linear_iterations += res.linear_iterations
                self.soln = jnp.asarray(res.x)
                # PostSolve
                self.soln_prev = self.soln
                for g, off in zip(self.goveqns, self.offsets[:-1]):
                    g.pressure = self.soln[off:off + g.mesh.ncells_local]
            if num_time_cuts > max_num_time_cuts:
                if self.metrics is not None:
                    self.metrics.record(
                        step=nstep, dt=dt, dt_used=dt_iter, converged=False,
                        reason=int(reason), dt_cuts=num_time_cuts,
                        newton_iterations=int(res.iterations),
                        linear_iterations=int(res.linear_iterations),
                        fnorm=float(res.fnorm))
                return False, reason
            if time >= dt:
                break
        if self.metrics is not None:
            self.metrics.record(
                step=nstep, dt=dt, dt_used=dt_iter, converged=converged,
                reason=int(reason), dt_cuts=num_time_cuts,
                newton_iterations=int(res.iterations),
                linear_iterations=int(res.linear_iterations),
                fnorm=float(res.fnorm))
        return converged, reason

    def get_soln(self):
        return np.asarray(self.soln)


class VSFMMPP(MPPBase):
    """mpp_vsfm_type facade with the 8-step builder contract."""

    GE_CLASSES = {GEType.RE: RichardsGE}
    SS_COND_TYPES = (Cond.MASS_RATE, Cond.DOWNREG_MASS_RATE_CAMPBELL,
                     Cond.DOWNREG_MASS_RATE_FETCH2)

    def __init__(self):
        super().__init__()
        self.soe = VSFMSoE()

    def add_coupling_bcs_in_goveqn(self, ieqn, name, unit, id_of_other_goveqs,
                                   conn_set):
        """SOEBaseAddCouplingBCsInGovEqn (SystemOfEquationsBaseType.F90:
        1203-1257): a COND_DIRICHLET_FRM_OTR_GOVEQ boundary condition whose
        'up' side lives in another governing equation."""
        ge = self.soe.goveqns[ieqn - 1]
        cond = Condition(name=name, units=unit,
                         itype=int(Cond.DIRICHLET_FRM_OTR_GOVEQ),
                         conn_set=conn_set,
                         rank_of_other_goveqs=list(id_of_other_goveqs))
        cond.ensure_value()
        cond.coupled_cells = None
        ge.boundary_conditions.append(cond)
        return cond

    def update_connections(self):
        """VSFMSOEUpdateConnections (SystemOfEquationsVSFMType.F90:
        1174-1468): pair coupled BCs between GE pairs, rewire each BC
        connection's 'up' side to the partner GE's cell, set swap_order on
        the higher-rank GE's condition, and exchange the BC-side cell
        parameters and conn-auxvar up-side relperm/conductance."""
        import dataclasses as _dc
        ges = self.soe.goveqns

        def _bc_offset(ge, cond):
            off = 0
            for c in ge.boundary_conditions:
                if c is cond:
                    return off
                off += c.num_connections
            raise KeyError(cond)

        for i in range(len(ges)):
            for j in range(i + 1, len(ges)):
                conds_i = [c for c in ges[i].boundary_conditions
                           if c.itype == int(Cond.DIRICHLET_FRM_OTR_GOVEQ)
                           and (j + 1) in c.rank_of_other_goveqs]
                conds_j = [c for c in ges[j].boundary_conditions
                           if c.itype == int(Cond.DIRICHLET_FRM_OTR_GOVEQ)
                           and (i + 1) in c.rank_of_other_goveqs]
                for ci, cj in zip(conds_i, conds_j):
                    if ci.num_connections != cj.num_connections:
                        raise ValueError("coupled BC size mismatch")
                    cj.swap_order = True     # higher rank swaps (F90:1350-54)
                    ci.coupled_cells = cj.conn_set.id_dn.copy()
                    cj.coupled_cells = ci.conn_set.id_dn.copy()
                    # dist_up of one = dist_dn of the other (F90:1408-1412)
                    ci.conn_set.dist_up = cj.conn_set.dist_dn.copy()
                    cj.conn_set.dist_up = ci.conn_set.dist_dn.copy()
                    oi = _bc_offset(ges[i], ci)
                    oj = _bc_offset(ges[j], cj)
                    m = ci.num_connections
                    # swap BC cell-side auxvar parameters (F90:1420-1424):
                    # each side's BC auxvar carries the partner cell's
                    # constitutive parameters
                    for fld in _dc.fields(sf.SatParams):
                        a = getattr(ges[i].bc_sat_params, fld.name)
                        b = getattr(ges[j].bc_sat_params, fld.name)
                        tmp = a[oi:oi + m].copy()
                        a[oi:oi + m] = b[oj:oj + m]
                        b[oj:oj + m] = tmp
                    a = ges[i].bc_por_params.porosity_base
                    b = ges[j].bc_por_params.porosity_base
                    tmp = a[oi:oi + m].copy()
                    a[oi:oi + m] = b[oj:oj + m]
                    b[oj:oj + m] = tmp
                    tmp = ges[i].bc_perm[oi:oi + m].copy()
                    ges[i].bc_perm[oi:oi + m] = ges[j].bc_perm[oj:oj + m]
                    ges[j].bc_perm[oj:oj + m] = tmp
                    # conn auxvars: up-side relperm params and conductance
                    # come from the partner's dn side (F90:1446-1457)
                    ca_i, ca_j = ges[i].conn_bc, ges[j].conn_bc
                    for fld in _dc.fields(sf.SatParams):
                        ai = getattr(ca_i.sp_up, fld.name)
                        aj = getattr(ca_j.sp_up, fld.name)
                        ai[oi:oi + m] = getattr(ca_j.sp_dn, fld.name)[oj:oj + m]
                        aj[oj:oj + m] = getattr(ca_i.sp_dn, fld.name)[oi:oi + m]
                    ca_i.conductance_up[oi:oi + m] = \
                        ca_j.conductance_dn[oj:oj + m]
                    ca_j.conductance_up[oj:oj + m] = \
                        ca_i.conductance_dn[oi:oi + m]

    def setup_problem(self, dyn_linesearch=None):
        self.soe.setup()
        if dyn_linesearch is not None:
            self.soe.use_dynamic_linesearch = bool(dyn_linesearch)

    def set_soils(self, filter_vsfmc, watsat, hksat, bsw, sucsat,
                  residual_sat, satfunc_type, density_type, goveqn_id=1):
        self.soe.goveqns[goveqn_id - 1].set_soils(
            filter_vsfmc, watsat, hksat, bsw, sucsat, residual_sat,
            satfunc_type, density_type)

    # per-GE property setters (VSFMMPPSet* pass-throughs) ------------------
    def set_density_type(self, igoveqn, density_type):
        """VSFMMPPSetDensityType (MultiPhysicsProbVSFM.F90:1115-1152)."""
        self.soe.goveqns[igoveqn - 1].density_type = int(density_type)

    def set_soil_permeability(self, igoveqn, perm_x, perm_y, perm_z):
        """VSFMMPPSetSoilPermeability pass-through."""
        self.soe.goveqns[igoveqn - 1].set_soil_permeability(perm_x, perm_y,
                                                            perm_z)

    def set_soil_porosity(self, igoveqn, por):
        self.soe.goveqns[igoveqn - 1].set_soil_porosity(por)

    def set_saturation_function(self, igoveqn, satfunc_type, alpha, lam,
                                sat_res):
        self.soe.goveqns[igoveqn - 1].set_saturation_function(
            satfunc_type, alpha, lam, sat_res)

    def set_relative_permeability(self, igoveqn, relperm_type, p1, p2):
        self.soe.goveqns[igoveqn - 1].set_relative_permeability(
            relperm_type, p1, p2)

    def set_ss_auxvar(self, igoveqn, var_type, values):
        self.soe.goveqns[igoveqn - 1].set_ss_auxvar(var_type, values)

    def set_conn_int_value(self, igoveqn, kind, var_type, values):
        self.soe.goveqns[igoveqn - 1].set_conn_int_value(kind, var_type, values)

    def set_conn_real_value(self, igoveqn, kind, var_type, values):
        self.soe.goveqns[igoveqn - 1].set_conn_real_value(kind, var_type,
                                                          values)

    def set_conn_relperm(self, igoveqn, kind, set_upwind, relperm_itype,
                         p1, p2):
        self.soe.goveqns[igoveqn - 1].set_conn_relperm(
            kind, set_upwind, relperm_itype, p1, p2)

    def set_conn_satfunc(self, igoveqn, kind, set_upwind, satfunc_itype,
                         p1, p2, p3):
        self.soe.goveqns[igoveqn - 1].set_conn_satfunc(
            kind, set_upwind, satfunc_itype, p1, p2, p3)

    def restart(self, press_1d):
        """VSFMMPPRestart: seed soln/soln_prev/pressure_prev."""
        press = jnp.asarray(np.asarray(press_1d, np.float64))
        self.soe.soln = press
        self.soe.soln_prev = press
        self.soe.soln_prev_clm = press
        for g, off in zip(self.soe.goveqns, self.soe.offsets[:-1]):
            g.pressure_prev = press[off:off + g.mesh.ncells_local]

    def set_data(self, auxvar_kind, var_type, soe_auxvar_id, data):
        """SetDataFromCLM: BC/SS condition values.

        ``soe_auxvar_id`` indexes conditions in GE order (BCs then next GE),
        1-based, matching the SoE auxvar-offset bookkeeping.  Coupling BCs
        (COND_DIRICHLET_FRM_OTR_GOVEQ) are excluded from the numbering,
        as in VSFMMPPAllocateAuxVars's
        GetNCellsInCondsExcptCondItype(COND_BC, COND_DIRICHLET_FRM_OTR_GOVEQ)
        (MultiPhysicsProbVSFM.F90:786-789).
        """
        data = jnp.asarray(np.asarray(data, np.float64))
        if auxvar_kind == AuxVarKind.BC:
            idx = 0
            for g in self.soe.goveqns:
                for ci, cond in enumerate(g.boundary_conditions):
                    if cond.itype == int(Cond.DIRICHLET_FRM_OTR_GOVEQ):
                        continue
                    idx += 1
                    if idx == soe_auxvar_id:
                        off = sum(c.num_connections
                                  for c in g.boundary_conditions[:ci])
                        m = cond.num_connections
                        g.bc_value = g.bc_value.at[off:off + m].set(data)
                        return
            raise IndexError(soe_auxvar_id)
        elif auxvar_kind == AuxVarKind.SS:
            idx = 0
            for g in self.soe.goveqns:
                for ci, cond in enumerate(g.source_sinks):
                    idx += 1
                    if idx == soe_auxvar_id:
                        off = sum(c.num_connections
                                  for c in g.source_sinks[:ci])
                        m = cond.num_connections
                        g.ss_value = g.ss_value.at[off:off + m].set(data)
                        return
            raise IndexError(soe_auxvar_id)
        raise NotImplementedError(auxvar_kind)

    def get_data(self, auxvar_kind, var_type, goveqn_id=-1):
        """GetDataForCLM: pressure / saturation over all GEs."""
        out = []
        for g in self.soe.goveqns:
            P = g.pressure
            if var_type == Var.PRESSURE:
                out.append(np.asarray(P))
            elif var_type == Var.LIQ_SAT:
                sat, _ = sf.press_to_sat(g.sat_params, P)
                out.append(np.asarray(sat))
            else:
                raise NotImplementedError(var_type)
        return np.concatenate(out)
