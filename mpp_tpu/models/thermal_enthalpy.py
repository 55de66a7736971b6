"""Enthalpy-based soil heat transport GE + TH coupled SoE (SNES path).

JAX reimplementation of the reference's thermal-enthalpy stack:

* auxvar constitutive chain with the max(P, P_ref) clamp on the EOS
  (density/viscosity/internal-energy only; sat/kr/por use raw P):
  ``auxvar/ThermalEnthalpySoilAuxType.F90:219-278``
* energy two-point flux eflux = mflux*h - kbar*(T_up-T_dn)*area with
  upwinded enthalpy and analytic dT/dP derivatives:
  ``ge/ThermalEnthalpyMod.F90:27-332`` (note the h-upwind branch uses
  ``mflux <= 0`` for the value but ``mflux < 0`` for the derivative —
  reproduced verbatim)
* mass-flux temperature derivative (density/viscosity T-dependence):
  ``ge/RichardsMod.F90:343-648`` (the reference negates its internally
  sign-flipped expression, yielding the TRUE derivative — we compute the
  true derivative directly; identical values)
* energy residual F = Accum(T,P) - accum_prev + Divergence:
  ``ge/GoveqnThermalEnthalpySoilType.F90:1060-1497``
* Jacobian wrt T: ibid :1223-1295 (accum) and :1501-1716 (divergence)
* off-diagonal block wrt P (accum dP, internal conns, non-OTR BCs;
  inactive-cell rows get 1.0 on the off-diag too):
  ibid :2083-2375
* mass-equation off-diagonal wrt T (accum por*dden_dT*sat, internal
  conns only; regular Dirichlet BCs intentionally omitted):
  ``ge/GoveqnRichardsODEPressureType.F90:2333-2612``
* TH SoE: X=[P;T], pairwise auxvar exchange (T -> mass GE, P -> energy
  GE), 2x2 block Jacobian: ``soe/SystemOfEquationsTHType.F90:736-1003``
* property staging incl. BC/SS copies and the enthalpy GE's default
  permeability 8.3913e-12 that MPPTHSetSoils never overrides:
  ``mpp/MultiPhysicsProbTH.F90:75-607``,
  ``auxvar/ThermalEnthalpySoilAuxType.F90:93``
* standalone thermal-enthalpy MPP (MPP_THERMAL_EBASED_SNES_CLM): the
  reference SoE evaluates residual/Jacobian with auxvars frozen at
  soln_prev (``soe/SystemOfEquationsThermalEnthalpyType.F90:352``), so
  each StepDT reduces to one linearized implicit-Euler update — we
  implement exactly that update (validated against the golden
  heat_transport_1D baseline).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional

import numpy as np
import jax.numpy as jnp
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from mpp_tpu import constants as C
from mpp_tpu.constants import (Cond, GEType, SOEType, Var, AuxVarKind,
                               PRESSURE_REF, GRAVITY_CONSTANT, FMWH2O)
from mpp_tpu.dtypes.mesh import Mesh
from mpp_tpu.dtypes.conditions import Condition
from mpp_tpu.dtypes.regions import region_connection_set
from mpp_tpu.dtypes.mpp_base import MPPBase
from mpp_tpu.ops.sparse import csr_template, CSRTemplate
from mpp_tpu.ops import eos, satfunc as sf
from mpp_tpu.ops.porosity import PorosityParams, porosity
from mpp_tpu.ops.snes import SNESOptions, snes_solve, LS_BT, LS_L2
from mpp_tpu.ops.ilu import ILU0, petsc_gmres
from mpp_tpu.models.richards import RichardsGE, darcy_flux


def enthalpy_aux(P, T, sat_params, por_params, density_type,
                 int_energy_type, tc_wet, tc_dry, t_alpha):
    """ThermEnthalpyAuxVarCompute (ThermalEnthalpySoilAuxType.F90:219-278).

    Returns a dict of all secondary quantities + analytic derivatives.
    EOS quantities are evaluated at max(P, PRESSURE_REF); their returned
    derivatives are the ones at the clamped pressure (no chain-rule
    zeroing), exactly as the reference does.
    """
    sat, dsat_dP = sf.press_to_sat(sat_params, P)
    kr, dkr_dP = sf.press_to_relperm(sat_params, P, jnp.ones_like(P))
    por, dpor_dP = porosity(por_params, P)
    Pc = jnp.maximum(P, PRESSURE_REF)
    den, dden_dP, dden_dT = eos.density(Pc, T, density_type)
    vis, dvis_dP, dvis_dT = eos.viscosity(Pc, T)
    ul, hl, dul_dT, dhl_dT, dul_dP, dhl_dP = eos.internal_energy_and_enthalpy(
        Pc, T, int_energy_type, den * FMWH2O, dden_dT * FMWH2O,
        dden_dP * FMWH2O)
    tw = jnp.asarray(tc_wet)
    td = jnp.asarray(tc_dry)
    ta = jnp.asarray(t_alpha)
    kel = (sat + 1.0e-6) ** ta
    dkel_dP = ta * (sat + 1.0e-6) ** (ta - 1.0) * dsat_dP
    tc = tw * kel + td * (1.0 - kel)
    dtc_dP = (tw - td) * dkel_dP
    return dict(sat=sat, dsat_dP=dsat_dP, kr=kr, dkr_dP=dkr_dP,
                por=por, dpor_dP=dpor_dP, den=den, dden_dP=dden_dP,
                dden_dT=dden_dT, vis=vis, dvis_dP=dvis_dP,
                dvis_dT=dvis_dT, ul=ul, hl=hl, dul_dT=dul_dT,
                dhl_dT=dhl_dT, dul_dP=dul_dP, dhl_dP=dhl_dP,
                tc=tc, dtc_dP=dtc_dP, T=T, P=P)


def _flux_geometry(internal, cond_kind, perm_up, perm_dn, dist_up, dist_dn):
    """(upweight, Dq) per RichardsFlux (RichardsMod.F90:196-236)."""
    dist = dist_up + dist_dn
    if internal:
        upweight = dist_up / dist
        Dq = (perm_up * perm_dn) / (dist_up * perm_dn + dist_dn * perm_up)
    else:
        is_otr = np.asarray(cond_kind) == int(Cond.DIRICHLET_FRM_OTR_GOVEQ)
        w_int = dist_up / dist
        Dq_int = (perm_up * perm_dn) / (dist_up * perm_dn + dist_dn * perm_up)
        upweight = jnp.where(jnp.asarray(is_otr), w_int, 0.0)
        Dq = jnp.where(jnp.asarray(is_otr), Dq_int, perm_dn / dist)
    return upweight, Dq


def darcy_flux_dT(P_up, P_dn, kr_up, kr_dn, den_up, den_dn, dden_dT_up,
                  dden_dT_dn, vis_up, vis_dn, dvis_dT_up, dvis_dT_dn,
                  perm_up, perm_dn, dist_up, dist_dn, area, unit_z,
                  internal: bool, cond_kind=None):
    """Vectorized RichardsFluxDerivativeWrtTemperature_Internal
    (RichardsMod.F90:431-648), returning the TRUE (flux, dT_up, dT_dn)
    derivatives (the reference's final negation of its sign-flipped
    intermediate yields the same values)."""
    upweight, Dq = _flux_geometry(internal, cond_kind, perm_up, perm_dn,
                                  dist_up, dist_dn)
    dist = dist_up + dist_dn
    dist_gravity = dist * (unit_z * (-GRAVITY_CONSTANT))
    den_ave = upweight * den_up + (1.0 - upweight) * den_dn
    dphi = P_up - P_dn + den_ave * FMWH2O * dist_gravity
    up_wind = dphi >= 0.0
    ukvr = jnp.where(up_wind, kr_up / vis_up, kr_dn / vis_dn)
    v_darcy = -Dq * ukvr * dphi
    if not internal and cond_kind is not None:
        mass_flux = jnp.asarray(np.asarray(cond_kind) == int(Cond.MASS_FLUX))
        v_darcy = jnp.where(mass_flux, 0.0, v_darcy)
    q = v_darcy * area
    flux = q * den_ave

    dden_ave_up = upweight * dden_dT_up
    dden_ave_dn = (1.0 - upweight) * dden_dT_dn
    dphi_up = upweight * dist_gravity * FMWH2O * dden_dT_up
    dphi_dn = (1.0 - upweight) * dist_gravity * FMWH2O * dden_dT_dn
    dukvr_up = jnp.where(up_wind,
                         -kr_up / (vis_up * vis_up) * dvis_dT_up, 0.0)
    dukvr_dn = jnp.where(up_wind, 0.0,
                         -kr_dn / (vis_dn * vis_dn) * dvis_dT_dn)
    dq_up = -Dq * (dukvr_up * dphi + ukvr * dphi_up) * area
    dq_dn = -Dq * (dukvr_dn * dphi + ukvr * dphi_dn) * area
    dflux_up = dq_up * den_ave + q * dden_ave_up
    dflux_dn = dq_dn * den_ave + q * dden_ave_dn
    if not internal and cond_kind is not None:
        dflux_up = jnp.where(mass_flux, 0.0, dflux_up)
        dflux_dn = jnp.where(mass_flux, 0.0, dflux_dn)
    return flux, dflux_up, dflux_dn


def _tc_ave_over_dist(internal, cond_kind, tc_up, tc_dn, dist_up, dist_dn):
    """Thermal-conductivity face weighting (ThermalEnthalpyMod.F90:109-129)."""
    if internal:
        D = (tc_up * tc_dn) / (dist_up * tc_dn + dist_dn * tc_up)
        upweight = dist_up / (dist_up + dist_dn)
    else:
        is_otr = np.asarray(cond_kind) == int(Cond.DIRICHLET_FRM_OTR_GOVEQ)
        D_int = (tc_up * tc_dn) / (dist_up * tc_dn + dist_dn * tc_up)
        D_dir = tc_dn / (dist_up + dist_dn)
        D = jnp.where(jnp.asarray(is_otr), D_int, D_dir)
        upweight = jnp.where(jnp.asarray(is_otr),
                             dist_up / (dist_up + dist_dn), 0.0)
    return upweight, D


def enthalpy_flux(T_up, T_dn, h_up, h_dn, tc_up, tc_dn, dist_up, dist_dn,
                  area, mflux, internal: bool, cond_kind=None):
    """ThermalEnthalpyFlux value (ThermalEnthalpyMod.F90:131-140)."""
    _, D = _tc_ave_over_dist(internal, cond_kind, tc_up, tc_dn,
                             dist_up, dist_dn)
    h = jnp.where(mflux <= 0.0, h_up, h_dn)
    eflux = mflux * h - D * (T_up - T_dn) * area
    return eflux, D, h


def enthalpy_flux_dT(T_up, T_dn, h_up, h_dn, dh_dT_up, dh_dT_dn,
                     tc_up, tc_dn, dist_up, dist_dn, area, mflux,
                     dmflux_dT_up, dmflux_dT_dn, internal, cond_kind=None):
    """eflux + d(eflux)/dT_up,dn (ThermalEnthalpyMod.F90:142-163)."""
    eflux, D, h = enthalpy_flux(T_up, T_dn, h_up, h_dn, tc_up, tc_dn,
                                dist_up, dist_dn, area, mflux, internal,
                                cond_kind)
    deriv_up_wind = mflux < 0.0
    dh_up = jnp.where(deriv_up_wind, dh_dT_up, 0.0)
    dh_dn = jnp.where(deriv_up_wind, 0.0, dh_dT_dn)
    de_up = dmflux_dT_up * h + mflux * dh_up - D * area
    de_dn = dmflux_dT_dn * h + mflux * dh_dn + D * area
    return eflux, de_up, de_dn


def enthalpy_flux_dP(T_up, T_dn, h_up, h_dn, dh_dP_up, dh_dP_dn,
                     tc_up, tc_dn, dtc_dP_up, dtc_dP_dn, dist_up, dist_dn,
                     area, mflux, dmflux_dP_up, dmflux_dP_dn, internal,
                     cond_kind=None):
    """eflux + d(eflux)/dP_up,dn incl. the Kersten-number conductivity
    dependence (ThermalEnthalpyMod.F90:288-330)."""
    eflux, D, h = enthalpy_flux(T_up, T_dn, h_up, h_dn, tc_up, tc_dn,
                                dist_up, dist_dn, area, mflux, internal,
                                cond_kind)
    deriv_up_wind = mflux < 0.0
    dh_up = jnp.where(deriv_up_wind, dh_dP_up, 0.0)
    dh_dn = jnp.where(deriv_up_wind, 0.0, dh_dP_dn)
    dD_up_int = D ** 2.0 / tc_up ** 2.0 * dist_up * dtc_dP_up
    dD_dn_int = D ** 2.0 / tc_dn ** 2.0 * dist_dn * dtc_dP_dn
    if internal:
        dD_up, dD_dn = dD_up_int, dD_dn_int
    else:
        is_otr = jnp.asarray(np.asarray(cond_kind)
                             == int(Cond.DIRICHLET_FRM_OTR_GOVEQ))
        dD_up = jnp.where(is_otr, dD_up_int, 0.0)
        dD_dn = jnp.where(is_otr, dD_dn_int,
                          dtc_dP_dn / (dist_up + dist_dn))
    de_up = dmflux_dP_up * h + mflux * dh_up - dD_up * (T_up - T_dn) * area
    de_dn = dmflux_dP_dn * h + mflux * dh_dn - dD_dn * (T_up - T_dn) * area
    return eflux, de_up, de_dn


@dataclasses.dataclass
class ThermalEnthalpyGE(RichardsGE):
    """GE_THERM_SOIL_EBASED: enthalpy-based soil heat transport.

    Extends the Richards GE state (the reference auxvar type literally
    extends rich_ode_pres_auxvar_type) with thermal properties.  The
    primary unknown is temperature; pressure is a staged parameter (set
    from CLM or exchanged from a coupled Richards GE).
    """
    itype: int = int(GEType.THERM_SOIL_EBASED)
    # per-cell thermal parameters
    therm_cond_wet: np.ndarray = None
    therm_cond_dry: np.ndarray = None
    therm_alpha: np.ndarray = None
    heat_cap_soil: np.ndarray = None
    den_soil: np.ndarray = None
    int_energy_type: int = eos.INT_ENERGY_ENTHALPY_CONSTANT
    # BC auxvar copies
    bc_therm_cond_wet: np.ndarray = None
    bc_therm_cond_dry: np.ndarray = None
    bc_therm_alpha: np.ndarray = None
    # dynamic: bc pressure parameter (ThermEnthalpy BC auxvars default to
    # pressure = 0.0 Pa, RichODEPressureAuxVarInit:91; TH drivers overwrite)
    bc_pressure: jnp.ndarray = None

    def allocate_auxvars(self):
        super().allocate_auxvars()
        n = self.mesh.ncells_all
        # defaults from ThermEnthalpyAuxVarInit (+perm 8.3913e-12, :93)
        self.perm[:] = 8.3913e-12
        self.therm_cond_wet = np.zeros(n)
        self.therm_cond_dry = np.zeros(n)
        self.therm_alpha = np.zeros(n)
        self.heat_cap_soil = np.zeros(n)
        self.den_soil = np.zeros(n)
        self.pressure = jnp.zeros(n)
        nbc = sum(c.num_connections for c in self.boundary_conditions)
        self.bc_perm[:] = 8.3913e-12
        self.bc_therm_cond_wet = np.zeros(nbc)
        self.bc_therm_cond_dry = np.zeros(nbc)
        self.bc_therm_alpha = np.zeros(nbc)
        self.bc_pressure = jnp.zeros(nbc)
        self.temperature = jnp.full(n, 273.15 + 25.0)

    # ---- property staging (ThermalEnthalpySoilAuxMod setters: value set
    # on internal auxvars then copied to BC/SS auxvars of adjacent cells)
    def _bc_copy(self, cell_arr):
        bc_ids = self._bc_concat()[0]
        return np.asarray(cell_arr)[bc_ids]

    def set_heat_capacity(self, data):
        self.heat_cap_soil[:len(np.asarray(data))] = data

    def set_thermal_cond_wet(self, data):
        self.therm_cond_wet[:len(np.asarray(data))] = data
        self.bc_therm_cond_wet = self._bc_copy(self.therm_cond_wet)

    def set_thermal_cond_dry(self, data):
        self.therm_cond_dry[:len(np.asarray(data))] = data
        self.bc_therm_cond_dry = self._bc_copy(self.therm_cond_dry)

    def set_thermal_alpha(self, data):
        self.therm_alpha[:len(np.asarray(data))] = data
        self.bc_therm_alpha = self._bc_copy(self.therm_alpha)

    def set_soil_density(self, data):
        self.den_soil[:len(np.asarray(data))] = data

    def set_int_energy_type(self, itype):
        self.int_energy_type = int(itype)

    def set_soil_permeability(self, perm_x, perm_y, perm_z):
        """ThermEnthalpySetSoilPermeability incl. BC copies."""
        n = len(np.asarray(perm_x))
        self.perm[:n, 0] = perm_x
        self.perm[:n, 1] = perm_y
        self.perm[:n, 2] = perm_z
        self.bc_perm[:] = self.perm[self._bc_concat()[0]]

    # ---- aux + assembly ----------------------------------------------------
    def _cell_aux_e(self, T, P):
        return enthalpy_aux(P, T, self.sat_params, self.por_params,
                            self.density_type, self.int_energy_type,
                            self.therm_cond_wet, self.therm_cond_dry,
                            self.therm_alpha)

    def _bc_aux_e(self, T, P, bc_value=None, bc_pressure=None):
        """BC auxvars: temperature = condition value for Dirichlet
        (ThermEnthalpySoilUpdateAuxVarsBC:997-1009); pressure = staged
        bc_pressure.  ``bc_value``/``bc_pressure`` default to the staged
        attributes (serial path); the compiled batched path passes them
        explicitly so the evaluation is pure."""
        if bc_value is None:
            bc_value = self.bc_value
        if bc_pressure is None:
            bc_pressure = self.bc_pressure
        bc_ids, _, _, _, _, code = self._bc_concat()
        if not bc_ids.size:
            return None
        takes_value = np.isin(code, (int(Cond.DIRICHLET),))
        T_bc = jnp.where(jnp.asarray(takes_value), bc_value,
                         T[jnp.asarray(bc_ids)])
        return enthalpy_aux(bc_pressure, T_bc, self.bc_sat_params,
                            self.bc_por_params, self.density_type,
                            self.int_energy_type, self.bc_therm_cond_wet,
                            self.bc_therm_cond_dry, self.bc_therm_alpha)

    def accum_e(self, T, P):
        """phi*den*sat*ul + (1-phi)*rho_s*cp_s*(T-273.15), times vol
        (ThermalEnthalpySoilAccum:1204-1215); caller divides by dt."""
        a = self._cell_aux_e(T, P)
        vol = jnp.asarray(self.mesh.vol)
        return (a["por"] * a["den"] * a["sat"] * a["ul"]
                + (1.0 - a["por"]) * jnp.asarray(self.den_soil)
                * jnp.asarray(self.heat_cap_soil) * (T - 273.15)) * vol

    def _perm_dirs(self):
        ic = self._internal()
        uv = ic.unit_vec
        perm_up = (np.abs(uv[:, 0]) * self.perm[ic.id_up, 0]
                   + np.abs(uv[:, 1]) * self.perm[ic.id_up, 1]
                   + np.abs(uv[:, 2]) * self.perm[ic.id_up, 2])
        perm_dn = (np.abs(uv[:, 0]) * self.perm[ic.id_dn, 0]
                   + np.abs(uv[:, 1]) * self.perm[ic.id_dn, 1]
                   + np.abs(uv[:, 2]) * self.perm[ic.id_dn, 2])
        return ic, perm_up, perm_dn

    def _internal_efluxes(self, T, P, a, wrt):
        """(eflux, de_up, de_dn) over internal conns; wrt in {'T','P'}."""
        ic, perm_up, perm_dn = self._perm_dirs()
        iu, idn = jnp.asarray(ic.id_up), jnp.asarray(ic.id_dn)
        du, dn_, ar = (jnp.asarray(ic.dist_up), jnp.asarray(ic.dist_dn),
                       jnp.asarray(ic.area))
        uz = jnp.asarray(ic.unit_vec[:, 2])
        pu, pd = jnp.asarray(perm_up), jnp.asarray(perm_dn)
        if wrt == "T":
            mflux, dm_up, dm_dn = darcy_flux_dT(
                P[iu], P[idn], a["kr"][iu], a["kr"][idn], a["den"][iu],
                a["den"][idn], a["dden_dT"][iu], a["dden_dT"][idn],
                a["vis"][iu], a["vis"][idn], a["dvis_dT"][iu],
                a["dvis_dT"][idn], pu, pd, du, dn_, ar, uz, internal=True)
            return enthalpy_flux_dT(
                T[iu], T[idn], a["hl"][iu], a["hl"][idn], a["dhl_dT"][iu],
                a["dhl_dT"][idn], a["tc"][iu], a["tc"][idn], du, dn_, ar,
                mflux, dm_up, dm_dn, internal=True)
        mflux, dm_up, dm_dn = darcy_flux(
            P[iu], P[idn], a["kr"][iu], a["kr"][idn], a["dkr_dP"][iu],
            a["dkr_dP"][idn], a["den"][iu], a["den"][idn], a["dden_dP"][iu],
            a["dden_dP"][idn], a["vis"][iu], a["vis"][idn], a["dvis_dP"][iu],
            a["dvis_dP"][idn], pu, pd, du, dn_, ar, uz, internal=True)
        return enthalpy_flux_dP(
            T[iu], T[idn], a["hl"][iu], a["hl"][idn], a["dhl_dP"][iu],
            a["dhl_dP"][idn], a["tc"][iu], a["tc"][idn], a["dtc_dP"][iu],
            a["dtc_dP"][idn], du, dn_, ar, mflux, dm_up, dm_dn,
            internal=True)

    def _bc_efluxes(self, T, P, a, ab, wrt):
        """(bc cell ids, codes, eflux, de_dn) over BC conns (Dirichlet-like
        only contribute; HEAT_FLUX handled by caller)."""
        bc_ids, bdup, bddn, barea, buvz, bcode = self._bc_concat()
        if not bc_ids.size:
            return bc_ids, bcode, jnp.zeros(0), jnp.zeros(0)
        bids = jnp.asarray(bc_ids)
        perm_b, perm_cell = self._bc_perms()
        du, dn_, ar = (jnp.asarray(bdup), jnp.asarray(bddn),
                       jnp.asarray(barea))
        uz = jnp.asarray(buvz)
        pu, pd = jnp.asarray(perm_b), jnp.asarray(perm_cell)
        # cond kind for the flux weighting: DIRICHLET path
        if wrt == "T":
            mflux, dm_up, dm_dn = darcy_flux_dT(
                ab["P"], P[bids], ab["kr"], a["kr"][bids], ab["den"],
                a["den"][bids], ab["dden_dT"], a["dden_dT"][bids],
                ab["vis"], a["vis"][bids], ab["dvis_dT"],
                a["dvis_dT"][bids], pu, pd, du, dn_, ar, uz,
                internal=False, cond_kind=bcode)
            eflux, _de_up, de_dn = enthalpy_flux_dT(
                ab["T"], T[bids], ab["hl"], a["hl"][bids], ab["dhl_dT"],
                a["dhl_dT"][bids], ab["tc"], a["tc"][bids], du, dn_, ar,
                mflux, dm_up, dm_dn, internal=False, cond_kind=bcode)
        else:
            mflux, dm_up, dm_dn = darcy_flux(
                ab["P"], P[bids], ab["kr"], a["kr"][bids], ab["dkr_dP"],
                a["dkr_dP"][bids], ab["den"], a["den"][bids], ab["dden_dP"],
                a["dden_dP"][bids], ab["vis"], a["vis"][bids],
                ab["dvis_dP"], a["dvis_dP"][bids], pu, pd, du, dn_, ar, uz,
                internal=False, cond_kind=bcode)
            eflux, _de_up, de_dn = enthalpy_flux_dP(
                ab["T"], T[bids], ab["hl"], a["hl"][bids], ab["dhl_dP"],
                a["dhl_dP"][bids], ab["tc"], a["tc"][bids], ab["dtc_dP"],
                a["dtc_dP"][bids], du, dn_, ar, mflux, dm_up, dm_dn,
                internal=False, cond_kind=bcode)
        return bc_ids, bcode, eflux, de_dn

    def residual_e(self, T, P, dt, bc_value=None, ss_value=None,
                   accum_prev=None, bc_pressure=None):
        """Energy residual (length ncells_local).  The optional dynamic
        inputs default to the staged attributes (serial path); the
        compiled batched path passes them explicitly."""
        if bc_value is None:
            bc_value = self.bc_value
        if ss_value is None:
            ss_value = self.ss_value
        if accum_prev is None:
            accum_prev = self.accum_prev
        n = self.mesh.ncells_local
        active = jnp.asarray(self.mesh.is_active)
        F = jnp.where(active, self.accum_e(T, P) / dt, 0.0)
        F = F - accum_prev

        a = self._cell_aux_e(T, P)
        eflux, _, _ = self._internal_efluxes(T, P, a, "T")
        ic = self._internal()
        iu, idn = jnp.asarray(ic.id_up), jnp.asarray(ic.id_dn)
        both = active[iu] & active[idn]
        eflux = jnp.where(both, eflux, 0.0)
        F = F.at[iu].add(-eflux).at[idn].add(eflux)

        bc_ids, bcode, eflux_b, _ = self._bc_efluxes(
            T, P, a, self._bc_aux_e(T, P, bc_value, bc_pressure), "T")
        if bc_ids.size:
            bids = jnp.asarray(bc_ids)
            is_dir = jnp.asarray(np.isin(
                bcode, (int(Cond.DIRICHLET),
                        int(Cond.DIRICHLET_FRM_OTR_GOVEQ))))
            is_hf = jnp.asarray(bcode == int(Cond.HEAT_FLUX))
            barea = jnp.asarray(self._bc_concat()[3])
            contrib = jnp.where(is_dir, eflux_b,
                                jnp.where(is_hf, bc_value * barea, 0.0))
            contrib = jnp.where(active[bids], contrib, 0.0)
            F = F.at[bids].add(contrib)

        ss_ids, ss_code = self._ss_concat()
        if ss_ids.size:
            sids = jnp.asarray(ss_ids)
            if not (ss_code == int(Cond.HEAT_RATE)).all():
                raise ValueError("Unknown SS condition in enthalpy GE")
            F = F.at[sids].add(jnp.where(active[sids], ss_value, 0.0))
        return F

    def jacobian_e_values(self, T, P, dt, bc_value=None, bc_pressure=None):
        """dF/dT values in coo_coords order (internal 4/conn, bc diag,
        ss diag, accum diag)."""
        n = self.mesh.ncells_local
        active = jnp.asarray(self.mesh.is_active)
        a = self._cell_aux_e(T, P)

        _, de_up, de_dn = self._internal_efluxes(T, P, a, "T")
        ic = self._internal()
        iu, idn = jnp.asarray(ic.id_up), jnp.asarray(ic.id_dn)
        both = active[iu] & active[idn]
        de_up = jnp.where(both, de_up, 0.0)
        de_dn = jnp.where(both, de_dn, 0.0)
        intr_vals = jnp.concatenate([-de_up, -de_dn, de_up, de_dn])

        bc_ids, bcode, _, de_dn_b = self._bc_efluxes(
            T, P, a, self._bc_aux_e(T, P, bc_value, bc_pressure), "T")
        if bc_ids.size:
            bids = jnp.asarray(bc_ids)
            is_dir = jnp.asarray(np.isin(
                bcode, (int(Cond.DIRICHLET),
                        int(Cond.DIRICHLET_FRM_OTR_GOVEQ))))
            bc_vals = jnp.where(is_dir & active[bids], de_dn_b, 0.0)
        else:
            bc_vals = jnp.zeros(0)

        ss_ids, _ = self._ss_concat()
        ss_vals = jnp.zeros(ss_ids.size)

        # d/dT accumulation (ThermalEnthalpySoilAccumDeriv:1278-1284);
        # dsat_dT = dkr_dT = 0 in the reference auxvar chain
        vol = jnp.asarray(self.mesh.vol)
        dacc = (a["por"] * a["dden_dT"] * a["sat"] * a["ul"]
                + a["por"] * a["den"] * a["sat"] * a["dul_dT"]
                + (1.0 - a["por"]) * jnp.asarray(self.den_soil)
                * jnp.asarray(self.heat_cap_soil)) * vol / dt
        diag_vals = jnp.where(active[:n], dacc[:n], 1.0)
        return jnp.concatenate([intr_vals, bc_vals, ss_vals, diag_vals])

    # ---- off-diagonal block wrt pressure -----------------------------------
    def offdiag_p_coords(self, row_off=0, col_off=0):
        """Sparsity of dF_energy/dP: accum diag + internal 4/conn + bc diag
        (OffDiagJacobian_Pressure_ForInternalAuxVars:2157-2373)."""
        n = self.mesh.ncells_local
        ic = self._internal()
        bc_ids = self._bc_concat()[0]
        rows = [np.arange(n), ic.id_up, ic.id_up, ic.id_dn, ic.id_dn, bc_ids]
        cols = [np.arange(n), ic.id_up, ic.id_dn, ic.id_up, ic.id_dn, bc_ids]
        return (np.concatenate(rows) + row_off, np.concatenate(cols) + col_off)

    def offdiag_p_values(self, T, P, dt, bc_value=None, bc_pressure=None):
        n = self.mesh.ncells_local
        active = jnp.asarray(self.mesh.is_active)
        a = self._cell_aux_e(T, P)

        vol = jnp.asarray(self.mesh.vol)
        dacc = (a["dpor_dP"] * a["den"] * a["sat"] * a["ul"]
                + a["por"] * a["dden_dP"] * a["sat"] * a["ul"]
                + a["por"] * a["den"] * a["dsat_dP"] * a["ul"]
                + a["por"] * a["den"] * a["sat"] * a["dul_dP"]
                - a["dpor_dP"] * jnp.asarray(self.den_soil)
                * jnp.asarray(self.heat_cap_soil) * (T - 273.15)) * vol / dt
        diag_vals = jnp.where(active[:n], dacc[:n], 1.0)

        _, de_up, de_dn = self._internal_efluxes(T, P, a, "P")
        ic = self._internal()
        iu, idn = jnp.asarray(ic.id_up), jnp.asarray(ic.id_dn)
        both = active[iu] & active[idn]
        de_up = jnp.where(both, de_up, 0.0)
        de_dn = jnp.where(both, de_dn, 0.0)
        intr_vals = jnp.concatenate([-de_up, -de_dn, de_up, de_dn])

        bc_ids, bcode, _, de_dn_b = self._bc_efluxes(
            T, P, a, self._bc_aux_e(T, P, bc_value, bc_pressure), "P")
        if bc_ids.size:
            bids = jnp.asarray(bc_ids)
            not_otr = jnp.asarray(bcode != int(Cond.DIRICHLET_FRM_OTR_GOVEQ))
            bc_vals = jnp.where(not_otr & active[bids], de_dn_b, 0.0)
        else:
            bc_vals = jnp.zeros(0)
        return jnp.concatenate([diag_vals, intr_vals, bc_vals])


def richards_offdiag_t_coords(ge: RichardsGE, row_off=0, col_off=0):
    """Sparsity of dF_mass/dT: accum diag + internal 4/conn; regular
    Dirichlet BCs contribute nothing
    (OffDiagJacobian_Temperature_For*AuxVars, GoveqnRichardsODEPressure
    Type.F90:2361-2612)."""
    n = ge.mesh.ncells_local
    ic = ge._internal()
    rows = [np.arange(n), ic.id_up, ic.id_up, ic.id_dn, ic.id_dn]
    cols = [np.arange(n), ic.id_up, ic.id_dn, ic.id_up, ic.id_dn]
    return (np.concatenate(rows) + row_off, np.concatenate(cols) + col_off)


def richards_offdiag_t_values(ge: RichardsGE, P, T, dt):
    n = ge.mesh.ncells_local
    active = jnp.asarray(ge.mesh.is_active)
    sat, _ = sf.press_to_sat(ge.sat_params, P)
    kr, _ = sf.press_to_relperm(ge.sat_params, P, ge.frac_liq_sat)
    den, _, dden_dT = eos.density(P, T, ge.density_type)
    vis, _, dvis_dT = eos.viscosity(P, T)
    por, _ = porosity(ge.por_params, P)
    vol = jnp.asarray(ge.mesh.vol)
    dacc = (por * dden_dT * sat) * vol / dt
    diag_vals = jnp.where(active[:n], dacc[:n], 1.0)

    ic = ge._internal()
    iu, idn = jnp.asarray(ic.id_up), jnp.asarray(ic.id_dn)
    uv = ic.unit_vec
    perm_up = (np.abs(uv[:, 0]) * ge.perm[ic.id_up, 0]
               + np.abs(uv[:, 1]) * ge.perm[ic.id_up, 1]
               + np.abs(uv[:, 2]) * ge.perm[ic.id_up, 2])
    perm_dn = (np.abs(uv[:, 0]) * ge.perm[ic.id_dn, 0]
               + np.abs(uv[:, 1]) * ge.perm[ic.id_dn, 1]
               + np.abs(uv[:, 2]) * ge.perm[ic.id_dn, 2])
    _, df_up, df_dn = darcy_flux_dT(
        P[iu], P[idn], kr[iu], kr[idn], den[iu], den[idn], dden_dT[iu],
        dden_dT[idn], vis[iu], vis[idn], dvis_dT[iu], dvis_dT[idn],
        jnp.asarray(perm_up), jnp.asarray(perm_dn),
        jnp.asarray(ic.dist_up), jnp.asarray(ic.dist_dn),
        jnp.asarray(ic.area), jnp.asarray(ic.unit_vec[:, 2]), internal=True)
    both = active[iu] & active[idn]
    df_up = jnp.where(both, df_up, 0.0)
    df_dn = jnp.where(both, df_dn, 0.0)
    intr_vals = jnp.concatenate([-df_up, -df_dn, df_up, df_dn])
    return jnp.concatenate([diag_vals, intr_vals])


class THSoE:
    """SOE_TH: coupled Richards (+) thermal-enthalpy, proper Newton on
    X = [P; T] (SystemOfEquationsTHType.F90:736-1003)."""

    def __init__(self):
        self.ge_mass: Optional[RichardsGE] = None
        self.ge_energy: Optional[ThermalEnthalpyGE] = None
        self.itype = int(SOEType.TH)
        self.soln = None
        self.soln_prev = None
        self.template: Optional[CSRTemplate] = None
        self.use_dynamic_linesearch = False
        self.snes_stol = 1e-10
        self.cumulative_newton_iterations = 0
        self.cumulative_linear_iterations = 0
        self.metrics = None

    @property
    def goveqns(self):
        return [g for g in (self.ge_mass, self.ge_energy) if g is not None]

    def setup(self):
        n = self.ge_mass.mesh.ncells_local
        self.n = n
        r1, c1 = self.ge_mass.coo_coords(0, 0)
        r12, c12 = richards_offdiag_t_coords(self.ge_mass, 0, n)
        r21, c21 = self.ge_energy.offdiag_p_coords(n, 0)
        r2, c2 = self.ge_energy.coo_coords(n, n)
        rows = np.concatenate([r1, r12, r21, r2])
        cols = np.concatenate([c1, c12, c21, c2])
        self.template = csr_template(2 * n, 2 * n, rows, cols)
        self.soln = jnp.zeros(2 * n)
        self.soln_prev = jnp.zeros(2 * n)

    def _split(self, X):
        return X[:self.n], X[self.n:]

    def _exchange(self, P, T):
        """SOETHGovEqnExchangeAuxVars: mass GE receives T; energy GE
        receives P (internal auxvars, cell-wise copy)."""
        self.ge_mass.temperature = T
        self.ge_energy.pressure = P

    def _residual(self, X, dt):
        Xj = jnp.asarray(X)
        P, T = self._split(Xj)
        self._exchange(P, T)
        F1 = self.ge_mass.residual(P, dt)
        F2 = self.ge_energy.residual_e(T, P, dt)
        return np.asarray(jnp.concatenate([F1, F2]))

    def _jacobian(self, X, dt):
        Xj = jnp.asarray(X)
        P, T = self._split(Xj)
        self._exchange(P, T)
        v1 = self.ge_mass.jacobian_values(P, dt)
        v12 = richards_offdiag_t_values(self.ge_mass, P, T, dt)
        v21 = self.ge_energy.offdiag_p_values(T, P, dt)
        v2 = self.ge_energy.jacobian_e_values(T, P, dt)
        data = np.asarray(self.template.assemble(
            jnp.concatenate([v1, v12, v21, v2])))
        return self.template.indptr, self.template.indices, data

    def pre_solve(self, dt):
        """SOETHPreSolve: auxvars from soln_prev; per-GE accum_prev."""
        P, T = self._split(self.soln_prev)
        self._exchange(P, T)
        ga = jnp.asarray(self.ge_mass.mesh.is_active)
        self.ge_mass.accum_prev = jnp.where(
            ga, self.ge_mass.accum(P) / dt, 0.0)
        ge = self.ge_energy
        ga2 = jnp.asarray(ge.mesh.is_active)
        ge.accum_prev = jnp.where(ga2, ge.accum_e(T, P) / dt, 0.0)

    def step_dt(self, dt, nstep=1):
        """SOEBaseStepDT_SNES semantics (line-search rotation + dt cuts)."""
        time = 0.0
        dt_iter = dt
        num_time_cuts = 0
        linesearch_iter = 0
        ls_list = [LS_BT, LS_L2]
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
                self.soln_prev = self.soln
            if num_time_cuts > 20:
                if self.metrics is not None:
                    self.metrics.record(step=nstep, dt=dt, converged=False,
                                        reason=int(reason),
                                        dt_cuts=num_time_cuts)
                return False, reason
            if time >= dt:
                break
        if self.metrics is not None:
            self.metrics.record(
                step=nstep, dt=dt, dt_used=dt_iter, converged=converged,
                reason=int(reason), dt_cuts=num_time_cuts,
                newton_iterations=int(res.iterations),
                linear_iterations=int(res.linear_iterations))
        return converged, reason


class ThermalEnthalpySoE:
    """SOE_THERMAL_EBASED: standalone enthalpy SoE.

    The reference's residual/Jacobian callbacks re-stage auxvars from
    soln_prev on every SNES evaluation
    (SystemOfEquationsThermalEnthalpyType.F90:352,285), so the "Newton"
    solve degenerates to a single linearized implicit-Euler update
    T <- T_prev - J(T_prev)^{-1} F(T_prev) per StepDT; we implement that
    update directly.
    """

    def __init__(self):
        self.ge: Optional[ThermalEnthalpyGE] = None
        self.itype = int(SOEType.THERMAL_EBASED)
        self.soln = None
        self.soln_prev = None
        self.template = None
        self._ilu = None
        self.cumulative_newton_iterations = 0
        self.cumulative_linear_iterations = 0
        self.metrics = None

    def setup(self):
        n = self.ge.mesh.ncells_local
        self.n = n
        r, c = self.ge.coo_coords(0, 0)
        self.template = csr_template(n, n, r, c)
        self.soln = jnp.zeros(n)
        self.soln_prev = jnp.zeros(n)

    def step_dt(self, dt, nstep=1):
        ge = self.ge
        T_prev = self.soln_prev
        P = ge.pressure
        active = jnp.asarray(ge.mesh.is_active)
        ge.accum_prev = jnp.where(active, ge.accum_e(T_prev, P) / dt, 0.0)
        F = np.asarray(ge.residual_e(T_prev, P, dt))
        vals = ge.jacobian_e_values(T_prev, P, dt)
        data = np.asarray(self.template.assemble(vals))
        # PETSc SNES-inner KSP: GMRES(30)+ILU(0), rtol 1e-5.  The golden
        # answers embed this single INEXACT Newton update (the reference
        # residual callback re-stages auxvars from soln_prev on every SNES
        # evaluation, so no further iteration can correct it) — a direct
        # solve differs from the baselines at ~2e-4.
        if self._ilu is None:
            self._ilu = ILU0(self.template.indptr, self.template.indices)
        lu = self._ilu.factor(data)
        dx, iters, _conv = petsc_gmres(self.template.indptr,
                                       self.template.indices, data, -F,
                                       pc=self._ilu, pc_data=lu)
        self.cumulative_linear_iterations += int(iters)
        self.soln = T_prev + jnp.asarray(dx)
        self.soln_prev = self.soln
        self.cumulative_newton_iterations += 1
        if self.metrics is not None:
            self.metrics.record(step=nstep, dt=dt, converged=True, reason=2,
                                newton_iterations=1,
                                linear_iterations=int(iters))
        return True, 2


class THMPP(MPPBase):
    """mpp_th_type facade (MPP_TH_SNES_CLM) with the 8-step builder."""

    def __init__(self):
        super().__init__()
        self.soe = THSoE()

    def add_goveqn(self, ge_type, name, mesh_index=0):
        mesh = self.meshes[mesh_index]
        if ge_type == GEType.RE:
            self.soe.ge_mass = RichardsGE(name=name, mesh=mesh)
        elif ge_type == GEType.THERM_SOIL_EBASED:
            self.soe.ge_energy = ThermalEnthalpyGE(name=name, mesh=mesh)
        else:
            raise NotImplementedError(ge_type)

    def set_soils(self, filter_thermal, watsat, csol, tkdry, hksat, bsw,
                  sucsat, residual_sat, satfunc_type, density_type,
                  int_energy_type, grav=C.GRAV_CLM, denh2o=C.DENH2O):
        """MPPTHSetSoils (MultiPhysicsProbTH.F90:75-607): VSFM GE gets
        perm from hksat; enthalpy GE keeps the 8.3913e-12 default perm
        but gets thermal props.  Column blocks are stacked per GE."""
        vish2o = 0.001002
        watsat = np.asarray(watsat)
        _, nlev = watsat.shape
        gm, ge = self.soe.ge_mass, self.soe.ge_energy
        col0 = 0
        for g in (gm, ge):
            n = g.mesh.ncells_all
            ncols = n // nlev
            g.density_type = int(density_type)
            for cc in range(ncols):
                col = col0 + cc
                for j in range(nlev):
                    icell = cc * nlev + j
                    perm = hksat[col, j] * vish2o / (denh2o * grav) * 0.001
                    alpha = 1.0 / (sucsat[col, j] * grav)
                    lam = 1.0 / bsw[col, j]
                    if g is gm:
                        g.perm[icell, :] = perm
                    g.por_params.porosity_base[icell] = watsat[col, j]
                    if satfunc_type == "van_genuchten":
                        g.sat_params.set_vg(icell, residual_sat[col, j],
                                            alpha, lam)
                    elif satfunc_type == "brooks_corey":
                        g.sat_params.set_bc(icell, residual_sat[col, j],
                                            alpha, lam)
                    else:
                        raise ValueError(satfunc_type)
                    if g is ge:
                        g.therm_alpha[icell] = 0.45
                        g.therm_cond_wet[icell] = 1.3
                        g.therm_cond_dry[icell] = tkdry[col, j]
                        g.heat_cap_soil[icell] = csol[col, j]
                        g.den_soil[icell] = 2700.0
            g._copy_params_to_bc_ss()
            if g is ge:
                g.set_int_energy_type(int_energy_type)
                bc_ids = g._bc_concat()[0]
                g.bc_therm_cond_wet = g.therm_cond_wet[bc_ids]
                g.bc_therm_cond_dry = g.therm_cond_dry[bc_ids]
                g.bc_therm_alpha = g.therm_alpha[bc_ids]
            col0 += ncols

    def set_data(self, auxvar_kind, var_type, soe_auxvar_id, data):
        """SetDataFromCLM: soe_auxvar_id is the global condition index
        in GE order (BCs, then SS), 1-based."""
        data = jnp.asarray(np.asarray(data, np.float64))
        conds = []
        for g in self.soe.goveqns:
            src = (g.boundary_conditions if auxvar_kind == AuxVarKind.BC
                   else g.source_sinks)
            for ci, cond in enumerate(src):
                conds.append((g, ci, cond))
        g, ci, cond = conds[soe_auxvar_id - 1]
        src = (g.boundary_conditions if auxvar_kind == AuxVarKind.BC
               else g.source_sinks)
        off = sum(c.num_connections for c in src[:ci])
        m = cond.num_connections
        if auxvar_kind == AuxVarKind.BC:
            g.bc_value = g.bc_value.at[off:off + m].set(data)
        elif auxvar_kind == AuxVarKind.SS:
            g.ss_value = g.ss_value.at[off:off + m].set(data)
        else:
            raise NotImplementedError(auxvar_kind)

    def get_data(self, var_type):
        """GetDataForCLM: [P-block; T-block] of the solution."""
        return np.asarray(self.soe.soln)

    def set_initial_solution(self, P0, T0):
        X = jnp.concatenate([jnp.asarray(np.asarray(P0, np.float64)),
                             jnp.asarray(np.asarray(T0, np.float64))])
        self.soe.soln = X
        self.soe.soln_prev = X


class ThermalEnthalpyMPP(MPPBase):
    """mpp_thermal_type facade (MPP_THERMAL_EBASED_SNES_CLM)."""

    def __init__(self):
        super().__init__()
        self.soe = ThermalEnthalpySoE()

    def _goveqns(self):
        return [self.soe.ge] if self.soe.ge is not None else []

    def add_goveqn(self, ge_type, name, mesh_index=0):
        assert ge_type == GEType.THERM_SOIL_EBASED
        self.soe.ge = ThermalEnthalpyGE(name=name,
                                        mesh=self.meshes[mesh_index])

    def set_soils(self, filter_thermal, watsat, csol, tkdry, hksat, bsw,
                  sucsat, residual_sat, satfunc_type, density_type,
                  int_energy_type, grav=C.GRAV_CLM, denh2o=C.DENH2O):
        """MPPThermalSetSoils (MultiPhysicsProbThermalEnthalpy.F90:75-328):
        perm is NOT set (stays at the 8.3913e-12 auxvar-init default)."""
        g = self.soe.ge
        watsat = np.asarray(watsat)
        ncol, nlev = watsat.shape
        g.density_type = int(density_type)
        g.set_int_energy_type(int_energy_type)
        for c in range(ncol):
            for j in range(nlev):
                icell = c * nlev + j
                alpha = 1.0 / (sucsat[c, j] * grav)
                lam = 1.0 / bsw[c, j]
                g.por_params.porosity_base[icell] = watsat[c, j]
                if satfunc_type == "van_genuchten":
                    g.sat_params.set_vg(icell, residual_sat[c, j], alpha, lam)
                elif satfunc_type == "brooks_corey":
                    g.sat_params.set_bc(icell, residual_sat[c, j], alpha, lam)
                else:
                    raise ValueError(satfunc_type)
                g.therm_alpha[icell] = 0.45
                g.therm_cond_wet[icell] = 1.3
                g.therm_cond_dry[icell] = tkdry[c, j]
                g.heat_cap_soil[icell] = csol[c, j]
                g.den_soil[icell] = 2700.0
        g._copy_params_to_bc_ss()
        bc_ids = g._bc_concat()[0]
        g.bc_therm_cond_wet = g.therm_cond_wet[bc_ids]
        g.bc_therm_cond_dry = g.therm_cond_dry[bc_ids]
        g.bc_therm_alpha = g.therm_alpha[bc_ids]

    def set_data(self, auxvar_kind, var_type, soe_auxvar_id, data):
        g = self.soe.ge
        data = jnp.asarray(np.asarray(data, np.float64))
        if auxvar_kind == AuxVarKind.INTERNAL and var_type == Var.PRESSURE:
            g.pressure = g.pressure.at[:data.size].set(data)
            return
        if auxvar_kind == AuxVarKind.BC:
            off = sum(c.num_connections
                      for c in g.boundary_conditions[:soe_auxvar_id - 1])
            m = g.boundary_conditions[soe_auxvar_id - 1].num_connections
            g.bc_value = g.bc_value.at[off:off + m].set(data)
            return
        raise NotImplementedError((auxvar_kind, var_type))

    def get_data(self, var_type):
        if var_type == Var.TEMPERATURE:
            return np.asarray(self.soe.soln)
        raise NotImplementedError(var_type)

    def set_initial_temperature(self, T0):
        X = jnp.asarray(np.asarray(T0, np.float64))
        self.soe.soln = X
        self.soe.soln_prev = X
