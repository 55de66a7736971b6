"""Photosynthesis / stomatal-conductance model (SNES path).

JAX reimplementation of the reference's photosynthesis stack:

* per-cell auxvar state + constitutive chain (Farquhar C3 / Collatz C4
  biochemistry, temperature response fns ft/fth/fth25, electron transport,
  metabolic rates, net assimilation):
  ``auxvar/PhotosynthesisAuxVarType.F90`` (struct :81-200, Init :365-498,
  temperature responses :1156-1202, Je :1208-1232, metabolic rates
  :1238-1310, net assimilation :1316-1466, from-gs variant :1468-1551)
* stomatal models: Ball-Berry :1554-1586, Medlyn :1589-1627,
  WUE/Manzoni11/Bonan14/ModifiedBonan14/OSMWang residuals via the
  delta-gs finite-difference construction in AuxVarCompute :737-855
* plant hydraulics coupling: ComputeSoilResistance :626-728,
  ComputeCriticalFlow :858-886, ComputeChangeInPsi :889-906,
  ComputePsi_ModifiedBonan14 :909-946
* boundedness pre-check (mutates ci/gs!): :1632-1715
* GE residual F(ci)=An-gleaf*(ca-ci) (BB/Medlyn) or the WUE/hyd
  residuals, with inactive/unbounded dofs zeroed:
  ``ge/GoveqnPhotosynthesis.F90:130-257``
* GE Jacobian by finite-difference perturbation of the biochemistry
  (ci_perturb=-1e-7, gs_perturb per model; whole-gs-array assignment
  side effects reproduced verbatim): ibid :261-431
* SoE: proper Newton staging X -> ci/gs for bounded dofs only
  (``soe/SystemOfEquationsPhotosynthesisType.F90:154-249``); the
  regression answers are PETSc SNES iterates at the global
  ||F|| < rtol*||F0|| stop, so the stepper emulates SNESConvergedDefault
  + BT-with-full-steps semantics.

State is numpy SoA [ncell] / [ncell, ndof]; the whole chain is
elementwise and maps 1:1 onto a jnp/vmap batched Newton for the device
production path (glibc libm is used here for golden-file bit parity).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import math

import numpy as np

from mpp_tpu.constants import (GEType, SOEType, Var, TFRZ, RGAS)
from mpp_tpu.dtypes.mpp_base import MPPBase

# Stomatal conductance model ids (MultiPhysicsProbConstants.F90:150-170)
SCM_MEDLYN = 1
SCM_BBERRY = 2
SCM_WUE = 3
SCM_BONAN14 = 4
SCM_MANZONI11 = 5
SCM_MODIFIED_BONAN14 = 6
SCM_OSMWANG = 7
PATHWAY_C3 = 1
PATHWAY_C4 = 0

# module parameters (PhotosynthesisAuxVarType.F90:216-222)
GS_MIN = 1.0e-6
GS_MIN_WUE = 0.005
GS_MAX_WUE = 2.0
GS_DELTA_WUE = 1.0e-5
GS_MIN_BONAN14 = 0.005
GS_DELTA_BONAN14 = 0.001

_G = 9.80665
_DENH2O = 1000.0

# glibc scalar transcendentals (what gfortran links): numpy's SIMD
# exp/pow/log differ from libm in ~5% of arguments by 1 ulp, and the
# delta-gs finite-difference residual/Jacobian construction amplifies
# single ulps by ~1/gs_delta^2, so golden-file parity needs bit-identical
# transcendentals.  sqrt and x**2.0 are correctly rounded everywhere.
_math_exp = np.frompyfunc(math.exp, 1, 1)
_math_pow = np.frompyfunc(math.pow, 2, 1)
_math_log = np.frompyfunc(math.log, 1, 1)


def exp_g(x):
    return _math_exp(np.asarray(x, np.float64)).astype(np.float64)


def pow_g(x, y):
    return _math_pow(np.asarray(x, np.float64),
                     np.asarray(y, np.float64)).astype(np.float64)


def log_g(x):
    return _math_log(np.asarray(x, np.float64)).astype(np.float64)



def sat_vap_np(t_K):
    """Numpy SatVap (SatVapor.F90:26-114); water branch only needed here."""
    a = (6.11213476, 0.444007856, 0.143064234e-01, 0.264461437e-03,
         0.305903558e-05, 0.196237241e-07, 0.892344772e-10,
         -0.373208410e-12, 0.209339997e-15)
    b = (0.444017302, 0.286064092e-01, 0.794683137e-03, 0.121211669e-04,
         0.103354611e-06, 0.404125005e-09, -0.788037859e-12,
         -0.114596802e-13, 0.381294516e-16)
    c = (6.11123516, 0.503109514, 0.188369801e-01, 0.420547422e-03,
         0.614396778e-05, 0.602780717e-07, 0.387940929e-09,
         0.149436277e-11, 0.262655803e-14)
    d = (0.503277922, 0.377289173e-01, 0.126801703e-02, 0.249468427e-04,
         0.313703411e-06, 0.257180651e-08, 0.133268878e-10,
         0.394116744e-13, 0.498070196e-16)

    def horner(cf, x):
        out = np.zeros_like(x) + cf[-1]
        for v in reversed(cf[:-1]):
            out = out * x + v
        return out

    tc = np.clip(np.asarray(t_K, np.float64) - TFRZ, -75.0, 100.0)
    water = tc >= 0.0
    es = np.where(water, horner(a, tc), horner(c, tc))
    desdt = np.where(water, horner(b, tc), horner(d, tc))
    return es * 100.0, desdt * 100.0


def quadratic(a, b, c):
    """Vectorized MathUtilsMod::quadratic (MathUtils.F90:24-58)."""
    disc = np.sqrt(b * b - 4.0 * a * c)
    q = np.where(b >= 0.0, -0.5 * (b + disc), -0.5 * (b - disc))
    r1 = q / a
    with np.errstate(divide="ignore", invalid="ignore"):
        r2 = np.where(q != 0.0, c / q, 1.0e36)
    return r1, r2


def ft(tl, ha):
    return exp_g(ha / (RGAS * (TFRZ + 25.0)) * (1.0 - (TFRZ + 25.0) / tl))


def fth(tl, hd, se, c):
    return c / (1.0 + exp_g((-hd + se * tl) / (RGAS * tl)))


def fth25(hd, se):
    return 1.0 + math.exp((-hd + se * (TFRZ + 25.0)) / (RGAS * (TFRZ + 25.0)))


@dataclasses.dataclass
class PhotosynthesisAuxVars:
    """SoA of ``photosynthesis_auxvar_type`` over all cells.

    Scalars per cell are [n]; per-dof quantities are [n, ndof].
    ``c3psn``/``gstype``/``colim`` are uniform static ints (the reference
    stores them per cell but every driver sets one value problem-wide).
    """
    n: int
    ndof: int
    c3psn: int = PATHWAY_C3
    gstype: int = SCM_MEDLYN
    colim: int = 1

    def __post_init__(self):
        n, ndof = self.n, self.ndof
        z = lambda: np.zeros(n)
        zd = lambda: np.zeros((n, ndof))
        self.ci = zd()
        self.tleaf = z()
        self.tleaf_prev = z()
        self.gbv = z()
        self.gbc = z()
        self.eair = z()
        self.pref = np.full(n, 101325.0)
        self.cair = z()
        self.o2ref = z()
        self.apar = z()
        self.ceair = z()
        self.esat = z()
        self.desat = z()
        self.g0opt = z()
        self.g1opt = z()
        self.g0 = z()
        self.g1 = z()
        self.dpai = z()
        self.btran = np.ones(n)
        # kinetic constants (PhotosynthesisInit :388-440)
        self.kc25, self.ko25, self.cp25 = 404.9, 278.4, 42.75
        self.kcha, self.koha, self.cpha = 79430.0, 36380.0, 37830.0
        self.rdha, self.vcmaxha, self.jmaxha = 46390.0, 65330.0, 43540.0
        self.rdhd = self.vcmaxhd = self.jmaxhd = 150000.0
        self.rdse = self.vcmaxse = self.jmaxse = 490.0
        self.vcmaxc = fth25(self.vcmaxhd, self.vcmaxse)
        self.jmaxc = fth25(self.jmaxhd, self.jmaxse)
        self.rdc = fth25(self.rdhd, self.rdse)
        self.phi_psii, self.theta_j = 0.85, 0.90
        self.colim_c3 = 0.98
        self.colim_c4a, self.colim_c4b = 0.80, 0.95
        self.qe_c4 = 0.05
        self.vcmax25 = z()
        self.jmax25 = z()
        self.rd25 = z()
        self.kp25 = z()
        self.vcmax = z()
        self.jmax = z()
        self.je = z()
        self.kc = z()
        self.ko = z()
        self.cp = z()
        self.rd = z()
        self.kp = z()
        self.hs = z()
        self.vpd = z()
        self.cs = z()
        self.ac, self.aj, self.ap = zd(), zd(), zd()
        self.ag, self.an = zd(), zd()
        self.gs = zd()
        self.gleaf_c, self.gleaf_w = zd(), zd()
        self.dac_dci, self.daj_dci, self.dap_dci = zd(), zd(), zd()
        self.dag_dci, self.dan_dci = zd(), zd()
        self.iota = np.full(n, 750.0)
        self.manzoni11_beta = np.full(n, -1.5e-3)
        self.residual_wue = zd()
        self.residual_hyd = zd()
        self.soln_is_bounded = np.ones((n, ndof), bool)
        self.fdry = z()
        self.fwet = z()
        # _soln copies (PostSolve outputs)
        self.ac_soln = z()
        self.aj_soln = z()
        self.ap_soln = z()
        self.ag_soln = z()
        self.an_soln = z()
        self.gs_soln = z()
        self.gleaf_c_soln = z()
        self.gleaf_w_soln = z()
        # root (root_auxvar_type)
        self.root_biomass = z()
        self.root_radius = z()
        self.root_density = z()
        self.root_resist = z()
        # soil (soil_auxvar_type): [n, nlevsoi] set by set_soil
        self.nlevsoi = 0
        # plant (plant_auxvar_type), single leaf (ileaf=1)
        self.leaf_psi = z()
        self.leaf_height = z()
        self.leaf_capc = z()
        self.leaf_lsc = z()
        self.leaf_minlwp = z()
        self.leaf_lai = z()
        self.k_stem2leaf = z()
        self.resist_soil = z()
        self.psi_soil = z()
        self.dpsi_leaf = z()
        self.weibull_c = z()
        self.weibull_b = z()
        self.leaf_psi_crt = z()
        self.plant_dtime = np.full(n, 300.0)
        self._params_defined = False

    def set_soil(self, nlevsoi: int):
        self.nlevsoi = nlevsoi
        for f in ("h2osoi_vol", "watsat", "psi_sat", "psi", "hksat",
                  "bsw", "rootfr", "dz"):
            setattr(self, "soil_" + f, np.zeros((self.n, nlevsoi)))

    # ---- parameter defaults (SetPathway/StomatalConductance/Plant) ---------
    def set_default_parameters(self):
        if self._params_defined:
            return
        if self.c3psn == PATHWAY_C4:
            self.vcmax25[:] = 40.0
            self.jmax25[:] = 0.0
            self.kp25[:] = 0.02 * self.vcmax25
            self.rd25[:] = 0.025 * self.vcmax25
        else:
            self.vcmax25[:] = 57.7
            self.jmax25[:] = 1.67 * self.vcmax25
            self.kp25[:] = 0.0
            self.rd25[:] = 0.015 * self.vcmax25
        if self.gstype == SCM_BBERRY:
            if self.c3psn == PATHWAY_C4:
                self.g0opt[:], self.g1opt[:] = 0.04, 4.0
            else:
                self.g0opt[:], self.g1opt[:] = 0.01, 9.0
        elif self.gstype == SCM_MEDLYN:
            if self.c3psn == PATHWAY_C4:
                self.g0opt[:], self.g1opt[:] = 1.0e-4, 1.62
            else:
                self.g0opt[:], self.g1opt[:] = 1.0e-4, 4.45
        if self.gstype == SCM_MODIFIED_BONAN14:
            self.weibull_b[:], self.weibull_c[:] = 2.0, 5.0
        elif self.gstype == SCM_OSMWANG:
            self.weibull_b[:], self.weibull_c[:] = 1.2, 5.0
            self.leaf_psi_crt[:] = -1.2 * math.log(1.0e3) ** (1.0 / 5.0)
        self._params_defined = True

    # ---- plant hydraulics ---------------------------------------------------
    def compute_soil_resistance(self):
        """ComputeSoilResistance (PhotosynthesisAuxVarType.F90:626-728)."""
        head = _G * _DENH2O * 1.0e-6
        area = np.pi * self.root_radius ** 2.0
        vwc = np.maximum(self.soil_h2osoi_vol, 1.0e-6) \
            / (self.soil_dz * _DENH2O)
        s = np.maximum(np.minimum(vwc / self.soil_watsat, 1.0), 0.01)
        hk = self.soil_hksat * pow_g(s, 2.0 * self.soil_bsw + 3.0)
        hk = hk * 1.0e-3 / head
        hk = hk * _DENH2O / 18.02e-3 * 1000.0
        self.soil_psi = self.soil_psi_sat * pow_g(s, -self.soil_bsw)
        psi_mpa = self.soil_psi * 1.0e-3 * head
        rbd = np.maximum(self.root_biomass[:, None] * self.soil_rootfr
                         / self.soil_dz, 1.0e-10)
        rld = rbd / (self.root_density * area)[:, None]
        root_dist = np.sqrt(1.0 / (rld * np.pi))
        soilr1 = log_g(root_dist / self.root_radius[:, None]) \
            / (2.0 * np.pi * rld * self.soil_dz * hk)
        soilr2 = self.root_resist[:, None] / (rbd * self.soil_dz)
        soilr = soilr1 + soilr2
        blw = (1.0 / soilr).sum(axis=1)
        evap = np.maximum((psi_mpa - self.leaf_minlwp[:, None]) / soilr, 0.0)
        self.resist_soil = self.leaf_lai / blw
        totevap = evap.sum(axis=1)
        psi_soil = (psi_mpa * evap).sum(axis=1)
        self.psi_soil = np.where(totevap > 0.0, psi_soil / np.where(
            totevap > 0.0, totevap, 1.0), self.leaf_minlwp)
        self.leaf_lsc = 1.0 / (1.0 / self.k_stem2leaf + self.resist_soil)

    def compute_critical_flow(self):
        """ComputeCriticalFlow (:858-886)."""
        head = _G * _DENH2O * 1.0e-6
        kl = self.leaf_lsc * exp_g(-pow_g(-self.psi_soil / self.weibull_b,
                                           self.weibull_c))
        return np.maximum(kl * (self.psi_soil - self.leaf_psi_crt
                                - head * self.leaf_height) / 1.0e3, 1.0e-7)

    def compute_change_in_psi(self, etflx):
        """ComputeChangeInPsi (:889-906): sets dpsi_leaf."""
        head = _G * _DENH2O * 1.0e-6
        a = self.psi_soil - head * self.leaf_height \
            - 1.0e3 * etflx / self.leaf_lsc
        b = self.leaf_capc / self.leaf_lsc
        self.dpsi_leaf = (a - self.leaf_psi) \
            * (1.0 - exp_g(-self.plant_dtime / b))

    def compute_psi_modified_bonan14(self, etflx):
        """ComputePsi_ModifiedBonan14 (:909-946): returns psi_new."""
        head = _G * _DENH2O * 1.0e-6
        w_b, w_c = 2.0, 5.0
        Cp, dt = self.leaf_capc, self.plant_dtime
        psi_old = self.leaf_psi
        factor = exp_g(-pow_g(-psi_old / w_b, w_c))
        Kl = 1.0 / (1.0 / (self.k_stem2leaf * factor) + self.resist_soil)
        E = 1.0e3 * etflx
        return ((Cp / dt) * psi_old
                + Kl * (self.psi_soil - head * self.leaf_height) - E) \
            / (Cp / dt + Kl)

    # ---- biochemistry -------------------------------------------------------
    def _c4_temperature_response(self):
        t1 = pow_g(2.0, (self.tleaf - (TFRZ + 25.0)) / 10.0)
        t2 = 1.0 + exp_g(0.2 * ((TFRZ + 15.0) - self.tleaf))
        t3 = 1.0 + exp_g(0.3 * (self.tleaf - (TFRZ + 40.0)))
        self.vcmax = self.vcmax25 * t1 / (t2 * t3)
        t3 = 1.0 + exp_g(1.3 * (self.tleaf - (TFRZ + 55.0)))
        self.rd = self.rd25 * t1 / t3
        self.kp = self.kp25 * t1
        self.vcmax = self.vcmax * self.btran

    def _c3_temperature_response(self):
        tl = self.tleaf
        self.kc = self.kc25 * ft(tl, self.kcha)
        self.ko = self.ko25 * ft(tl, self.koha)
        self.cp = self.cp25 * ft(tl, self.cpha)
        self.vcmax = self.vcmax25 * ft(tl, self.vcmaxha) \
            * fth(tl, self.vcmaxhd, self.vcmaxse, self.vcmaxc)
        self.jmax = self.jmax25 * ft(tl, self.jmaxha) \
            * fth(tl, self.jmaxhd, self.jmaxse, self.jmaxc)
        self.rd = self.rd25 * ft(tl, self.rdha) \
            * fth(tl, self.rdhd, self.rdse, self.rdc)
        self.kp = np.zeros_like(self.kp)
        self.vcmax = self.vcmax * self.btran

    def _electron_transport_rate(self):
        qabs = 0.5 * self.phi_psii * self.apar
        r1, r2 = quadratic(np.full(self.n, self.theta_j),
                           -(qabs + self.jmax), qabs * self.jmax)
        self.je = np.minimum(r1, r2)

    def _c4_metabolic_rate(self):
        for idof in range(self.ndof):
            self.ac[:, idof] = self.vcmax
            self.dac_dci[:, idof] = 0.0
            self.aj[:, idof] = self.qe_c4 * self.apar
            self.daj_dci[:, idof] = 0.0
            pos = self.ci[:, idof] > 0.0
            self.ap[:, idof] = np.where(pos, self.kp * self.ci[:, idof], 0.0)
            self.dap_dci[:, idof] = np.where(pos, self.kp, 0.0)

    def _c3_metabolic_rate(self):
        for idof in range(self.ndof):
            ci = self.ci[:, idof]
            ok = ci - self.cp > 0.0
            a = self.vcmax
            b = self.kc * (1.0 + self.o2ref / self.ko)
            self.ac[:, idof] = np.where(ok, a * (ci - self.cp) / (ci + b), 0.0)
            self.dac_dci[:, idof] = np.where(
                ok, a * (b + self.cp) / ((ci + b) ** 2.0), 0.0)
            a = self.je / 4.0
            b = 2.0 * self.cp
            self.aj[:, idof] = np.where(ok, a * (ci - self.cp) / (ci + b), 0.0)
            self.daj_dci[:, idof] = np.where(
                ok, a * (b + self.cp) / ((ci + b) ** 2.0), 0.0)
            self.ap[:, idof] = 0.0
            self.dap_dci[:, idof] = 0.0

    def _clamp_negative_rates(self, idof):
        for name in ("ac", "aj", "ap", "ag"):
            arr = getattr(self, name)
            darr = getattr(self, "d" + name + "_dci")
            neg = arr[:, idof] < 0.0
            arr[neg, idof] = 0.0
            darr[neg, idof] = 0.0

    def _c4_net_assimilation(self):
        for idof in range(self.ndof):
            ac, aj, ap = self.ac[:, idof], self.aj[:, idof], self.ap[:, idof]
            if self.colim == 1:
                r1, r2 = quadratic(np.full(self.n, self.colim_c4a),
                                   -(ac + aj), ac * aj)
                ai = np.minimum(r1, r2)
                denom = ac + aj - 2.0 * self.colim_c4a * ai
                dai = (self.dac_dci[:, idof] * (aj - ai)
                       + self.daj_dci[:, idof] * (ac - ai)) / denom
                r1, r2 = quadratic(np.full(self.n, self.colim_c4b),
                                   -(ai + ap), ai * ap)
                self.ag[:, idof] = np.minimum(r1, r2)
                pos = self.ag[:, idof] > 0.0
                denom = ai + ap - 2.0 * self.colim_c4b * self.ag[:, idof]
                dag = (dai * (ap - self.ag[:, idof])
                       + self.dap_dci[:, idof] * (ai - self.ag[:, idof])) \
                    / np.where(denom != 0.0, denom, 1.0)
                self.dag_dci[:, idof] = np.where(pos, dag, 0.0)
            else:
                self.ag[:, idof] = np.minimum(np.minimum(ac, aj), ap)
                self.dag_dci[:, idof] = np.where(
                    (ac < aj) & (ac < ap), self.dac_dci[:, idof],
                    np.where((aj < ac) & (aj < ap), self.daj_dci[:, idof],
                             self.dap_dci[:, idof]))
            self._clamp_negative_rates(idof)
            self.an[:, idof] = self.ag[:, idof] - self.rd
            self.dan_dci[:, idof] = self.dag_dci[:, idof]

    def _c3_net_assimilation(self):
        for idof in range(self.ndof):
            ac, aj = self.ac[:, idof], self.aj[:, idof]
            if self.colim == 1:
                r1, r2 = quadratic(np.full(self.n, self.colim_c3),
                                   -(ac + aj), ac * aj)
                self.ag[:, idof] = np.minimum(r1, r2)
                pos = self.ag[:, idof] > 0.0
                denom = ac + aj - 2.0 * self.colim_c3 * self.ag[:, idof]
                dag = (self.dac_dci[:, idof] * (aj - self.ag[:, idof])
                       + self.daj_dci[:, idof] * (ac - self.ag[:, idof])) \
                    / np.where(denom != 0.0, denom, 1.0)
                self.dag_dci[:, idof] = np.where(pos, dag, 0.0)
            else:
                self.ag[:, idof] = np.minimum(ac, aj)
                self.dag_dci[:, idof] = np.where(
                    ac < aj, self.dac_dci[:, idof], self.daj_dci[:, idof])
            self._clamp_negative_rates(idof)
            self.an[:, idof] = self.ag[:, idof] - self.rd
            self.dan_dci[:, idof] = self.dag_dci[:, idof]

    def _c3_net_assimilation_from_gs(self):
        """C3_Net_Assimilation_From_Gs (:1468-1551): an(gs), sets ci."""
        ci_min = 1.0
        for idof in range(self.ndof):
            gs = self.gs[:, idof]
            with np.errstate(divide="ignore", invalid="ignore"):
                self.gleaf_c[:, idof] = 1.0 / (1.0 / self.gbc + 1.6 / gs)
                self.gleaf_w[:, idof] = 1.0 / (1.0 / self.gbv + 1.0 / gs)
            glc = self.gleaf_c[:, idof]
            a = self.vcmax
            b = self.kc * (1.0 + self.o2ref / self.ko)
            aq = 1.0 / glc
            bq = -(self.cair + b) - (a - self.rd) / glc
            cq = a * (self.cair - self.cp) - self.rd * (self.cair + b)
            r1, r2 = quadratic(aq, bq, cq)
            self.ac[:, idof] = np.minimum(r1, r2) + self.rd
            a = self.je / 4.0
            b = 2.0 * self.cp
            bq = -(self.cair + b) - (a - self.rd) / glc
            cq = a * (self.cair - self.cp) - self.rd * (self.cair + b)
            r1, r2 = quadratic(aq, bq, cq)
            self.aj[:, idof] = np.minimum(r1, r2) + self.rd
            if self.colim == 1:
                r1, r2 = quadratic(
                    np.full(self.n, self.colim_c3),
                    -(self.ac[:, idof] + self.aj[:, idof]),
                    self.ac[:, idof] * self.aj[:, idof])
                self.ag[:, idof] = np.minimum(r1, r2)
            else:
                self.ag[:, idof] = np.minimum(self.ac[:, idof],
                                              self.aj[:, idof])
            for name in ("ac", "aj", "ap", "ag"):
                arr = getattr(self, name)
                arr[arr[:, idof] < 0.0, idof] = 0.0
            self.an[:, idof] = self.ag[:, idof] - self.rd
            self.ci[:, idof] = np.maximum(
                self.cair - self.an[:, idof] / glc, ci_min)

    # ---- stomatal conductance models ---------------------------------------
    def _gs_ball_berry(self):
        """GsBallBerry (:1554-1586)."""
        self.g0 = np.maximum(self.g0opt * self.btran, GS_MIN)
        self.g1 = self.g1opt.copy()
        for idof in range(self.ndof):
            an = self.an[:, idof]
            aq = self.cs
            bq = self.cs * (self.gbv - self.g0) - self.g1 * an
            cq = -self.gbv * (self.cs * self.g0
                              + self.g1 * an * self.ceair / self.esat)
            r1, r2 = quadratic(aq, bq, cq)
            self.gs[:, idof] = np.where(an > 0.0, np.maximum(r1, r2), self.g0)

    def _gs_medlyn(self):
        """GsMedlyn (:1589-1627)."""
        vpd_min = 100.0
        self.g0 = self.g0opt.copy()
        self.g1 = self.g1opt.copy()
        # lanes with gbv == 0 (non-leaf cells in a staged multi-layer
        # batch) are dead: an <= 0 there, so gs falls back to g0 below
        # regardless of bq — mask the denominator to keep the evaluation
        # warning-clean without changing any live lane
        gbv_safe = np.where(self.gbv > 0.0, self.gbv, 1.0)
        for idof in range(self.ndof):
            an = self.an[:, idof]
            vpd_term = np.maximum(self.esat - self.ceair, vpd_min) * 0.001
            term = 1.6 * an / self.cs
            aq = np.ones(self.n)
            bq = -(2.0 * (self.g0 + term)
                   + (self.g1 * term) ** 2.0 / (gbv_safe * vpd_term))
            cq = self.g0 * self.g0 + (2.0 * self.g0 + term * (
                1.0 - self.g1 * self.g1 / vpd_term)) * term
            r1, r2 = quadratic(aq, bq, cq)
            self.gs[:, idof] = np.where(an > 0.0, np.maximum(r1, r2), self.g0)

    # ---- AuxVarCompute variants ---------------------------------------------
    def _compute_semi_empirical(self):
        """PhotosynthesisAuxVarCompute_SemiEmpirical (:975-1070)."""
        self.set_default_parameters()
        if self.c3psn == PATHWAY_C4:
            self._c4_temperature_response()
            self._c4_metabolic_rate()
            self._c4_net_assimilation()
        else:
            self._c3_temperature_response()
            self._electron_transport_rate()
            self._c3_metabolic_rate()
            self._c3_net_assimilation()
        # gbc == 0 marks dead (non-leaf) lanes; divide only live lanes
        gbc_safe = np.where(self.gbc > 0.0, self.gbc, 1.0)
        for idof in range(self.ndof):
            self.cs = np.maximum(self.cair - self.an[:, idof] / gbc_safe, 1.0)
        self.esat, self.desat = sat_vap_np(self.tleaf)
        self.ceair = np.minimum(np.maximum(self.eair, 0.20 * self.esat),
                                self.esat)
        self.ceair = np.minimum(self.eair, self.esat)
        if self.gstype == SCM_BBERRY:
            self._gs_ball_berry()
        elif self.gstype == SCM_MEDLYN:
            self._gs_medlyn()
        else:
            return
        for idof in range(self.ndof):
            gs = self.gs[:, idof]
            pos = gs > 0.0
            with np.errstate(divide="ignore", invalid="ignore"):
                self.gleaf_c[:, idof] = np.where(
                    pos, 1.0 / (1.0 / self.gbc + 1.6 / gs), 0.0)
                self.gleaf_w[:, idof] = np.where(
                    pos, 1.0 / (1.0 / self.gbv + 1.0 / gs), 0.0)

    def _compute_wue(self):
        """PhotosynthesisAuxVarCompute_WUE (:1072-1151)."""
        self.set_default_parameters()
        if self.c3psn == PATHWAY_C4:
            raise NotImplementedError("WUE path not implemented for C4 "
                                      "(reference aborts too)")
        self._c3_temperature_response()
        self._electron_transport_rate()
        self._c3_net_assimilation_from_gs()
        gbc_safe = np.where(self.gbc > 0.0, self.gbc, 1.0)
        for idof in range(self.ndof):
            self.cs = np.maximum(self.cair - self.an[:, idof] / gbc_safe, 1.0)
        self.esat, self.desat = sat_vap_np(self.tleaf)
        self.ceair = np.minimum(np.maximum(self.eair, 0.20 * self.esat),
                                self.esat)
        self.ceair = np.minimum(self.eair, self.esat)
        if self.gstype in (SCM_WUE, SCM_MANZONI11):
            for idof in range(self.ndof):
                gs = self.gs[:, idof]
                self.hs = (self.gbv * self.eair + gs * self.esat) \
                    / ((self.gbv + gs) * self.esat)
                self.vpd = np.maximum(self.esat - self.hs * self.esat,
                                      0.1) / self.pref
        else:  # BONAN14 / MODIFIED_BONAN14
            gs = self.gs[:, 0]
            self.hs = (self.gbv * self.eair + gs * self.esat) \
                / ((self.gbv + gs) * self.esat)
            self.vpd = np.maximum(self.esat - self.hs * self.esat,
                                  0.1) / self.pref

    def aux_var_compute(self):
        """PhotosynthesisAuxVarCompute dispatch (:737-855)."""
        idof_wue, idof_hyd = 0, 1
        if self.gstype in (SCM_BBERRY, SCM_MEDLYN):
            self._compute_semi_empirical()
            self.compute_soil_resistance()
        elif self.gstype in (SCM_WUE, SCM_MANZONI11):
            gs_val = self.gs[:, idof_wue].copy()
            self.gs[:, idof_wue] = gs_val - GS_DELTA_WUE
            self._compute_wue()
            an_low = self.an[:, idof_wue].copy()
            self.gs[:, idof_wue] = gs_val
            self._compute_wue()
            an_high = self.an[:, idof_wue].copy()
            self.compute_soil_resistance()
            factor = np.ones(self.n)
            if self.gstype == SCM_MANZONI11:
                factor = exp_g(self.manzoni11_beta * self.leaf_psi)
            self.residual_wue[:, idof_wue] = (an_high - an_low) \
                - self.iota * factor * GS_DELTA_WUE * self.vpd
        elif self.gstype in (SCM_BONAN14, SCM_MODIFIED_BONAN14):
            gs_val_wue = self.gs[:, idof_wue].copy()
            gs_val_hyd = self.gs[:, idof_hyd].copy()
            self.gs[:, idof_wue] = gs_val_wue - GS_DELTA_BONAN14
            self.gs[:, idof_hyd] = gs_val_hyd - GS_DELTA_BONAN14
            self._compute_wue()
            an_low = self.an[:, idof_wue].copy()
            self.gs[:, idof_wue] = gs_val_wue
            self.gs[:, idof_hyd] = gs_val_hyd
            self._compute_wue()
            an_high = self.an[:, idof_wue].copy()
            self.residual_wue[:, idof_wue] = (an_high - an_low) \
                - self.iota * GS_DELTA_BONAN14 * self.vpd
            self.compute_soil_resistance()
            etflx = (self.esat - self.eair) / self.pref \
                * self.gleaf_w[:, idof_hyd] * self.fdry
            if self.gstype == SCM_BONAN14:
                self.compute_change_in_psi(etflx)
                self.residual_hyd[:, idof_hyd] = self.leaf_psi \
                    + self.dpsi_leaf - self.leaf_minlwp
            else:
                psi_new = self.compute_psi_modified_bonan14(etflx)
                self.dpsi_leaf = psi_new - self.leaf_psi
                self.residual_hyd[:, idof_hyd] = psi_new - self.leaf_minlwp
        elif self.gstype == SCM_OSMWANG:
            gs_val = self.gs[:, idof_wue].copy()
            self.gs[:, idof_wue] = gs_val - GS_DELTA_WUE
            self._compute_wue()
            an_low = self.an[:, idof_wue].copy()
            etflx_low = (self.esat - self.eair) / self.pref \
                * self.gleaf_w[:, idof_wue] * self.fdry
            self.gs[:, idof_wue] = gs_val
            self._compute_wue()
            an_high = self.an[:, idof_wue].copy()
            etflx_high = (self.esat - self.eair) / self.pref \
                * self.gleaf_w[:, idof_wue] * self.fdry
            self.compute_soil_resistance()
            etflx_c = self.compute_critical_flow()
            cost_low = an_low * etflx_low / etflx_c
            cost_high = an_high * etflx_high / etflx_c
            self.residual_wue[:, idof_wue] = \
                (an_high - an_low) / (etflx_high - etflx_low) \
                - (cost_high - cost_low) / (etflx_high - etflx_low)
        else:
            raise ValueError(f"Unsupported stomatal model {self.gstype}")

    # ---- boundedness pre-check ----------------------------------------------
    def determine_if_solution_is_bounded(self):
        """PhotosynthesisDetermineIfSolutionIsBounded (:1632-1715).

        Mutates ci/gs exactly like the reference (the leftover values feed
        the unbounded dofs' outputs)."""
        idof_wue, idof_hyd = 0, 1
        if self.gstype in (SCM_WUE, SCM_MANZONI11, SCM_OSMWANG):
            self.gs[:, idof_wue] = GS_MAX_WUE
            self.aux_var_compute()
            res2 = self.residual_wue[:, idof_wue].copy()
            self.gs[:, idof_wue] = GS_MIN_WUE
            self.aux_var_compute()
            res1 = self.residual_wue[:, idof_wue].copy()
            self.soln_is_bounded[:, idof_wue] = res1 * res2 <= 0.0
        elif self.gstype in (SCM_BONAN14, SCM_MODIFIED_BONAN14):
            self.gs[:, idof_wue] = GS_MAX_WUE
            self.gs[:, idof_hyd] = GS_MAX_WUE
            self.aux_var_compute()
            res_wue_2 = self.residual_wue[:, idof_wue].copy()
            res_hyd_2 = self.residual_hyd[:, idof_hyd].copy()
            self.gs[:, idof_wue] = GS_MIN_BONAN14
            self.gs[:, idof_hyd] = GS_MIN_BONAN14
            self.aux_var_compute()
            res_wue_1 = self.residual_wue[:, idof_wue].copy()
            res_hyd_1 = self.residual_hyd[:, idof_hyd].copy()
            any_cross = np.minimum(res_wue_1, res_hyd_1) \
                * np.minimum(res_wue_2, res_hyd_2) < 0.0
            self.soln_is_bounded[:, idof_wue] = any_cross \
                & (res_wue_1 * res_wue_2 < 0.0)
            self.soln_is_bounded[:, idof_hyd] = any_cross \
                & (res_hyd_1 * res_hyd_2 < 0.0)
        elif self.gstype in (SCM_BBERRY, SCM_MEDLYN):
            frac = 0.7 if self.c3psn == PATHWAY_C3 else 0.4
            self.ci[:, idof_wue] = frac * self.cair
            self.aux_var_compute()
            neg1 = self.an[:, idof_wue] < 0.0
            self.ci[~neg1, idof_wue] = 0.99 * self.cair[~neg1]
            self.aux_var_compute()
            neg2 = self.an[:, idof_wue] < 0.0
            self.soln_is_bounded[:, idof_wue] = ~(neg1 | neg2)
        else:
            raise ValueError(f"Unknown stomatal model {self.gstype}")

    # ---- pre/post solve -----------------------------------------------------
    def pre_solve(self):
        """PhotosynthesisPreSolve (:1718-1742): advance leaf_psi."""
        self.compute_soil_resistance()
        esat, desat = sat_vap_np(self.tleaf_prev)
        etflx = (esat + desat * (self.tleaf - self.tleaf_prev) - self.eair) \
            / self.pref * self.gleaf_w_soln * self.fdry
        if self.gstype == SCM_MODIFIED_BONAN14:
            self.leaf_psi = self.compute_psi_modified_bonan14(etflx)
        else:
            self.compute_change_in_psi(etflx)
            self.leaf_psi = self.leaf_psi + self.dpsi_leaf

    def post_solve(self):
        """PhotosynthesisPostSolve (:1745-1826): pick the solution dof."""
        idof_wue, idof_hyd = 0, 1
        if self.gstype in (SCM_BONAN14, SCM_MODIFIED_BONAN14):
            both = self.soln_is_bounded[:, idof_wue] \
                & self.soln_is_bounded[:, idof_hyd]
            pick_hyd = both & (self.gs[:, idof_hyd] <= self.gs[:, idof_wue])
            idof = np.where(pick_hyd, idof_hyd, idof_wue)
        else:
            idof = np.zeros(self.n, np.intp)
        rows = np.arange(self.n)
        self.ac_soln = self.ac[rows, idof]
        self.aj_soln = self.aj[rows, idof]
        self.ap_soln = self.ap[rows, idof]
        self.ag_soln = self.ag[rows, idof]
        self.an_soln = self.an[rows, idof]
        self.gs_soln = self.gs[rows, idof]
        self.gleaf_c_soln = self.gleaf_c[rows, idof]
        self.gleaf_w_soln = self.gleaf_w[rows, idof]
        pos = self.gs_soln > 0.0
        with np.errstate(divide="ignore", invalid="ignore"):
            self.gleaf_c_soln = np.where(
                pos, 1.0 / (1.0 / self.gbc + 1.6 / self.gs_soln),
                self.gleaf_c_soln)
            self.gleaf_w_soln = np.where(
                pos, 1.0 / (1.0 / self.gbv + 1.0 / self.gs_soln),
                self.gleaf_w_soln)


@dataclasses.dataclass
class PhotosynthesisGE:
    """GE_PHOTOSYNTHESIS (GoveqnPhotosynthesis.F90)."""
    name: str
    mesh: object
    itype: int = int(GEType.PHOTOSYNTHESIS)
    dof: int = 1
    avars: Optional[PhotosynthesisAuxVars] = None

    def allocate_auxvars(self, c3psn, gstype):
        self.avars = PhotosynthesisAuxVars(self.mesh.ncells_all, self.dof,
                                           c3psn=c3psn, gstype=gstype)

    def save_primary(self, X):
        """PhotosynthesisSavePrmIndepVar: X -> ci (BB/Medlyn) or gs,
        bounded dofs only."""
        av = self.avars
        n = self.mesh.ncells_local
        vals = np.asarray(X, np.float64).reshape(n, self.dof)
        target = av.ci if av.gstype in (SCM_BBERRY, SCM_MEDLYN) else av.gs
        b = av.soln_is_bounded[:n]
        target[:n][b] = vals[b]

    def residual(self):
        """PhotosynthesisComputeResidual (assumes auxvars updated)."""
        av = self.avars
        n = self.mesh.ncells_local
        active = np.asarray(self.mesh.is_active)[:n, None]
        ok = active & av.soln_is_bounded[:n]
        if av.gstype in (SCM_BBERRY, SCM_MEDLYN):
            F = np.where(ok & (av.an[:n] > 0.0),
                         av.an[:n] - av.gleaf_c[:n]
                         * (av.cair[:n, None] - av.ci[:n]), 0.0)
        elif av.gstype in (SCM_WUE, SCM_MANZONI11, SCM_OSMWANG):
            F = np.where(ok, av.residual_wue[:n], 0.0)
        else:  # BONAN14 variants: dof1 = wue residual, dof2 = hyd residual
            F = np.where(ok, av.residual_wue[:n], 0.0)
            if self.dof > 1:
                F[:, self.dof - 1] = np.where(
                    ok[:, self.dof - 1],
                    av.residual_hyd[:n, self.dof - 1], 0.0)
        return F.reshape(-1)

    def jacobian_diag(self):
        """PhotosynthesisComputeJacobian: FD diagonal (:261-431), with the
        reference's whole-gs-array assignment side effects."""
        av = self.avars
        n = self.mesh.ncells_local
        active = np.asarray(self.mesh.is_active)[:n, None]
        ok = active & av.soln_is_bounded[:n]
        diag = np.ones((n, self.dof))
        semi = av.gstype in (SCM_BBERRY, SCM_MEDLYN)
        for idof in range(self.dof):
            if semi and av.c3psn == PATHWAY_C3:
                ci_pert = -1.0e-7
            elif av.gstype in (SCM_BONAN14, SCM_MODIFIED_BONAN14):
                ci_pert, gs_pert = -1.0e-7, -1.0e-8
            else:
                ci_pert, gs_pert = -1.0e-7, -1.0e-5
            if semi:
                an_1 = av.an[:, idof].copy()
                ci_1 = av.ci[:, idof].copy()
                gleaf_1 = av.gleaf_c[:, idof].copy()
                av.ci[:, idof] = ci_1 - ci_pert
                av.aux_var_compute()
                an_2 = av.an[:, idof].copy()
                gleaf_2 = av.gleaf_c[:, idof].copy()
                av.ci[:, idof] = ci_1
                av.aux_var_compute()
                val = np.where(
                    av.an[:, idof] > 0.0,
                    (an_1 - an_2) / ci_pert
                    - (gleaf_1 - gleaf_2) / ci_pert * (av.cair - ci_1)
                    + gleaf_1, 1.0)
            elif av.gstype in (SCM_WUE, SCM_MANZONI11, SCM_OSMWANG):
                res_1 = av.residual_wue[:, idof].copy()
                gs_1 = av.gs[:, idof].copy()
                av.gs[:, :] = (gs_1 - gs_pert)[:, None]
                av.aux_var_compute()
                res_2 = av.residual_wue[:, idof].copy()
                val = (res_1 - res_2) / gs_pert
                av.gs[:, :] = gs_1[:, None]
                av.aux_var_compute()
            else:  # BONAN14 variants
                if idof == 0:
                    res_1 = av.residual_wue[:, idof].copy()
                    gs_1 = av.gs[:, idof].copy()
                    av.gs[:, :] = (gs_1 - gs_pert)[:, None]
                    av.aux_var_compute()
                    res_2 = av.residual_wue[:, idof].copy()
                    val = (res_1 - res_2) / gs_pert
                    av.gs[:, :] = gs_1[:, None]
                    av.aux_var_compute()
                else:
                    gs_1 = av.gs[:, idof].copy()
                    av.gs[:, :] = (gs_1 - gs_pert)[:, None]
                    av.aux_var_compute()
                    av.gs[:, :] = gs_1[:, None]
                    av.aux_var_compute()
                    val = np.ones(av.n)
            diag[:, idof] = np.where(ok[:, idof], val[:n], 1.0)
        return diag.reshape(-1)

    def get_r_values(self, var_type):
        av = self.avars
        if var_type == Var.STOMATAL_CONDUCTANCE:
            return av.gs_soln.copy()
        if var_type == Var.GROSS_PHOTOSYNTHESIS:
            return av.ag_soln.copy()
        if var_type == Var.NET_PHOTOSYNTHESIS:
            return av.an_soln.copy()
        raise NotImplementedError(var_type)


class PhotosynthesisSoE:
    """SOE_PHOTOSYNTHESIS: diagonal Newton with PETSc SNES stopping
    semantics (the golden files record the iterate at the global
    ||F|| < rtol*||F0|| stop, so the iteration is replicated:
    full-step Newton on the FD-diagonal Jacobian, SNESConvergedDefault
    with rtol=1e-8, stol=1e-10, atol=1e-50)."""

    def __init__(self):
        self.ge: Optional[PhotosynthesisGE] = None
        self.itype = int(SOEType.PHOTOSYNTHESIS)
        self.soln = None
        self.soln_prev = None
        self.cumulative_newton_iterations = 0
        self.metrics = None

    def setup(self):
        n = self.ge.mesh.ncells_local * self.ge.dof
        self.soln = np.zeros(n)
        self.soln_prev = np.zeros(n)

    def _residual(self, X):
        self.ge.save_primary(X)
        self.ge.avars.aux_var_compute()
        return self.ge.residual()

    def step_dt(self, dt, nstep=1, rtol=1e-8, stol=1e-10, atol=1e-50,
                max_it=50):
        X = np.asarray(self.soln, np.float64).copy()
        F = self._residual(X)
        fnorm = np.linalg.norm(F)
        reason = 0
        if fnorm < atol:
            reason = 2
        else:
            ttol = fnorm * rtol
            for it in range(max_it):
                diag = self.ge.jacobian_diag()
                dx = -F / diag
                X = X + dx
                F = self._residual(X)
                fnorm = np.linalg.norm(F)
                self.cumulative_newton_iterations += 1
                if fnorm <= ttol:
                    reason = 3  # CONVERGED_FNORM_RELATIVE
                    break
                if np.linalg.norm(dx) < stol * np.linalg.norm(X):
                    reason = 4  # CONVERGED_SNORM_RELATIVE
                    break
        self.soln = X
        # PostSolve (PhotosynthesisSoePostSolve :109-151)
        self.soln_prev = self.soln.copy()
        self.ge.save_primary(self.soln)
        self.ge.avars.post_solve()
        if self.metrics is not None:
            self.metrics.record(step=nstep, dt=dt, converged=reason > 0,
                                reason=int(reason), fnorm=float(fnorm))
        return reason > 0, reason


class PhotosynthesisMPP(MPPBase):
    """mpp_photosynthesis_type facade (MPP_PHOTOSYNTHESIS_SNES)."""

    def __init__(self):
        super().__init__()
        self.soe = PhotosynthesisSoE()

    def _goveqns(self):
        return [self.soe.ge] if self.soe.ge is not None else []

    def add_goveqn(self, name="Photosynthesis model", mesh_index=0):
        self.soe.ge = PhotosynthesisGE(name=name,
                                       mesh=self.meshes[mesh_index])
        return 1

    def set_dofs_for_goveqn(self, ieqn, dof):
        self.soe.ge.dof = int(dof)

    def get_data(self, var_type):
        return self.soe.ge.get_r_values(var_type)
