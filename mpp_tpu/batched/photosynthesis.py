"""Batched (jnp) photosynthesis / stomatal conductance: the
production path.

Functional re-expression of ``models/photosynthesis.py`` (itself a
transcription of ``auxvar/PhotosynthesisAuxVarType.F90`` and
``ge/GoveqnPhotosynthesis.F90``): every leaf cell advances together as a
[n] lane of a masked Newton iteration.  The biochemistry chain
(Farquhar C3 / Collatz C4, temperature responses, electron transport,
co-limitation quadratics, the stomatal models, and the plant-hydraulics
coupling) is pure elementwise math, so the port is a pure function of a
parameter NamedTuple; the finite-difference Jacobian construction of
``GoveqnPhotosynthesis.F90:261-431`` (including its whole-gs-array
perturbation for the Bonan14 hydraulic dof and the fixed perturbation
sizes) is reproduced so the batched path converges through the same
iteration map as the serial one.

The serial numpy module remains the golden-parity path (it carries the
glibc-libm bit parity the regression goldens need); this module is
verified against it cell-for-cell (tests/test_batched_photosynthesis.py)
and is jit/vmap/shard_map compatible for production column counts.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import jax.numpy as jnp
from jax import lax

from mpp_tpu.constants import TFRZ, RGAS
from mpp_tpu.ops.satvap import sat_vap
from mpp_tpu.models.photosynthesis import (
    SCM_MEDLYN, SCM_BBERRY, SCM_WUE, SCM_BONAN14, SCM_MANZONI11,
    SCM_MODIFIED_BONAN14, SCM_OSMWANG, PATHWAY_C3, PATHWAY_C4,
    GS_MIN, GS_MIN_WUE, GS_MAX_WUE, GS_DELTA_WUE, GS_MIN_BONAN14,
    GS_DELTA_BONAN14)

_G = 9.80665
_DENH2O = 1000.0


@dataclasses.dataclass(frozen=True)
class PsyConfig:
    """Static (trace-time) problem configuration."""
    c3psn: int = PATHWAY_C3
    gstype: int = SCM_MEDLYN
    colim: int = 1
    ndof: int = 1


class PsyParams(NamedTuple):
    """Per-cell [n] photosynthesis parameters + forcing (the x-independent
    slice of ``photosynthesis_auxvar_type``)."""
    tleaf: jnp.ndarray
    gbv: jnp.ndarray
    gbc: jnp.ndarray
    eair: jnp.ndarray
    pref: jnp.ndarray
    cair: jnp.ndarray
    o2ref: jnp.ndarray
    apar: jnp.ndarray
    btran: jnp.ndarray
    vcmax25: jnp.ndarray
    jmax25: jnp.ndarray
    rd25: jnp.ndarray
    kp25: jnp.ndarray
    g0opt: jnp.ndarray
    g1opt: jnp.ndarray
    iota: jnp.ndarray
    manzoni11_beta: jnp.ndarray
    fdry: jnp.ndarray
    fwet: jnp.ndarray
    # plant hydraulics
    leaf_psi: jnp.ndarray
    leaf_height: jnp.ndarray
    leaf_capc: jnp.ndarray
    leaf_minlwp: jnp.ndarray
    leaf_lai: jnp.ndarray
    k_stem2leaf: jnp.ndarray
    weibull_b: jnp.ndarray
    weibull_c: jnp.ndarray
    leaf_psi_crt: jnp.ndarray
    plant_dtime: jnp.ndarray
    root_biomass: jnp.ndarray
    root_radius: jnp.ndarray
    root_density: jnp.ndarray
    root_resist: jnp.ndarray
    # soil column [n, nlevsoi]
    soil_h2osoi_vol: jnp.ndarray
    soil_watsat: jnp.ndarray
    soil_psi_sat: jnp.ndarray
    soil_hksat: jnp.ndarray
    soil_bsw: jnp.ndarray
    soil_rootfr: jnp.ndarray
    soil_dz: jnp.ndarray


class SoilDerived(NamedTuple):
    """x-independent plant/soil hydraulic state (ComputeSoilResistance,
    PhotosynthesisAuxVarType.F90:626-728)."""
    resist_soil: jnp.ndarray
    psi_soil: jnp.ndarray
    leaf_lsc: jnp.ndarray


def params_from_auxvars(av) -> Tuple[PsyConfig, PsyParams]:
    """Build (config, params) from a serial ``PhotosynthesisAuxVars``."""
    av.set_default_parameters()
    f = lambda a: jnp.asarray(np.asarray(a, np.float64))
    cfg = PsyConfig(c3psn=av.c3psn, gstype=av.gstype, colim=av.colim,
                    ndof=av.ndof)
    p = PsyParams(
        tleaf=f(av.tleaf), gbv=f(av.gbv), gbc=f(av.gbc), eair=f(av.eair),
        pref=f(av.pref), cair=f(av.cair), o2ref=f(av.o2ref), apar=f(av.apar),
        btran=f(av.btran), vcmax25=f(av.vcmax25), jmax25=f(av.jmax25),
        rd25=f(av.rd25), kp25=f(av.kp25), g0opt=f(av.g0opt),
        g1opt=f(av.g1opt), iota=f(av.iota),
        manzoni11_beta=f(av.manzoni11_beta), fdry=f(av.fdry), fwet=f(av.fwet),
        leaf_psi=f(av.leaf_psi), leaf_height=f(av.leaf_height),
        leaf_capc=f(av.leaf_capc), leaf_minlwp=f(av.leaf_minlwp),
        leaf_lai=f(av.leaf_lai), k_stem2leaf=f(av.k_stem2leaf),
        weibull_b=f(av.weibull_b), weibull_c=f(av.weibull_c),
        leaf_psi_crt=f(av.leaf_psi_crt), plant_dtime=f(av.plant_dtime),
        root_biomass=f(av.root_biomass), root_radius=f(av.root_radius),
        root_density=f(av.root_density), root_resist=f(av.root_resist),
        soil_h2osoi_vol=f(av.soil_h2osoi_vol), soil_watsat=f(av.soil_watsat),
        soil_psi_sat=f(av.soil_psi_sat), soil_hksat=f(av.soil_hksat),
        soil_bsw=f(av.soil_bsw), soil_rootfr=f(av.soil_rootfr),
        soil_dz=f(av.soil_dz))
    return cfg, p


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def quadratic(a, b, c):
    """MathUtilsMod::quadratic (MathUtils.F90:24-58), both roots."""
    disc = jnp.sqrt(b * b - 4.0 * a * c)
    q = jnp.where(b >= 0.0, -0.5 * (b + disc), -0.5 * (b - disc))
    r1 = q / a
    r2 = jnp.where(q != 0.0, c / jnp.where(q != 0.0, q, 1.0), 1.0e36)
    return r1, r2


def ft(tl, ha):
    return jnp.exp(ha / (RGAS * (TFRZ + 25.0)) * (1.0 - (TFRZ + 25.0) / tl))


def fth(tl, hd, se, c):
    return c / (1.0 + jnp.exp((-hd + se * tl) / (RGAS * tl)))


def fth25(hd, se):
    return 1.0 + np.exp((-hd + se * (TFRZ + 25.0)) / (RGAS * (TFRZ + 25.0)))


# kinetic constants (PhotosynthesisAuxVarType.F90:388-440)
KC25, KO25, CP25 = 404.9, 278.4, 42.75
KCHA, KOHA, CPHA = 79430.0, 36380.0, 37830.0
RDHA, VCMAXHA, JMAXHA = 46390.0, 65330.0, 43540.0
RDHD = VCMAXHD = JMAXHD = 150000.0
RDSE = VCMAXSE = JMAXSE = 490.0
VCMAXC = fth25(VCMAXHD, VCMAXSE)
JMAXC = fth25(JMAXHD, JMAXSE)
RDC = fth25(RDHD, RDSE)
PHI_PSII, THETA_J = 0.85, 0.90
COLIM_C3 = 0.98
COLIM_C4A, COLIM_C4B = 0.80, 0.95
QE_C4 = 0.05


class Biochem(NamedTuple):
    """x-independent biochemistry rates (temperature responses +
    electron transport; PhotosynthesisAuxVarType.F90:1156-1232)."""
    vcmax: jnp.ndarray
    jmax: jnp.ndarray
    je: jnp.ndarray
    kc: jnp.ndarray
    ko: jnp.ndarray
    cp: jnp.ndarray
    rd: jnp.ndarray
    kp: jnp.ndarray
    esat: jnp.ndarray
    ceair: jnp.ndarray


def biochem_rates(cfg: PsyConfig, p: PsyParams) -> Biochem:
    tl = p.tleaf
    if cfg.c3psn == PATHWAY_C4:
        t1 = jnp.power(2.0, (tl - (TFRZ + 25.0)) / 10.0)
        t2 = 1.0 + jnp.exp(0.2 * ((TFRZ + 15.0) - tl))
        t3 = 1.0 + jnp.exp(0.3 * (tl - (TFRZ + 40.0)))
        vcmax = p.vcmax25 * t1 / (t2 * t3) * p.btran
        t3r = 1.0 + jnp.exp(1.3 * (tl - (TFRZ + 55.0)))
        rd = p.rd25 * t1 / t3r
        kp = p.kp25 * t1
        kc = ko = cp = jmax = je = jnp.zeros_like(tl)
    else:
        kc = KC25 * ft(tl, KCHA)
        ko = KO25 * ft(tl, KOHA)
        cp = CP25 * ft(tl, CPHA)
        vcmax = p.vcmax25 * ft(tl, VCMAXHA) * fth(tl, VCMAXHD, VCMAXSE,
                                                  VCMAXC) * p.btran
        jmax = p.jmax25 * ft(tl, JMAXHA) * fth(tl, JMAXHD, JMAXSE, JMAXC)
        rd = p.rd25 * ft(tl, RDHA) * fth(tl, RDHD, RDSE, RDC)
        kp = jnp.zeros_like(tl)
        qabs = 0.5 * PHI_PSII * p.apar
        r1, r2 = quadratic(jnp.full_like(tl, THETA_J), -(qabs + jmax),
                           qabs * jmax)
        je = jnp.minimum(r1, r2)
    esat, _ = sat_vap(tl)
    # ceair: the reference's max-clamp is overwritten (quirk preserved,
    # models/photosynthesis.py:550-552)
    ceair = jnp.minimum(p.eair, esat)
    return Biochem(vcmax=vcmax, jmax=jmax, je=je, kc=kc, ko=ko, cp=cp,
                   rd=rd, kp=kp, esat=esat, ceair=ceair)


def soil_resistance(p: PsyParams) -> SoilDerived:
    """ComputeSoilResistance (:626-728), x-independent."""
    head = _G * _DENH2O * 1.0e-6
    area = jnp.pi * p.root_radius ** 2
    vwc = jnp.maximum(p.soil_h2osoi_vol, 1.0e-6) / (p.soil_dz * _DENH2O)
    s = jnp.clip(vwc / p.soil_watsat, 0.01, 1.0)
    hk = p.soil_hksat * jnp.power(s, 2.0 * p.soil_bsw + 3.0)
    hk = hk * 1.0e-3 / head
    hk = hk * _DENH2O / 18.02e-3 * 1000.0
    soil_psi = p.soil_psi_sat * jnp.power(s, -p.soil_bsw)
    psi_mpa = soil_psi * 1.0e-3 * head
    rbd = jnp.maximum(p.root_biomass[:, None] * p.soil_rootfr / p.soil_dz,
                      1.0e-10)
    rld = rbd / (p.root_density * area)[:, None]
    root_dist = jnp.sqrt(1.0 / (rld * jnp.pi))
    soilr1 = jnp.log(root_dist / p.root_radius[:, None]) \
        / (2.0 * jnp.pi * rld * p.soil_dz * hk)
    soilr = soilr1 + p.root_resist[:, None] / (rbd * p.soil_dz)
    blw = (1.0 / soilr).sum(axis=1)
    evap = jnp.maximum((psi_mpa - p.leaf_minlwp[:, None]) / soilr, 0.0)
    resist_soil = p.leaf_lai / blw
    totevap = evap.sum(axis=1)
    psi_soil = (psi_mpa * evap).sum(axis=1)
    psi_soil = jnp.where(totevap > 0.0,
                         psi_soil / jnp.where(totevap > 0.0, totevap, 1.0),
                         p.leaf_minlwp)
    leaf_lsc = 1.0 / (1.0 / p.k_stem2leaf + resist_soil)
    return SoilDerived(resist_soil=resist_soil, psi_soil=psi_soil,
                       leaf_lsc=leaf_lsc)


# ---------------------------------------------------------------------------
# semi-empirical chain: an(ci) -> gs (BB / Medlyn)
# ---------------------------------------------------------------------------

class SemiOut(NamedTuple):
    an: jnp.ndarray
    ag: jnp.ndarray
    ac: jnp.ndarray
    aj: jnp.ndarray
    ap: jnp.ndarray
    gs: jnp.ndarray
    gleaf_c: jnp.ndarray
    gleaf_w: jnp.ndarray
    cs: jnp.ndarray


def semi_empirical(cfg: PsyConfig, p: PsyParams, bc: Biochem,
                   ci: jnp.ndarray) -> SemiOut:
    """PhotosynthesisAuxVarCompute_SemiEmpirical (:975-1070), ndof=1."""
    if cfg.c3psn == PATHWAY_C4:
        ac = bc.vcmax
        dac = jnp.zeros_like(ci)
        aj = QE_C4 * p.apar
        ap = jnp.where(ci > 0.0, bc.kp * ci, 0.0)
        if cfg.colim == 1:
            r1, r2 = quadratic(jnp.full_like(ci, COLIM_C4A), -(ac + aj),
                               ac * aj)
            ai = jnp.minimum(r1, r2)
            r1, r2 = quadratic(jnp.full_like(ci, COLIM_C4B), -(ai + ap),
                               ai * ap)
            ag = jnp.minimum(r1, r2)
        else:
            ag = jnp.minimum(jnp.minimum(ac, aj), ap)
        del dac
    else:
        ok = ci - bc.cp > 0.0
        b1 = bc.kc * (1.0 + p.o2ref / bc.ko)
        ac = jnp.where(ok, bc.vcmax * (ci - bc.cp) / (ci + b1), 0.0)
        aj = jnp.where(ok, bc.je / 4.0 * (ci - bc.cp) / (ci + 2.0 * bc.cp),
                       0.0)
        ap = jnp.zeros_like(ci)
        if cfg.colim == 1:
            r1, r2 = quadratic(jnp.full_like(ci, COLIM_C3), -(ac + aj),
                               ac * aj)
            ag = jnp.minimum(r1, r2)
        else:
            ag = jnp.minimum(ac, aj)
    ac = jnp.maximum(ac, 0.0)
    aj = jnp.maximum(aj, 0.0)
    ap = jnp.maximum(ap, 0.0)
    ag = jnp.maximum(ag, 0.0)
    an = ag - bc.rd

    cs = jnp.maximum(p.cair - an / p.gbc, 1.0)
    if cfg.gstype == SCM_BBERRY:
        g0 = jnp.maximum(p.g0opt * p.btran, GS_MIN)
        g1 = p.g1opt
        aq = cs
        bq = cs * (p.gbv - g0) - g1 * an
        cq = -p.gbv * (cs * g0 + g1 * an * bc.ceair / bc.esat)
        r1, r2 = quadratic(aq, bq, cq)
        gs = jnp.where(an > 0.0, jnp.maximum(r1, r2), g0)
    else:  # Medlyn
        g0 = p.g0opt
        g1 = p.g1opt
        vpd_term = jnp.maximum(bc.esat - bc.ceair, 100.0) * 0.001
        term = 1.6 * an / cs
        aq = jnp.ones_like(an)
        bq = -(2.0 * (g0 + term) + (g1 * term) ** 2
               / (p.gbv * vpd_term))
        cq = g0 * g0 + (2.0 * g0 + term
                        * (1.0 - g1 * g1 / vpd_term)) * term
        r1, r2 = quadratic(aq, bq, cq)
        gs = jnp.where(an > 0.0, jnp.maximum(r1, r2), g0)
    pos = gs > 0.0
    gsafe = jnp.where(pos, gs, 1.0)
    gleaf_c = jnp.where(pos, 1.0 / (1.0 / p.gbc + 1.6 / gsafe), 0.0)
    gleaf_w = jnp.where(pos, 1.0 / (1.0 / p.gbv + 1.0 / gsafe), 0.0)
    return SemiOut(an=an, ag=ag, ac=ac, aj=aj, ap=ap, gs=gs,
                   gleaf_c=gleaf_c, gleaf_w=gleaf_w, cs=cs)


# ---------------------------------------------------------------------------
# WUE-family chain: gs -> an (C3 only, like the reference)
# ---------------------------------------------------------------------------

class FromGsOut(NamedTuple):
    an: jnp.ndarray
    ag: jnp.ndarray
    ci: jnp.ndarray
    gleaf_c: jnp.ndarray
    gleaf_w: jnp.ndarray
    hs: jnp.ndarray
    vpd: jnp.ndarray


def an_from_gs(cfg: PsyConfig, p: PsyParams, bc: Biochem,
               gs: jnp.ndarray) -> FromGsOut:
    """C3_Net_Assimilation_From_Gs (:1468-1551) + the hs/vpd staging of
    PhotosynthesisAuxVarCompute_WUE (:1072-1151); gs is a single dof."""
    gleaf_c = 1.0 / (1.0 / p.gbc + 1.6 / gs)
    gleaf_w = 1.0 / (1.0 / p.gbv + 1.0 / gs)
    aq = 1.0 / gleaf_c
    b1 = bc.kc * (1.0 + p.o2ref / bc.ko)
    bq = -(p.cair + b1) - (bc.vcmax - bc.rd) / gleaf_c
    cq = bc.vcmax * (p.cair - bc.cp) - bc.rd * (p.cair + b1)
    r1, r2 = quadratic(aq, bq, cq)
    ac = jnp.minimum(r1, r2) + bc.rd
    a2 = bc.je / 4.0
    b2 = 2.0 * bc.cp
    bq = -(p.cair + b2) - (a2 - bc.rd) / gleaf_c
    cq = a2 * (p.cair - bc.cp) - bc.rd * (p.cair + b2)
    r1, r2 = quadratic(aq, bq, cq)
    aj = jnp.minimum(r1, r2) + bc.rd
    if cfg.colim == 1:
        r1, r2 = quadratic(jnp.full_like(gs, COLIM_C3), -(ac + aj), ac * aj)
        ag = jnp.minimum(r1, r2)
    else:
        ag = jnp.minimum(ac, aj)
    ag = jnp.maximum(ag, 0.0)
    an = ag - bc.rd
    ci = jnp.maximum(p.cair - an / gleaf_c, 1.0)
    hs = (p.gbv * p.eair + gs * bc.esat) / ((p.gbv + gs) * bc.esat)
    vpd = jnp.maximum(bc.esat - hs * bc.esat, 0.1) / p.pref
    return FromGsOut(an=an, ag=ag, ci=ci, gleaf_c=gleaf_c, gleaf_w=gleaf_w,
                     hs=hs, vpd=vpd)


def critical_flow(p: PsyParams, sd: SoilDerived) -> jnp.ndarray:
    """ComputeCriticalFlow (:858-886)."""
    head = _G * _DENH2O * 1.0e-6
    kl = sd.leaf_lsc * jnp.exp(-jnp.power(-sd.psi_soil / p.weibull_b,
                                          p.weibull_c))
    return jnp.maximum(kl * (sd.psi_soil - p.leaf_psi_crt
                             - head * p.leaf_height) / 1.0e3, 1.0e-7)


def change_in_psi(p: PsyParams, sd: SoilDerived, etflx) -> jnp.ndarray:
    """ComputeChangeInPsi (:889-906): dpsi_leaf."""
    head = _G * _DENH2O * 1.0e-6
    a = sd.psi_soil - head * p.leaf_height - 1.0e3 * etflx / sd.leaf_lsc
    b = p.leaf_capc / sd.leaf_lsc
    return (a - p.leaf_psi) * (1.0 - jnp.exp(-p.plant_dtime / b))


def psi_modified_bonan14(p: PsyParams, sd: SoilDerived, etflx):
    """ComputePsi_ModifiedBonan14 (:909-946)."""
    head = _G * _DENH2O * 1.0e-6
    w_b, w_c = 2.0, 5.0
    factor = jnp.exp(-jnp.power(-p.leaf_psi / w_b, w_c))
    Kl = 1.0 / (1.0 / (p.k_stem2leaf * factor) + sd.resist_soil)
    E = 1.0e3 * etflx
    return ((p.leaf_capc / p.plant_dtime) * p.leaf_psi
            + Kl * (sd.psi_soil - head * p.leaf_height) - E) \
        / (p.leaf_capc / p.plant_dtime + Kl)


# ---------------------------------------------------------------------------
# residual  F(x) per dof (GoveqnPhotosynthesis.F90:130-257)
# ---------------------------------------------------------------------------

def residual(cfg: PsyConfig, p: PsyParams, bc: Biochem, sd: SoilDerived,
             x: jnp.ndarray, bounded: jnp.ndarray) -> jnp.ndarray:
    """F(x): x is [n, ndof] (ci for BB/Medlyn, gs otherwise)."""
    gst = cfg.gstype
    if gst in (SCM_BBERRY, SCM_MEDLYN):
        ci = x[:, 0]
        out = semi_empirical(cfg, p, bc, ci)
        F = jnp.where(out.an > 0.0,
                      out.an - out.gleaf_c * (p.cair - ci), 0.0)
        F = jnp.where(bounded[:, 0], F, 0.0)
        return F[:, None]
    if gst in (SCM_WUE, SCM_MANZONI11):
        gs = x[:, 0]
        lo = an_from_gs(cfg, p, bc, gs - GS_DELTA_WUE)
        hi = an_from_gs(cfg, p, bc, gs)
        factor = jnp.ones_like(gs)
        if gst == SCM_MANZONI11:
            factor = jnp.exp(p.manzoni11_beta * p.leaf_psi)
        F = (hi.an - lo.an) - p.iota * factor * GS_DELTA_WUE * hi.vpd
        return jnp.where(bounded[:, 0], F, 0.0)[:, None]
    if gst == SCM_OSMWANG:
        gs = x[:, 0]
        lo = an_from_gs(cfg, p, bc, gs - GS_DELTA_WUE)
        hi = an_from_gs(cfg, p, bc, gs)
        et_lo = (bc.esat - p.eair) / p.pref * lo.gleaf_w * p.fdry
        et_hi = (bc.esat - p.eair) / p.pref * hi.gleaf_w * p.fdry
        etc = critical_flow(p, sd)
        cost_lo = lo.an * et_lo / etc
        cost_hi = hi.an * et_hi / etc
        den = et_hi - et_lo
        F = (hi.an - lo.an) / den - (cost_hi - cost_lo) / den
        return jnp.where(bounded[:, 0], F, 0.0)[:, None]
    # BONAN14 / MODIFIED_BONAN14: dof0 = wue residual, dof1 = hydraulics
    gs_w, gs_h = x[:, 0], x[:, 1]
    lo = an_from_gs(cfg, p, bc, gs_w - GS_DELTA_BONAN14)
    hi = an_from_gs(cfg, p, bc, gs_w)
    F_wue = (hi.an - lo.an) - p.iota * GS_DELTA_BONAN14 * hi.vpd
    gl_h = 1.0 / (1.0 / p.gbv + 1.0 / gs_h)
    etflx = (bc.esat - p.eair) / p.pref * gl_h * p.fdry
    if gst == SCM_BONAN14:
        dpsi = change_in_psi(p, sd, etflx)
        F_hyd = p.leaf_psi + dpsi - p.leaf_minlwp
    else:
        psi_new = psi_modified_bonan14(p, sd, etflx)
        F_hyd = psi_new - p.leaf_minlwp
    F = jnp.stack([F_wue, F_hyd], axis=1)
    return jnp.where(bounded, F, 0.0)


def jacobian_diag(cfg: PsyConfig, p: PsyParams, bc: Biochem,
                  sd: SoilDerived, x: jnp.ndarray,
                  bounded: jnp.ndarray) -> jnp.ndarray:
    """FD diagonal (GoveqnPhotosynthesis.F90:261-431): same perturbation
    sizes and whole-gs-array semantics as the reference."""
    gst = cfg.gstype
    if gst in (SCM_BBERRY, SCM_MEDLYN):
        ci_pert = -1.0e-7
        ci = x[:, 0]
        o1 = semi_empirical(cfg, p, bc, ci)
        o2 = semi_empirical(cfg, p, bc, ci - ci_pert)
        val = jnp.where(
            o1.an > 0.0,
            (o1.an - o2.an) / ci_pert
            - (o1.gleaf_c - o2.gleaf_c) / ci_pert * (p.cair - ci)
            + o1.gleaf_c, 1.0)
        return jnp.where(bounded[:, 0], val, 1.0)[:, None]
    if gst in (SCM_WUE, SCM_MANZONI11, SCM_OSMWANG):
        gs_pert = -1.0e-5
        F1 = residual(cfg, p, bc, sd, x, bounded)
        F2 = residual(cfg, p, bc, sd, x - gs_pert, bounded)
        val = (F1 - F2) / gs_pert
        return jnp.where(bounded, val, 1.0)
    # BONAN14 family: dof0 FD with the whole-gs-array perturbation
    # (both dofs shifted to gs0-pert), dof1 diag = 1.0 (:410-431)
    gs_pert = -1.0e-8
    F1 = residual(cfg, p, bc, sd, x, bounded)
    x2 = jnp.stack([x[:, 0] - gs_pert, x[:, 0] - gs_pert], axis=1)
    F2 = residual(cfg, p, bc, sd, x2, bounded)
    d0 = (F1[:, 0] - F2[:, 0]) / gs_pert
    d0 = jnp.where(bounded[:, 0], d0, 1.0)
    d1 = jnp.ones_like(d0)
    return jnp.stack([d0, d1], axis=1)


# ---------------------------------------------------------------------------
# boundedness pre-check (PhotosynthesisDetermineIfSolutionIsBounded
# :1632-1715) — pure, returns (bounded, x_mutated)
# ---------------------------------------------------------------------------

def determine_bounded(cfg: PsyConfig, p: PsyParams, bc: Biochem,
                      sd: SoilDerived, x0: jnp.ndarray):
    gst = cfg.gstype
    ones = jnp.ones_like(x0, bool)
    if gst in (SCM_WUE, SCM_MANZONI11, SCM_OSMWANG):
        hi = jnp.full_like(x0, GS_MAX_WUE)
        lo = jnp.full_like(x0, GS_MIN_WUE)
        r2 = residual(cfg, p, bc, sd, hi, ones)
        r1 = residual(cfg, p, bc, sd, lo, ones)
        return r1 * r2 <= 0.0, x0
    if gst in (SCM_BONAN14, SCM_MODIFIED_BONAN14):
        hi = jnp.full_like(x0, GS_MAX_WUE)
        lo = jnp.full_like(x0, GS_MIN_BONAN14)
        r2 = residual(cfg, p, bc, sd, hi, ones)
        r1 = residual(cfg, p, bc, sd, lo, ones)
        any_cross = (jnp.minimum(r1[:, 0], r1[:, 1])
                     * jnp.minimum(r2[:, 0], r2[:, 1])) < 0.0
        b0 = any_cross & (r1[:, 0] * r2[:, 0] < 0.0)
        b1 = any_cross & (r1[:, 1] * r2[:, 1] < 0.0)
        return jnp.stack([b0, b1], axis=1), x0
    # BB / Medlyn: mutates ci (the leftover value feeds unbounded outputs)
    frac = 0.7 if cfg.c3psn == PATHWAY_C3 else 0.4
    ci1 = frac * p.cair
    o1 = semi_empirical(cfg, p, bc, ci1)
    neg1 = o1.an < 0.0
    ci2 = jnp.where(neg1, ci1, 0.99 * p.cair)
    o2 = semi_empirical(cfg, p, bc, ci2)
    neg2 = o2.an < 0.0
    bounded = ~(neg1 | neg2)
    return bounded[:, None], ci2[:, None]


# ---------------------------------------------------------------------------
# batched Newton (SNES emulation with per-cell stopping)
# ---------------------------------------------------------------------------

class SolveResult(NamedTuple):
    x: jnp.ndarray            # [n, ndof] converged primary unknowns
    converged: jnp.ndarray    # [n] bool
    iters: jnp.ndarray        # [n] int32
    fnorm: jnp.ndarray        # [n] final residual norm


def solve(cfg: PsyConfig, p: PsyParams, x0: jnp.ndarray,
          rtol: float = 1e-8, stol: float = 1e-10, atol: float = 1e-50,
          max_it: int = 50) -> Tuple[SolveResult, jnp.ndarray]:
    """Masked batched Newton over all cells.

    The serial path stops on the *global* SNES norms (the golden files
    record that iterate); the batched production path applies the same
    tests per cell so one stiff lane cannot stall the batch.  Returns
    (result, bounded mask).
    """
    bc = biochem_rates(cfg, p)
    sd = soil_resistance(p)
    bounded, x0 = determine_bounded(cfg, p, bc, sd, x0)

    F0 = residual(cfg, p, bc, sd, x0, bounded)
    fnorm0 = jnp.sqrt((F0 * F0).sum(axis=1))
    ttol = fnorm0 * rtol
    done0 = fnorm0 < atol

    def cond(state):
        x, F, fnorm, done, it = state
        return (~done).any() & (it < max_it)

    def body(state):
        x, F, fnorm, done, it = state
        diag = jacobian_diag(cfg, p, bc, sd, x, bounded)
        dx = -F / diag
        dx = jnp.where(done[:, None], 0.0, dx)
        xn = x + dx
        Fn = residual(cfg, p, bc, sd, xn, bounded)
        fn = jnp.sqrt((Fn * Fn).sum(axis=1))
        newly = (fn <= ttol) | (jnp.sqrt((dx * dx).sum(axis=1))
                                < stol * jnp.sqrt((xn * xn).sum(axis=1)))
        return xn, Fn, fn, done | newly, it + 1

    x, F, fnorm, done, it = lax.while_loop(
        cond, body, (x0, F0, fnorm0, done0, jnp.zeros((), jnp.int32)))
    return SolveResult(x=x, converged=done, iters=jnp.broadcast_to(
        it, fnorm.shape), fnorm=fnorm), bounded


class PostSolve(NamedTuple):
    an: jnp.ndarray
    ag: jnp.ndarray
    gs: jnp.ndarray
    ci: jnp.ndarray
    gleaf_c: jnp.ndarray
    gleaf_w: jnp.ndarray


def post_solve(cfg: PsyConfig, p: PsyParams, x: jnp.ndarray,
               bounded: jnp.ndarray) -> PostSolve:
    """PhotosynthesisPostSolve (:1745-1826): pick the solution dof and
    recompute the output chain at the converged unknowns."""
    bc = biochem_rates(cfg, p)
    gst = cfg.gstype
    if gst in (SCM_BBERRY, SCM_MEDLYN):
        ci = x[:, 0]
        out = semi_empirical(cfg, p, bc, ci)
        return PostSolve(an=out.an, ag=out.ag, gs=out.gs, ci=ci,
                         gleaf_c=out.gleaf_c, gleaf_w=out.gleaf_w)
    if gst in (SCM_WUE, SCM_MANZONI11, SCM_OSMWANG):
        gs = x[:, 0]
        out = an_from_gs(cfg, p, bc, gs)
        gl_c = 1.0 / (1.0 / p.gbc + 1.6 / gs)
        gl_w = 1.0 / (1.0 / p.gbv + 1.0 / gs)
        return PostSolve(an=out.an, ag=out.ag, gs=gs, ci=out.ci,
                         gleaf_c=gl_c, gleaf_w=gl_w)
    both = bounded[:, 0] & bounded[:, 1]
    pick_hyd = both & (x[:, 1] <= x[:, 0])
    gs = jnp.where(pick_hyd, x[:, 1], x[:, 0])
    out = an_from_gs(cfg, p, bc, gs)
    gl_c = 1.0 / (1.0 / p.gbc + 1.6 / gs)
    gl_w = 1.0 / (1.0 / p.gbv + 1.0 / gs)
    return PostSolve(an=out.an, ag=out.ag, gs=gs, ci=out.ci,
                     gleaf_c=gl_c, gleaf_w=gl_w)


def solve_global(cfg: PsyConfig, p: PsyParams, x0: jnp.ndarray,
                 rtol: float = 1e-8, stol: float = 1e-10, atol: float = 1e-50,
                 max_it: int = 50):
    """Global-norm Newton replicating the serial facade solve's iteration
    map (PhotosynthesisSoE.step_dt: one SNES solve over ALL cells with
    SNESConvergedDefault on the global ||F||, matching the reference's
    single PETSc SNESSolve per ml_model substep,
    ``soe/SystemOfEquationsPhotosynthesisType.F90:154-249``).

    Returns (SolveResult with scalar-broadcast convergence data, bounded,
    reason, x_prev) — ``reason`` uses the PETSc codes (2=FNORM_ABS,
    3=FNORM_RELATIVE, 4=SNORM_RELATIVE, 0=not converged).  ``x_prev`` is
    the second-to-last iterate: the reference's BONAN14 FD Jacobian
    clobbers the whole gs array with dof-0's value at each Jacobian
    evaluation (GoveqnPhotosynthesis.F90:261-431's whole-array
    assignment), so UNBOUNDED dofs end the solve holding the previous
    iterate's dof-0 gs — needed for regression-exact auxvar writeback."""
    bc = biochem_rates(cfg, p)
    sd = soil_resistance(p)
    bounded, x0 = determine_bounded(cfg, p, bc, sd, x0)

    F0 = residual(cfg, p, bc, sd, x0, bounded)
    fnorm0 = jnp.sqrt((F0 * F0).sum())
    ttol = fnorm0 * rtol
    reason0 = jnp.where(fnorm0 < atol, 2, 0).astype(jnp.int32)

    def cond(state):
        x, xp, F, fnorm, reason, it = state
        return (reason == 0) & (it < max_it)

    def body(state):
        x, xp, F, fnorm, reason, it = state
        diag = jacobian_diag(cfg, p, bc, sd, x, bounded)
        dx = -F / diag
        xn = x + dx
        Fn = residual(cfg, p, bc, sd, xn, bounded)
        fn = jnp.sqrt((Fn * Fn).sum())
        r = jnp.where(fn <= ttol, 3, 0).astype(jnp.int32)
        snorm = jnp.sqrt((dx * dx).sum())
        xnorm = jnp.sqrt((xn * xn).sum())
        r = jnp.where((r == 0) & (snorm < stol * xnorm), 4, r) \
            .astype(jnp.int32)
        return xn, x, Fn, fn, r, it + 1

    x, x_prev, F, fnorm, reason, it = lax.while_loop(
        cond, body, (x0, x0, F0, fnorm0, reason0, jnp.zeros((), jnp.int32)))
    n = x.shape[0]
    res = SolveResult(x=x, converged=jnp.broadcast_to(reason > 0, (n,)),
                      iters=jnp.broadcast_to(it, (n,)),
                      fnorm=jnp.broadcast_to(fnorm, (n,)))
    return res, bounded, reason, x_prev


class CompiledPhotosynthesis:
    """A facade-built ``PhotosynthesisMPP`` frozen into the jitted
    batched Newton — the compiled driver of the ONE batched physics
    implementation (this module), which the canopy production pipeline
    consumes for its psy stage.

    Drop-in serial use (the standalone golden problems)::

        comp = compile_photosynthesis(mpp).install()
        converged, reason = mpp.soe.step_dt(0.0, 1)

    The Newton runs jitted on device; the output chain (PostSolve
    writeback into the auxvars for ``get_data``/regression output) reuses
    the serial auxvar evaluation at the converged unknowns, so outputs
    flow through the same code both paths.
    """

    def __init__(self, mpp):
        import jax
        self.mpp = mpp
        self.ge = mpp.soe.ge
        self.cfg, _ = params_from_auxvars(self.ge.avars)

        def _solve(p, x0):
            return solve_global(self.cfg, p, x0)
        self._jit = jax.jit(_solve)

    def install(self):
        self.mpp.soe.step_dt = self.step_dt
        return self

    def step_dt(self, dt, nstep=1):
        soe = self.mpp.soe
        av = self.ge.avars
        cfg, p = params_from_auxvars(av)
        assert cfg == self.cfg, "static config changed after compile"
        x0 = jnp.asarray(np.asarray(soe.soln, np.float64)
                         .reshape(av.n, av.ndof))
        res, bounded, reason, x_prev = self._jit(p, x0)
        reason = int(reason)
        converged = reason > 0
        soe.soln = np.asarray(res.x).reshape(-1)
        soe.soln_prev = soe.soln.copy()
        soe.cumulative_newton_iterations += int(res.iters[0])
        # PostSolve through the serial auxvar chain (identical output
        # plumbing for both drivers).  BONAN14 family: the reference's FD
        # Jacobian overwrites the WHOLE gs array with dof-0's value each
        # evaluation (whole-array assignment, GoveqnPhotosynthesis.F90:
        # 261-431), so unbounded dofs end the serial solve holding the
        # previous iterate's dof-0 gs — replicate before writeback.
        if av.gstype in (SCM_BONAN14, SCM_MODIFIED_BONAN14) \
                and int(res.iters[0]) > 0:
            nb = ~np.asarray(bounded)
            xp0 = np.asarray(x_prev)[:, 0]
            for d in range(av.ndof):
                av.gs[nb[:, d], d] = xp0[nb[:, d]]
        self.ge.save_primary(soe.soln)
        av.aux_var_compute()
        av.post_solve()
        if soe.metrics is not None:
            soe.metrics.record(step=nstep, dt=dt, converged=converged,
                               reason=reason,
                               newton_iterations=int(res.iters[0]),
                               fnorm=float(res.fnorm[0]))
        return converged, reason


def compile_photosynthesis(mpp) -> CompiledPhotosynthesis:
    """Freeze a fully-staged ``PhotosynthesisMPP`` into a compiled
    batched stepper (call after staging + determine_if_solution_is_bounded
    + initial condition)."""
    return CompiledPhotosynthesis(mpp)
