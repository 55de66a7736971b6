"""Batched (jnp) multi-layer canopy: the production path.

Functional re-expression of ``models/mlc.py`` (itself a transcription of
``soe/SystemOfEquationsMLCType.F90`` and the three canopy GEs): the
coupled [T_air | q_air | T_sun... | T_shd...] system is block-tridiagonal
when unknowns are grouped per canopy level — every coupling in the 4-block
DMComposite fill (:333-455) stays within a level or reaches level k±1 —
so the PETSc GMRES+ILU(0) solve becomes an exact batched block-Thomas
sweep (``ops/block_thomas``), with canopy-air columns as the batch axis.

Block layout per level: m = 2 + 2*ntree rows
  row 0        = canopy-air temperature (Bonan eliminated-soil row at k=0)
  row 1        = canopy-air water vapor
  row 2+s      = leaf temperature, slot s (sun trees first, then shade)

The reference's assembly quirks are reproduced exactly (verified
entry-for-entry against the serial CSR assembly in
tests/test_batched_mlc.py): the air-row leaf off-diagonals index the
boundary conductances by GE rank (sun/shade) rather than tree slot
(``models/mlc.py:447-455, 511-525``), and the leaf GEs read the
last column's cpair (:244-246).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from mpp_tpu.constants import HVAP, MM_H2O
from mpp_tpu.ops.satvap import sat_vap
from mpp_tpu.ops.block_thomas import block_thomas

LAMBDA = HVAP * MM_H2O


class MLCBlockInputs(NamedTuple):
    """Staged (post-presolve) MLC state, batched over [ncair] columns.

    Shapes: [ncair] scalars-per-column, [ncair, nlev] air-cell fields,
    [ncair, nlev, nslots] leaf fields (nslots = 2*ntree, sun slots
    first), [ncair, nlev-1] internal-connection conductances.
    Level 0 is the soil cell of every column (mlc_meshes.F90)."""
    # primaries (staged from the previous solution)
    at_T: jnp.ndarray            # [ncair, nlev]
    av_q: jnp.ndarray            # [ncair, nlev]
    leaf_T: jnp.ndarray          # [ncair, nlev, nslots]
    # per-column scalars from the turbulence presolve
    cpair: jnp.ndarray           # [ncair]
    rhomol: jnp.ndarray          # [ncair]
    pref: jnp.ndarray            # [ncair]
    leaf_cpair: jnp.ndarray      # [] or [ncair] (reference: last column's)
    leaf_pref: jnp.ndarray
    # soil-surface properties (level 0)
    soil_rhg: jnp.ndarray        # [ncair]
    soil_rn: jnp.ndarray
    soil_tk: jnp.ndarray
    soil_dz: jnp.ndarray
    soil_res: jnp.ndarray
    soil_T: jnp.ndarray
    # leaf-slot fields on air cells
    gbh_air: jnp.ndarray         # [ncair, nlev, nslots]
    gbv_air: jnp.ndarray
    leaf_gs: jnp.ndarray
    leaf_fwet: jnp.ndarray
    leaf_fdry: jnp.ndarray
    leaf_fssh: jnp.ndarray
    leaf_dpai: jnp.ndarray
    # leaf-GE own fields
    leaf_gbh: jnp.ndarray        # [ncair, nlev, nslots]
    leaf_gbv: jnp.ndarray
    leaf_rn: jnp.ndarray
    leaf_cp: jnp.ndarray
    # aerodynamic conductances + top BC
    conn_ga: jnp.ndarray         # [ncair, nlev-1]
    bc_ga: jnp.ndarray           # [ncair]
    bc_T: jnp.ndarray
    bc_q: jnp.ndarray
    vol_air: jnp.ndarray         # [] cell volume (dz_cair)


def inputs_from_mpp(mpp) -> MLCBlockInputs:
    """Convert a staged serial ``MLCMPP`` (after ``pre_solve`` +
    ``get_from_soe_auxvars_cturb``) into batched block inputs."""
    nc, nlev, nt = mpp.ncair, mpp.nlev, mpp.ntree
    ns = 2 * nt
    f = lambda a, shape: jnp.asarray(np.asarray(a, np.float64).reshape(shape))

    assert bool(np.all(mpp.at_is_soil.reshape(nc, nlev)[:, 0])), \
        "level 0 must be the soil cell"

    # leaf GE cell (icair, itree, k) -> [ncair, nlev, slot]
    leaf_T = np.zeros((nc, nlev, ns))
    leaf_own = {k: np.zeros((nc, nlev, ns))
                for k in ("gbh", "gbv", "rn", "cp")}
    for r in (0, 1):
        ge = mpp.leaf[r]
        vals = ge["T"].reshape(nc, nt, nlev)
        for it in range(nt):
            leaf_T[:, :, r * nt + it] = vals[:, it, :]
            for k in leaf_own:
                leaf_own[k][:, :, r * nt + it] = \
                    ge[k].reshape(nc, nt, nlev)[:, it, :]

    return MLCBlockInputs(
        at_T=f(mpp.at_T, (nc, nlev)),
        av_q=f(mpp.av_q, (nc, nlev)),
        leaf_T=jnp.asarray(leaf_T),
        cpair=f(mpp.at_cpair.reshape(nc, nlev)[:, 0], (nc,)),
        rhomol=f(mpp.at_rhomol.reshape(nc, nlev)[:, 0], (nc,)),
        pref=f(mpp.at_pref.reshape(nc, nlev)[:, 0], (nc,)),
        leaf_cpair=jnp.asarray(float(mpp.leaf[0]["cpair"][0])),
        leaf_pref=jnp.asarray(float(mpp.leaf[0]["pref"][0])),
        soil_rhg=f(mpp.at_soil_rhg.reshape(nc, nlev)[:, 0], (nc,)),
        soil_rn=f(mpp.at_soil_rn.reshape(nc, nlev)[:, 0], (nc,)),
        soil_tk=f(mpp.at_soil_tk.reshape(nc, nlev)[:, 0], (nc,)),
        soil_dz=f(mpp.at_soil_dz.reshape(nc, nlev)[:, 0], (nc,)),
        soil_res=f(mpp.at_soil_resis.reshape(nc, nlev)[:, 0], (nc,)),
        soil_T=f(mpp.at_soil_T.reshape(nc, nlev)[:, 0], (nc,)),
        gbh_air=f(mpp.at_gbh, (nc, nlev, ns)),
        gbv_air=f(mpp.av_gbv, (nc, nlev, ns)),
        leaf_gs=f(mpp.at_leaf_gs, (nc, nlev, ns)),
        leaf_fwet=f(mpp.at_leaf_fwet, (nc, nlev, ns)),
        leaf_fdry=f(mpp.at_leaf_fdry, (nc, nlev, ns)),
        leaf_fssh=f(mpp.at_leaf_fssh, (nc, nlev, ns)),
        leaf_dpai=f(mpp.at_leaf_dpai, (nc, nlev, ns)),
        leaf_gbh=jnp.asarray(leaf_own["gbh"]),
        leaf_gbv=jnp.asarray(leaf_own["gbv"]),
        leaf_rn=jnp.asarray(leaf_own["rn"]),
        leaf_cp=jnp.asarray(leaf_own["cp"]),
        conn_ga=f(mpp.at_conn_ga, (nc, nlev - 1)),
        bc_ga=f(mpp.at_bc_ga, (nc,)),
        bc_T=f(mpp.at_bc_T, (nc,)),
        bc_q=f(mpp.av_bc_q, (nc,)),
        vol_air=jnp.asarray(float(mpp._compute_vol_air()[0])),
    )


def _soil_coeffs(inp: MLCBlockInputs):
    """Eliminated ground-surface row coefficients (Bonan 2019 eqns
    16.86-16.88; GoveqnCanopyAirTemperatureType.F90:594-730)."""
    ga0 = inp.conn_ga[:, 0]
    gsw = 1.0 / inp.soil_res * inp.rhomol
    gs0 = gsw * ga0 / (gsw + ga0)
    esat0, desat0 = sat_vap(inp.at_T[:, 0])
    qsat0 = esat0 / inp.pref
    dqsat0 = desat0 / inp.pref
    rhg = inp.soil_rhg
    gamma0 = (inp.cpair * ga0 + LAMBDA * rhg * gs0 * dqsat0
              + inp.soil_tk / inp.soil_dz)
    alpha0 = inp.cpair * ga0 / gamma0
    beta0 = LAMBDA * gs0 / gamma0
    delta0 = (inp.soil_rn
              - LAMBDA * rhg * gs0 * (qsat0 - dqsat0 * inp.at_T[:, 0])
              + inp.soil_tk / inp.soil_dz * inp.soil_T) / gamma0
    return ga0, gs0, qsat0, dqsat0, alpha0, beta0, delta0


def assemble(inp: MLCBlockInputs, dt):
    """Block-tridiagonal (L, D, U, b) for one KSP step.

    Returns blocks [ncair, nlev, m, m] and RHS [ncair, nlev, m]."""
    nc, nlev, ns = inp.leaf_dpai.shape
    nt = ns // 2
    m = 2 + ns
    dtype = inp.at_T.dtype
    L = jnp.zeros((nc, nlev, m, m), dtype)
    D = jnp.zeros((nc, nlev, m, m), dtype)
    U = jnp.zeros((nc, nlev, m, m), dtype)
    b = jnp.zeros((nc, nlev, m), dtype)

    ga0, gs0, qsat0, dqsat0, alpha0, beta0, delta0 = _soil_coeffs(inp)
    # rank index of each slot (sun GE=0, shade GE=1) for the air-row
    # off-diagonal conductance quirk
    rank_of_slot = jnp.asarray([0] * nt + [1] * nt)

    dpai_pos = inp.leaf_dpai > 0.0
    cp_col = inp.cpair[:, None]          # [nc, 1]
    rho_col = inp.rhomol[:, None]
    pref_col = inp.pref[:, None]

    # ===== air temperature rows (row 0) =====================================
    # soil row (level 0): identity + eliminated-surface couplings
    D = D.at[:, 0, 0, 0].set(1.0)
    U = U.at[:, 0, 0, 0].set(-alpha0)
    U = U.at[:, 0, 0, 1].set(-beta0)
    b = b.at[:, 0, 0].set(delta0)
    D = D.at[:, 1, 0, 0].add(-alpha0 * ga0)
    D = D.at[:, 1, 0, 1].add(-beta0 * ga0)
    b = b.at[:, 1, 0].add(delta0 * ga0)

    # non-soil accumulation + leaf sensible-heat diagonal
    acc_T = rho_col / dt * inp.vol_air
    leaf_diag = jnp.where(dpai_pos,
                          2.0 * inp.gbh_air * inp.leaf_fssh * inp.leaf_dpai,
                          0.0).sum(-1)
    D = D.at[:, 1:, 0, 0].add(acc_T + leaf_diag[:, 1:])
    b = b.at[:, 1:, 0].add(acc_T * inp.at_T[:, 1:])

    # internal connections (k <-> k+1), conductance ga
    ga = inp.conn_ga
    # upper cell (k>0) of connection k: +ga diag, -ga to k+1
    D = D.at[:, 1:-1, 0, 0].add(ga[:, 1:])
    U = U.at[:, 1:-1, 0, 0].add(-ga[:, 1:])
    # lower cell (k+1) of every connection: +ga diag; -ga to k if k>0
    D = D.at[:, 1:, 0, 0].add(ga)
    L = L.at[:, 2:, 0, 0].add(-ga[:, 1:])

    # top boundary
    D = D.at[:, -1, 0, 0].add(inp.bc_ga)
    b = b.at[:, -1, 0].add(inp.bc_ga * inp.bc_T)

    # off-diagonal to leaf temperatures (conductance indexed by GE rank,
    # not slot — models/mlc.py:447-455)
    gbh_rank = inp.gbh_air[:, :, rank_of_slot]
    offT = jnp.where(dpai_pos,
                     -2.0 * gbh_rank * inp.leaf_fssh * inp.leaf_dpai, 0.0)
    D = D.at[:, 1:, 0, 2:].add(offT[:, 1:])

    # ===== air vapor rows (row 1) ===========================================
    D = D.at[:, 0, 1, 1].set(1.0)
    b = b.at[:, 0, 1].set(inp.av_q[:, 0])
    # (vapor GE reads the same staged state, so its gs0/alpha0/beta0/delta0
    # coincide with the temperature GE's)
    rhg = inp.soil_rhg
    D = D.at[:, 1, 1, 1].add(-gs0 * dqsat0 * rhg * beta0)
    D = D.at[:, 1, 1, 0].add(-rhg * dqsat0 * gs0 * alpha0)
    b = b.at[:, 1, 1].add(gs0 * rhg * (qsat0 + dqsat0
                                       * (delta0 - inp.at_T[:, 0])))

    esat_l, desat_l = sat_vap(inp.leaf_T)
    qsat_l = esat_l / pref_col[..., None]
    dqsat_l = desat_l / pref_col[..., None]
    gleaf = inp.leaf_gs * inp.gbv_air / (inp.leaf_gs + inp.gbv_air)
    gleaf_et = (gleaf * inp.leaf_fdry + inp.gbv_air * inp.leaf_fwet) \
        * inp.leaf_fssh * inp.leaf_dpai
    gleaf_et = jnp.where(dpai_pos, gleaf_et, 0.0)

    acc_q = rho_col / dt * inp.vol_air
    D = D.at[:, 1:, 1, 1].add(acc_q + gleaf_et.sum(-1)[:, 1:])
    b = b.at[:, 1:, 1].add(acc_q * inp.av_q[:, 1:]
                           + jnp.where(dpai_pos, gleaf_et
                                       * (qsat_l - dqsat_l * inp.leaf_T),
                                       0.0).sum(-1)[:, 1:])

    # connections: soil-end connections use the series surface conductance
    gsw = 1.0 / inp.soil_res * inp.rhomol
    ga_v0 = gsw * ga[:, 0] / (gsw + ga[:, 0])
    D = D.at[:, 1:-1, 1, 1].add(ga[:, 1:])
    U = U.at[:, 1:-1, 1, 1].add(-ga[:, 1:])
    D = D.at[:, 1, 1, 1].add(ga_v0)
    D = D.at[:, 2:, 1, 1].add(ga[:, 1:])
    L = L.at[:, 2:, 1, 1].add(-ga[:, 1:])

    D = D.at[:, -1, 1, 1].add(inp.bc_ga)
    b = b.at[:, -1, 1].add(inp.bc_ga * inp.bc_q)

    # off-diagonal to leaf temperatures (rank-indexed gbv quirk,
    # models/mlc.py:511-525)
    gbv_rank = inp.gbv_air[:, :, rank_of_slot]
    gleaf_r = inp.leaf_gs * gbv_rank / (inp.leaf_gs + gbv_rank)
    gleaf_et_r = (gleaf_r * inp.leaf_fdry + gbv_rank * inp.leaf_fwet) \
        * inp.leaf_fssh * inp.leaf_dpai
    offq = jnp.where(dpai_pos, -dqsat_l * gleaf_et_r, 0.0)
    D = D.at[:, 1:, 1, 2:].add(offq[:, 1:])

    # ===== leaf temperature rows (rows 2+s) =================================
    lf_dpai_pos = inp.leaf_dpai > 0.0     # leaf GE dpai == air-staged dpai
    esat_o, desat_o = sat_vap(inp.leaf_T)
    dqsat_o = desat_o / inp.leaf_pref
    qsat_o = esat_o / inp.leaf_pref
    gleaf_own = inp.leaf_gs * inp.leaf_gbv / (inp.leaf_gs + inp.leaf_gbv)
    gleaf_et_own = gleaf_own * inp.leaf_fdry + inp.leaf_gbv * inp.leaf_fwet

    diag_leaf = (inp.leaf_cp / dt + 2.0 * inp.leaf_cpair * inp.leaf_gbh
                 + LAMBDA * dqsat_o * gleaf_et_own)
    rhs_leaf = (inp.leaf_rn + inp.leaf_cp / dt * inp.leaf_T
                - LAMBDA * (qsat_o - dqsat_o * inp.leaf_T) * gleaf_et_own)
    slots = jnp.arange(ns)
    D = D.at[:, :, 2 + slots, 2 + slots].set(
        jnp.where(lf_dpai_pos, diag_leaf, 1.0))
    D = D.at[:, :, 2:, 0].set(
        jnp.where(lf_dpai_pos, -2.0 * inp.leaf_cpair * inp.leaf_gbh, 0.0))
    D = D.at[:, :, 2:, 1].set(
        jnp.where(lf_dpai_pos, -LAMBDA * gleaf_et_own, 0.0))
    b = b.at[:, :, 2:].set(jnp.where(lf_dpai_pos, rhs_leaf, 0.0))

    return L, D, U, b


def step(inp: MLCBlockInputs, dt):
    """One KSP step: assemble + exact block-Thomas solve.

    Returns the new state x [ncair, nlev, m] (rows: T_air, q_air,
    leaf slots)."""
    L, D, U, b = assemble(inp, dt)
    return block_thomas(L, D, U, b)
