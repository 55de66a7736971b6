"""Standalone photosynthesis problem (the `photosynthesis` suite).

Reimplements ``src/driver/standalone/photosynthesis/``: a 93-level canopy
column (nz_cair=92), one SNES solve of the per-leaf stomatal system with
leaf temperature ramping 11C..34C up the canopy
(photosynthesis_parameters.F90:58-132), pathway/stomatal model selected by
namelist (photosynthesis_problem.F90:80-166).
"""
from __future__ import annotations

import numpy as np

from mpp_tpu.constants import MPPType, TFRZ, MeshType as MeshKind
from mpp_tpu.dtypes.mesh import Mesh
from mpp_tpu.models import photosynthesis as ph
from mpp_tpu.io.regression import RegressionWriter

PATHWAYS = {"c3": ph.PATHWAY_C3, "c4": ph.PATHWAY_C4}
SCMS = {"ball-berry": ph.SCM_BBERRY, "medlyn": ph.SCM_MEDLYN,
        "wue": ph.SCM_WUE, "bonan14": ph.SCM_BONAN14}

NZ_CAIR = 92


def _canopy_mesh(ncair=1, ntree=1, nz_cair=NZ_CAIR, z_cair=46.0):
    """photosynthesis_meshes.F90:39-180 (connections unused by this GE)."""
    ncells = (nz_cair + 1) * ncair * ntree
    dz_cair = z_cair / nz_cair
    zc = np.zeros(ncells)
    icell = 0
    for _ in range(ncair * ntree):
        for k in range(nz_cair + 1):
            if k == 0:
                zc[icell] = 0.0
            elif k == 1:
                zc[icell] = dz_cair / 2.0
            else:
                zc[icell] = zc[icell - 1] + dz_cair
            icell += 1
    mesh = Mesh(name="Canopy Air", itype=0,
                orientation=int(MeshKind.AGAINST_GRAVITY),
                ncells_local=ncells, ncells_ghost=0, nlev=nz_cair + 1,
                xc=np.zeros(ncells), yc=np.zeros(ncells), zc=zc,
                dx=np.ones(ncells), dy=np.ones(ncells),
                dz=np.full(ncells, dz_cair), area_xy=np.ones(ncells),
                is_active=np.ones(ncells, bool))
    mesh.compute_volume()
    return mesh


def _set_soil_parameters(av: ph.PhotosynthesisAuxVars):
    """set_soil_parameters (photosynthesis_parameters.F90:135-187)."""
    theta_sat = [0.395, 0.410, 0.435, 0.485, 0.451, 0.420, 0.477, 0.476,
                 0.426, 0.492, 0.482]
    psi_sat = [-121.0, -90.0, -218.0, -786.0, -478.0, -299.0, -356.0,
               -630.0, -153.0, -490.0, -405.0]
    b = [4.05, 4.38, 4.90, 5.30, 5.39, 7.12, 7.75, 8.52, 10.40, 10.40, 11.40]
    k_sat = [1.056, 0.938, 0.208, 0.0432, 0.0417, 0.0378, 0.0102, 0.0147,
             0.0130, 0.0062, 0.0077]
    texture = 5 - 1
    av.set_soil(11)
    dz = np.array([0.050, 0.050, 0.100, 0.100, 0.200, 0.200, 0.200, 0.300,
                   0.400, 0.400, 0.500])
    # NOTE: the reference initializes dz with single-precision literals
    # (0.050 etc. without d0, photosynthesis_parameters.F90:146-156)
    dz = np.float64(np.float32(dz))
    av.soil_dz[:] = dz
    # beta_param is also a single-precision literal (ibid:158)
    beta = float(np.float64(np.float32(0.90)))
    rootfr = np.zeros(11)
    z2 = 0.0
    for j in range(11):
        if j == 0:
            z2 = dz[j] * 100.0
            rootfr[j] = 1.0 - beta ** z2
        else:
            z1 = z2
            z2 = z1 + dz[j] * 100.0
            rootfr[j] = beta ** z1 - beta ** z2
    av.soil_rootfr[:] = rootfr
    av.soil_watsat[:] = theta_sat[texture]
    av.soil_hksat[:] = k_sat[texture] * 10.0 / 60.0
    av.soil_bsw[:] = b[texture]
    av.soil_h2osoi_vol[:] = 0.5 * theta_sat[texture]
    av.soil_psi_sat[:] = psi_sat[texture]
    av.soil_psi[:] = psi_sat[texture] * (0.5) ** (-b[texture])


def run_photosynthesis_problem(pathway="c4", scm="medlyn",
                               ncair=1, ntree=1, compiled=False):
    """``compiled=True`` routes the SNES solve through the jitted batched
    Newton (batched/photosynthesis.compile_photosynthesis) instead of the
    serial host iteration — same physics chain, batched driver."""
    c3psn = PATHWAYS[pathway]
    gstype = SCMS[scm]
    nz = NZ_CAIR

    mpp = ph.PhotosynthesisMPP()
    mpp.set_name("Photosynthesis model")
    mpp.set_id(MPPType.PHOTOSYNTHESIS_SNES)
    mpp.set_num_meshes(1)
    mpp.add_mesh(_canopy_mesh(ncair, ntree, nz))
    mpp.add_goveqn()
    if gstype == ph.SCM_BONAN14:
        mpp.set_dofs_for_goveqn(1, 2)
    mpp.allocate_auxvars(c3psn, gstype)
    mpp.setup_problem()

    # set_parameters (photosynthesis_parameters.F90:20-132)
    av = mpp.soe.ge.avars
    tau = rho = 0.1
    esat_25C, _ = ph.sat_vap_np(np.array(273.15 + 25.0))
    tair = TFRZ + 25.0
    relhum = 80.0
    esat_tair, _ = ph.sat_vap_np(np.array(tair))
    eair = esat_tair * relhum / 100.0
    vpd_tleaf = esat_25C - eair

    n = av.n
    k = np.tile(np.arange(1, nz + 2), ncair * ntree)
    av.colim = 1
    av.cair[:] = 380.0
    av.o2ref[:] = 0.209 * 1000.0
    av.apar[:] = 2000.0 * (1.0 - rho - tau)
    av.tleaf[:] = TFRZ + 11.0 + 0.25 * (k - 1)
    av.gbv[:] = 2.224407920268566
    av.gbc[:] = 1.637448199187622
    esat_cur, _ = ph.sat_vap_np(av.tleaf)
    if gstype in (ph.SCM_MEDLYN, ph.SCM_WUE):
        av.eair[:] = esat_cur - vpd_tleaf
    else:
        av.eair[:] = esat_cur * relhum / 100.0
    av.btran[:] = 1.0
    av.dpai[:] = 1.0
    av.root_biomass[:] = 500.0
    av.root_radius[:] = 0.29e-3
    av.root_density[:] = 0.31e6
    av.root_resist[:] = 25.0
    _set_soil_parameters(av)
    av.leaf_psi[:] = -1.5
    av.leaf_height[:] = 15.0
    av.leaf_capc[:] = 2500.0
    av.leaf_minlwp[:] = -2.0
    av.leaf_lai[:] = 500.0
    av.k_stem2leaf[:] = 4.0
    av.determine_if_solution_is_bounded()

    # set_initial_condition (photosynthesis_problem.F90:221-247)
    if gstype in (ph.SCM_BBERRY, ph.SCM_MEDLYN):
        mpp.soe.soln[:] = 0.9 * 380.0
    else:
        mpp.soe.soln[:] = 0.002

    if compiled:
        from mpp_tpu.batched.photosynthesis import compile_photosynthesis
        compile_photosynthesis(mpp).install()

    converged, reason = mpp.soe.step_dt(0.0, 1)
    assert converged, f"photosynthesis SNES diverged (reason {reason})"
    return mpp


def output_regression(mpp, filename_base, num_cells):
    """output_regression_photosynthesis_problem
    (photosynthesis_problem.F90:250-299): ci per dof per cell."""
    ge = mpp.soe.ge
    ci = ge.avars.ci[:ge.mesh.ncells_local].reshape(-1)
    w = RegressionWriter(filename_base, num_cells)
    w.write_data("ci", "general", ci)
    w.close()
    return w.filename
