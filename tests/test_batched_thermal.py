"""Batched block-Thomas thermal solve (production path) vs the serial
GMRES+ILU(0) golden path on the 1-D MMS column problem."""
import numpy as np

from mpp_tpu.problems.thermal_mms import (run_thermal_mms_problem,
                                          STEADY_STATE_1D, _temperature)


def test_block_solver_matches_ksp_and_analytic():
    mpp, soln_ksp = run_thermal_mms_problem(STEADY_STATE_1D)

    # re-solve the identical staged system through the block path
    mpp.soe._block_tpl = None
    mpp.soe.pre_step_dt()
    ok = mpp.soe.step_dt(1.0, solver="block")
    assert ok
    soln_blk = mpp.soe.get_soln()

    np.testing.assert_allclose(soln_blk, soln_ksp, rtol=1e-6, atol=1e-6)

    # MMS: the exact sweep must beat/meet the suite's 1e-8 tolerance
    # against the analytic manufactured solution's discrete system answer
    ge = mpp.soe.goveqns[0]
    xc = np.asarray(ge.mesh.xc)
    T_analytic = np.asarray(_temperature(STEADY_STATE_1D, xc, ge.mesh.yc,
                                         ge.mesh.zc))
    # discretization error of the 100-cell mesh is ~0.03 K (the golden
    # baseline embeds the same discrete solution, which we match above)
    assert np.max(np.abs(soln_blk - T_analytic)) < 0.05
