"""Batched block-tridiagonal radiation solve (production path) vs the
serial GMRES+ILU(0) golden path and the exact dense solution."""
import numpy as np
import pytest

from mpp_tpu.problems.canopy_radiation import (run_shortwave_problem,
                                               run_longwave_problem)


@pytest.mark.parametrize("runner,ncair", [
    (run_shortwave_problem, 1), (run_longwave_problem, 1),
    (run_shortwave_problem, 3), (run_longwave_problem, 3),
])
def test_block_solve_matches_dense_and_ksp(runner, ncair):
    mpp = runner(ncair=ncair)
    ge = mpp.goveqns[0]
    Iup_ksp = np.asarray(ge.Iup).copy()
    Idn_ksp = np.asarray(ge.Idn).copy()

    # exact dense solve of the identical COO system
    r, c = ge.coo_coords()
    vals = np.asarray(ge.matrix_values())
    b = np.asarray(ge.rhs())
    n = ge.mesh.ncells_local * ge.dof
    A = np.zeros((n, n))
    np.add.at(A, (r, c), vals)
    x_exact = np.linalg.solve(A, b)

    ok, _ = mpp.step_dt(300.0, solver="block")
    assert ok
    x_block = np.zeros(n)
    if ge.dof == 4:  # shortwave cell layout: [Iup_b0, Idn_b0, Iup_b1, Idn_b1]
        x_block = np.stack([np.asarray(ge.Iup), np.asarray(ge.Idn)],
                           axis=2).reshape(-1)
    else:
        x_block = np.stack([np.asarray(ge.Iup), np.asarray(ge.Idn),
                            np.asarray(ge.Iabs)], axis=1).reshape(-1)

    np.testing.assert_allclose(x_block, x_exact, rtol=1e-10, atol=1e-10)
    # GMRES stops at its relative tolerance; the exact sweep is at least
    # as accurate
    np.testing.assert_allclose(np.asarray(ge.Iup), Iup_ksp,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ge.Idn), Idn_ksp,
                               rtol=1e-5, atol=1e-5)


def test_block_template_rejects_cross_column_coupling():
    from mpp_tpu.ops.block_structure import BlockTridiagTemplate
    with pytest.raises(ValueError):
        BlockTridiagTemplate(2, 4, 1, rows=np.array([0]), cols=np.array([4]))
    with pytest.raises(ValueError):
        BlockTridiagTemplate(1, 8, 1, rows=np.array([0]), cols=np.array([2]))
