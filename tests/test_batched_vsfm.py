"""Batched-column VSFM (batched path): physics consistency + sharding.

Checks the batched f64 solver against the serial regression-grade VSFM
solve on the celia1990 configuration (constant density in the batched
path, so comparison uses a constant-density serial run), plus the
tridiagonal solver and the multichip dry run on the virtual CPU mesh.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mpp_tpu.ops.tridiag import thomas, tridiag_matvec


def test_thomas_matches_dense():
    rng = np.random.default_rng(0)
    b, n = 7, 33
    dl = rng.uniform(0.1, 0.3, (b, n))
    du = rng.uniform(0.1, 0.3, (b, n))
    d = rng.uniform(1.0, 2.0, (b, n))
    rhs = rng.normal(size=(b, n))
    x = np.asarray(thomas(jnp.asarray(dl), jnp.asarray(d), jnp.asarray(du),
                          jnp.asarray(rhs)))
    y = np.asarray(tridiag_matvec(jnp.asarray(dl), jnp.asarray(d),
                                  jnp.asarray(du), jnp.asarray(x)))
    np.testing.assert_allclose(y, rhs, rtol=1e-10)


def test_batched_newton_converges_and_is_columnwise_independent():
    from mpp_tpu.models import vsfm_batched as vb

    nz, ncol = 50, 8
    params = vb.ColumnParams.uniform(nz, dtype=jnp.float64)
    P0 = jnp.full((ncol, nz), 3.5355e3, jnp.float64)
    # different BCs per column: solutions must differ per column but be
    # identical for identical columns
    bc_top = jnp.asarray(np.where(np.arange(ncol) % 2 == 0, 9.3991e4, 5.0e4))
    bc_bot = jnp.full((ncol,), 3.5355e3, jnp.float64)
    P = P0
    for _ in range(4):
        P, iters, done = vb.step_dt(P, 3600.0, bc_top, bc_bot, params)
    assert bool(jnp.all(done)), "some columns failed to converge"
    P = np.asarray(P)
    np.testing.assert_allclose(P[0], P[2], rtol=0, atol=0)
    np.testing.assert_allclose(P[1], P[3], rtol=0, atol=0)
    assert not np.allclose(P[0], P[1])
    # infiltration: top-cell pressure pulled toward the top BC
    assert P[0, -1] > P[1, -1] > 3.5355e3


def test_batched_matches_serial_vsfm_constant_density():
    """Batched-path solver vs the regression-grade serial VSFM on the
    same problem (constant density in both)."""
    from mpp_tpu.models import vsfm_batched as vb
    from mpp_tpu.problems.vsfm_celia1990 import run_vsfm_celia1990_problem
    from mpp_tpu.ops import eos
    from mpp_tpu.constants import AuxVarKind, Var

    nz = 40
    # serial run with constant density
    import mpp_tpu.problems.vsfm_celia1990 as prob
    mpp = None

    # build serial problem manually with DENSITY_CONSTANT
    from mpp_tpu.constants import (Cond, ConnKind, GEType, MPPType, Region,
                                   GRAVITY_CONSTANT)
    from mpp_tpu.dtypes.mesh import structured_mesh
    from mpp_tpu.models.richards import VSFMMPP
    from mpp_tpu import constants as C

    mpp = VSFMMPP()
    mpp.set_id(MPPType.VSFM_SNES_CLM)
    mesh = structured_mesh("col", 1.0, 1.0, 1.0, 1, 1, nz, ConnKind.IN_Z_DIR)
    mpp.add_mesh(mesh)
    ieqn = mpp.add_goveqn(GEType.RE, "RE")
    mpp.add_condition_in_goveqn(ieqn, Cond.BC, "top", "Pa", Cond.DIRICHLET,
                                region=Region.SOIL_TOP_CELLS)
    mpp.add_condition_in_goveqn(ieqn, Cond.BC, "bot", "Pa", Cond.DIRICHLET,
                                region=Region.SOIL_BOTTOM_CELLS)
    mpp.allocate_auxvars()
    mpp.setup_problem()
    porosity, lam, alpha, perm = 0.368, 0.5, 3.4257e-4, 8.3913e-12
    vish2o = 0.001002
    hksat = perm / vish2o * (C.DENH2O * C.GRAV_CLM) / 0.001
    shape = (1, nz)
    mpp.set_soils(np.ones(1, np.int64), np.full(shape, porosity),
                  np.full(shape, hksat), np.full(shape, 1 / lam),
                  np.full(shape, 1.0 / (alpha * GRAVITY_CONSTANT)),
                  np.full(shape, 0.2772), "van_genuchten",
                  eos.DENSITY_CONSTANT)
    mpp.restart(np.full(nz, 3.5355e3))
    mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 1, np.full(1, 9.3991e4))
    mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 2, np.full(1, 3.5355e3))
    ok, _ = mpp.soe.step_dt(3600.0, 1)
    assert ok
    P_serial = mpp.get_data(AuxVarKind.INTERNAL, Var.PRESSURE)

    # batched path: effective alpha matches VSFMMPPSetSoilsCLM's
    # sucsat round trip (alpha' = alpha*GRAVITY_CONSTANT/grav)
    alpha_eff = 1.0 / ((1.0 / (alpha * GRAVITY_CONSTANT)) * C.GRAV_CLM)
    perm_eff = hksat * vish2o / (C.DENH2O * C.GRAV_CLM) * 0.001
    params = vb.ColumnParams.uniform(nz, dtype=jnp.float64, alpha=alpha_eff,
                                     m=lam, sat_res=0.2772, perm=perm_eff,
                                     por=porosity)
    P0 = jnp.full((3, nz), 3.5355e3, jnp.float64)
    bc_top = jnp.full((3,), 9.3991e4, jnp.float64)
    bc_bot = jnp.full((3,), 3.5355e3, jnp.float64)
    P, iters, done = vb.step_dt(P0, 3600.0, bc_top, bc_bot, params,
                                rtol=1e-12, stol=1e-13, max_it=60)
    assert bool(jnp.all(done))
    # The serial path reproduces PETSc SNES stopping (stol=1e-10 on the
    # step), so its answer carries ~1e-5 relative solver error at the
    # infiltration front; the batched path converges to ~1e-13 residual.
    np.testing.assert_allclose(np.asarray(P[0]), P_serial, rtol=5e-5)


def test_dryrun_multichip_cpu():
    import sys, os
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as ge
    n = min(8, len(jax.devices()))
    ge.dryrun_multichip(n)


def test_entry_compiles():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert bool(jnp.all(jnp.isfinite(out)))
