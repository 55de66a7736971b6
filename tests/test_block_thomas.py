"""Batched block-tridiagonal solver vs dense reference."""
import numpy as np
import jax
import jax.numpy as jnp

from mpp_tpu.ops.block_thomas import block_thomas, block_tridiag_matvec


def _dense(L, D, U):
    B, n, m, _ = D.shape
    A = np.zeros((B, n * m, n * m))
    for b in range(B):
        for k in range(n):
            A[b, k * m:(k + 1) * m, k * m:(k + 1) * m] = D[b, k]
            if k > 0:
                A[b, k * m:(k + 1) * m, (k - 1) * m:k * m] = L[b, k]
            if k < n - 1:
                A[b, k * m:(k + 1) * m, (k + 1) * m:(k + 2) * m] = U[b, k]
    return A


def _random_system(B=3, n=7, m=4, seed=0):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(B, n, m, m))
    U = rng.normal(size=(B, n, m, m))
    D = rng.normal(size=(B, n, m, m)) + 6.0 * np.eye(m)  # diag dominant
    b = rng.normal(size=(B, n, m))
    return L, D, U, b


def test_block_thomas_matches_dense():
    L, D, U, b = _random_system()
    x = np.asarray(block_thomas(jnp.asarray(L), jnp.asarray(D),
                                jnp.asarray(U), jnp.asarray(b)))
    A = _dense(L, D, U)
    x_ref = np.linalg.solve(A, b.reshape(b.shape[0], -1, 1))[..., 0]
    np.testing.assert_allclose(x.reshape(x.shape[0], -1), x_ref,
                               rtol=1e-11, atol=1e-11)


def test_block_tridiag_matvec_roundtrip():
    L, D, U, b = _random_system(seed=1)
    x = block_thomas(jnp.asarray(L), jnp.asarray(D), jnp.asarray(U),
                     jnp.asarray(b))
    y = np.asarray(block_tridiag_matvec(jnp.asarray(L), jnp.asarray(D),
                                        jnp.asarray(U), x))
    np.testing.assert_allclose(y, b, rtol=1e-10, atol=1e-10)


def test_block_thomas_m1_matches_scalar_thomas():
    from mpp_tpu.ops.tridiag import thomas
    rng = np.random.default_rng(2)
    B, n = 4, 9
    dl = rng.normal(size=(B, n))
    du = rng.normal(size=(B, n))
    d = rng.normal(size=(B, n)) + 5.0
    b = rng.normal(size=(B, n))
    x_scalar = np.asarray(thomas(jnp.asarray(dl), jnp.asarray(d),
                                 jnp.asarray(du), jnp.asarray(b)))
    x_block = np.asarray(block_thomas(
        jnp.asarray(dl)[..., None, None], jnp.asarray(d)[..., None, None],
        jnp.asarray(du)[..., None, None], jnp.asarray(b)[..., None]))
    np.testing.assert_allclose(x_block[..., 0], x_scalar, rtol=1e-12,
                               atol=1e-12)


def test_small_solve_matches_lapack_with_pivoting():
    """small_solve (closed-form 2x2 / unrolled Gauss-Jordan, the batched
    replacement for per-level jnp.linalg.solve) must match LAPACK on
    systems that REQUIRE row pivoting (zero leading diagonal)."""
    from mpp_tpu.ops.block_thomas import small_solve
    rng = np.random.default_rng(7)
    for m in (1, 2, 3, 4, 5, 8):
        A = rng.standard_normal((6, 3, m, m))
        if m >= 2:
            A[0, 0, 0, 0] = 0.0        # forces a pivot swap
        if m >= 3:
            A[1, 2, 1, 1] = 0.0
        B = rng.standard_normal((6, 3, m, 2))
        X = np.asarray(small_solve(jnp.asarray(A), jnp.asarray(B)))
        np.testing.assert_allclose(X, np.linalg.solve(A, B),
                                   rtol=1e-10, atol=1e-10)


def test_compiled_th_interleaved_direct_solve_exact():
    """CompiledTH's interleaved [P_i,T_i] 2x2 block-tridiagonal direct
    solve equals the dense solve of the assembled TH Jacobian."""
    from mpp_tpu.problems import th
    from mpp_tpu.batched.th_compiled import compile_th
    mpp, _ = th.run_mass_and_heat(nx=12)
    comp = compile_th(mpp, linear_solver="direct")
    assert comp._th_blk is not None
    ncol = 3
    X0 = jnp.broadcast_to(mpp.soe.soln, (ncol, comp.n))
    bc, ss = comp.gather_inputs(ncol)
    dyn = comp._serial_dyn(ncol)
    dt = 3600.0

    def jac_one(x, b0, b1, s0, s1, d0, d1):
        return comp._jac_one(x, (b0, b1), (s0, s1), dt, (d0, d1))
    A = jax.vmap(jac_one)(X0, bc[0], bc[1], ss[0], ss[1], dyn[0], dyn[1])
    rng = np.random.default_rng(0)
    F = jnp.asarray(rng.standard_normal((ncol, comp.n)))
    Y = np.asarray(comp._solve(A, F))
    dense = np.asarray(jax.vmap(comp.template.to_dense)(A))
    Yd = np.linalg.solve(dense, np.asarray(F)[..., None])[..., 0]
    np.testing.assert_allclose(Y, Yd, rtol=1e-9, atol=1e-12)
