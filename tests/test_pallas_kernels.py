"""The Newton-direction kernels (Triton-route Pallas, run here in
interpret mode) against the plain ``lax.scan`` references, and the
platform choice points that pick between them."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mpp_tpu.ops.block_thomas import block_thomas
from mpp_tpu.ops.pallas_kernels import (block_thomas2_kernel,
                                        block_tridiag2_solve, thomas_kernel,
                                        tridiag_solve)
from mpp_tpu.ops.tridiag import thomas, tridiag_matvec


def _system(ncol=16, nz=32, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    d = rng.uniform(4.0, 5.0, (ncol, nz))
    dl = rng.uniform(0.1, 0.9, (ncol, nz))
    du = rng.uniform(0.1, 0.9, (ncol, nz))
    x = rng.uniform(-1.0, 1.0, (ncol, nz))
    return tuple(jnp.asarray(a, dtype) for a in (dl, d, du, x))


def _block_system(ncol, n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((ncol, n, 2, 2)) * 0.2
    U = rng.standard_normal((ncol, n, 2, 2)) * 0.2
    D = rng.standard_normal((ncol, n, 2, 2))
    D[..., 0, 0] += 3.0
    D[..., 1, 1] += 3.0
    b = rng.standard_normal((ncol, n, 2))
    return tuple(jnp.asarray(a, dtype) for a in (L, D, U, b))


def test_spmv_matches_matvec():
    """The Jacobian action (``tridiag_matvec``, the BT line-search
    slope) equals the dense tridiagonal product."""
    dl, d, du, x = _system()
    dense = (jnp.apply_along_axis(jnp.diag, 1, d)
             + jnp.apply_along_axis(lambda v: jnp.diag(v[1:], -1), 1, dl)
             + jnp.apply_along_axis(lambda v: jnp.diag(v[:-1], 1), 1, du))
    want = jnp.einsum("cij,cj->ci", dense, x,
                      precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_allclose(np.asarray(tridiag_matvec(dl, d, du, x)),
                               np.asarray(want), rtol=1e-14, atol=1e-15)


@pytest.mark.parametrize("nz", [15, 30, 64, 128])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_thomas_kernel_interpret_matches_scan(dtype, nz):
    """Same recurrence and operation order as the scan reference:
    equal to the last bit in interpret mode, f32 and f64, any depth
    (levels past nz load as identity rows, so nz need not be a multiple
    of the level chunk or a power of 2)."""
    dl, d, du, b = _system(ncol=64, nz=nz, dtype=dtype)
    x = thomas_kernel(dl, d, du, b, interpret=True)
    assert x.dtype == dtype and x.shape == b.shape
    np.testing.assert_array_equal(np.asarray(x),
                                  np.asarray(thomas(dl, d, du, b)))


@pytest.mark.parametrize("ncol", [33, 75])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_thomas_kernel_ragged_columns(dtype, ncol):
    """ncol not a multiple of the 32-column program: the tail program
    masks its loads and stores."""
    dl, d, du, b = _system(ncol=ncol, nz=30, seed=3, dtype=dtype)
    x = thomas_kernel(dl, d, du, b, interpret=True)
    np.testing.assert_array_equal(np.asarray(x),
                                  np.asarray(thomas(dl, d, du, b)))


def test_f32_newton_with_mixed_action_converges():
    """The compiled f32 Newton, whose BT initslope uses the f32
    Jacobian action, converges on every column."""
    import __graft_entry__ as g

    _, comp = g._build_compiled_celia(16)
    X = jnp.full((8, 16), 3.5355e3, jnp.float32)
    bc = jnp.tile(jnp.asarray([[9.3991e4, 3.5355e3]], jnp.float32), (8, 1))
    ss = jnp.zeros((8, 0), jnp.float32)
    src = jnp.zeros((8, 16), jnp.float32)
    Xn, iters, ok, reason = comp.step_batched(X, (bc,), (ss,), 3600.0,
                                              src=src)
    assert bool(ok.all()), np.asarray(reason)
    assert np.isfinite(np.asarray(Xn)).all()


def test_pallas_block_thomas2_interpret_matches_scan():
    """The 2x2 block-Thomas kernel (TH Newton-direction solver) vs the
    lax.scan block sweep, in interpret mode (runs on CPU)."""
    L, D, U, b = _block_system(256, 32)
    x = np.asarray(block_thomas2_kernel(L, D, U, b, interpret=True))
    xr = np.asarray(block_thomas(L, D, U, b))
    np.testing.assert_allclose(x, xr, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("ncol,n,dtype,tol", [
    (75, 30, np.float64, 1e-12), (75, 15, np.float32, 2e-5),
    (33, 64, np.float64, 1e-12), (33, 6, np.float32, 2e-5)])
def test_block_thomas2_kernel_dtypes_and_ragged(ncol, n, dtype, tol):
    """f64 runs in the kernel too; ragged ncol and a depth that is not a
    multiple of the level chunk are masked."""
    L, D, U, b = _block_system(ncol, n, seed=5, dtype=dtype)
    x = block_thomas2_kernel(L, D, U, b, interpret=True)
    assert x.dtype == dtype and x.shape == b.shape
    np.testing.assert_allclose(np.asarray(x),
                               np.asarray(block_thomas(L, D, U, b)),
                               rtol=tol, atol=tol)


def _lowered_text(fn, args, platform):
    return jax.jit(fn).trace(*args).lower(
        lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize("which", ["tridiag", "block2"])
def test_cpu_lowering_has_no_pallas_call(which):
    """The choice point lowers the plain reference for the CPU and the
    Triton kernel for CUDA, with no run-time branch between them."""
    if which == "tridiag":
        fn, args = tridiag_solve, _system(ncol=8, nz=6)
    else:
        fn, args = block_tridiag2_solve, _block_system(8, 6)
    cpu = _lowered_text(fn, args, "cpu")
    assert "triton" not in cpu.lower() and "custom_call" not in cpu
    cuda = _lowered_text(fn, args, "cuda")
    assert "__gpu$xla.gpu.triton" in cuda
    np.testing.assert_array_equal(
        np.asarray(jax.jit(fn)(*args)),
        np.asarray((thomas if which == "tridiag" else block_thomas)(*args)))


def test_cuda_lowering_under_shard_map():
    """The sharded ALM step calls the choice point inside shard_map: the
    kernel's outputs carry the inputs' varying mesh axes."""
    from jax.sharding import Mesh, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()), ("col",))
    spec = P("col", None)
    fn = jax.jit(jax.shard_map(tridiag_solve, mesh=mesh,
                               in_specs=(spec,) * 4, out_specs=spec))
    args = _system(ncol=8 * len(jax.devices()), nz=6)
    assert "__gpu$xla.gpu.triton" in _lowered_text(fn, args, "cuda")
    np.testing.assert_array_equal(np.asarray(fn(*args)),
                                  np.asarray(thomas(*args)))


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA device; run with MPP_TEST_DEVICE=gpu")
    return jax.devices()[0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_kernels_on_card_match_scan(gpu, dtype):
    """The compiled kernels against the scan references on the card."""
    dl, d, du, b = _system(ncol=4099, nz=30, dtype=dtype)
    np.testing.assert_allclose(np.asarray(tridiag_solve(dl, d, du, b)),
                               np.asarray(thomas(dl, d, du, b)),
                               rtol=1e-5 if dtype == np.float32 else 1e-13)
    L, D, U, bb = _block_system(1027, 64, dtype=dtype)
    np.testing.assert_allclose(
        np.asarray(block_tridiag2_solve(L, D, U, bb)),
        np.asarray(block_thomas(L, D, U, bb)),
        rtol=1e-4 if dtype == np.float32 else 1e-12,
        atol=1e-4 if dtype == np.float32 else 1e-12)
