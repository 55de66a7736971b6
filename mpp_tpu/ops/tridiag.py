"""Batched tridiagonal (Thomas) solver — the plain reference.

The reference's per-column implicit systems (vertical Richards / thermal
columns) are tridiagonal; PETSc solved them with ILU(0) which *is* the
exact LU of a tridiagonal matrix.  Columns are the leading batch axis and
``lax.scan`` sweeps the levels: each step is an elementwise op over the
[ncol] columns.  This is what the CPU runs; on the GPU the compiled steps
call the kernel behind ``ops/pallas_kernels.tridiag_solve``.

Also provides the tridiagonal SpMV (the Jacobian action).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def thomas(dl, d, du, b):
    """Solve batched tridiagonal systems.

    Args (all [..., n], batch leading): ``dl`` sub-diagonal (dl[...,0]
    unused), ``d`` diagonal, ``du`` super-diagonal (du[...,n-1] unused),
    ``b`` right-hand side.  Returns x with the same shape.
    """
    n = d.shape[-1]
    # move level axis to front for scan
    dl_t = jnp.moveaxis(dl, -1, 0)
    d_t = jnp.moveaxis(d, -1, 0)
    du_t = jnp.moveaxis(du, -1, 0)
    b_t = jnp.moveaxis(b, -1, 0)

    def fwd(carry, inp):
        cp_prev, bp_prev = carry
        dl_k, d_k, du_k, b_k = inp
        denom = d_k - dl_k * cp_prev
        cp = du_k / denom
        bp = (b_k - dl_k * bp_prev) / denom
        return (cp, bp), (cp, bp)

    zeros = jnp.zeros_like(d_t[0])
    (_, _), (cp, bp) = lax.scan(fwd, (zeros, zeros),
                                (dl_t, d_t, du_t, b_t))

    def back(x_next, inp):
        cp_k, bp_k = inp
        x = bp_k - cp_k * x_next
        return x, x

    _, x_rev = lax.scan(back, zeros, (cp, bp), reverse=True)
    return jnp.moveaxis(x_rev, 0, -1)


def tridiag_matvec(dl, d, du, x):
    """y = T x for batched tridiagonal T given as three diagonals.

    Concatenate-of-slices form: XLA fuses it into a single elementwise
    pass (the ``.at[].add`` form materializes an extra intermediate).
    """
    z = jnp.zeros_like(x[..., :1])
    lo = jnp.concatenate([z, dl[..., 1:] * x[..., :-1]], -1)
    hi = jnp.concatenate([du[..., :-1] * x[..., 1:], z], -1)
    return d * x + lo + hi

