"""GPU kernels for the Newton-direction solves, and the one place that
chooses between them and the plain references.

Every compiled VSFM, thermal-KSP and ALM step solves one batched
tridiagonal system per Newton iteration, and every compiled TH step one
batched 2x2 block-tridiagonal system.  The plain references
(``ops/tridiag.thomas``, ``ops/block_thomas.block_thomas``) sweep the
levels with ``lax.scan``; XLA lowers each sweep to a while loop that
launches its body once per level, 2*nz launches per solve.

The kernels here are Pallas kernels on the Triton route: one column per
thread, 32 columns (one warp) per program, both sweeps as loops inside
the kernel.  The bands go in level-major ([nz, ncol]) so that a warp's
load of one level is one coalesced row; XLA does the transposes.  Levels
go in chunks: the loads of chunk c+1 are issued before chunk c is
eliminated, so a thread waits for memory once per chunk and not once per
level.  The forward carry stays in registers; c' (the block analog C')
is staged in a scratch output for the backward sweep, and b' in the
solution buffer, which the back substitution overwrites in place.
Levels past nz load as identity rows and are not stored, so the depth
need not be a power of two; ragged column counts are masked.  f32 and
f64 both run in the kernel.

``tridiag_solve`` and ``block_tridiag2_solve`` are the choice points:
``lax.platform_dependent`` lowers the plain reference on the CPU and the
kernel on CUDA.  Nothing falls back at run time, by shape or by dtype.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from mpp_tpu.ops.block_thomas import block_thomas
from mpp_tpu.ops.tridiag import thomas

BLOCK_COLS = 32        # columns per program: one warp, a column a thread
THOMAS_CHUNK = 8       # levels per prefetched chunk (fastest of 1/4/8/16)
BLOCK2_CHUNK = 4       # the same for the 14-plane 2x2 sweep (of 1/2/4)


def _level_major(x):
    """[ncol, n, *comp] -> flat [n, *comp, ncol] buffer, and the offset
    of (columns, level, component) in it."""
    ncol, n = x.shape[:2]
    m = x[0, 0].size
    flat = jnp.moveaxis(x.reshape(ncol, n * m), 0, -1).reshape(-1)
    return flat, lambda cols, k, c: (k * m + c) * ncol + cols


def _column_major(flat, shape):
    return jnp.moveaxis(flat.reshape(-1, shape[0]), -1, 0).reshape(shape)


def _sweep_kernel(ncol, n, chunk, eliminate, substitute, fwd_refs,
                  back_refs, interpret, name, inputs, outputs):
    """Launch a chunked forward/backward level sweep; returns the
    solution buffer.

    ``fwd_refs`` gives, per input, its offset function and the values a
    level past n loads as (an identity row); ``back_refs`` the same for
    the two outputs (scratch, solution), which the backward sweep reads.
    ``eliminate(carry, rows)`` steps one level forward and returns
    (carry, (solution values, scratch values)) to store;
    ``substitute(carry, rows)`` steps one level back and returns
    (carry, solution values)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    nch = pl.cdiv(n, chunk)
    (s_off, s_others), (x_off, x_others) = back_refs

    def kern(*refs):
        in_refs, (x_ref, s_ref) = refs[:-2], refs[-2:]
        cols = pl.program_id(0) * BLOCK_COLS + jnp.arange(BLOCK_COLS)
        live = cols < ncol

        def mask(k):
            return live & (k >= 0) & (k < n)

        def load(spec, c):
            return [[tuple(plgpu.load(ref.at[off(cols, c * chunk + j, i)],
                                      mask=mask(c * chunk + j), other=o)
                           for i, o in enumerate(others))
                     for ref, (off, others) in spec]
                    for j in range(chunk)]

        def store(ref, off, k, vals):
            for i, v in enumerate(vals):
                plgpu.store(ref.at[off(cols, k, i)], v, mask=mask(k))

        fwd_spec = list(zip(in_refs, fwd_refs))
        back_spec = list(zip((s_ref, x_ref), back_refs))

        def fwd(c, state):
            carry, rows = state
            nxt = load(fwd_spec, c + 1)
            for j in range(chunk):
                carry, (xv, sv) = eliminate(carry, rows[j])
                store(x_ref, x_off, c * chunk + j, xv)
                store(s_ref, s_off, c * chunk + j, sv)
            return carry, nxt

        def back(i, state):
            carry, rows = state
            c = nch - 1 - i
            nxt = load(back_spec, c - 1)
            for j in reversed(range(chunk)):
                carry, xv = substitute(carry, rows[j])
                store(x_ref, x_off, c * chunk + j, xv)
            return carry, nxt

        zero = jnp.zeros((BLOCK_COLS,), outputs[0].dtype)
        lax.fori_loop(0, nch, fwd, ((zero,) * (len(s_others)
                                               + len(x_others)),
                                    load(fwd_spec, 0)))
        lax.fori_loop(0, nch, back, ((zero,) * len(x_others),
                                     load(back_spec, nch - 1)))

    return pl.pallas_call(
        kern,
        # vma: the outputs vary over the same shard_map axes as inputs
        out_shape=[jax.ShapeDtypeStruct(o.shape, o.dtype,
                                        vma=jax.typeof(o).vma)
                   for o in outputs],
        grid=(pl.cdiv(ncol, BLOCK_COLS),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name=name,
    )(*inputs)[0]


@functools.partial(jax.jit, static_argnames=("interpret",))
def thomas_kernel(dl, d, du, b, *, interpret=False):
    """Batched Thomas solve of [ncol, nz] tridiagonal systems (same
    arguments and recurrence as ``ops.tridiag.thomas``)."""
    ncol, nz = d.shape
    (fdl, off), (fd, _), (fdu, _), (fb, _) = (
        _level_major(a[..., None]) for a in (dl, d, du, b))

    def eliminate(carry, rows):
        (cpm, bpm), ((dlk,), (dk,), (duk,), (bk,)) = carry, rows
        denom = dk - dlk * cpm
        cp = duk / denom
        bp = (bk - dlk * bpm) / denom
        return (cp, bp), ((bp,), (cp,))

    def substitute(carry, rows):
        (xn,), ((cpk,), (bpk,)) = carry, rows
        x = bpk - cpk * xn
        return (x,), (x,)

    x = _sweep_kernel(
        ncol, nz, THOMAS_CHUNK, eliminate, substitute,
        [(off, (0.0,)), (off, (1.0,)), (off, (0.0,)), (off, (0.0,))],
        [(off, (0.0,)), (off, (0.0,))], interpret, "thomas_tridiag",
        [fdl, fd, fdu, fb], [fb, fb])
    return _column_major(x, (ncol, nz))


@functools.partial(jax.jit, static_argnames=("interpret",))
def block_thomas2_kernel(L, D, U, b, *, interpret=False):
    """Batched 2x2 block-tridiagonal solve (same arguments and
    recurrence as ``ops.block_thomas.block_thomas`` at m=2: L/D/U
    [ncol, n, 2, 2], b [ncol, n, 2]): the closed-form adjugate solve of
    ``small_solve`` per level, in registers."""
    ncol, n = b.shape[:2]
    (fL, offm), (fD, _), (fU, _) = (_level_major(a) for a in (L, D, U))
    fb, offv = _level_major(b)

    def eliminate(carry, rows):
        (c00, c01, c10, c11, p0, p1), (lk, dk, uk, rk) = carry, rows
        l00, l01, l10, l11 = lk
        u00, u01, u10, u11 = uk
        a = dk[0] - (l00 * c00 + l01 * c10)
        bb = dk[1] - (l00 * c01 + l01 * c11)
        c = dk[2] - (l10 * c00 + l11 * c10)
        dd = dk[3] - (l10 * c01 + l11 * c11)
        r0 = rk[0] - (l00 * p0 + l01 * p1)
        r1 = rk[1] - (l10 * p0 + l11 * p1)
        det = a * dd - bb * c
        cp = ((dd * u00 - bb * u10) / det, (dd * u01 - bb * u11) / det,
              (a * u10 - c * u00) / det, (a * u11 - c * u01) / det)
        dp = ((dd * r0 - bb * r1) / det, (a * r1 - c * r0) / det)
        return cp + dp, (dp, cp)

    def substitute(carry, rows):
        (x0, x1), ((c00, c01, c10, c11), (p0, p1)) = carry, rows
        x = (p0 - (c00 * x0 + c01 * x1), p1 - (c10 * x0 + c11 * x1))
        return x, x

    zeros4, zeros2 = (0.0,) * 4, (0.0,) * 2
    x = _sweep_kernel(
        ncol, n, BLOCK2_CHUNK, eliminate, substitute,
        [(offm, zeros4), (offm, (1.0, 0.0, 0.0, 1.0)), (offm, zeros4),
         (offv, zeros2)],
        [(offm, zeros4), (offv, zeros2)], interpret, "block_thomas2",
        [fL, fD, fU, fb], [fb, fL])
    return _column_major(x, b.shape)


def tridiag_solve(dl, d, du, b):
    """Newton-direction tridiagonal solve over [ncol, nz]: the plain
    ``lax.scan`` reference on the CPU, the Triton kernel on CUDA."""
    return lax.platform_dependent(dl, d, du, b, cpu=thomas,
                                  cuda=thomas_kernel)


def block_tridiag2_solve(L, D, U, b):
    """2x2 block-tridiagonal solve over [ncol, n]: the plain reference
    on the CPU, the Triton kernel on CUDA."""
    return lax.platform_dependent(L, D, U, b, cpu=block_thomas,
                                  cuda=block_thomas2_kernel)
