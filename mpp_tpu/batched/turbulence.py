"""Batched (jnp) canopy turbulence: the production path.

Functional re-expression of ``models/canopy_turbulence.py`` (itself a
transcription of ``ge/CanopyTurbulence.F90``): all canopy-air columns
advance together as [ncair] lanes, the Obukhov-length fixed point runs as
a *batched* hybrid/Brent root solve (``MathTools.F90:38-235`` semantics,
one function evaluation per iteration for every lane, per-lane
convergence masks), and the RSL psi-hat lookup is a vectorized bilinear
gather.  Everything is pure jnp — jit/vmap/shard_map compatible — so the
MLC presolve can run on the device at production column counts.

The serial numpy module remains the golden-parity path; this module is
verified against it lane-for-lane (tests/test_batched_canopy.py).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp
from jax import lax

from mpp_tpu.constants import (VKC, GRAVITY_CONSTANT, MM_H2O, MM_DRY_AIR,
                               CPD, CPW, RGAS)
from mpp_tpu.ops.rsl_psihat import load_psihat
from mpp_tpu.models.canopy_turbulence import (
    CD, BETA_NEUTRAL_MAX, CR, C2, PR0, PR1, PR2, Z0MG, ZETA_MIN, ZETA_MAX,
    BETA_MIN, BETA_MAX, WIND_MIN, RA_MAX)


# ---------------------------------------------------------------------------
# psi-hat bilinear lookup, vectorized (CanopyTurbulence.F90:445-538)
# ---------------------------------------------------------------------------

class PsiHatTablesJnp(NamedTuple):
    zdt_m: jnp.ndarray
    dtl_m: jnp.ndarray
    psi_m: jnp.ndarray
    zdt_h: jnp.ndarray
    dtl_h: jnp.ndarray
    psi_h: jnp.ndarray


def load_psihat_jnp(path=None, dtype=jnp.float64) -> PsiHatTablesJnp:
    t = load_psihat(path)
    f = lambda a: jnp.asarray(np.asarray(a), dtype)
    return PsiHatTablesJnp(f(t.zdt_m), f(t.dtl_m), f(t.psi_m),
                           f(t.zdt_h), f(t.dtl_h), f(t.psi_h))


def lookup_psihat_jnp(zdt, dtl, zdtgrid, dtlgrid, psigrid):
    """Vectorized bilinear psihat lookup; off-grid queries collapse to the
    0.5/0.5-weighted edge row/column exactly as the reference does."""
    nl = dtlgrid.shape[0]
    nz = zdtgrid.shape[0]

    # dt/L axis (ascending grid)
    jj = jnp.searchsorted(dtlgrid, dtl, side="left") - 1
    l1 = jnp.clip(jj, 0, nl - 2)
    l2 = l1 + 1
    wl1_in = (dtlgrid[l2] - dtl) / (dtlgrid[l2] - dtlgrid[l1])
    lo_l = dtl <= dtlgrid[0]
    hi_l = dtl > dtlgrid[nl - 1]
    l1 = jnp.where(lo_l, 0, jnp.where(hi_l, nl - 1, l1))
    l2 = jnp.where(lo_l, 0, jnp.where(hi_l, nl - 1, l2))
    wl1 = jnp.where(lo_l | hi_l, 0.5, wl1_in)
    wl2 = jnp.where(lo_l | hi_l, 0.5, 1.0 - wl1_in)

    # z/dt axis (descending grid): search on the reversed (ascending) view
    ii = nz - 1 - jnp.searchsorted(zdtgrid[::-1], zdt, side="right")
    ii = jnp.maximum(ii, 0)
    z1 = jnp.clip(ii, 0, nz - 2)
    z2 = jnp.minimum(z1 + 1, nz - 1)
    wz1_in = (zdt - zdtgrid[z2]) / (zdtgrid[z1] - zdtgrid[z2])
    lo_z = zdt > zdtgrid[0]
    hi_z = zdt < zdtgrid[nz - 1]
    z1 = jnp.where(lo_z, 0, jnp.where(hi_z, nz - 1, z1))
    z2 = jnp.where(lo_z, 0, jnp.where(hi_z, nz - 1, z2))
    wz1 = jnp.where(lo_z | hi_z, 0.5, wz1_in)
    wz2 = jnp.where(lo_z | hi_z, 0.5, 1.0 - wz1_in)

    return (wz1 * wl1 * psigrid[z1, l1] + wz2 * wl1 * psigrid[z2, l1]
            + wz1 * wl2 * psigrid[z1, l2] + wz2 * wl2 * psigrid[z2, l2])


# ---------------------------------------------------------------------------
# Monin-Obukhov stability functions (CanopyTurbulence.F90:540-630)
# ---------------------------------------------------------------------------

def phim_mo(zeta):
    unstable = zeta < 0.0
    zs = jnp.where(unstable, zeta, -1.0)
    return jnp.where(unstable, 1.0 / jnp.sqrt(jnp.sqrt(1.0 - 16.0 * zs)),
                     1.0 + 5.0 * zeta)


def phic_mo(zeta):
    unstable = zeta < 0.0
    zs = jnp.where(unstable, zeta, -1.0)
    return jnp.where(unstable, 1.0 / jnp.sqrt(1.0 - 16.0 * zs),
                     1.0 + 5.0 * zeta)


def psim_mo(zeta):
    unstable = zeta < 0.0
    zs = jnp.where(unstable, zeta, -1.0)
    x = jnp.sqrt(jnp.sqrt(1.0 - 16.0 * zs))
    val = (2.0 * jnp.log((1.0 + x) / 2.0) + jnp.log((1.0 + x * x) / 2.0)
           - 2.0 * jnp.arctan(x) + jnp.pi * 0.5)
    return jnp.where(unstable, val, -5.0 * zeta)


def psic_mo(zeta):
    unstable = zeta < 0.0
    zs = jnp.where(unstable, zeta, -1.0)
    x = jnp.sqrt(jnp.sqrt(1.0 - 16.0 * zs))
    return jnp.where(unstable, 2.0 * jnp.log((1.0 + x * x) / 2.0),
                     -5.0 * zeta)


def compute_psi_rsl(tab: PsiHatTablesJnp, za, hc, disp, obu, beta, prsc):
    """RSL-corrected (psim, psic) at height ``za``
    (CanopyTurbulence.F90:330-404), all args broadcastable arrays."""
    z_minus_d = za - disp
    h_minus_d = hc - disp

    phim = phim_mo(h_minus_d / obu)
    c1 = (1.0 - VKC / (2.0 * beta * phim)) * jnp.exp(0.5 * C2)
    psihat1 = lookup_psihat_jnp((za - hc) / h_minus_d, h_minus_d / obu,
                                tab.zdt_m, tab.dtl_m, tab.psi_m)
    psihat2 = lookup_psihat_jnp(za * 0.0, h_minus_d / obu,
                                tab.zdt_m, tab.dtl_m, tab.psi_m)
    psim = (-psim_mo(z_minus_d / obu) + psim_mo(h_minus_d / obu)
            + (psihat1 - psihat2) * c1 + VKC / beta)

    phic = phic_mo(h_minus_d / obu)
    c1 = (1.0 - prsc * VKC / (2.0 * beta * phic)) * jnp.exp(0.5 * C2)
    psihat1 = lookup_psihat_jnp((za - hc) / h_minus_d, h_minus_d / obu,
                                tab.zdt_h, tab.dtl_h, tab.psi_h)
    psihat2 = lookup_psihat_jnp(za * 0.0, h_minus_d / obu,
                                tab.zdt_h, tab.dtl_h, tab.psi_h)
    psic = (-psic_mo(z_minus_d / obu) + psic_mo(h_minus_d / obu)
            + (psihat1 - psihat2) * c1)
    return psim, psic


# ---------------------------------------------------------------------------
# turbulence state + derived inputs (CanopyTurbulenceAuxType.F90:171-198)
# ---------------------------------------------------------------------------

class TurbInputs(NamedTuple):
    """Per-column [ncair] forcing/static inputs."""
    hc: jnp.ndarray
    zref: jnp.ndarray
    pref: jnp.ndarray
    uref: jnp.ndarray
    qref: jnp.ndarray
    tref: jnp.ndarray
    tcan: jnp.ndarray
    qcan: jnp.ndarray
    pai: jnp.ndarray
    # derived (derived_atm)
    rhomol: jnp.ndarray
    thref: jnp.ndarray
    thvref: jnp.ndarray
    Lc: jnp.ndarray


def derive_inputs(hc, zref, pref, uref, qref, tref, tcan, qcan,
                  pai) -> TurbInputs:
    rhomol = pref / (RGAS * tref)
    thref = tref + 0.0098 * zref
    thvref = thref * (1.0 + 0.61 * qref)
    Lc = hc / (CD * pai)
    return TurbInputs(hc, zref, pref, uref, qref, tref, tcan, qcan, pai,
                      rhomol, thref, thvref, Lc)


class TurbAux(NamedTuple):
    """Side-effect state of one Obukhov residual evaluation [ncair]."""
    beta: jnp.ndarray
    disp: jnp.ndarray
    PrSc: jnp.ndarray
    c1m: jnp.ndarray
    ustar: jnp.ndarray
    tstar: jnp.ndarray
    qstar: jnp.ndarray
    obu_ustar: jnp.ndarray
    gac: jnp.ndarray
    obu: jnp.ndarray


def obukhov_residual(tab: PsiHatTablesJnp, inp: TurbInputs, obu_val):
    """Batched fixed-point residual (CanopyTurbulence.F90:233-327).

    Returns (g = obu_new - obu_val, TurbAux of this evaluation)."""
    obu_cur = jnp.where(jnp.abs(obu_val) < 0.1, 0.1, obu_val)

    c1 = (VKC / jnp.log((inp.hc + Z0MG) / Z0MG)) ** 2.0
    beta_neutral = jnp.minimum(jnp.sqrt(c1 + CR * inp.pai), BETA_NEUTRAL_MAX)

    LcL = inp.Lc / obu_cur
    # unstable branch
    bu = 16.0 * LcL * beta_neutral ** 4.0
    beta_unstable = jnp.sqrt(
        0.5 * (-bu + jnp.sqrt(bu ** 2.0 + 4.0 * beta_neutral ** 4.0)))
    # stable branch: depressed-cubic closed form
    a = 5.0 * jnp.where(LcL > 0.0, LcL, 1.0)
    dd = -beta_neutral
    q = (27.0 * a ** 2 * dd) ** 2.0 - 4.0 * (-3.0 * a) ** 3.0
    q = jnp.sqrt(q)
    r = 0.5 * (q + 27.0 * a ** 2 * dd)
    r = jnp.cbrt(r)
    beta_stable = -r / (3.0 * a) - (-3.0 * a) / (3.0 * a * r)
    beta = jnp.where(LcL <= 0.0, beta_unstable, beta_stable)
    beta = jnp.clip(beta, BETA_MIN, BETA_MAX)

    dp = beta ** 2.0 * inp.Lc * (1.0 - jnp.exp(-0.25 * inp.pai / beta ** 2.0))
    dp = jnp.minimum(inp.hc, dp)
    disp = jnp.maximum(inp.hc - dp, 0.0)

    z_minus_d = inp.zref - disp
    h_minus_d = inp.hc - disp

    prsc = PR0 + PR1 * jnp.tanh(PR2 * inp.Lc / obu_cur)
    prsc = ((1.0 - beta_neutral / BETA_NEUTRAL_MAX)
            + (beta_neutral / BETA_NEUTRAL_MAX) * prsc)

    zeta = z_minus_d / obu_cur
    zeta = jnp.where(zeta >= 0.0, jnp.clip(zeta, 0.01, ZETA_MAX),
                     jnp.clip(zeta, ZETA_MIN, -0.01))
    obu_cur = z_minus_d / zeta

    phi_m_hc = phim_mo(h_minus_d / obu_cur)
    c1m = (1.0 - VKC / (2.0 * beta * phi_m_hc)) * jnp.exp(0.5 * C2)

    psim, psic = compute_psi_rsl(tab, inp.zref, inp.hc, disp, obu_cur,
                                 beta, prsc)
    zlog = jnp.log(z_minus_d / h_minus_d)
    ustar = inp.uref * VKC / (zlog + psim)
    tstar = (inp.thref - inp.tcan) * VKC / (zlog + psic)
    qstar = (inp.qref - inp.qcan) * VKC / (zlog + psic)
    gac = inp.rhomol * VKC * ustar / (zlog + psic)
    tvstar = tstar + 0.61 * inp.thref * qstar
    obu_new = ustar ** 2.0 * inp.thvref / (VKC * GRAVITY_CONSTANT * tvstar)
    aux = TurbAux(beta, disp, prsc, c1m, ustar, tstar, qstar, obu_cur, gac,
                  obu_new)
    return obu_new - obu_val, aux


# ---------------------------------------------------------------------------
# batched hybrid/Brent root solve (MathTools.F90:38-235 semantics)
# ---------------------------------------------------------------------------

MODE_SECANT = 0
MODE_BRENT = 1
MODE_FINAL = 2   # itmax hit: one last eval at minx, then done
MODE_DONE = 3


def batched_hybrid(fn, x0_init, x1_init, tol, itmax=40, brent_itmax=50,
                   eps=1.0e-8):
    """Batched root solve with the reference ``hybrid`` semantics:
    secant iteration per lane, switching to Brent once a sign change
    brackets the root; after ``itmax`` secant steps, re-evaluate at the
    minimum-f iterate and stop.  ``fn(x) -> (g, aux)`` evaluates ALL lanes
    (one call per iteration); each lane's ``aux`` freezes at its last
    evaluation, matching the side-effect contract of the scalar solver.

    Returns (x_root, aux_last)."""
    n = x0_init.shape[0]
    g0, aux = fn(x0_init)
    g1, aux1 = fn(x1_init)
    aux = aux1

    # NOTE: reference compares raw f, not |f| (MathTools.F90:85-91)
    minx = jnp.where(g1 < g0, x1_init, x0_init)
    minf = jnp.where(g1 < g0, g1, g0)

    mode = jnp.where(g0 == 0.0, MODE_DONE, MODE_SECANT)
    mode = jnp.where((g1 == 0.0) & (mode != MODE_DONE), MODE_DONE, mode)
    root = jnp.where(g0 == 0.0, x0_init, x1_init)

    zf = jnp.zeros_like(x0_init)

    class _S(NamedTuple):
        mode: jnp.ndarray
        root: jnp.ndarray
        x0: jnp.ndarray
        f0: jnp.ndarray
        x1: jnp.ndarray
        f1: jnp.ndarray
        minx: jnp.ndarray
        minf: jnp.ndarray
        a: jnp.ndarray
        fa: jnp.ndarray
        b: jnp.ndarray
        fb: jnp.ndarray
        c: jnp.ndarray
        fc: jnp.ndarray
        d: jnp.ndarray
        e: jnp.ndarray
        it: jnp.ndarray
        bit: jnp.ndarray
        aux: object

    st = _S(mode, root, x0_init, g0, x1_init, g1, minx, minf,
            zf, zf, zf, zf, zf, zf, zf, zf,
            jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32), aux)

    def cond(st):
        return jnp.any(st.mode != MODE_DONE)

    def body(st):
        in_sec = st.mode == MODE_SECANT
        in_brent = st.mode == MODE_BRENT
        in_final = st.mode == MODE_FINAL

        # ---- secant proposal (MathTools.F90:94-131)
        denom = jnp.where(st.f1 == st.f0, 1.0, st.f1 - st.f0)
        dx = -st.f1 * (st.x1 - st.x0) / denom
        x_prop = st.x1 + dx
        sec_conv = jnp.abs(dx) < tol
        it_next = jnp.where(in_sec, st.it + 1, st.it)
        sec_itmax = it_next > itmax

        # ---- Brent step (MathTools.F90:135-235)
        a, fa, b, fb, c, fc, d, e = (st.a, st.fa, st.b, st.fb, st.c, st.fc,
                                     st.d, st.e)
        same_sign = ((fb > 0.0) & (fc > 0.0)) | ((fb < 0.0) & (fc < 0.0))
        c = jnp.where(same_sign, a, c)
        fc = jnp.where(same_sign, fa, fc)
        d = jnp.where(same_sign, b - a, d)
        e = jnp.where(same_sign, b - a, e)
        swap = jnp.abs(fc) < jnp.abs(fb)
        a2 = jnp.where(swap, b, a)
        b2 = jnp.where(swap, c, b)
        c2 = jnp.where(swap, a, c)
        fa2 = jnp.where(swap, fb, fa)
        fb2 = jnp.where(swap, fc, fb)
        fc2 = jnp.where(swap, fa, fc)
        a, b, c, fa, fb, fc = a2, b2, c2, fa2, fb2, fc2
        tol1 = 2.0 * eps * jnp.abs(b) + 0.5 * tol
        xm = 0.5 * (c - b)
        brent_done = (jnp.abs(xm) <= tol1) | (fb == 0.0)
        # interpolation step
        use_interp = (jnp.abs(e) >= tol1) & (jnp.abs(fa) > jnp.abs(fb))
        s = fb / jnp.where(fa == 0.0, 1.0, fa)
        a_eq_c = a == c
        p_lin = 2.0 * xm * s
        q_lin = 1.0 - s
        qq = fa / jnp.where(fc == 0.0, 1.0, fc)
        rr = fb / jnp.where(fc == 0.0, 1.0, fc)
        p_quad = s * (2.0 * xm * qq * (qq - rr) - (b - a) * (rr - 1.0))
        q_quad = (qq - 1.0) * (rr - 1.0) * (s - 1.0)
        p = jnp.where(a_eq_c, p_lin, p_quad)
        q = jnp.where(a_eq_c, q_lin, q_quad)
        q = jnp.where(p > 0.0, -q, q)
        p = jnp.abs(p)
        accept = (2.0 * p < jnp.minimum(3.0 * xm * q - jnp.abs(tol1 * q),
                                        jnp.abs(e * q)))
        e_new = jnp.where(accept, d, xm)
        d_new = jnp.where(accept, p / jnp.where(q == 0.0, 1.0, q), xm)
        e_new = jnp.where(use_interp, e_new, xm)
        d_new = jnp.where(use_interp, d_new, xm)
        a_next = b
        fa_next = fb
        # (copysign spelled with where; tol1 > 0 so this is exact)
        b_step = jnp.where(jnp.abs(d_new) > tol1, b + d_new,
                           b + jnp.where(xm >= 0.0, tol1, -tol1))
        bit_next = jnp.where(in_brent, st.bit + 1, st.bit)
        brent_fail = bit_next >= brent_itmax

        # ---- evaluation point for every lane
        x_eval = jnp.where(in_sec, x_prop,
                           jnp.where(in_brent, b_step,
                                     jnp.where(in_final, st.minx, st.root)))
        # lanes finishing this step without needing the eval:
        sec_now_done = in_sec & sec_conv
        brent_now_done = in_brent & (brent_done | brent_fail)
        need_eval = ((in_sec & ~sec_conv) | (in_brent & ~brent_now_done)
                     | in_final)

        g, aux_new = fn(x_eval)
        aux = _tree_where(need_eval, aux_new, st.aux)

        # ---- secant post-eval updates
        minf_new = jnp.where(in_sec & need_eval & (g < st.minf), g, st.minf)
        minx_new = jnp.where(in_sec & need_eval & (g < st.minf), x_eval,
                             st.minx)
        bracket = in_sec & need_eval & (g * st.f1 < 0.0)
        # shift: x0,f0 = x1,f1 ; x1,f1 = x_prop,g
        x0n = jnp.where(in_sec & ~sec_conv, st.x1, st.x0)
        f0n = jnp.where(in_sec & ~sec_conv, st.f1, st.f0)
        x1n = jnp.where(in_sec & ~sec_conv, x_prop, st.x1)
        f1n = jnp.where(in_sec & ~sec_conv, g, st.f1)

        # mode transitions
        mode = st.mode
        root = st.root
        # secant converged: root = x_prop (no eval of it)
        mode = jnp.where(sec_now_done, MODE_DONE, mode)
        root = jnp.where(sec_now_done, x_prop, root)
        # bracket found -> enter Brent with (a,fa)=(x0,f0)shifted,(b,fb)=new
        enter_brent = bracket & ~sec_now_done
        mode = jnp.where(enter_brent, MODE_BRENT, mode)
        an = jnp.where(enter_brent, x0n, a_next)
        fan = jnp.where(enter_brent, f0n, fa_next)
        bn = jnp.where(enter_brent, x1n, b_step)
        fbn = jnp.where(enter_brent, f1n, g)
        cn = jnp.where(enter_brent, x1n, c)
        fcn = jnp.where(enter_brent, f1n, fc)
        dn = jnp.where(enter_brent, 0.0, d_new)
        en = jnp.where(enter_brent, 0.0, e_new)
        # secant itmax -> final eval at minx next iteration
        hit_itmax = in_sec & ~sec_now_done & ~enter_brent & sec_itmax
        mode = jnp.where(hit_itmax, MODE_FINAL, mode)
        # brent done: root = b (pre-step b)
        mode = jnp.where(brent_now_done, MODE_DONE, mode)
        root = jnp.where(brent_now_done, b, root)
        # brent post-eval: fb = g at b_step; immediate zero -> done
        brent_zero = in_brent & ~brent_now_done & (g == 0.0)
        mode = jnp.where(brent_zero, MODE_DONE, mode)
        root = jnp.where(brent_zero, b_step, root)
        # final-eval lanes: done, root = minx
        mode = jnp.where(in_final, MODE_DONE, mode)
        root = jnp.where(in_final, st.minx, root)

        keep_b = in_brent & ~brent_now_done
        return _S(mode, root,
                  jnp.where(in_sec, x0n, st.x0),
                  jnp.where(in_sec, f0n, st.f0),
                  jnp.where(in_sec, x1n, st.x1),
                  jnp.where(in_sec, f1n, st.f1),
                  minx_new, minf_new,
                  jnp.where(keep_b, an, jnp.where(enter_brent, an, st.a)),
                  jnp.where(keep_b, fan, jnp.where(enter_brent, fan, st.fa)),
                  jnp.where(keep_b, bn, jnp.where(enter_brent, bn, st.b)),
                  jnp.where(keep_b, fbn, jnp.where(enter_brent, fbn, st.fb)),
                  jnp.where(keep_b, cn, jnp.where(enter_brent, cn, st.c)),
                  jnp.where(keep_b, fcn, jnp.where(enter_brent, fcn, st.fc)),
                  jnp.where(keep_b, dn, jnp.where(enter_brent, dn, st.d)),
                  jnp.where(keep_b, en, jnp.where(enter_brent, en, st.e)),
                  it_next, bit_next, aux)

    st = lax.while_loop(cond, body, st)
    return st.root, st.aux


def _tree_where(mask, new, old):
    import jax
    return jax.tree.map(
        lambda a, b: jnp.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)),
                               a, b), new, old)


def obukhov_length(tab: PsiHatTablesJnp, inp: TurbInputs):
    """Batched Obukhov fixed point (CanopyTurbulence.F90:42-64).

    Returns the TurbAux from the last residual evaluation, with
    ``obu = obu_ustar`` applied (the reference keeps the side-effect
    state, not the returned root)."""
    x0 = jnp.full_like(inp.hc, 100.0)
    x1 = jnp.full_like(inp.hc, -100.0)
    _, aux = batched_hybrid(lambda x: obukhov_residual(tab, inp, x),
                            x0, x1, 0.01)
    return aux._replace(obu=aux.obu_ustar)


# ---------------------------------------------------------------------------
# wind + conductance profiles (CanopyTurbulence.F90:67-231), vectorized
# ---------------------------------------------------------------------------

def wind_profile(tab: PsiHatTablesJnp, inp: TurbInputs, aux: TurbAux, zs,
                 ntop: int):
    """RSL wind profile over [ncair, nlev]; ``zs`` is [ncair, nlev] and
    ``ntop`` the (static) canopy-top level index."""
    nlev = zs.shape[-1]
    k = jnp.arange(nlev)
    hc = inp.hc[:, None]
    disp = aux.disp[:, None]
    h_minus_d = hc - disp
    psim, _ = compute_psi_rsl(tab, zs, hc, disp, aux.obu[:, None],
                              aux.beta[:, None], aux.PrSc[:, None])
    above = (aux.ustar[:, None] / VKC
             * (jnp.log((zs - disp) / h_minus_d) + psim))
    ucan = aux.ustar / aux.beta
    lm_over_beta = 2.0 * aux.beta ** 2.0 * inp.Lc
    within = jnp.maximum(
        ucan[:, None] * jnp.exp((zs - hc) / lm_over_beta[:, None]), WIND_MIN)
    wind = jnp.where(k[None, :] >= ntop, above, within)
    wind = jnp.where(k[None, :] == 0, 0.0, wind)
    return wind, ucan


def aerodynamic_conductances(tab: PsiHatTablesJnp, inp: TurbInputs,
                             aux: TurbAux, zs, wind, ntop: int):
    """Layer-to-layer conductance profile ga [ncair, nlev]
    (CanopyTurbulence.F90:109-231)."""
    nlev = zs.shape[-1]
    k = jnp.arange(nlev)
    hc = inp.hc[:, None]
    disp = aux.disp[:, None]
    obu = aux.obu[:, None]
    beta = aux.beta[:, None]
    prsc = aux.PrSc[:, None]
    rhomol = inp.rhomol[:, None]
    ustar = aux.ustar[:, None]

    # psic at every level + at zref
    _, psic_z = compute_psi_rsl(tab, zs, hc, disp, obu, beta, prsc)
    _, psic_ref = compute_psi_rsl(tab, inp.zref[:, None], hc, disp, obu,
                                  beta, prsc)
    _, psic_hc = compute_psi_rsl(tab, hc, hc, disp, obu, beta, prsc)

    # above-canopy neighbors k -> k+1 (valid for k in [ntop, nlev-2])
    zs_up = jnp.concatenate([zs[:, 1:], inp.zref[:, None]], axis=1)
    psic_up = jnp.concatenate([psic_z[:, 1:], psic_ref], axis=1)
    ga_above = (rhomol * VKC * ustar
                / (jnp.log((zs_up - disp) / (zs - disp))
                   + (psic_up - psic_z)))

    # within canopy (k in [1, ntop-2]): exponential resistance
    lm_over_beta = (2.0 * aux.beta ** 2.0 * inp.Lc)[:, None]
    zl = zs - hc
    zu = zs_up - hc
    res_within = (prsc / (beta * ustar)
                  * (jnp.exp(-zl / lm_over_beta)
                     - jnp.exp(-zu / lm_over_beta)))
    ga_within = rhomol / res_within

    # top-of-canopy layer (k = ntop-1): series of below-hc and above-hc legs
    res_below_hc = (prsc / (beta * ustar)
                    * (jnp.exp(-zl / lm_over_beta) - 1.0))
    ga_below_hc = rhomol / res_below_hc
    ga_above_hc = (rhomol * VKC * ustar
                   / (jnp.log((zs_up - disp) / (hc - disp))
                      + (psic_up - psic_hc)))
    ga_top = 1.0 / (1.0 / ga_below_hc + 1.0 / ga_above_hc)

    ga = jnp.where(k[None, :] >= ntop, ga_above,
                   jnp.where(k[None, :] == ntop - 1, ga_top, ga_within))

    # ground (k = 0)
    zoc_g = 0.1 * Z0MG
    zlog_m = jnp.log(zs[:, 1] / Z0MG)
    zlog_c = jnp.log(zs[:, 1] / zoc_g)
    ustar_g = jnp.maximum(wind[:, 1] * VKC / zlog_m, 0.01)
    res_g = zlog_c / (VKC * ustar_g)
    ga0 = rhomol[:, 0] / res_g
    res_g = jnp.minimum(rhomol[:, 0] / ga0, RA_MAX)
    ga0 = rhomol[:, 0] / res_g
    ga = ga.at[:, 0].set(ga0)

    # clamp resistance to < 500 s/m for k >= 1
    res = jnp.minimum(rhomol / ga, 500.0)
    ga_clamped = rhomol / res
    ga = jnp.where(k[None, :] >= 1, ga_clamped, ga)
    return ga


def presolve(tab: PsiHatTablesJnp, inp: TurbInputs, zs, ntop: int):
    """Full turbulence presolve: Obukhov solve + wind + conductances.

    Returns (TurbAux, wind [ncair, nlev], ga [ncair, nlev])."""
    aux = obukhov_length(tab, inp)
    wind, _ = wind_profile(tab, inp, aux, zs, ntop)
    ga = aerodynamic_conductances(tab, inp, aux, zs, wind, ntop)
    return aux, wind, ga
