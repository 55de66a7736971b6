"""Saturation-function tests: analytic identities, FD derivative checks,
round-trip inverses, branch behavior at the saturated limit.

Reference behavior: src/mpp/util/SaturationFunction.F90.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from mpp_tpu.constants import PRESSURE_REF
from mpp_tpu.ops import satfunc as sf


def make_vg(n=1, sat_res=0.125, alpha=1.0e-4, vg_m=0.5):
    p = sf.SatParams.zeros(n)
    p.set_vg(slice(None), sat_res, alpha, vg_m)
    return p


def make_bc(n=1, sat_res=0.1, alpha=2.0e-4, lam=0.4):
    p = sf.SatParams.zeros(n)
    p.set_bc(slice(None), sat_res, alpha, lam)
    return p


def test_vg_saturated_limit():
    p = make_vg()
    sat, dsat = sf.press_to_sat(p, jnp.array([PRESSURE_REF + 10.0]))
    assert float(sat[0]) == 1.0 and float(dsat[0]) == 0.0
    kr, dkr = sf.press_to_relperm(p, jnp.array([PRESSURE_REF + 10.0]), 1.0)
    assert float(kr[0]) == 1.0 and float(dkr[0]) == 0.0


def test_vg_analytic_value():
    """Closed-form VG check: Se = (1+(-alpha pc)^n)^-m."""
    sat_res, alpha, m = 0.125, 1e-4, 0.5
    n = 1.0 / (1.0 - m)
    p = make_vg(sat_res=sat_res, alpha=alpha, vg_m=m)
    pc = -20000.0
    press = jnp.array([pc + PRESSURE_REF])
    sat, _ = sf.press_to_sat(p, press)
    Se = (1 + (-alpha * pc) ** n) ** (-m)
    assert float(sat[0]) == pytest.approx(sat_res + (1 - sat_res) * Se, rel=1e-14)
    kr, _ = sf.press_to_relperm(p, press, 1.0)
    AA = (-alpha * pc) ** n / (1 + (-alpha * pc) ** n)
    kr_expect = np.sqrt(Se) * (1 - AA ** m) ** 2
    assert float(kr[0]) == pytest.approx(kr_expect, rel=1e-14)


@pytest.mark.parametrize("maker", [make_vg, make_bc])
def test_fd_derivatives(maker):
    p = maker()
    press = jnp.array([PRESSURE_REF - 30000.0])
    dp = 1e-2
    sat, dsat = sf.press_to_sat(p, press)
    sp, _ = sf.press_to_sat(p, press + dp)
    sm, _ = sf.press_to_sat(p, press - dp)
    assert float(dsat[0]) == pytest.approx(float(sp[0] - sm[0]) / (2 * dp), rel=1e-6)
    kr, dkr = sf.press_to_relperm(p, press, 1.0)
    kp, _ = sf.press_to_relperm(p, press + dp, 1.0)
    km, _ = sf.press_to_relperm(p, press - dp, 1.0)
    assert float(dkr[0]) == pytest.approx(float(kp[0] - km[0]) / (2 * dp), rel=1e-6)


def test_roundtrip_vg_bc():
    for maker in (make_vg, make_bc):
        p = maker()
        press = jnp.array([PRESSURE_REF - 45000.0])
        sat, _ = sf.press_to_sat(p, press)
        back = sf.sat_to_press(p, sat)
        assert float(back[0]) == pytest.approx(float(press[0]), rel=1e-12)


def test_sbc_continuity():
    """SBC saturation is continuous at pu and ps."""
    n = 1
    p = sf.SatParams.zeros(n)
    alpha, lam, sat_res = 2.0e-4, 0.4, 0.1
    ps = -0.9 / alpha
    p.set_sbc_bz2(slice(None), sat_res, alpha, lam, ps)
    pu = p.sbc_pu[0]
    eps = 1e-6 * abs(pu)
    for pc0 in (pu, ps):
        lo, _ = sf.pc_to_sat_sbc(p, jnp.array([pc0 - eps]))
        hi, _ = sf.pc_to_sat_sbc(p, jnp.array([pc0 + eps]))
        assert float(lo[0]) == pytest.approx(float(hi[0]), abs=1e-6)
    # saturated regime
    sat, _ = sf.pc_to_sat_sbc(p, jnp.array([0.0]))
    assert float(sat[0]) == 1.0


def test_sbc_bz3():
    p = sf.SatParams.zeros(1)
    alpha, lam, sat_res = 2.0e-4, 0.4, 0.1
    p.set_sbc_bz3(slice(None), sat_res, alpha, lam, -0.9 / alpha)
    assert p.sbc_b3[0] == 0.0 and p.sbc_b2[0] < 0.0
    sat, dsat = sf.pc_to_sat_sbc(p, jnp.array([p.sbc_pu[0] * 1.5]))
    assert 0.0 < float(sat[0]) < 1.0


def test_fetch2_chuang():
    p = sf.SatParams.zeros(2)
    p.set_fetch2(0, -2.0e6, -3.0e6)
    # chuang_phi0 is negative in real drivers (vsfm_spac_fetch2_problem.F90:42)
    p.set_chuang(1, -2.0e6, 2.0)
    press = jnp.array([PRESSURE_REF - 1.0e6, PRESSURE_REF - 1.0e6])
    sat, dsat = sf.press_to_sat(p, press)
    assert 0.0 < float(sat[0]) < 1.0 and 0.0 < float(sat[1]) < 1.0
    back = sf.sat_to_press(p, sat)
    # FETCH2 forward/inverse are mutual inverses.
    assert float(back[0]) == pytest.approx(float(press[0]), rel=1e-12)
    # The reference's SatToPc_Chuang (SaturationFunction.F90:1364-1389) is
    # sign-inconsistent with PcToSat_Chuang for the negative-phi0 convention
    # its drivers use; it is also dead code (no caller in the reference).
    # We reproduce the literal formula: pc = (sat^(-1/p) - 1) * (-phi0).
    phi0, pp = -2.0e6, 2.0
    expect_pc = (1.0 / float(sat[1]) ** (1.0 / pp) - 1.0) * (-phi0)
    assert float(back[1]) == pytest.approx(expect_pc + PRESSURE_REF, rel=1e-12)


def test_weibull_campbell_relperm():
    p = sf.SatParams.zeros(2)
    p.set_vg(slice(None), 0.125, 1e-4, 0.5)  # sat func (unused by these relperms)
    p.set_weibull_relperm(0, 300.0 * 9806.65, 2.0)  # d [Pa], c
    # campbell_he is stored positive: drivers set `-Campbell_he*1e3` with
    # Campbell_he = -4.2 J/kg (vsfm_spac_campbell_problem.F90:1050,1452)
    p.set_campbell_relperm(1, 5000.0, 3.0)
    press = jnp.array([PRESSURE_REF - 2.0e6, PRESSURE_REF - 2.0e6])
    kr, dkr = sf.press_to_relperm(p, press, 1.0)
    pc = -2.0e6
    kr_w = np.exp(-((-pc / (300.0 * 9806.65)) ** 2.0))
    kr_c = (5000.0 / -pc) ** 3.0
    assert float(kr[0]) == pytest.approx(kr_w, rel=1e-12)
    assert float(kr[1]) == pytest.approx(kr_c, rel=1e-12)
    # FD check both
    dp = 1.0
    kp, _ = sf.press_to_relperm(p, press + dp, 1.0)
    km, _ = sf.press_to_relperm(p, press - dp, 1.0)
    fd = (np.asarray(kp) - np.asarray(km)) / (2 * dp)
    np.testing.assert_allclose(np.asarray(dkr), fd, rtol=1e-6)


def test_satvap():
    from mpp_tpu.ops.satvap import sat_vap, lat_vap
    es, desdt = sat_vap(jnp.array([273.15 + 20.0]))
    # ~2339 Pa at 20C
    assert 2300.0 < float(es[0]) < 2400.0
    dT = 1e-3
    ep, _ = sat_vap(jnp.array([273.15 + 20.0 + dT]))
    em, _ = sat_vap(jnp.array([273.15 + 20.0 - dT]))
    assert float(desdt[0]) == pytest.approx(float(ep[0] - em[0]) / (2 * dT), rel=1e-5)
    # ice branch
    es_ice, _ = sat_vap(jnp.array([253.15]))
    assert 0.0 < float(es_ice[0]) < 200.0
    assert float(lat_vap(jnp.array([300.0]))[0]) == pytest.approx(2.501e6 * 18.02e-3)
    assert float(lat_vap(jnp.array([260.0]))[0]) == pytest.approx(2.8347e6 * 18.02e-3)


def test_porosity():
    from mpp_tpu.ops.porosity import PorosityParams, porosity
    pp = PorosityParams.constant(np.array([0.35, 0.4]))
    por, dpor = porosity(pp, jnp.array([2.0e5, 1.0e5]))
    np.testing.assert_allclose(np.asarray(por), [0.35, 0.4])
    np.testing.assert_allclose(np.asarray(dpor), [0.0, 0.0])
    pl = PorosityParams.linear(np.array([0.35]), 1.0e5, 1e-9)
    por, dpor = porosity(pl, jnp.array([2.0e5]))
    assert float(por[0]) == pytest.approx(0.35 + 1.0e5 * 1e-9)
    assert float(dpor[0]) == pytest.approx(1e-9)


@pytest.mark.parametrize("satfunc_type,AA", [("smooth_brooks_corey_bz3", 2),
                                             ("smooth_brooks_corey_bz2", 3)])
def test_satparams_dyn_clm_matches_scalar_solve(satfunc_type, AA):
    """The per-column SBC staging solves the pu multiplier once per
    distinct lambda and maps it back; repeated and distinct lambdas get
    exactly the scalar solve's value."""
    rng = np.random.default_rng(0)
    lam = 1.0 / (2.0 + 2.0 * rng.random((7, 5)))
    lam[0] = lam[1]
    alpha = 1.0 / ((20.0 + 20.0 * rng.random((7, 5))) * 9.80616)
    out = sf.satparams_dyn_clm(satfunc_type, np.full((7, 5), 0.1), alpha,
                               lam)
    want = np.vectorize(
        lambda lv: sf._find_gu_sbc_zero_coeff(float(lv), AA, 0.9))(lam)
    np.testing.assert_array_equal(out["sbc_pu"], want / (-alpha))
