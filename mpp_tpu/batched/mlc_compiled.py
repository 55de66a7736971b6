"""Compiled MLC: the facade-built multi-layer-canopy KSP problem on the
batched path.

The MLC analog of :mod:`~mpp_tpu.batched.ksp_compiled` (VERDICT r3 item
3): a problem built through ``MLCMPP`` (meshes, 3·ntree+2 fused GE
blocks, staged auxvars) is frozen into one jitted assemble+solve per
KSP step.  The serial path's per-cell Python assembly
(``models/mlc.py`` compute_rhs / compute_operators, the reference's
``SystemOfEquationsMLCType.F90:138-455`` block fill) becomes pure
vectorized segment evaluations over the SAME static COO structure:

* every ``add(r, c, v)`` site in the serial assembly maps to a
  vectorized segment (soil rows, interior accumulation, leaf-slot
  coupling, connection stencils, BC rows) whose coordinates are frozen
  at compile from the staged configuration (``dpai > 0`` and
  ``is_soil`` patterns — the reference re-discovers sparsity per step
  via MATPREALLOCATOR; we amortize, so recompile if the plant-area
  pattern changes);
* CSR assembly sums duplicate contributions, so segment ORDER is free —
  values land within f64 round-off of the serial loop order;
* the linear solve replicates the reference's GMRES(30)+ILU(0) at
  rtol 1e-5 through the batched machinery (``batched/ilu_gmres``), so
  golden trajectories (mlc suite) are reproduced through this path.

Serial drop-in (golden parity, ncol=1)::

    comp = compile_mlc(mpp)
    comp.install()            # mpp.soe.step_dt now runs compiled

The Obukhov/wind/conductance PreSolve stays host-side in the serial
wrapper exactly as the reference keeps it outside the KSP callbacks
(``MlcSoePreSolve``); the batched production pipeline's turbulence runs
through ``batched/turbulence`` (see ``batched/canopy_pipeline``).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from mpp_tpu.models.mlc import LAMBDA, _A, _B
from mpp_tpu.ops.sparse import csr_template


def _satvap(t):
    """jnp twin of models.mlc.satvap_np (Flatau water-range polynomial,
    op-for-op with util/SatVapor.F90:95-113)."""
    tc = jnp.minimum(jnp.maximum(t - 273.15, -75.0), 100.0)
    es = jnp.full_like(tc, _A[-1])
    for c in reversed(_A[:-1]):
        es = c + tc * es
    desdt = jnp.full_like(tc, _B[-1])
    for c in reversed(_B[:-1]):
        desdt = c + tc * desdt
    return es * 100.0, desdt * 100.0


#: dynamic per-step inputs gathered from the staged MLCMPP attributes
_STATE_KEYS = (
    "at_T", "av_q", "at_cpair", "at_rhomol", "at_pref",
    "at_soil_rhg", "at_soil_rn", "at_soil_tk", "at_soil_dz",
    "at_soil_resis", "at_soil_T", "at_gbh", "at_leaf_gs",
    "at_leaf_fwet", "at_leaf_fdry", "at_leaf_fssh", "at_leaf_dpai",
    "at_conn_ga", "at_bc_ga", "at_bc_T",
    "av_cpair", "av_rhomol", "av_pref", "av_soil_rhg", "av_soil_rn",
    "av_soil_tk", "av_soil_dz", "av_soil_resis", "av_soil_T",
    "av_gbv", "av_leaf_T", "av_leaf_gs", "av_leaf_fwet",
    "av_leaf_fdry", "av_leaf_fssh", "av_leaf_dpai",
    "av_conn_ga", "av_bc_ga", "av_bc_q",
)
_LEAF_KEYS = ("T", "pref", "cpair", "gbh", "gbv", "gs", "rn", "cp",
              "fwet", "fdry", "dpai")


class CompiledMLC:
    """A facade-built ``MLCMPP`` frozen into a jitted assemble+solve."""

    def __init__(self, mpp, ksp_rtol: float = 1e-5, ksp_restart: int = 30):
        self.mpp = mpp
        self.ksp_rtol = ksp_rtol
        self.ksp_restart = ksp_restart
        m = mpp
        Na, Nl, ns, nc = m.Na, m.Nl, m.nleaf_slots, m.ncair
        nlev = m.nlev
        o = m.off
        self.o = o

        # ---- static index machinery (patterns frozen at compile) ----
        sc = np.arange(nc, dtype=np.int64) * nlev          # soil cells
        sic = np.arange(nc, dtype=np.int64) * (nlev - 1)   # their iconn
        self.sc, self.sic = sc, sic
        nonsoil = np.nonzero(~m.at_is_soil)[0]
        self.nonsoil = nonsoil
        # (i, l) pairs with plant area, interior cells only
        dp_at = np.asarray(m.at_leaf_dpai) > 0.0
        dp_at[m.at_is_soil] = False
        self.pi_i, self.pi_l = np.nonzero(dp_at)
        dp_av = np.asarray(m.av_leaf_dpai) > 0.0
        dp_av[m.av_is_soil] = False
        self.pv_i, self.pv_l = np.nonzero(dp_av)
        cu = np.asarray(m.conn_up)
        cd = np.asarray(m.conn_dn)
        self.cu, self.cd = cu, cd
        su = np.asarray(m.at_is_soil)[cu]
        sd = np.asarray(m.at_is_soil)[cd]
        self.conn_soil_cell = np.where(su, cu, cd)
        self.conn_touches_soil = su | sd
        bc = np.asarray(m.bc_cell)
        self.bc = bc
        # leaf-coupling index sets per rank (compile-time dpai pattern)
        self.leaf_sets = []
        for r in (0, 1):
            slots = np.asarray(m.leaf_slot) + r * m.ntree
            cair = np.asarray(m.leaf2cair)
            act_at = np.asarray(m.at_leaf_dpai)[cair, slots] > 0.0
            act_av = np.asarray(m.av_leaf_dpai)[cair, slots] > 0.0
            act_ge = np.asarray(m.leaf[r]["dpai"]) > 0.0
            self.leaf_sets.append(dict(
                slots=slots, cair=cair,
                il_at=np.nonzero(act_at)[0], il_av=np.nonzero(act_av)[0],
                act_ge=act_ge, il_ge=np.nonzero(act_ge)[0],
                il_ge_off=np.nonzero(~act_ge)[0]))

        rows, cols = self._coords()
        self.template = csr_template(m.n, m.n, rows, cols)
        from mpp_tpu.batched.ilu_gmres import BatchedILU0, make_ell_matvec
        self._ilu = BatchedILU0(self.template.indptr, self.template.indices)
        self._matvec = make_ell_matvec(self.template.indptr,
                                       self.template.indices)
        self._jit = jax.jit(self._assemble_solve)

    # ---- static COO coordinates, one tuple per value segment ----
    def _coords(self):
        m, o = self.mpp, self.o
        sc, sic, bc = self.sc, self.sic, self.bc
        cu, cd = self.cu, self.cd
        ns_ = self.nonsoil
        su = np.asarray(m.at_is_soil)[cu]
        sd = np.asarray(m.at_is_soil)[cd]
        R, C = [], []

        def seg(r, c):
            R.append(np.asarray(r, np.int64))
            C.append(np.asarray(c, np.int64))

        # air-T diag
        seg(o[0] + sc, o[0] + sc)                      # 1.0
        seg(o[0] + sc, o[0] + sc + 1)                  # -alpha0
        seg(o[0] + sc + 1, o[0] + sc + 1)              # -alpha0*ga
        seg(o[0] + ns_, o[0] + ns_)                    # accum
        seg(o[0] + self.pi_i, o[0] + self.pi_i)        # 2 gbh fssh dpai
        seg(o[0] + cu, o[0] + cd)                      # conns (masked vals)
        seg(o[0] + cu, o[0] + cu)
        seg(o[0] + cd, o[0] + cu)
        seg(o[0] + cd, o[0] + cd)
        seg(o[0] + bc, o[0] + bc)                      # bc_ga
        # air-T offdiag
        seg(o[0] + sc, o[1] + sc + 1)                  # -beta0
        seg(o[0] + sc + 1, o[1] + sc + 1)              # -beta0*ga
        for r in (0, 1):
            ls = self.leaf_sets[r]
            seg(o[0] + ls["cair"][ls["il_at"]], o[2 + r] + ls["il_at"])
        # air-vapor diag
        seg(o[1] + sc, o[1] + sc)                      # 1.0
        seg(o[1] + sc + 1, o[1] + sc + 1)              # soil beta term
        seg(o[1] + ns_, o[1] + ns_)                    # accum
        seg(o[1] + self.pv_i, o[1] + self.pv_i)        # gleaf_et
        seg(o[1] + cu, o[1] + cd)                      # conns (masked vals)
        seg(o[1] + cu, o[1] + cu)
        seg(o[1] + cd, o[1] + cu)
        seg(o[1] + cd, o[1] + cd)
        seg(o[1] + bc, o[1] + bc)
        # air-vapor offdiag
        seg(o[1] + sc, o[0] + sc)                      # explicit zero
        seg(o[1] + sc + 1, o[0] + sc + 1)
        for r in (0, 1):
            ls = self.leaf_sets[r]
            seg(o[1] + ls["cair"][ls["il_av"]], o[2 + r] + ls["il_av"])
        # leaf GEs
        for r in (0, 1):
            ls = self.leaf_sets[r]
            seg(o[2 + r] + ls["il_ge"], o[2 + r] + ls["il_ge"])   # diag
            seg(o[2 + r] + ls["il_ge"],
                o[0] + ls["cair"][ls["il_ge"]])                   # vs T
            seg(o[2 + r] + ls["il_ge"],
                o[1] + ls["cair"][ls["il_ge"]])                   # vs q
            seg(o[2 + r] + ls["il_ge_off"], o[2 + r] + ls["il_ge_off"])
        return np.concatenate(R), np.concatenate(C)

    # ---- pure value/rhs evaluation over the same segments ----
    def _values_rhs(self, S, L, dt):
        m, o = self.mpp, self.o
        sc = jnp.asarray(self.sc)
        sic = jnp.asarray(self.sic)
        vol = jnp.asarray(m._compute_vol_air())
        V = []

        # soil coefficients, temperature GE (models/mlc._soil_coeffs)
        ga_s = S["at_conn_ga"][sic]
        gsw = 1.0 / S["at_soil_resis"][sc] * S["at_rhomol"][sc]
        gs0 = gsw * ga_s / (gsw + ga_s)
        esat0, desat0 = _satvap(S["at_T"][sc])
        qsat0 = esat0 / S["at_pref"][sc]
        dqsat0 = desat0 / S["at_pref"][sc]
        rhg = S["at_soil_rhg"][sc]
        tkdz = S["at_soil_tk"][sc] / S["at_soil_dz"][sc]
        gamma0 = (S["at_cpair"][sc] * ga_s + LAMBDA * rhg * gs0 * dqsat0
                  + tkdz)
        alpha0 = S["at_cpair"][sc] * ga_s / gamma0
        beta0 = LAMBDA * gs0 / gamma0
        delta0 = (S["at_soil_rn"][sc]
                  - LAMBDA * rhg * gs0 * (qsat0 - dqsat0 * S["at_T"][sc])
                  + tkdz * S["at_soil_T"][sc]) / gamma0

        # soil coefficients, vapor GE (av_* staging)
        ga_v = S["av_conn_ga"][sic]
        gswv = 1.0 / S["av_soil_resis"][sc] * S["av_rhomol"][sc]
        gs0v = gswv * ga_v / (gswv + ga_v)
        av_T_sc = S["at_T"][sc]            # av_T == at_T after exchange
        esat0v, desat0v = _satvap(av_T_sc)
        qsat0v = esat0v / S["av_pref"][sc]
        dqsat0v = desat0v / S["av_pref"][sc]
        rhgv = S["av_soil_rhg"][sc]
        tkdzv = S["av_soil_tk"][sc] / S["av_soil_dz"][sc]
        gamma0v = (S["av_cpair"][sc] * ga_v
                   + LAMBDA * rhgv * gs0v * dqsat0v + tkdzv)
        alpha0v = S["av_cpair"][sc] * ga_v / gamma0v
        beta0v = LAMBDA * gs0v / gamma0v
        delta0v = (S["av_soil_rn"][sc]
                   - LAMBDA * rhgv * gs0v * (qsat0v - dqsat0v * av_T_sc)
                   + tkdzv * S["av_soil_T"][sc]) / gamma0v

        one_s = jnp.ones_like(gs0)
        # air-T diag
        V += [one_s, -alpha0, -alpha0 * ga_s]
        ns_ = jnp.asarray(self.nonsoil)
        V.append(S["at_rhomol"][ns_] / dt * vol[ns_])
        pi_i, pi_l = jnp.asarray(self.pi_i), jnp.asarray(self.pi_l)
        V.append(2.0 * S["at_gbh"][pi_i, pi_l]
                 * S["at_leaf_fssh"][pi_i, pi_l]
                 * S["at_leaf_dpai"][pi_i, pi_l])
        cu, cd = jnp.asarray(self.cu), jnp.asarray(self.cd)
        su = jnp.asarray(np.asarray(m.at_is_soil)[self.cu])
        sd = jnp.asarray(np.asarray(m.at_is_soil)[self.cd])
        vco = S["at_conn_ga"]
        V.append(jnp.where(~su & ~sd, -vco, 0.0))      # (u, d)
        V.append(jnp.where(~su, vco, 0.0))             # (u, u)
        V.append(jnp.where(~sd & ~su, -vco, 0.0))      # (d, u)
        V.append(jnp.where(~sd, vco, 0.0))             # (d, d)
        V.append(S["at_bc_ga"])
        # air-T offdiag
        V += [-beta0, -beta0 * ga_s]
        for r in (0, 1):
            ls = self.leaf_sets[r]
            il = jnp.asarray(ls["il_at"])
            ca = jnp.asarray(ls["cair"][ls["il_at"]])
            sl = jnp.asarray(ls["slots"][ls["il_at"]])
            V.append(-2.0 * S["at_gbh"][ca, r]
                     * S["at_leaf_fssh"][ca, sl]
                     * S["at_leaf_dpai"][ca, sl])
        # air-vapor diag
        V.append(one_s)
        V.append(-gs0v * dqsat0v * rhgv * beta0v)
        V.append(S["av_rhomol"][ns_] / dt * vol[ns_])
        pv_i, pv_l = jnp.asarray(self.pv_i), jnp.asarray(self.pv_l)
        gbv_pv = S["av_gbv"][pv_i, pv_l]
        gs_pv = S["av_leaf_gs"][pv_i, pv_l]
        gleaf_pv = gs_pv * gbv_pv / (gs_pv + gbv_pv)
        gleafet_pv = (gleaf_pv * S["av_leaf_fdry"][pv_i, pv_l]
                      + gbv_pv * S["av_leaf_fwet"][pv_i, pv_l]) \
            * S["av_leaf_fssh"][pv_i, pv_l] * S["av_leaf_dpai"][pv_i, pv_l]
        V.append(gleafet_pv)
        # vapor connections: soil-touching conns take the series value;
        # non-touching lanes guard the (zero) soil resistance so masked
        # branches stay finite under nan-debugging
        csc = jnp.asarray(self.conn_soil_cell)
        touches = jnp.asarray(self.conn_touches_soil)
        res_safe = jnp.where(touches, S["av_soil_resis"][csc], 1.0)
        gsw_c = 1.0 / res_safe * S["av_rhomol"][csc]
        ga_c = S["av_conn_ga"]
        vser = gsw_c * ga_c / (gsw_c + ga_c)
        vval = jnp.where(touches, vser, ga_c)
        V.append(jnp.where(~su & ~sd, -vval, 0.0))
        V.append(jnp.where(~su, vval, 0.0))
        V.append(jnp.where(~sd & ~su, -vval, 0.0))
        V.append(jnp.where(~sd, vval, 0.0))
        V.append(S["av_bc_ga"])
        # air-vapor offdiag
        V.append(jnp.zeros_like(one_s))
        V.append(-rhgv * dqsat0v * gs0v * alpha0v)
        for r in (0, 1):
            ls = self.leaf_sets[r]
            ca = jnp.asarray(ls["cair"][ls["il_av"]])
            sl = jnp.asarray(ls["slots"][ls["il_av"]])
            _, desat_l = _satvap(S["av_leaf_T"][ca, sl])
            dqsat_l = desat_l / S["av_pref"][ca]
            gbv_l = S["av_gbv"][ca, r]
            gs_l = S["av_leaf_gs"][ca, sl]
            gleaf_l = gs_l * gbv_l / (gs_l + gbv_l)
            gleafet_l = (gleaf_l * S["av_leaf_fdry"][ca, sl]
                         + gbv_l * S["av_leaf_fwet"][ca, sl]) \
                * S["av_leaf_fssh"][ca, sl] * S["av_leaf_dpai"][ca, sl]
            V.append(-dqsat_l * gleafet_l)
        # leaf GEs
        leaf_rhs = []
        for r in (0, 1):
            ls = self.leaf_sets[r]
            G = L[r]
            il = jnp.asarray(ls["il_ge"])
            esat_g, desat_g = _satvap(G["T"][il])
            qsat_g = esat_g / G["pref"][il]
            dqsat_g = desat_g / G["pref"][il]
            gleaf_g = G["gs"][il] * G["gbv"][il] / (G["gs"][il]
                                                    + G["gbv"][il])
            gleafet_g = (gleaf_g * G["fdry"][il]
                         + G["gbv"][il] * G["fwet"][il])
            V.append(G["cp"][il] / dt
                     + 2.0 * G["cpair"][il] * G["gbh"][il]
                     + LAMBDA * dqsat_g * gleafet_g)
            V.append(-2.0 * G["cpair"][il] * G["gbh"][il])
            V.append(-LAMBDA * gleafet_g)
            V.append(jnp.ones(ls["il_ge_off"].size, one_s.dtype))
            bl = jnp.zeros(m.Nl, one_s.dtype)
            bl = bl.at[il].set(G["rn"][il] + G["cp"][il] / dt * G["T"][il]
                               - LAMBDA * (qsat_g - dqsat_g * G["T"][il])
                               * gleafet_g)
            leaf_rhs.append(bl)

        vals = jnp.concatenate(V)

        # ---- rhs ----
        bt = jnp.zeros(m.Na, one_s.dtype)
        bt = bt.at[ns_].add(S["at_rhomol"][ns_] / dt * S["at_T"][ns_]
                            * vol[ns_])
        bt = bt.at[sc].set(delta0)
        bt = bt.at[sc + 1].add(delta0 * ga_s)
        bt = bt.at[jnp.asarray(self.bc)].add(S["at_bc_ga"] * S["at_bc_T"])

        bq = jnp.zeros(m.Na, one_s.dtype)
        bq = bq.at[ns_].add(S["av_rhomol"][ns_] / dt * S["av_q"][ns_]
                            * vol[ns_])
        esat_pv, desat_pv = _satvap(S["av_leaf_T"][pv_i, pv_l])
        qsat_pv = esat_pv / S["av_pref"][pv_i]
        dqsat_pv = desat_pv / S["av_pref"][pv_i]
        bq = bq.at[pv_i].add(gleafet_pv
                             * (qsat_pv - dqsat_pv
                                * S["av_leaf_T"][pv_i, pv_l]))
        bq = bq.at[sc].set(S["av_q"][sc])
        bq = bq.at[sc + 1].add(gs0v * rhgv * (
            qsat0v + dqsat0v * (delta0v - av_T_sc)))
        bq = bq.at[jnp.asarray(self.bc)].add(S["av_bc_ga"] * S["av_bc_q"])

        b = jnp.concatenate([bt, bq] + leaf_rhs)
        return vals, b

    def _assemble_solve(self, S, L, dt):
        from mpp_tpu.batched.ilu_gmres import petsc_gmres_batched
        vals, b = self._values_rhs(S, L, dt)
        data = self.template.assemble(vals)[None, :]
        lu = self._ilu.factor(data)
        x, cycles, conv = petsc_gmres_batched(self._matvec, data, b[None, :],
                                              ilu=self._ilu, pc_data=lu,
                                              rtol=self.ksp_rtol,
                                              restart=self.ksp_restart)
        return x[0], cycles

    # ---- public API ----
    def install(self):
        self.mpp.soe.step_dt = self.step_dt
        return self

    def step_dt(self, dt, nstep: int = 1):
        """Drop-in for the MLC SoE ``step_dt``: host PreSolve (Obukhov
        chain + auxvar exchange, MlcSoePreSolve), jitted assemble+solve,
        host PostSolve."""
        m = self.mpp
        m.dtime = dt
        m._vol_air = m._compute_vol_air()
        m.pre_solve()
        m.exchange_auxvars()       # compute_rhs refreshes before staging
        S = {k: jnp.asarray(getattr(m, k)) for k in _STATE_KEYS}
        L = tuple({k: jnp.asarray(m.leaf[r][k]) for k in _LEAF_KEYS}
                  for r in (0, 1))
        x, cycles = self._jit(S, L, dt)
        m.cumulative_linear_iterations += int(cycles)
        m.soln_prev[:] = m.soln
        m.soln[:] = np.asarray(x)
        m.post_solve()
        if m.soe.metrics is not None:
            m.soe.metrics.record(step=nstep, dt=dt, converged=True,
                                 solver="compiled",
                                 linear_iterations=int(cycles))
        return True, int(cycles)


def compile_mlc(mpp, **kw) -> CompiledMLC:
    """Freeze a fully-staged ``MLCMPP`` into a compiled stepper."""
    return CompiledMLC(mpp, **kw)
