"""Batched end-to-end canopy pipeline: the ml_model substep loop as one
jitted function over [ncair] columns — the production path for the
coupled canopy system.

Reproduces the operator-split orchestration of
``driver/standalone/ml_model/ml_model_problem.F90:377-409``:

  shortwave (hourly, solved once at build — sky forcing is static here)
  -> per substep: longwave -> leaf boundary layer -> photosynthesis ->
     multi-layer canopy (turbulence presolve + coupled T/q/Tleaf solve)

with the inter-MPP data plumbing of ``ml_model/{swv,lwv,lbl,
photosynthesis,mlc}.F90`` (absorbed radiation -> leaf net radiation,
boundary-layer conductances -> photosynthesis & canopy exchange, stomatal
conductance -> transpiration, canopy-top state -> next Obukhov iterate).

Every stage is pure jnp: longwave/MLC solve through the batched
block-Thomas path, photosynthesis through the batched masked Newton,
turbulence through the batched Obukhov solve.  The whole substep jits to
a single XLA program; columns shard over the device mesh.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from mpp_tpu.constants import MM_H2O, MM_DRY_AIR
from mpp_tpu.batched import turbulence as bt
from mpp_tpu.batched import mlc as bmlc
from mpp_tpu.batched import photosynthesis as bp
from mpp_tpu.models import photosynthesis as ph
from mpp_tpu.models.canopy_turbulence import CanopyTurbulenceAuxVar
from mpp_tpu.models.lbl import LeafBoundaryLayerGE
from mpp_tpu.models.radiation import LongwaveGE, ShortwaveMPP
from mpp_tpu.ops.block_structure import BlockTridiagTemplate
from mpp_tpu.problems import mlc as mlc_problem
from mpp_tpu.problems.canopy_radiation import canopy_mesh, _top_bc_conns
from mpp_tpu.problems.photosynthesis import _set_soil_parameters


class CanopyState(NamedTuple):
    """Per-column prognostic state ([ncair, nlev]; level 0 = ground)."""
    T_air: jnp.ndarray
    q_air: jnp.ndarray
    T_sun: jnp.ndarray
    T_shd: jnp.ndarray


class Forcing(NamedTuple):
    """Hourly forcing record as DYNAMIC inputs of the jitted stages
    (the reference re-reads BCs and re-solves shortwave every hour,
    ml_model_problem.F90:375-382; making these jit arguments means the
    hourly update never retraces).  Built by
    :meth:`CanopyPipeline.make_forcing`."""
    apar_sun: jnp.ndarray        # [nc, nlev] absorbed PAR per leaf area
    apar_shd: jnp.ndarray
    rn_sw_sun: jnp.ndarray       # [nc, nlev] absorbed shortwave
    rn_sw_shd: jnp.ndarray
    isoil_sw: jnp.ndarray        # scalar
    fssh_lev: jnp.ndarray        # [nlev] sunlit fraction
    lw_trans: jnp.ndarray        # [nc*nlev] longwave layer transmittance
    irsky: jnp.ndarray           # scalar sky longwave
    tref: jnp.ndarray            # scalars: atmospheric forcing
    qref: jnp.ndarray
    uref: jnp.ndarray
    thref: jnp.ndarray
    bc_q: jnp.ndarray
    cpair: jnp.ndarray
    rhomol: jnp.ndarray
    soil_T: jnp.ndarray


@dataclasses.dataclass
class CanopyPipeline:
    """Build once, then call the jitted ``substep``.

    Forcing/canopy structure come from the mlc + ml_model reference test
    problems (mlc_parameters.F90, ml_model BCs), broadcast over ncair."""
    ncair: int
    nz_cair: int = 92
    dtype: object = jnp.float64

    def __post_init__(self):
        nc = self.ncair
        nlev = self.nz_cair + 1
        self.nlev = nlev
        dt = self.dtype

        dpai, _ = mlc_problem.get_dpai_fssh()
        self.dpai_lev = np.asarray(dpai[1:nlev + 1])        # [nlev], lev 0 soil
        dpai_pos = self.dpai_lev > 0.0

        # --- forcing (mlc_parameters.F90 + ml_model synthetic BCs)
        self.pref = 98620.0
        self.uref = 5.169
        self.tref = 295.9349938964844
        self.qref = 0.01
        self.irsky = 400.0
        self.soil_T_forcing = 294.8492736816406
        self.soil_res = 3361.509423807650
        self.soil_rhg = 0.9984057411945876
        self.soil_tk = 1.261326601469150
        self.soil_dz = 7.1006354171935350e-3
        self.co2ref, self.o2ref = 380.0, 0.209 * 1000.0

        # turbulence static pieces (zs grid + derived scalars)
        ct = CanopyTurbulenceAuxVar(1, nlev)
        ct.pai[0] = mlc_problem.PAI
        ct.hc[0] = mlc_problem.HC
        ct.zref[0] = 46.0
        ct.pref[0] = self.pref
        ct.uref[0] = self.uref
        ct.tref[0] = self.tref
        ct.qref[0] = self.qref
        ct.compute_derived_atm_inputs(0)
        self.zs = np.asarray(ct.zs)
        self.ntop = int(ct.ntop[0])
        self.thref = float(ct.thref[0])
        self.eref = float(ct.eref[0])
        self.cpair0 = float(ct.cpair[0])
        self.rhomol0 = float(ct.rhomol[0])
        self.tables = bt.load_psihat_jnp(dtype=dt)

        # --- shortwave facade problem (re-solved per forcing record)
        self._build_shortwave()
        self.default_forcing = self.make_forcing()
        # default-forcing aliases kept for the existing envelope tests
        f0 = self.default_forcing
        self.apar_sun = np.asarray(f0.apar_sun)
        self.apar_shd = np.asarray(f0.apar_shd)
        self.rn_sw_sun = np.asarray(f0.rn_sw_sun)
        self.rn_sw_shd = np.asarray(f0.rn_sw_shd)
        self.isoil_sw = float(f0.isoil_sw)
        self.fssh_lev = np.asarray(f0.fssh_lev)

        # --- longwave GE + block template at [ncair] columns
        dz_cair = 46.0 / self.nz_cair
        lw = LongwaveGE(name="lw", mesh=canopy_mesh(self.nz_cair, ncair=nc),
                        nleaf=2)
        lw.boundary_conditions = []
        from mpp_tpu.constants import Cond
        from mpp_tpu.dtypes.conditions import Condition
        cond = Condition(name="sky", units="W/m2", itype=int(Cond.DIRICHLET),
                         conn_set=_top_bc_conns(self.nz_cair, nc, dz_cair))
        cond.ensure_value()
        lw.boundary_conditions.append(cond)
        lw.allocate_auxvars()
        n = nc * nlev
        emleaf, emgrnd = 0.98, 0.96
        is_soil_n = np.zeros(n, bool)
        is_soil_n[0::nlev] = True
        lw.is_soil = is_soil_n
        lw.trans = jnp.asarray(np.asarray(self.default_forcing.lw_trans))
        lw.leaf_rho = jnp.full(n, 1.0 - emleaf)
        lw.leaf_tau = jnp.zeros(n)
        lw.leaf_emiss = jnp.full(n, emleaf)
        gem = np.zeros(n)
        gem[0::nlev] = emgrnd
        lw.ground_emiss = jnp.asarray(gem)
        dpai_n = np.tile(self.dpai_lev, nc)
        lw.leaf_dpai = jnp.stack([jnp.asarray(dpai_n)] * 2, axis=1)
        lw.bc_Idn = jnp.full(nc, self.irsky)
        r, c = lw.coo_coords()
        self.lw = lw
        self.lw_tpl = BlockTridiagTemplate(nc, nlev, lw.dof, r, c)

        # --- leaf boundary layer GE (2*nlev leaf cells per column: sun+shd)
        lbl_mesh = canopy_mesh(self.nz_cair, ncair=2 * nc)
        self.lbl = LeafBoundaryLayerGE(name="lbl", mesh=lbl_mesh)
        self.lbl.allocate_auxvars()
        self.lbl.dleaf = jnp.full(2 * n, 0.04)

        # --- photosynthesis: a real facade problem (8-step builder) whose
        # compiled form is the psy stage — one physics stack for the
        # golden configs and the production pipeline (VERDICT r4 item 1).
        # 2*n cells: [sun | shd] leaf lanes per canopy level.
        from mpp_tpu.constants import MPPType
        from mpp_tpu.problems.photosynthesis import _canopy_mesh
        psy_mpp = ph.PhotosynthesisMPP()
        psy_mpp.set_name("Photosynthesis model")
        psy_mpp.set_id(MPPType.PHOTOSYNTHESIS_SNES)
        psy_mpp.set_num_meshes(1)
        psy_mpp.add_mesh(_canopy_mesh(ncair=2 * nc, ntree=1,
                                      nz_cair=self.nz_cair))
        psy_mpp.add_goveqn()
        psy_mpp.allocate_auxvars(ph.PATHWAY_C3, ph.SCM_MEDLYN)
        psy_mpp.setup_problem()
        av = psy_mpp.soe.ge.avars
        av.pref[:] = self.pref
        av.cair[:] = self.co2ref
        av.o2ref[:] = self.o2ref
        av.btran[:] = 1.0
        av.dpai[:] = np.tile(dpai_n, 2)
        av.root_biomass[:] = 500.0
        av.root_radius[:] = 0.29e-3
        av.root_density[:] = 0.31e6
        av.root_resist[:] = 25.0
        _set_soil_parameters(av)
        av.leaf_psi[:] = -1.5
        av.leaf_height[:] = 15.0
        av.leaf_capc[:] = 2500.0
        av.leaf_minlwp[:] = -2.0
        av.leaf_lai[:] = 500.0
        av.k_stem2leaf[:] = 4.0
        self.psy_mpp = psy_mpp
        self.psy = bp.compile_photosynthesis(psy_mpp)
        self.psy_cfg = self.psy.cfg
        _, self._psy_params0 = bp.params_from_auxvars(av)

        # --- MLC static block-input pieces
        self.mlc_static = dict(
            cpair=jnp.full(nc, self.cpair0, dt),
            rhomol=jnp.full(nc, self.rhomol0, dt),
            pref=jnp.full(nc, self.pref, dt),
            leaf_cpair=jnp.asarray(self.cpair0, dt),
            leaf_pref=jnp.asarray(self.pref, dt),
            soil_rhg=jnp.full(nc, self.soil_rhg, dt),
            soil_tk=jnp.full(nc, self.soil_tk, dt),
            soil_dz=jnp.full(nc, self.soil_dz, dt),
            soil_res=jnp.full(nc, self.soil_res, dt),
            soil_T=jnp.full(nc, self.soil_T_forcing, dt),
            leaf_fwet=jnp.zeros((nc, nlev, 2), dt),
            leaf_fdry=jnp.broadcast_to(
                jnp.where(jnp.asarray(dpai_pos), mlc_problem.FDRY, 0.0),
                (nc, nlev)).astype(dt)[..., None].repeat(2, -1),
            leaf_fssh=jnp.stack(
                [jnp.broadcast_to(jnp.asarray(self.fssh_lev), (nc, nlev)),
                 jnp.broadcast_to(1.0 - jnp.asarray(self.fssh_lev),
                                  (nc, nlev))], axis=-1).astype(dt),
            leaf_dpai=jnp.broadcast_to(jnp.asarray(self.dpai_lev),
                                       (nc, nlev)).astype(dt)[..., None]
            .repeat(2, -1),
            leaf_cp=jnp.full((nc, nlev, 2), mlc_problem.CP_LEAF, dt),
            bc_T=jnp.full(nc, self.thref, dt),
            bc_q=jnp.full(nc, self.eref / self.pref, dt),
            vol_air=jnp.asarray(46.0 / self.nz_cair, dt),
        )
        self.dpai_pos = jnp.asarray(dpai_pos)

    # ------------------------------------------------------------------
    def _build_shortwave(self):
        """The ncair=1 shortwave facade problem (swv.F90 parameters);
        solved per forcing record by :meth:`solve_shortwave`."""
        from mpp_tpu.constants import Cond
        nlev = self.nlev
        sw = ShortwaveMPP()
        sw.add_mesh(canopy_mesh(self.nz_cair, ncair=1))
        ieqn = sw.add_goveqn("shortwave")
        dz_cair = 46.0 / self.nz_cair
        sw.add_condition_in_goveqn(ieqn, Cond.BC, "sky", "W/m2",
                                   Cond.DIRICHLET,
                                   conn_set=_top_bc_conns(self.nz_cair, 1,
                                                          dz_cair))
        sw.allocate_auxvars()
        ge = sw.goveqns[0]
        n1 = nlev
        dpai_pos = self.dpai_lev > 0.0
        is_soil = np.zeros(n1, bool)
        is_soil[0] = True
        ge.is_soil = is_soil
        ge.leaf_rho = jnp.where(jnp.asarray(dpai_pos)[:, None],
                                jnp.asarray([[0.10, 0.45]]), 1e-6)
        ge.leaf_tau = jnp.where(jnp.asarray(dpai_pos)[:, None],
                                jnp.asarray([[0.05, 0.25]]), 1e-6)
        ge.leaf_omega = ge.leaf_rho + ge.leaf_tau
        ge.leaf_dpai = jnp.asarray(self.dpai_lev)
        ge.soil_albedo_b = jnp.tile(jnp.asarray([[0.1, 0.2]]), (n1, 1))
        ge.soil_albedo_d = jnp.tile(jnp.asarray([[0.1, 0.2]]), (n1, 1))
        self.sw = sw

    def solve_shortwave(self, sza=0.5, iskyb=(320.0, 320.0),
                        iskyd=(20.0, 20.0)):
        """Re-solve the shortwave problem for a sun angle / sky forcing
        (solve_swv, ml_model_problem.F90:375-382 + swv.F90:188-273).
        Returns (apar_sun, apar_shd, rn_sun, rn_shd, isoil, fssh, td)
        as [nlev]-shaped numpy (broadcast over columns by the caller)."""
        from mpp_tpu.problems.ml_model import (compute_kb,
                                               compute_transmittance)
        nlev = self.nlev
        dpai_pos = self.dpai_lev > 0.0
        xl = 0.25
        _, _, kb = compute_kb(xl, sza)
        tb_lev = np.ones(nlev)
        td_lev = np.ones(nlev)
        for k in range(nlev):
            tb_lev[k], td_lev[k] = compute_transmittance(
                xl, sza, float(self.dpai_lev[k]), 1.0)
        cumpai_above = np.concatenate(
            [np.cumsum(self.dpai_lev[::-1])[::-1][1:], [0.0]])
        leaf_tbcum = np.exp(-kb * cumpai_above)
        sumpai_mid = cumpai_above + 0.5 * self.dpai_lev
        fssh_lev = np.where(dpai_pos, np.exp(-kb * sumpai_mid), 0.0)
        ge = self.sw.goveqns[0]
        n1 = nlev
        ge.leaf_td = jnp.asarray(td_lev)
        ge.leaf_tb = jnp.asarray(tb_lev)
        ge.leaf_tbcum = jnp.asarray(leaf_tbcum)
        ge.leaf_fssh = jnp.stack([jnp.asarray(fssh_lev),
                                  1.0 - jnp.asarray(fssh_lev)], axis=1)
        iskyb = np.asarray(iskyb, np.float64)
        iskyd = np.asarray(iskyd, np.float64)
        ge.Iskyb = jnp.tile(jnp.asarray(iskyb), (n1, 1))
        ge.Iskyd = jnp.tile(jnp.asarray(iskyd), (n1, 1))
        ge.bc_Iskyb = jnp.asarray(iskyb)[None, :]
        ge.bc_Iskyd = jnp.asarray(iskyd)[None, :]
        ok, _ = self.sw.step_dt(0.0)
        assert ok, "shortwave solve diverged"
        ge.post_solve()
        iabs = np.asarray(ge.Iabs_leaf)
        return (iabs[:, 0] * 4.6, iabs[:, 1] * 4.6,
                iabs[:, 0] + iabs[:, 2], iabs[:, 1] + iabs[:, 3],
                float(np.asarray(ge.Iabs_soil)[0].sum()), fssh_lev, td_lev)

    def make_forcing(self, sza=0.5, iskyb=(320.0, 320.0),
                     iskyd=(20.0, 20.0), irsky=None, tref=None, qref=None,
                     uref=None, soil_T=None) -> "Forcing":
        """One hourly :class:`Forcing` record: re-solves shortwave and
        derives the turbulence reference-state scalars."""
        nc, nlev, dt = self.ncair, self.nlev, self.dtype
        irsky = self.irsky if irsky is None else irsky
        tref = self.tref if tref is None else tref
        qref = self.qref if qref is None else qref
        uref = self.uref if uref is None else uref
        soil_T = self.soil_T_forcing if soil_T is None else soil_T
        ap_s, ap_h, rn_s, rn_h, isoil, fssh, td = self.solve_shortwave(
            sza, iskyb, iskyd)
        ct = CanopyTurbulenceAuxVar(1, nlev)
        ct.pai[0] = mlc_problem.PAI
        ct.hc[0] = mlc_problem.HC
        ct.zref[0] = 46.0
        ct.pref[0] = self.pref
        ct.uref[0] = uref
        ct.tref[0] = tref
        ct.qref[0] = qref
        ct.compute_derived_atm_inputs(0)
        sc = lambda v: jnp.asarray(v, dt)
        bcast = lambda v: jnp.broadcast_to(jnp.asarray(v, dt), (nc, nlev))
        return Forcing(
            apar_sun=bcast(ap_s), apar_shd=bcast(ap_h),
            rn_sw_sun=bcast(rn_s), rn_sw_shd=bcast(rn_h),
            isoil_sw=sc(isoil), fssh_lev=jnp.asarray(fssh, dt),
            lw_trans=jnp.asarray(np.tile(td, nc), dt),
            irsky=sc(irsky), tref=sc(tref), qref=sc(qref), uref=sc(uref),
            thref=sc(float(ct.thref[0])),
            bc_q=sc(float(ct.eref[0]) / self.pref),
            cpair=sc(float(ct.cpair[0])), rhomol=sc(float(ct.rhomol[0])),
            soil_T=sc(soil_T))

    def forcing_from_bc(self, bc) -> "Forcing":
        """Forcing from an ml_model hourly BC record
        (problems/ml_model.MLBoundaryConditions, e.g.
        synthetic_diurnal_bc)."""
        return self.make_forcing(
            sza=bc.sza, iskyb=(bc.iskyb_vis, bc.iskyb_nir),
            iskyd=(bc.iskyd_vis, bc.iskyd_nir), irsky=bc.irsky,
            tref=bc.tref, qref=bc.qref, uref=bc.uref, soil_T=bc.soil_t)

    def initial_state(self) -> CanopyState:
        nc, nlev = self.ncair, self.nlev
        T0 = jnp.full((nc, nlev), self.tref, self.dtype)
        q0 = jnp.full((nc, nlev), self.qref, self.dtype)
        return CanopyState(T_air=T0, q_air=q0, T_sun=T0, T_shd=T0)

    def substep(self, state: CanopyState, dt=300.0,
                forcing: "Forcing" = None) -> CanopyState:
        """One operator-split substep (lwv -> lbl -> psy -> mlc), pure jnp
        (ml_model_problem.F90:388-409).  ``forcing`` defaults to the
        build-time (midday) record; the diurnal loop passes the hourly
        record — a dynamic jit input, so the hour change never
        retraces."""
        if forcing is None:
            forcing = self.default_forcing
        pre = self._stage_pre(state, forcing)
        gs2 = self._stage_psy(state, pre, forcing)
        return self._stage_mlc(state, pre, gs2, forcing, dt)

    def staged_substep_fns(self, jax):
        """Three separately-jitted stage programs (pre = turbulence+
        longwave+LBL, psy = photosynthesis Newton, mlc = canopy block
        solve).  Splitting the monolithic substep into 3 programs cuts
        peak XLA compile cost ~3x (the bench's compile-budget lever) with
        identical numerics — every intermediate stays on device."""
        return (jax.jit(self._stage_pre), jax.jit(self._stage_psy),
                jax.jit(self._stage_mlc, static_argnums=(4,)))

    def fused_hour_fn(self, jax, nsubstep=12, dt=300.0):
        """ONE jitted program advancing a whole hourly record's
        ``nsubstep`` substeps (the reference's isubstep loop,
        ml_model_problem.F90:384-409) — one dispatch per HOUR instead of
        3 per substep, which removes the 3-dispatch floor the
        per-stage breakdown in bench.py quantifies; numerics identical to
        ``run_staged`` (same pure substep composition)."""
        def hour(state, forcing):
            def body(_, s):
                return self.substep(s, dt, forcing)
            return jax.lax.fori_loop(0, nsubstep, body, state)
        return jax.jit(hour)

    def run_staged(self, fns, state: CanopyState, dt=300.0,
                   forcing: "Forcing" = None) -> CanopyState:
        if forcing is None:
            forcing = self.default_forcing
        pre = fns[0](state, forcing)
        gs2 = fns[1](state, pre, forcing)
        return fns[2](state, pre, gs2, forcing, dt)

    def _stage_pre(self, state: CanopyState, forcing: "Forcing"):
        nc, nlev = self.ncair, self.nlev
        dtype = self.dtype

        # canopy-top state feeds the Obukhov iterate (mlc.F90:447-506)
        tcan = state.T_air[:, self.ntop - 1]
        q_top = state.q_air[:, self.ntop - 1]
        eair_top = q_top * self.pref
        factor = (MM_H2O / MM_DRY_AIR) / (
            self.pref - (1.0 - MM_H2O / MM_DRY_AIR) * eair_top)
        qcan = eair_top * factor

        ones = jnp.ones(nc, dtype)
        tinp = bt.derive_inputs(
            hc=mlc_problem.HC * ones, zref=46.0 * ones,
            pref=self.pref * ones, uref=forcing.uref * ones,
            qref=forcing.qref * ones, tref=forcing.tref * ones,
            tcan=tcan, qcan=qcan, pai=mlc_problem.PAI * ones)
        taux, wind, ga = bt.presolve(self.tables, tinp,
                                     np.broadcast_to(self.zs, (nc,
                                                               self.nlev)),
                                     self.ntop)

        # ---- longwave (block solve) -----------------------------------
        lw = self.lw
        gt = jnp.zeros((nc, nlev), dtype).at[:, 0].set(state.T_air[:, 0])
        lw.ground_temperature = gt.reshape(-1)
        lw.leaf_temperature = jnp.stack(
            [state.T_sun.reshape(-1), state.T_shd.reshape(-1)], axis=1)
        fssh_b = jnp.broadcast_to(forcing.fssh_lev, (nc, nlev))
        lw.leaf_fssh = jnp.stack(
            [fssh_b.reshape(-1), (1.0 - fssh_b).reshape(-1)], axis=1)
        lw.trans = forcing.lw_trans
        lw.bc_Idn = jnp.full(nc, forcing.irsky)
        x_lw = self.lw_tpl.solve(lw.matrix_values(), lw.rhs())
        iabs_lw = x_lw[..., 2]                       # [nc, nlev]
        dpai_b = jnp.broadcast_to(jnp.asarray(self.dpai_lev), (nc, nlev))
        labs = jnp.where(self.dpai_pos,
                         iabs_lw / jnp.where(dpai_b == 0, 1.0, dpai_b), 0.0)
        labs_soil = iabs_lw[:, 0]

        # ---- leaf boundary layer --------------------------------------
        lbl = self.lbl
        tleaf2 = jnp.concatenate([state.T_sun.reshape(-1),
                                  state.T_shd.reshape(-1)])
        tair2 = jnp.tile(state.T_air.reshape(-1), 2)
        wind2 = jnp.tile(wind.reshape(-1), 2)
        lbl.tleaf, lbl.tair, lbl.wind = tleaf2, tair2, wind2
        lbl.pref = jnp.full(2 * nc * nlev, self.pref, dtype)
        lbl.tref = jnp.full(2 * nc * nlev, 1.0, dtype) * forcing.tref
        lbl.compute()
        gbh2, gbv2, gbc2 = lbl.gbh, lbl.gbv, lbl.gbc
        # build-time longwave/LBL staging arrays are f64 numpy; under
        # jax_enable_x64 they upcast the stage — pin the stage boundary
        # to the pipeline dtype so f32 runs stay f32 end to end
        return tuple(a.astype(dtype) for a in
                     (ga, labs, labs_soil, gbh2, gbv2, gbc2, tleaf2))

    def _stage_psy(self, state: CanopyState, pre, forcing: "Forcing"):
        nc, nlev = self.ncair, self.nlev
        dtype = self.dtype
        ga, labs, labs_soil, gbh2, gbv2, gbc2, tleaf2 = pre

        # ---- photosynthesis (batched masked Newton) --------------------
        eair_lev = jnp.tile((state.q_air * self.pref).reshape(-1), 2)
        # absorbed PAR per leaf area from the shortwave stage, stacked
        # [sun | shd] like tleaf2 (ml_model photosynthesis.F90 staging:
        # av.apar = ileaf_vis * 4.6, solve_photosynthesis)
        apar2 = jnp.concatenate(
            [forcing.apar_sun.reshape(-1),
             forcing.apar_shd.reshape(-1)]).astype(dtype)
        p = self._psy_params0._replace(
            tleaf=tleaf2, gbv=gbv2, gbc=gbc2, eair=eair_lev, apar=apar2)
        x0 = jnp.full((2 * nc * nlev, 1), 0.9 * self.co2ref, dtype)
        res, bounded = bp.solve(self.psy_cfg, p, x0)
        out = bp.post_solve(self.psy_cfg, p, res.x, bounded)
        return jnp.where(bounded[:, 0], out.gs, ph.GS_MIN).astype(dtype)

    def _stage_mlc(self, state: CanopyState, pre, gs2, forcing: "Forcing",
                   dt=300.0):
        nc, nlev = self.ncair, self.nlev
        dtype = self.dtype
        ga, labs, labs_soil, gbh2, gbv2, gbc2, tleaf2 = pre
        gs_sun = gs2[:nc * nlev].reshape(nc, nlev)
        gs_shd = gs2[nc * nlev:].reshape(nc, nlev)

        # ---- MLC (block solve) -----------------------------------------
        gbh_sun = gbh2[:nc * nlev].reshape(nc, nlev)
        gbh_shd = gbh2[nc * nlev:].reshape(nc, nlev)
        gbv_sun = gbv2[:nc * nlev].reshape(nc, nlev)
        gbv_shd = gbv2[nc * nlev:].reshape(nc, nlev)
        rn_sun = forcing.rn_sw_sun + labs
        rn_shd = forcing.rn_sw_shd + labs
        soil_rn = forcing.isoil_sw + labs_soil

        ones_c = jnp.ones(nc, dtype)
        fssh_b = jnp.broadcast_to(forcing.fssh_lev, (nc, nlev))
        mlc_static = dict(self.mlc_static)
        mlc_static.update(
            cpair=forcing.cpair * ones_c,
            rhomol=forcing.rhomol * ones_c,
            leaf_cpair=forcing.cpair,
            soil_T=forcing.soil_T * ones_c,
            bc_T=forcing.thref * ones_c,
            bc_q=forcing.bc_q * ones_c,
            leaf_fssh=jnp.stack([fssh_b, 1.0 - fssh_b],
                                axis=-1).astype(dtype))

        inp = bmlc.MLCBlockInputs(
            at_T=state.T_air, av_q=state.q_air,
            leaf_T=jnp.stack([state.T_sun, state.T_shd], axis=-1),
            soil_rn=soil_rn,
            gbh_air=jnp.stack([gbh_sun, gbh_shd], axis=-1),
            gbv_air=jnp.stack([gbv_sun, gbv_shd], axis=-1),
            leaf_gs=jnp.stack([gs_sun, gs_shd], axis=-1),
            leaf_gbh=jnp.stack([gbh_sun, gbh_shd], axis=-1),
            leaf_gbv=jnp.stack([gbv_sun, gbv_shd], axis=-1),
            leaf_rn=jnp.stack([rn_sun, rn_shd], axis=-1),
            conn_ga=ga[:, :nlev - 1],
            bc_ga=ga[:, nlev - 1],
            **mlc_static)
        x = bmlc.step(inp, dt)

        return CanopyState(
            T_air=x[:, :, 0],      # level 0 = eliminated ground temperature
            q_air=x[:, :, 1],
            T_sun=jnp.where(self.dpai_pos, x[:, :, 2], state.T_sun),
            T_shd=jnp.where(self.dpai_pos, x[:, :, 3], state.T_shd))

    # ---- diurnal production loop (ml_model_problem.F90:372-417) --------
    def run_diurnal(self, state: CanopyState, beg_step=1, end_step=24,
                    nsubstep=12, bc_provider=None, jax=None,
                    checkpoint_dir=None, fused=True):
        """The hourly istep / 300-s isubstep production loop: re-solve
        shortwave for each hourly BC record (solve_swv, ibid:375-382),
        advance ``nsubstep`` substeps with the hourly :class:`Forcing`
        as a dynamic input (no retrace across hours), checkpoint at each
        hour when ``checkpoint_dir`` is set (checkpoint_mlc,
        ml_model/mlc.F90:1006-1092).  ``fused=True`` (default) runs the
        whole hour as ONE jitted program (`fused_hour_fn`) — one device
        dispatch per hour; ``fused=False`` keeps the 3-programs-per-
        substep staging (lower peak compile cost, same numerics).

        Returns (state, trajectory) where trajectory[istep] is the
        hour-end canopy-top (T_air, q_air) numpy snapshot."""
        import jax as _jax
        jax = jax or _jax
        if bc_provider is None:
            from mpp_tpu.problems.ml_model import synthetic_diurnal_bc
            bc_provider = synthetic_diurnal_bc
        if fused:
            hour = self.fused_hour_fn(jax, nsubstep=nsubstep)
        else:
            fns = self.staged_substep_fns(jax)
        bc = None
        traj = {}
        for istep in range(beg_step, end_step + 1):
            bc = bc_provider(istep, bc)
            forcing = self.forcing_from_bc(bc)
            if fused:
                state = hour(state, forcing)
            else:
                for _ in range(nsubstep):
                    state = self.run_staged(fns, state, 300.0, forcing)
            traj[istep] = (np.asarray(state.T_air[:, self.ntop - 1]),
                           np.asarray(state.q_air[:, self.ntop - 1]))
            if checkpoint_dir is not None:
                self.checkpoint(state, istep, nsubstep, checkpoint_dir)
        return state, traj

    def checkpoint(self, state: CanopyState, istep, isubstep,
                   directory=".") -> str:
        """Write the batched canopy state as a PetscViewer binary Vec
        (mlc_checkpoint.<step>.<substep>.bin layout: the four state
        fields concatenated, column-major like the reference's
        per-column records)."""
        from mpp_tpu.io.petsc_vec import write_vec
        fname = f"{directory}/canopy_checkpoint.{istep}.{isubstep}.bin"
        flat = np.concatenate([np.asarray(a, np.float64).reshape(-1)
                               for a in state])
        write_vec(fname, flat)
        return fname

    def restore(self, fname: str) -> CanopyState:
        """Read a :meth:`checkpoint` file back into a CanopyState."""
        from mpp_tpu.io.petsc_vec import read_vec
        flat = read_vec(fname)
        n = self.ncair * self.nlev
        assert flat.size == 4 * n, "checkpoint size mismatch"
        parts = [jnp.asarray(flat[i * n:(i + 1) * n].reshape(
            self.ncair, self.nlev), self.dtype) for i in range(4)]
        return CanopyState(*parts)
