"""ELM/ALM host-model coupling layer on the compiled full-physics path.

Re-implements the production coupling path of the reference
(``src/driver/alm/MPPVSFMALM_Driver.F90``, ``MPPVSFMALM_Initialize.F90``):
the land model hands the framework a batch of soil columns with CLM-style
state and fluxes each timestep; the framework stages unit-converted
source/sink terms, exchanges ghost-column data for lateral connectivity,
solves the FULL VSFM physics, audits per-column mass balance, and unpacks
results back to CLM arrays.

The VSFM problem is built through the ``VSFMMPP`` facade exactly as the
reference builds it (``MPPVSFMALM_Initialize.F90``):

* one Richards GE over a CLM column mesh;
* SS ``COND_MASS_RATE`` conditions Infiltration/Dew/Snow-disappearance/
  Sublimation (top cells) and Evapotranspiration/Drainage (all cells),
  plus Lateral_flux (all cells) under the 'source_sink' lateral model and
  an optional ``COND_SEEPAGE_BC`` at the top (ibid:814-882);
* per-column heterogeneous CLM soils (``VSFMMPPSetSoils`` with the
  ``vsfm_satfunc_type`` family and ``DENSITY_TGDPB01``, ibid:986-992)

and frozen by :func:`~mpp_tpu.batched.vsfm_compiled.compile_vsfm` into
one jitted batched Newton step; the per-column soils, temperatures and
liquid fractions ride the compiled path's dynamic-parameter contract
(``dyn``), so the production driver solves the complete physics — density
dispatch with dden/dP (``EOSWaterMod.F90:38-78``), every CLM saturation
function (``SaturationFunction.F90``), seepage clamping
(``RichardsMod.F90:281-299``) — not a simplified second implementation.

Reference semantics reproduced (file:line):

* flux unit conversion mm/s -> kg/s via ``area * denh2o * 1e-3``
  (MPPVSFMALM_Driver.F90:298).
* ET sink ``-qflx_tran_veg * rootr(j)``, infiltration/dew/sublimation
  into the top cell, per-layer drainage split below the water table with
  the ``watmin`` availability limiter (ibid:301-370).
* frac_liq staged from ice fractions each step (ibid:445-465).
* lateral ghost exchange before the solve and the operator-split
  'source_sink' lateral model: explicit lateral Darcy flux from ghosted
  states staged as the Lateral_flux SS condition, ``qflx_lateral``
  returned in mm/s (ibid:465-532).
* retry loop, max 10 attempts (ibid:620-930): on divergence switch
  ``stol`` to the alternate 1e-10 and, after a second divergence, reset
  ``frac_liq=1`` (ibid:650-667); on convergence audit the per-column
  mass balance ``|mass_beg - mass_end + total_flux*dt| <
  max_abs_mass_error_col = 1e-5`` kg (ibid:140,861-863) and if violated
  tighten rtol or stol by 10x according to the converged reason
  (ibid:886-905) and re-solve; hard error after ``max_iter_count``
  attempts (ibid:919-922).
* unpacking: ``h2osoi_liq/ice`` from cell mass split by ``frac_ice``
  (ibid:840-843), ``smp_l`` in mm (ibid:851), water-table depth ``zwt``
  interpolated at the first unsaturated layer (ibid:866-873),
  ``qflx_seepage`` from the seepage-BC mass exchange (ibid:736-738),
  ``qcharge = 0`` (ibid:864).

Beyond the reference (production hardening): for f32 state the audit
drives a **per-column f64 escalation** — columns whose mass-balance error
persists above the audit threshold (the f32 evaluation floor, not a
solver-policy failure) are gathered, re-solved from the pre-step state in
f64 on the same compiled stepper, and scattered back; the reference has
no analog because it always runs f64.

Device mapping: each MPI rank's ``begc:endc`` column loop becomes a
batched [ncol, nz] state solved by one masked Newton (the compiled
stepper's per-column dt ladders); host-model MPI ghost exchange becomes
ppermute halos inside shard_map over the device-mesh column axis
(parallel/sharding, parallel/ugrid).  The retry ladder stays host-side
Python around the jitted solve, exactly where the reference keeps it
(driver, not library).

Level convention: arrays are [ncol, nz] with level 0 at the column
BOTTOM and level nz-1 at the surface (the mesh is built bottom-first;
``region_connection_set(SOIL_TOP_CELLS)`` resolves the surface cell).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from mpp_tpu.constants import (Cond, GEType, MPPType, Region,
                               MeshType as MeshKind, DENH2O, FMWH2O,
                               GRAVITY_CONSTANT, GRAV_CLM, PRESSURE_REF)
from mpp_tpu.dtypes.mesh import column_mesh
from mpp_tpu.models.richards import VSFMMPP
from mpp_tpu.ops import eos, satfunc as sf
from mpp_tpu.ops.snes import (CONVERGED_FNORM_RELATIVE,
                              CONVERGED_SNORM_RELATIVE)
from mpp_tpu.batched.vsfm_compiled import compile_vsfm

MAX_ITER_COUNT = 10              # MPPVSFMALM_Driver.F90:116 max_iter_count
STOL_ALTERNATE = 1e-10           # ibid:122 stol_alternate
MAX_ABS_MASS_ERROR_COL = 1e-5    # ibid:140 [kg]
WATMIN = 0.01                    # CLM clm_varcon watmin [kg/m^2]
VISH2O = 0.001002                # VSFMMPPSetSoilsCLM vish2o [N s/m^2]


@dataclasses.dataclass
class ALMVSFMProblem:
    """State of the coupled VSFM problem owned by the host model.

    Built once by :func:`alm_vsfm_initialize` (the
    ``MPPVSFMALM_Initialize.F90`` analog); advanced every land-model step
    by :func:`alm_vsfm_solve`.
    """
    mpp: VSFMMPP                     # template single-column facade problem
    comp: object                     # CompiledVSFM stepper
    dyn: tuple                       # per-GE dynamic params, [ncol, ...]
    P: jnp.ndarray                   # soil liquid pressure [Pa], [ncol, nz]
    area: np.ndarray                 # column area [m^2], [ncol]
    dz: np.ndarray                   # layer thickness [m], [ncol, nz]
    zi: np.ndarray                   # interface depth below surface [m],
                                     # [ncol, nz+1] (zi[:,0]=0, top-first)
    ss_slices: dict                  # condition name -> (offset, size)
    include_seepage_bc: bool = False
    lateral_connectivity: bool = False
    lateral_conductance: float = 0.0  # [kmol/s/Pa] per column pair (ring)
    mesh_axis: Optional[str] = None   # shard_map axis name when sharded
    device_mesh: Optional[jax.sharding.Mesh] = None
    # general-graph lateral connectivity (ldomain adjacency analog,
    # MPPVSFMALM_Initialize.F90:588-795): when set, the lateral source is
    # the per-connection, per-level lateral Darcy flux over the UGDM
    # (replacing the 1-D ring + scalar-conductance model)
    ugrid: Optional[object] = None    # parallel.ugrid.UGrid
    ugdm: Optional[object] = None     # parallel.ugrid.UGDM
    # defaults mirror SNESSetTolerances in MPPSetupProblemSNES; for f32
    # state the compiled stepper substitutes its f32-floor parameter set
    atol: float = 1e-10
    rtol: float = 1e-8
    stol: float = 1e-10
    # f32 production: re-solve audit-failing columns in f64 (bounded)
    escalate_f64: bool = True
    # per-problem audit threshold [kg] (the reference's 1e-5; an f32
    # throughput mode without escalation must relax this to its
    # evaluation floor ~ O(1e-6) relative of column storage)
    audit_threshold_kg: float = MAX_ABS_MASS_ERROR_COL
    # cached jitted audit/unpack closures (one device dispatch each)
    jits: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def ncol(self) -> int:
        return int(self.P.shape[0])

    @property
    def nz(self) -> int:
        return int(self.P.shape[1])


def _build_template_mpp(dz0, area0, satfunc_type, density_type,
                        watsat0, hksat0, bsw0, sucsat0, residual_sat0,
                        lateral_connectivity, include_seepage_bc):
    """The 8-step builder sequence of MPPVSFMALM_Initialize.F90 for one
    template column; per-column heterogeneity rides the dyn contract."""
    nz = dz0.size
    mpp = VSFMMPP()
    mpp.set_name("VSFM-ALM")
    mpp.set_id(MPPType.VSFM_SNES_CLM)
    mpp.set_num_meshes(1)
    zc = np.cumsum(dz0) - 0.5 * dz0          # bottom-first
    mesh = column_mesh("ALM soil column", zc, dz0, np.full(nz, area0),
                       ncols=1, itype=int(MeshKind.CLM_SOIL_COL),
                       orientation=int(MeshKind.AGAINST_GRAVITY))
    mpp.add_mesh(mesh)
    ieqn = mpp.add_goveqn(GEType.RE, "Richards Equation ODE")
    # conditions in the reference's order (Initialize.F90:836-870)
    mpp.add_condition_in_goveqn(ieqn, Cond.SS, "Infiltration_Flux", "kg/s",
                                Cond.MASS_RATE, region=Region.SOIL_TOP_CELLS)
    mpp.add_condition_in_goveqn(ieqn, Cond.SS, "Evapotranspiration_Flux",
                                "kg/s", Cond.MASS_RATE,
                                region=Region.SOIL_CELLS)
    mpp.add_condition_in_goveqn(ieqn, Cond.SS, "Dew_Flux", "kg/s",
                                Cond.MASS_RATE, region=Region.SOIL_TOP_CELLS)
    mpp.add_condition_in_goveqn(ieqn, Cond.SS, "Drainage_Flux", "kg/s",
                                Cond.MASS_RATE, region=Region.SOIL_CELLS)
    mpp.add_condition_in_goveqn(ieqn, Cond.SS, "Snow_Disappearance_Flux",
                                "kg/s", Cond.MASS_RATE,
                                region=Region.SOIL_TOP_CELLS)
    mpp.add_condition_in_goveqn(ieqn, Cond.SS, "Sublimation_Flux", "kg/s",
                                Cond.MASS_RATE, region=Region.SOIL_TOP_CELLS)
    if lateral_connectivity:
        mpp.add_condition_in_goveqn(ieqn, Cond.SS, "Lateral_flux", "kg/s",
                                    Cond.MASS_RATE,
                                    region=Region.SOIL_CELLS)
    if include_seepage_bc:
        mpp.add_condition_in_goveqn(ieqn, Cond.BC, "Seepage_Flux", "kg/s",
                                    Cond.SEEPAGE_BC,
                                    region=Region.SOIL_TOP_CELLS)
    mpp.allocate_auxvars()
    mpp.setup_problem()
    shape1 = (1, nz)
    mpp.set_soils(filter_vsfmc=np.ones(1, np.int64),
                  watsat=watsat0.reshape(shape1),
                  hksat=hksat0.reshape(shape1),
                  bsw=bsw0.reshape(shape1),
                  sucsat=sucsat0.reshape(shape1),
                  residual_sat=residual_sat0.reshape(shape1),
                  satfunc_type=satfunc_type, density_type=density_type)
    return mpp


def alm_vsfm_initialize(watsat, hksat, bsw, sucsat, residual_sat, dz, area,
                        P0=None, satfunc_type="smooth_brooks_corey_bz3",
                        density_type=eos.DENSITY_TGDPB01,
                        lateral_connectivity=False, lateral_conductance=0.0,
                        device_mesh=None, ugrid=None, dtype=jnp.float64,
                        include_seepage_bc=False, escalate_f64=True):
    """Build the batched VSFM problem from CLM column data
    (MPPVSFMALM_Initialize.F90 + VSFMMPPSetSoilsCLM analog).

    CLM Clapp-Hornberger inputs [ncol, nz] are converted exactly as
    ``VSFMMPPSetSoilsCLM`` (MultiPhysicsProbVSFM.F90:367-419): perm =
    hksat_mm/s * 1e-3 * vish2o / (denh2o*g), lambda = 1/bsw, alpha =
    1/(sucsat*g); the saturation-function family is the global
    ``vsfm_satfunc_type`` (default 'smooth_brooks_corey_bz3',
    mpp_varctl.F90:17) with per-column parameters; density defaults to
    ``DENSITY_TGDPB01`` (Initialize.F90:992).
    """
    watsat = np.asarray(watsat, np.float64)
    ncol, nz = watsat.shape
    hksat = np.broadcast_to(np.asarray(hksat, np.float64), (ncol, nz))
    bsw = np.broadcast_to(np.asarray(bsw, np.float64), (ncol, nz))
    sucsat = np.broadcast_to(np.asarray(sucsat, np.float64), (ncol, nz))
    residual_sat = np.broadcast_to(np.asarray(residual_sat, np.float64),
                                   (ncol, nz))
    dz = np.broadcast_to(np.asarray(dz, np.float64), (ncol, nz)).copy()
    area = np.broadcast_to(np.asarray(area, np.float64), (ncol,)).copy()

    mpp = _build_template_mpp(dz[0], area[0], satfunc_type, density_type,
                              watsat[0], hksat[0], bsw[0], sucsat[0],
                              residual_sat[0], lateral_connectivity,
                              include_seepage_bc)
    comp = compile_vsfm(mpp, linear_solver="direct")

    # --- per-column dynamic parameters (the dyn contract) ---
    # conversion constants match VSFMMPPSetSoilsCLM exactly: CLM's grav
    # (mpp_varcon grav = 9.80616), not the library GRAVITY_CONSTANT
    lam = 1.0 / bsw
    alpha = 1.0 / (sucsat * GRAV_CLM)
    perm = hksat * 1e-3 * VISH2O / (DENH2O * GRAV_CLM)
    sat = sf.satparams_dyn_clm(satfunc_type, residual_sat, alpha, lam)
    f = lambda v: jnp.asarray(v, dtype)
    dyn_g = {"sat": {k: f(v) for k, v in sat.items()},
             "por_base": f(watsat),
             "perm": f(np.repeat(perm[..., None], 3, axis=-1)),
             "frac_liq": jnp.ones((ncol, nz), dtype),
             "vol": f(area[:, None] * dz),
             # internal connection geometry (nz-1 vertical faces/column)
             "in_dist_up": f(0.5 * dz[:, :-1]),
             "in_dist_dn": f(0.5 * dz[:, 1:]),
             "in_area": f(np.broadcast_to(area[:, None], (ncol, nz - 1)))}
    if include_seepage_bc:
        dyn_g["bc_dist_up"] = f(np.zeros((ncol, 1)))
        dyn_g["bc_dist_dn"] = f(0.5 * dz[:, -1:])
        dyn_g["bc_area"] = f(area[:, None])
    dyn = (dyn_g,)

    # SS staging offsets by condition name
    ss_slices = {}
    off = 0
    for cond in mpp.soe.goveqns[0].source_sinks:
        ss_slices[cond.name] = (off, cond.num_connections)
        off += cond.num_connections

    if P0 is None:
        P0 = np.full((ncol, nz), 3.5355e3)
    # interface depths below the surface, top-first (zi[:,0]=0 at surface);
    # model levels are bottom-first, hence the reverse
    zi = np.zeros((ncol, nz + 1))
    zi[:, 1:] = np.cumsum(dz[:, ::-1], axis=1)
    ugdm = None
    if ugrid is not None:
        ndev = (len(device_mesh.devices.ravel())
                if device_mesh is not None else 1)
        ugdm = ugrid.partition(ndev)
        if ugdm.ndev * ugdm.n_own != ncol:
            raise ValueError(
                f"ugrid padding ({ugdm.ndev}x{ugdm.n_own}) must match the "
                f"staged column count {ncol}; stage CLM arrays through "
                "ugdm.natural_to_sharded")
    return ALMVSFMProblem(
        mpp=mpp, comp=comp, dyn=dyn, P=jnp.asarray(P0, dtype),
        area=area, dz=dz, zi=zi, ss_slices=ss_slices,
        include_seepage_bc=include_seepage_bc,
        lateral_connectivity=lateral_connectivity,
        lateral_conductance=lateral_conductance, device_mesh=device_mesh,
        ugrid=ugrid, ugdm=ugdm,
        mesh_axis="col" if device_mesh is not None else None,
        escalate_f64=escalate_f64)


# ---- physical getters (VAR_MASS / VAR_LIQ_SAT analogs) ---------------------

def _audit_unpack_jits(prob: ALMVSFMProblem):
    """Jitted (storage, bc-flux) audit and (cell mass, smp) unpack
    closures — one device dispatch per call."""
    if "audit" not in prob.jits:
        comp = prob.comp

        # the audit accumulates ~1e2-1e3 kg of column storage and
        # compares differences at 1e-5 kg: f32 summation noise alone is
        # ~3e-5 kg, so the AUDIT always evaluates in f64 (the reference
        # is f64 throughout); the solve state stays f32
        with jax.enable_x64():
            @jax.jit
            def audit(P, bc, dyn):
                up = lambda a: a.astype(jnp.float64)
                return (comp.column_storage(
                            up(P), jax.tree_util.tree_map(up, dyn)),
                        comp.column_bc_flux(
                            up(P), (up(bc),),
                            jax.tree_util.tree_map(up, dyn)))

        g = comp.goveqns[0]

        @jax.jit
        def unpack(P, dyn):
            mass = jax.vmap(lambda x, dy: g.accum(x, dyn=dy))(P, dyn[0]) \
                * FMWH2O
            smp_l = (P - PRESSURE_REF) / (DENH2O * GRAVITY_CONSTANT) * 1e3
            return mass, smp_l

        prob.jits["audit"] = audit
        prob.jits["unpack"] = unpack
    return prob.jits["audit"], prob.jits["unpack"]


def cell_mass_kg(prob: ALMVSFMProblem, P, dyn=None):
    """Per-cell liquid water mass [kg] (VAR_MASS, full-physics por*den*
    sat*vol with the column's own parameters)."""
    g = prob.comp.goveqns[0]
    dyn = prob.dyn if dyn is None else dyn
    return jax.vmap(lambda x, dy: g.accum(x, dyn=dy))(P, dyn[0]) * FMWH2O


def _cell_kr(prob: ALMVSFMProblem, P, dyn=None):
    g = prob.comp.goveqns[0]
    dyn = prob.dyn if dyn is None else dyn
    return jax.vmap(lambda x, dy: g._cell_aux(x, dy)[2])(P, dyn[0])


def _lateral_source(prob: ALMVSFMProblem, P):
    """Operator-split lateral flux [kmol/s] per cell via ghost halos.

    MPPVSFMALM_Driver.F90:465-532 'source_sink' lateral model: exchange
    ghosted pressures, explicit lateral Darcy flux, staged as a source for
    the next implicit vertical solve.
    """
    from mpp_tpu.parallel.sharding import lateral_flux_op_split
    dtype = P.dtype
    if prob.ugdm is not None:
        # general-graph per-level lateral Darcy flux over the UGDM
        kr = _cell_kr(prob, P)
        perm = prob.dyn[0]["perm"][..., 0]       # x-directional
        dz = jnp.asarray(prob.dz, dtype)
        dm = prob.ugdm
        if prob.device_mesh is not None:
            from jax import shard_map
            from jax.sharding import PartitionSpec as PS
            spec = PS(prob.mesh_axis, None)
            fn = shard_map(
                lambda p_, k_, pe_, dz_: dm.lateral_darcy_source(
                    p_, k_, pe_, dz_, axis_name=prob.mesh_axis),
                mesh=prob.device_mesh, in_specs=(spec,) * 4,
                out_specs=spec)
            return fn(P, kr, perm, dz)
        from mpp_tpu.parallel.ugrid import lateral_darcy_source_global
        # 1-device: same math over the global (padded-petsc) layout via
        # the natural-order reference implementation
        P_nat = dm.sharded_to_natural(np.asarray(P))
        kr_nat = dm.sharded_to_natural(np.asarray(kr))
        perm_nat = dm.sharded_to_natural(np.asarray(perm))
        dz_nat = dm.sharded_to_natural(np.asarray(dz))
        src_nat = lateral_darcy_source_global(prob.ugrid, P_nat, kr_nat,
                                              perm_nat, dz_nat)
        return jnp.asarray(dm.natural_to_sharded(np.asarray(src_nat)),
                           dtype)
    g = jnp.asarray(prob.lateral_conductance, dtype)
    if prob.device_mesh is not None:
        from jax import shard_map
        from jax.sharding import PartitionSpec as PS
        spec = PS(prob.mesh_axis, None)
        fn = shard_map(
            lambda x: lateral_flux_op_split(x, g, axis_name=prob.mesh_axis),
            mesh=prob.device_mesh, in_specs=(spec,), out_specs=spec)
        return fn(P)
    # single-shard: same stencil without collectives
    left = jnp.concatenate([P[:1], P[:-1]], axis=0)
    right = jnp.concatenate([P[1:], P[-1:]], axis=0)
    return -g * ((P - left) + (P - right))


def _stage_drainage(qflx_drain, zwt, zi, dz, h2osoi_liq, dtime, conv):
    """Per-layer drainage sinks [kg/s, bottom-first] with the water-table
    split and watmin limiter (MPPVSFMALM_Driver.F90:330-370).

    Pure jnp (runs inside the fused per-attempt program); also accepts
    numpy (the jnp ops are shape-preserving elementwise/reductions)."""
    ncol, nz = dz.shape
    qflx_drain = jnp.asarray(qflx_drain, jnp.float64)
    pos = qflx_drain > 0.0
    # jwt: CLM layer above the water table (1-based top-first), >= 1
    # zi is top-first cumulative depth
    below = zwt[:, None] <= zi[:, 1:]            # [ncol, nz] layer j+1
    jwt = jnp.where(below.any(axis=1), jnp.argmax(below, axis=1), nz)
    jwt = jnp.maximum(jwt, 1)
    dz_top = dz[:, ::-1]                          # top-first
    liq_top = h2osoi_liq[:, ::-1]
    mask = jnp.arange(nz)[None, :] >= jwt[:, None]  # layers jwt..nz-1
    dzsum = jnp.where(mask, dz_top, 0.0).sum(axis=1)
    dzsum = jnp.where(dzsum > 0.0, dzsum, 1.0)
    ql = qflx_drain[:, None] * dz_top / dzsum[:, None]
    ql = jnp.minimum(ql, jnp.maximum(liq_top - WATMIN, 0.0) / dtime)
    ql = jnp.where(mask & pos[:, None], ql, 0.0)
    out = -(ql[:, ::-1]) * conv[:, None]          # back to bottom-first
    return out, ql.sum(axis=1)                    # (kg/s sinks, mm/s total)


def _fused_attempt_jit(prob: ALMVSFMProblem):
    """ONE jitted program per solve attempt (VERDICT r4 item 2; the
    reference issues one driver call per step, MPPVSFMALM_Driver.F90:
    380-663): previous-state unpack (zwt for the drainage split) ->
    flux unit conversion + SS staging -> lateral source -> the batched
    Newton -> f64 mass audit -> CLM unpack.  Host Python remains only
    between retry-ladder attempts, and each attempt costs exactly one
    dispatch plus one small diagnostics pull.

    The single-device UGDM lateral path is the one stage that cannot
    trace (numpy natural-order scatters); it is staged outside and
    passed in via ``lat_kg_in``.
    """
    if "fused" in prob.jits:
        return prob.jits["fused"]
    comp = prob.comp
    ncol, nz = prob.ncol, prob.nz
    ss_order = list(prob.ss_slices)
    include_seepage = prob.include_seepage_bc
    lateral_inline = prob.lateral_connectivity and (
        prob.ugdm is None or prob.device_mesh is not None)
    area_np = np.asarray(prob.area, np.float64)
    zi_np = np.asarray(prob.zi, np.float64)
    dz_np = np.asarray(prob.dz, np.float64)
    g = comp.goveqns[0]

    def fused(P_prev, dyn_base, temperature, frac_liq, frac_ice,
              forcing, lat_kg_in, reset_fl, rtol, stol, gate, dtime):
        dtype = P_prev.dtype
        f64 = jnp.float64
        area = jnp.asarray(area_np)
        zi = jnp.asarray(zi_np)
        dz = jnp.asarray(dz_np)
        conv = area * DENH2O * 1e-3               # [mm/s] -> [kg/s]
        up = lambda a: a.astype(f64)

        # ---- dynamic auxvar state (Driver:399-465) ----
        fl = jnp.where(reset_fl, jnp.ones_like(frac_liq), frac_liq)
        dyn_g = dict(dyn_base)
        dyn_g["temperature"] = temperature
        dyn_g["frac_liq"] = fl
        dyn = (dyn_g,)
        dyn64 = jax.tree_util.tree_map(up, dyn)

        # ---- previous-state unpack for the drainage split ----
        P64 = up(P_prev)
        mass_prev = jax.vmap(lambda x, dy: g.accum(x, dyn=dy))(
            P64, dyn64[0]) * FMWH2O
        smp_prev = (P64 - PRESSURE_REF) / (DENH2O * GRAVITY_CONSTANT) * 1e3
        h2o_prev = mass_prev / area[:, None]
        zwt_prev = _water_table_depth(smp_prev, zi)

        # ---- stage SS conditions [kg/s] (Driver:290-430) ----
        parts = {name: jnp.zeros((ncol, m), f64)
                 for name, (_, m) in prob.ss_slices.items()}
        et = (-forcing["qflx_tran_veg"] * conv)[:, None] * forcing["rootr"]
        parts["Evapotranspiration_Flux"] = et
        parts["Infiltration_Flux"] = (forcing["qflx_infl"]
                                      * conv)[:, None]
        parts["Dew_Flux"] = (forcing["qflx_dew"] * conv)[:, None]
        parts["Sublimation_Flux"] = (-forcing["qflx_sub_snow"]
                                     * conv)[:, None]
        parts["Snow_Disappearance_Flux"] = forcing["mflx_snowlyr"][:, None]
        drain, qflx_drain_tot = _stage_drainage(
            forcing["qflx_drain"], zwt_prev, zi, dz, h2o_prev, dtime, conv)
        parts["Drainage_Flux"] = drain

        qflx_lateral = jnp.zeros(ncol, f64)
        if "Lateral_flux" in parts:
            if lateral_inline:
                lat_kg = up(_lateral_source_pure(prob, P_prev,
                                                 dyn_base)) * FMWH2O
            else:
                lat_kg = lat_kg_in
            parts["Lateral_flux"] = lat_kg
            # qflx_lateral = -sum(mflx)/conv (Driver:522-523), mm/s
            qflx_lateral = -lat_kg.sum(axis=1) / conv

        ss64 = jnp.concatenate([parts[name] for name in ss_order], axis=1)
        total_flux_col = ss64.sum(axis=1)          # [kg/s]
        ss = ss64.astype(dtype)
        # seepage BC pressure = PRESSURE_REF (Driver:538-545)
        if include_seepage:
            bc = jnp.full((ncol, 1), 101325.0, dtype)
        else:
            bc = jnp.zeros((ncol, 0), dtype)

        # the audit accumulates ~1e2-1e3 kg of column storage and
        # compares differences at 1e-5 kg: f32 summation noise alone is
        # ~3e-5 kg, so the AUDIT always evaluates in f64 (the reference
        # is f64 throughout); the solve state stays ``dtype``
        mass_beg = comp.column_storage(P64, dyn64) * FMWH2O

        # ---- the batched Newton (per-column dt ladders) ----
        src = jnp.zeros_like(P_prev)
        tols = (jnp.asarray(rtol, dtype), jnp.asarray(stol, dtype),
                jnp.asarray(gate, dtype))
        X, iters, done, reason = comp._step_dt_batched(
            P_prev, (bc,), (ss,), dtime, src, dyn, tols)

        # ---- f64 audit at the converged state (Driver:861-863) ----
        X64 = up(X)
        S_end = comp.column_storage(X64, dyn64)
        bflux = comp.column_bc_flux(X64, (up(bc),), dyn64)
        err = jnp.abs(mass_beg - S_end * FMWH2O
                      + (total_flux_col - bflux * FMWH2O) * dtime)

        # ---- unpack to CLM arrays (Driver:700-900) ----
        mass_cell = jax.vmap(lambda x, dy: g.accum(x, dyn=dy))(
            X, dyn[0]) * FMWH2O
        smp_l = (X - PRESSURE_REF) / (DENH2O * GRAVITY_CONSTANT) * 1e3
        h2osoi_liq = (1.0 - frac_ice) * mass_cell / area[:, None]
        h2osoi_ice = frac_ice * mass_cell / area[:, None]
        zwt = _water_table_depth(smp_l, zi)
        qflx_seepage = bflux * FMWH2O / conv

        diag = jnp.stack([
            jnp.all(done).astype(f64), err.max(), iters.astype(f64),
            jnp.any(done & (reason == CONVERGED_FNORM_RELATIVE))
               .astype(f64),
            jnp.any(done & (reason == CONVERGED_SNORM_RELATIVE))
               .astype(f64)])
        return {"P": X, "done": done, "reason": reason, "err": err,
                "diag": diag, "mass_beg": mass_beg,
                "total_flux_col": total_flux_col, "ss": ss, "bc": bc,
                "S_end": S_end, "bflux": bflux,
                "mass_cell": mass_cell, "smp_l": smp_l,
                "h2osoi_liq": h2osoi_liq, "h2osoi_ice": h2osoi_ice,
                "zwt": zwt, "qflx_seepage": qflx_seepage,
                "qflx_lateral": qflx_lateral,
                "qflx_drain_tot": qflx_drain_tot}

    prob.jits["fused"] = jax.jit(fused)
    return prob.jits["fused"]


def _lateral_source_pure(prob: ALMVSFMProblem, P, dyn_base):
    """Traceable lateral source [kmol/s]: ring stencil or sharded UGDM
    (the single-device UGDM path stays host-side, `_lateral_source`)."""
    from mpp_tpu.parallel.sharding import lateral_flux_op_split
    dtype = P.dtype
    if prob.ugdm is not None:
        g = prob.comp.goveqns[0]
        kr = jax.vmap(lambda x, dy: g._cell_aux(x, dy)[2])(P, dyn_base)
        perm = dyn_base["perm"][..., 0]
        dz = jnp.asarray(prob.dz, dtype)
        dm = prob.ugdm
        from jax import shard_map
        from jax.sharding import PartitionSpec as PS
        spec = PS(prob.mesh_axis, None)
        fn = shard_map(
            lambda p_, k_, pe_, dz_: dm.lateral_darcy_source(
                p_, k_, pe_, dz_, axis_name=prob.mesh_axis),
            mesh=prob.device_mesh, in_specs=(spec,) * 4, out_specs=spec)
        return fn(P, kr, perm, dz)
    gc = jnp.asarray(prob.lateral_conductance, dtype)
    if prob.device_mesh is not None:
        from jax import shard_map
        from jax.sharding import PartitionSpec as PS
        spec = PS(prob.mesh_axis, None)
        fn = shard_map(
            lambda x: lateral_flux_op_split(x, gc,
                                            axis_name=prob.mesh_axis),
            mesh=prob.device_mesh, in_specs=(spec,), out_specs=spec)
        return fn(P)
    left = jnp.concatenate([P[:1], P[:-1]], axis=0)
    right = jnp.concatenate([P[1:], P[-1:]], axis=0)
    return -gc * ((P - left) + (P - right))


def alm_vsfm_solve(prob: ALMVSFMProblem, dtime,
                   qflx_infl=None, qflx_tran_veg=None, rootr=None,
                   qflx_dew=None, qflx_sub_snow=None, qflx_drain=None,
                   mflx_snowlyr=None, t_soil=None, frac_ice=None):
    """One host-model timestep (MPPVSFMALM_Solve analog).

    Fluxes in CLM units (all optional): ``qflx_infl`` [mm/s, ncol]
    infiltration, ``qflx_tran_veg`` [mm/s, ncol] transpiration with
    per-layer root fractions ``rootr`` [ncol, nz, bottom-first],
    ``qflx_dew`` [mm/s] dew onto the surface, ``qflx_sub_snow`` [mm/s]
    sublimation loss, ``qflx_drain`` [mm/s] drainage split below the
    water table, ``mflx_snowlyr`` [kg/s] snow-layer-disappearance mass,
    ``t_soil`` [K, ncol, nz] soil temperature, ``frac_ice`` [ncol, nz]
    ice fraction (stages frac_liq = 1 - frac_ice).

    Each attempt of the retry ladder runs as ONE fused jitted program
    (staging -> solve -> f64 audit -> unpack; `_fused_attempt_jit`) with
    one small diagnostics pull — the dispatch count per successful step
    is 2 (fused call + diag), vs the reference's one driver call per
    step (MPPVSFMALM_Driver.F90:380-663).

    Returns a dict of CLM-facing outputs: h2osoi_liq/ice [kg/m^2],
    smp_l [mm], zwt [m], qflx_lateral/qflx_seepage [mm/s], soilp [Pa],
    plus solver diagnostics (attempts, diverged_count,
    mass_bal_err_count, abs_mass_error_col, escalated_cols,
    dispatches_per_step).
    """
    ncol, nz = prob.ncol, prob.nz
    dtype = prob.P.dtype
    comp = prob.comp
    fused = _fused_attempt_jit(prob)

    # ---- dense dynamic inputs (absent forcings stage as zeros — the
    # same math; one trace covers every presence pattern).  Device
    # constants for absent inputs are CACHED on the problem, so a step
    # uploads no fresh constants.
    cache = prob.jits.setdefault("consts", {})

    def cached(key, build):
        if key not in cache:
            cache[key] = build()
        return cache[key]

    with jax.enable_x64():
        def dense(v, shape):
            if v is None:
                return cached(("z64", shape),
                              lambda: jnp.zeros(shape, jnp.float64))
            if isinstance(v, jax.Array) and v.dtype == jnp.float64 \
                    and v.shape == shape:
                return v
            return jnp.asarray(np.asarray(v, np.float64))
        forcing = {
            "qflx_infl": dense(qflx_infl, (ncol,)),
            "qflx_tran_veg": dense(qflx_tran_veg, (ncol,)),
            "rootr": dense(rootr, (ncol, nz)),
            "qflx_dew": dense(qflx_dew, (ncol,)),
            "qflx_sub_snow": dense(qflx_sub_snow, (ncol,)),
            "qflx_drain": dense(qflx_drain, (ncol,)),
            "mflx_snowlyr": dense(mflx_snowlyr, (ncol,)),
        }
        dyn_base = dict(prob.dyn[0])
        base_fl = dyn_base.pop("frac_liq")
        if t_soil is not None:
            temperature = jnp.asarray(t_soil, dtype)
        else:
            temperature = cached(
                ("temp_default", str(dtype)),
                lambda: jnp.broadcast_to(
                    jnp.asarray(comp.goveqns[0].temperature[:nz], dtype),
                    (ncol, nz)) + jnp.zeros((), dtype))
        if frac_ice is not None:
            frac_liq = 1.0 - jnp.asarray(frac_ice, dtype)
            frac_ice = jnp.asarray(frac_ice, dtype)
        else:
            frac_liq = base_fl
            frac_ice = cached(("z", (ncol, nz), str(dtype)),
                              lambda: jnp.zeros((ncol, nz), dtype))

        # single-device UGDM lateral: the one non-traceable stage
        if prob.lateral_connectivity and prob.ugdm is not None \
                and prob.device_mesh is None:
            lat_kg_in = jnp.asarray(
                np.asarray(_lateral_source(prob, prob.P), np.float64)
                * FMWH2O)
        else:
            lat_kg_in = cached(("z64", (ncol, nz)),
                               lambda: jnp.zeros((ncol, nz), jnp.float64))

    sp = comp.snes if dtype == jnp.float64 else comp.snes_f32
    rtol, stol = sp.rtol, sp.stol
    # the mass-closure gate (|sum F|*dt*FMWH2O, the audit integrand)
    # applies in f64 mode only: f64 closes it in the same iterations,
    # while the f32 RESIDUAL-EVALUATION bias of ~column_storage *
    # O(1e-6) kg means f32 cannot meaningfully iterate toward the
    # f64-audited 1e-5 kg threshold on heavy columns — those columns
    # go through the f64 escalation below instead (KNOWN_GAPS #9)
    gate = 0.5 * MAX_ABS_MASS_ERROR_COL if dtype == jnp.float64 else 0.0

    P_prev = prob.P
    attempts = diverged_count = mass_bal_err_count = 0
    escalated_cols = 0
    dispatches = 0
    abs_mass_error = np.inf
    reset_fl = False
    out = None
    err_np = None

    def sc(v):
        """Cached f64 device scalar (no fresh upload per attempt)."""
        with jax.enable_x64():
            return cached(("s64", float(v)),
                          lambda: jnp.asarray(float(v), jnp.float64))

    def sb(v):
        return cached(("b", bool(v)),
                      lambda: jnp.asarray(bool(v)))

    while True:
        attempts += 1
        with jax.enable_x64():
            out = fused(P_prev, dyn_base, temperature, frac_liq, frac_ice,
                        forcing, lat_kg_in, sb(reset_fl), sc(rtol),
                        sc(stol), sc(gate), sc(dtime))
        diag = np.asarray(out["diag"])
        dispatches += 2                    # fused call + diag pull
        converged = bool(diag[0])
        P = out["P"]
        err_np = None
        if not converged:
            # Driver:650-667: alternate stol, after 2nd divergence reset
            # frac_liq to 1
            stol = STOL_ALTERNATE
            diverged_count += 1
            if diverged_count > 1:
                reset_fl = True
                if dtype != jnp.float64 and prob.escalate_f64:
                    # the stiff f32 tail cannot close the mass gate at
                    # this dt — re-solve just those columns in f64
                    # (beyond-reference hardening; the reference is f64
                    # throughout so it never faces this)
                    err_stub = np.where(np.asarray(out["done"]), 0.0,
                                        np.inf)
                    dyn_g = dict(dyn_base)
                    dyn_g["temperature"] = temperature
                    dyn_g["frac_liq"] = jnp.ones((ncol, nz), dtype)
                    P, err_np, nesc = _escalate_f64(
                        prob, P_prev, P, out["bc"], out["ss"], (dyn_g,),
                        err_stub, dtime,
                        np.asarray(out["total_flux_col"]))
                    escalated_cols += nesc
                    converged = bool(np.all(np.isfinite(err_np)))
                    if converged:
                        abs_mass_error = float(err_np.max())
                        if abs_mass_error < prob.audit_threshold_kg:
                            break
                        converged = False
        elif converged:
            # audit seam: the fused program already computed the full
            # per-column err AND its max (diag[1]); the happy path reads
            # only the already-pulled diag (the full arrays would cost 4
            # extra [ncol] host pulls).
            # `_audit_err` stays the module-level interception point for
            # failure-injection tests, detected via the sentinel.
            if _audit_err is not _AUDIT_ERR_DEFAULT:
                err_np = _audit_err(prob, P, out["bc"], None,
                                    np.asarray(out["mass_beg"]),
                                    np.asarray(out["total_flux_col"]),
                                    dtime, (out["S_end"], out["bflux"]))
                abs_mass_error = float(err_np.max())
            else:
                err_np = None
                abs_mass_error = float(diag[1])
            if abs_mass_error >= prob.audit_threshold_kg:
                mass_bal_err_count += 1
                # f32: tightening below the f32 evaluation floor cannot
                # help — escalate the failing columns to f64 instead
                # (bounded, per-column; beyond-reference hardening)
                if (dtype != jnp.float64 and prob.escalate_f64
                        and mass_bal_err_count >= 2):
                    if err_np is None:
                        err_np = np.asarray(out["err"])
                    dyn_g = dict(dyn_base)
                    dyn_g["temperature"] = temperature
                    dyn_g["frac_liq"] = (jnp.ones((ncol, nz), dtype)
                                         if reset_fl else frac_liq)
                    P, err_np, nesc = _escalate_f64(
                        prob, P_prev, P, out["bc"], out["ss"], (dyn_g,),
                        err_np, dtime, np.asarray(out["total_flux_col"]))
                    escalated_cols += nesc
                    abs_mass_error = float(err_np.max())
                    if abs_mass_error < prob.audit_threshold_kg:
                        break
                else:
                    # Driver:886-905: tighten the criterion that fired
                    if diag[3]:
                        rtol = rtol / 10.0
                    if diag[4]:
                        stol = stol / 10.0
            else:
                break
        if attempts >= MAX_ITER_COUNT:
            raise RuntimeError(
                "ALM VSFM failed to converge after multiple attempts "
                f"(diverged {diverged_count}, mass-bal errors "
                f"{mass_bal_err_count}, last error {abs_mass_error:.3e} kg)")

    prob.P = P

    # escalation replaced column states: recompute the CLM unpack at the
    # final state (rare path; the common path reuses the fused program's
    # outputs untouched)
    if escalated_cols:
        dyn_g = dict(dyn_base)
        dyn_g["temperature"] = temperature
        dyn_g["frac_liq"] = (jnp.ones((ncol, nz), dtype) if reset_fl
                             else frac_liq)
        dyn_full = comp._dyn_or_empty((dyn_g,))
        audit_fn, unpack_fn = _audit_unpack_jits(prob)
        mass_cell, smp_l = unpack_fn(P, dyn_full)
        area_j = jnp.asarray(np.asarray(prob.area, np.float64))
        h2o_liq = (1.0 - frac_ice) * mass_cell / area_j[:, None]
        h2o_ice = frac_ice * mass_cell / area_j[:, None]
        with jax.enable_x64():
            bflux = audit_fn(P, out["bc"], dyn_full)[1]
        conv_np = np.asarray(prob.area, np.float64) * DENH2O * 1e-3
        unpacked = {"mass_cell": mass_cell, "smp_l": smp_l,
                    "h2osoi_liq": h2o_liq, "h2osoi_ice": h2o_ice,
                    "zwt": _water_table_depth(smp_l, prob.zi),
                    "qflx_seepage": np.asarray(bflux) * FMWH2O / conv_np}
    else:
        unpacked = {k: out[k] for k in
                    ("mass_cell", "smp_l", "h2osoi_liq", "h2osoi_ice",
                     "zwt", "qflx_seepage")}

    return {
        "h2osoi_liq": unpacked["h2osoi_liq"],
        "h2osoi_ice": unpacked["h2osoi_ice"],
        "smp_l": unpacked["smp_l"], "soilp": P, "zwt": unpacked["zwt"],
        "qflx_lateral": out["qflx_lateral"],
        "qflx_seepage": unpacked["qflx_seepage"],
        "qflx_drain_tot": out["qflx_drain_tot"],
        "qcharge": jnp.zeros((ncol,), dtype),
        "attempts": attempts, "diverged_count": diverged_count,
        "mass_bal_err_count": mass_bal_err_count,
        "abs_mass_error_col": abs_mass_error,
        "escalated_cols": escalated_cols,
        "newton_iters": int(diag[2]),
        "dispatches_per_step": dispatches,
        # the fused call is an async dispatch (~free on-device enqueue);
        # only the diag pull blocks on a host round trip
        "host_round_trips_per_step": attempts,
    }


def _audit_err(prob, P, bc, dyn, mass_beg_col, total_flux_col, dtime,
               precomputed=None):
    """Per-column |mass_beg - mass_end + total_flux*dt| [kg]
    (MPPVSFMALM_Driver.F90:861-863), evaluated in f64; BC (seepage)
    fluxes at the converged state enter with the residual's sign
    (outflow positive).  ``precomputed`` = (S_end [kmol], bflux
    [kmol/s]) from the fused attempt program skips the re-evaluation."""
    if precomputed is not None:
        S, bflux = precomputed
    else:
        audit, _ = _audit_unpack_jits(prob)
        with jax.enable_x64():
            S, bflux = audit(P, bc, prob.comp._dyn_or_empty(dyn))
    mass_end_col = np.asarray(S) * FMWH2O
    bflux_kg = np.asarray(bflux) * FMWH2O
    return np.abs(np.asarray(mass_beg_col) - mass_end_col
                  + (np.asarray(total_flux_col) - bflux_kg) * dtime)


#: sentinel for the failure-injection test seam: the production driver
#: skips the full-array audit pulls unless `_audit_err` was replaced
_AUDIT_ERR_DEFAULT = _audit_err


def _escalate_f64(prob, P_prev, P, bc, ss, dyn, err, dtime,
                  total_flux_col):
    """Gather audit-failing columns, re-solve them from the pre-step
    state in f64 on the same compiled stepper, scatter back.

    The gather is padded to the next power of two so the escalated solve
    compiles once per padded size, not per failure pattern."""
    comp = prob.comp
    fail = np.nonzero(err >= prob.audit_threshold_kg)[0]
    if fail.size == 0:
        return P, err, 0
    cap = 1 << int(np.ceil(np.log2(fail.size)))
    idx = np.pad(fail, (0, cap - fail.size), mode="edge")
    with jax.enable_x64():
        gather = lambda a: jnp.asarray(np.asarray(a)[idx], jnp.float64)
        dyn64 = (jax.tree_util.tree_map(gather, dyn[0]),)
        # tight f64 tolerances: the escalated columns must land well under
        # the audit threshold (f64 at rtol 1e-10 closes the balance to
        # ~1e-12 kg; the default 1e-8 leaves ~1e-8 kg of Newton truncation)
        X64, _, ok64, _ = comp.step_batched(
            gather(P_prev), (gather(bc),), (gather(ss),), dtime,
            dyn=dyn64, rtol=1e-10, stol=1e-12)
        mass_beg64 = np.asarray(
            comp.column_storage(gather(P_prev), dyn64)) * FMWH2O
        err64 = _audit_err(prob, X64, gather(bc), dyn64, mass_beg64,
                           np.asarray(total_flux_col)[idx], dtime)
        X64 = np.asarray(X64)
    ok64 = np.asarray(ok64)
    P_new = np.asarray(P).copy()
    err_new = err.copy()
    for k, c in enumerate(fail):
        if ok64[k]:
            P_new[c] = X64[k]
            err_new[c] = err64[k]
    return jnp.asarray(P_new, P.dtype), err_new, int(fail.size)


def _water_table_depth(smp_l, zi):
    """zwt from the first unsaturated layer (Driver:853-873), vectorized.

    Levels are ordered bottom (index 0) to top (index nz-1); CLM's j=1 is
    the surface, so scan from the top of the column downward.  ``zi`` is
    the top-first interface-depth array [ncol, nz+1].  Pure jnp (runs
    inside the fused per-attempt program); accepts numpy too.
    """
    smp_l = jnp.asarray(smp_l)
    ncol, nz = smp_l.shape
    zi = jnp.asarray(zi)
    depth_col = zi[:, -1]
    top_first = smp_l[:, ::-1]                   # j = 0 at the surface
    unsat = top_first < 0.0
    has = unsat.any(axis=1)
    jwt = jnp.where(has, jnp.argmax(unsat, axis=1), -1)
    sel = has & (jwt != nz - 1)
    j = jnp.clip(jwt, 0, nz - 2)
    r = jnp.arange(ncol)
    # midpoints of interfaces around the first unsaturated layer
    z_dn = 0.5 * (zi[r, j] + zi[r, j + 1])
    z_up = 0.5 * (zi[r, j + 1] + zi[r, j + 2])
    s0 = top_first[r, j]
    s1 = top_first[r, j + 1]
    denom = s0 - s1
    zw = jnp.where(denom == 0.0, depth_col,
                   (0.0 - s0) / jnp.where(denom == 0.0, 1.0, denom)
                   * (z_dn - z_up) + z_dn)
    zw = jnp.clip(zw, 0.0, depth_col)
    return jnp.where(sel, zw, depth_col)
