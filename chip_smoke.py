"""Run the solver stack once on an NVIDIA GPU and check it against the CPU.

    python chip_smoke.py [--seed N]      # one card: every phase below
    python chip_smoke.py --four-cards    # four cards: sharded ALM lateral

Each phase calls the entry points a user calls, at full width, on the
card, then runs the same code on the CPU backend of the same process
(f64, plain ``lax.scan`` solves) and prints the comparison beside its
tolerance and the card's peak memory.  The f64 card results must agree
with the f64 CPU results within the Newton stop band; the f32 card
results within the f32 band of ``tests/test_f32_accuracy.py`` (2e-2 of
the step's dynamic range).  Columns are independent outside the ALM
driver, so the CPU reference of the wide f32 phases runs a strided
subset of the columns.

Phases: ALM production driver (f64 default and f32 strict mode),
compiled VSFM, thermal KSP, coupled TH, canopy pipeline, and the
Newton-direction kernels against the scan reference and cuSPARSE, with
their times.  The last line of standard output is one JSON object,
printed only when every phase passed; the exit code is 0 only then.
Without a GPU, or without the rest of the repository beside it, the
script exits non-zero.
"""
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DT_ALM = 1800.0
F32_BAND = 2e-2          # tests/test_f32_accuracy.py: of the dynamic range
F64_BAND = 1e-6          # Newton stop band: of the dynamic range
AUDIT_KG = 1e-5          # ALM per-column mass audit
# full widths: [ncol, nz] of each phase, and the CPU reference's column
# stride where the columns are independent
WIDTH = dict(alm=(16384, 30, 8), vsfm=(16384, 64, 16), entry=128,
             ksp=(16384, 64), th=(8192, 64, 8), canopy=256,
             thomas=((16384, 30), (16384, 64), (16384, 128), (2048, 30),
                     (2048, 64), (2048, 128)),
             block2=((8192, 64), (1024, 64)), four=(256, 256, 30))


def log(*a):
    print(*a, flush=True)


class Smoke:
    def __init__(self, jax):
        self.jax = jax
        self.gpu = jax.devices()[0]
        self.cpu = jax.devices("cpu")[0]
        self.failed = []

    def check(self, name, ok, detail):
        log(f"  [{'pass' if ok else 'FAIL'}] {name}: {detail}")
        if not ok:
            self.failed.append(name)

    def close(self, name, got, ref, x0, band, prec, f32_ref=None):
        """max|got - ref| within ``band`` of the dynamic range
        max|ref - x0|.  An f32 result also gets the distance of the CPU's
        own f32 run ``f32_ref`` from ``ref`` as slack (f32 moves a sharp
        front by a cell, and stops Newton at its own floor, on any
        backend), and must be as close to that run."""
        got, ref = (np.asarray(a, np.float64) for a in (got, ref))
        dyn = float(np.abs(ref - np.asarray(x0, np.float64)).max())
        bound = band * dyn
        slack = ""
        if f32_ref is not None:
            f32_ref = np.asarray(f32_ref, np.float64)
            d32 = float(np.abs(f32_ref - ref).max())
            bound += d32
            slack = f" + cpu f32 distance {d32!r}"
        err = float(np.abs(got - ref).max()) if np.isfinite(got).all() \
            else float("inf")
        self.check(name, err <= bound,
                   f"max|card-cpu f64| = {err!r} <= {band:g} x dynamic "
                   f"range {dyn!r}{slack} ({prec})")
        if f32_ref is not None:
            e32 = float(np.abs(got - f32_ref).max())
            self.check(name + " (vs cpu f32)", e32 <= bound,
                       f"max|card-cpu f32| = {e32!r} <= {bound!r}")

    def phase(self, name, fn):
        log(f"== {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # noqa: BLE001 — report, fail, go on
            traceback.print_exc()
            self.check(name, False, "raised")
        peak = (self.gpu.memory_stats() or {}).get("peak_bytes_in_use")
        log(f"  {name}: {time.perf_counter() - t0:.1f} s, device "
            f"peak_bytes_in_use={peak}")

    def on_cpu(self):
        return self.jax.default_device(self.cpu)


# ---- ALM production driver -------------------------------------------------
def alm_inputs(ncol, nz, seed):
    """Seeded heterogeneous CLM soils and forcing (the ALM bench cell)."""
    rng = np.random.default_rng(seed)
    shape = (ncol, nz)
    soils = dict(
        watsat=0.35 + 0.1 * rng.random(shape),
        hksat=0.004 * (0.5 + rng.random(shape)),
        bsw=2.0 + 2.0 * rng.random(shape),
        sucsat=20.0 + 20.0 * rng.random(shape),
        residual_sat=0.10 + 0.1 * rng.random(shape),
        dz=np.full(shape, 0.1), area=np.ones(ncol),
        P0=np.full(shape, 3.5355e3), include_seepage_bc=True)
    rootr = np.zeros(shape)
    rootr[:, -6:] = 1.0 / 6.0
    forcing = dict(qflx_infl=2e-4 * (0.2 + rng.random(ncol)),
                   qflx_tran_veg=1e-4 * rng.random(ncol), rootr=rootr)
    return soils, forcing


def run_alm(jax, soils, forcing, dtype, escalate, nsteps=3, **kw):
    """``nsteps`` ALM steps; returns the problem, the step outputs and
    each step's wall time (the first includes compilation)."""
    from mpp_tpu.driver import alm
    prob = alm.alm_vsfm_initialize(dtype=dtype, escalate_f64=escalate,
                                   **soils, **kw)
    outs, ts = [], []
    for _ in range(nsteps):
        t0 = time.perf_counter()
        outs.append(alm.alm_vsfm_solve(prob, DT_ALM, **forcing))
        jax.block_until_ready(outs[-1]["soilp"])
        ts.append(time.perf_counter() - t0)
    return prob, outs, ts


def _columns(d, sub, ncol):
    """Every ``sub``-th column of the [ncol, ...] arrays in ``d``."""
    return {k: v[::sub] if isinstance(v, np.ndarray) and v.shape[:1] ==
            (ncol,) else v for k, v in d.items()}


def phase_alm(s, seed):
    jax, jnp = s.jax, s.jax.numpy
    ncol, nz, sub = WIDTH["alm"]
    soils, forcing = alm_inputs(ncol, nz, seed)
    P0 = soils["P0"]
    # one attempt per step (checked below): no batch-wide retry couples
    # the columns, so the CPU reference may run a strided subset
    with s.on_cpu():
        _, ref_outs, _ = run_alm(jax, _columns(soils, sub, ncol),
                                 _columns(forcing, sub, ncol), jnp.float64,
                                 False)
    s.check("alm cpu f64 reference: one attempt per step",
            [o["attempts"] for o in ref_outs] == [1] * len(ref_outs), "")
    P_ref = np.asarray(ref_outs[-1]["soilp"])
    for dtype, escalate, band, tag in (
            (jnp.float64, False, F64_BAND, "f64 default"),
            (jnp.float32, True, F32_BAND, "f32 + escalate_f64")):
        prob, outs, ts = run_alm(jax, soils, forcing, dtype, escalate)
        errs = [o["abs_mass_error_col"] for o in outs]
        log(f"  ALM {tag} [{ncol}, {nz}]: step wall s {ts} (first "
            f"compiles), newton_iters {[o['newton_iters'] for o in outs]},"
            f" attempts {[o['attempts'] for o in outs]}, escalated_cols "
            f"{[o['escalated_cols'] for o in outs]}")
        s.check(f"alm {tag} audit", max(errs) < AUDIT_KG,
                f"max per-column mass error {max(errs)!r} kg < {AUDIT_KG}")
        s.check(f"alm {tag} on card",
                prob.P.devices() == {s.gpu}, str(prob.P.devices()))
        if dtype == jnp.float64:
            s.check("alm f64 one attempt per step",
                    [o["attempts"] for o in outs] == [1] * len(outs), "")
        s.close(f"alm {tag} P vs cpu f64", np.asarray(outs[-1]["soilp"])
                [::sub], P_ref, P0[::sub], band,
                f"{tag}, every {sub}th column")


# ---- compiled VSFM -----------------------------------------------------------
def phase_vsfm(s, seed):
    jax, jnp = s.jax, s.jax.numpy
    import __graft_entry__ as g

    ncol, nz, sub = WIDTH["vsfm"]
    _, comp = g._build_compiled_celia(nz)

    def problem(dtype, n):
        X = jnp.full((n, nz), 3.5355e3, dtype)
        top = jnp.linspace(5.0e4, 9.8e4, ncol, dtype=dtype)[::ncol // n]
        bc = jnp.stack([top,
                        jnp.full((n,), 3.5355e3, dtype)], axis=1)
        return X, bc, jnp.zeros((n, 0), dtype)

    X, bc, ss = problem(jnp.float32, ncol)
    X0 = np.asarray(X)
    t0 = time.perf_counter()
    for _ in range(2):
        X, iters, ok, _ = comp.step_batched(X, (bc,), (ss,), 3600.0)
        s.check("vsfm f32 step converged", bool(np.asarray(ok).all()),
                f"{int(np.asarray(ok).sum())}/{ncol} columns, "
                f"{int(iters)} newton iterations")
    jax.block_until_ready(X)
    log(f"  VSFM [{ncol}, {nz}] f32: 2 steps incl. compile "
        f"{time.perf_counter() - t0:.1f} s")
    ref = {}
    with s.on_cpu():
        for dtype in (jnp.float64, jnp.float32):
            Xr, bcr, ssr = problem(dtype, ncol // sub)
            for _ in range(2):
                Xr, _, okr, _ = comp.step_batched(Xr, (bcr,), (ssr,),
                                                  3600.0)
            ref[dtype] = Xr
    s.check("vsfm cpu f64 reference converged", bool(np.asarray(okr).all()),
            "")
    s.close("vsfm f32 P vs cpu f64", np.asarray(X)[::sub], ref[jnp.float64],
            X0[::sub], F32_BAND, f"f32 card, every {sub}th column",
            f32_ref=ref[jnp.float32])

    # entry(): the narrow [256, 128] program
    fn, (Xe, bce) = g.entry()
    Xe1 = jax.jit(fn)(Xe, bce)
    _, comp128 = g._build_compiled_celia(WIDTH["entry"])
    ref = {}
    with s.on_cpu():
        for dtype in (jnp.float64, jnp.float32):
            ref[dtype], _, _, _ = comp128.step_batched(
                jnp.asarray(np.asarray(Xe[:1]), dtype),
                (jnp.asarray(np.asarray(bce[:1]), dtype),),
                (jnp.zeros((1, 0), dtype),), 3600.0)
    Xe1 = np.asarray(Xe1)
    # identical columns; the GPU's atomic scatter-adds sum in no fixed
    # order, so they agree to f32 rounding, not bit for bit
    spread = float(np.abs(Xe1 - Xe1[:1]).max())
    band = F32_BAND * float(np.abs(Xe1[0] - np.asarray(Xe[0])).max())
    s.check("entry() identical columns agree", spread <= band,
            f"max|column - column 0| = {spread!r} <= {band!r} (f32)")
    s.close("entry() [256, 128] f32 vs cpu f64", Xe1, ref[jnp.float64],
            np.asarray(Xe[:1]), F32_BAND, "f32 card",
            f32_ref=ref[jnp.float32])


# ---- thermal KSP -------------------------------------------------------------
def phase_ksp(s, seed):
    jax, jnp = s.jax, s.jax.numpy
    from mpp_tpu.problems import thermal_mms as tm
    from mpp_tpu.batched.ksp_compiled import compile_ksp

    with s.on_cpu():
        mpp, _ = tm.run_thermal_mms_problem(1, nx=WIDTH["ksp"][1])
    comp = compile_ksp(mpp, linear_solver="direct")
    g = comp.goveqns[0]
    ncol, n = WIDTH["ksp"][0], comp.n
    rng = np.random.default_rng(seed)
    T0 = 280.0 + 10.0 * rng.random((ncol, n))
    liq = 5.0 * rng.random((ncol, n))
    bc = np.broadcast_to(np.asarray(g.bc_value), (ncol,) + g.bc_value.shape)
    ss = np.broadcast_to(np.asarray(g.ss_values),
                         (ncol,) + g.ss_values.shape)

    def step(dtype):
        a = lambda v: jnp.asarray(v, dtype)
        return comp.step_batched(a(T0), (a(bc),), (a(ss),), 1800.0,
                                 dyn=({"liq": a(liq)},))

    T1, ok, _ = step(jnp.float32)
    s.check("ksp f32 solve finite", bool(np.asarray(ok).all()), "")
    with s.on_cpu():
        Tr, okr, _ = step(jnp.float64)
        Tr32, _, _ = step(jnp.float32)
    s.close(f"ksp [{ncol}, {n}] f32 vs cpu f64", T1, Tr, T0, F32_BAND,
            "f32 card", f32_ref=Tr32)


# ---- coupled TH --------------------------------------------------------------
def phase_th(s, seed):
    jax, jnp = s.jax, s.jax.numpy
    from mpp_tpu.problems import th
    from mpp_tpu.batched.th_compiled import compile_th

    ncol, nh, sub = WIDTH["th"]
    with s.on_cpu():
        mpp, _ = th.run_mass_and_heat(nx=nh)
    comp = compile_th(mpp, linear_solver="direct")
    X0 = np.broadcast_to(np.asarray(mpp.soe.soln), (ncol, comp.n))
    bc, ss = comp.gather_inputs(ncol)
    bc = [np.array(b) for b in bc]
    bc[1][:, 0] = np.linspace(296.15, 310.15, ncol)
    ss = [np.asarray(v) for v in ss]
    dyn = [{k: np.asarray(v) for k, v in d.items()}
           for d in comp._serial_dyn(ncol)]

    def step(dtype, cols, **tol):
        a = lambda v: jnp.asarray(v[cols], dtype)
        return comp.step_batched(
            a(X0), tuple(a(b) for b in bc), tuple(a(v) for v in ss), 3600.0,
            dyn=tuple({k: a(v) for k, v in d.items()} for d in dyn), **tol)

    X1, it, ok, _ = step(jnp.float32, slice(None), rtol=2e-3, stol=1e-5)
    s.check("th f32 step converged", bool(np.asarray(ok).all()),
            f"{int(it)} newton iterations")
    with s.on_cpu():
        Xr, _, okr, _ = step(jnp.float64, slice(None, None, sub))
        Xr32, _, _, _ = step(jnp.float32, slice(None, None, sub),
                             rtol=2e-3, stol=1e-5)
    s.check("th cpu f64 reference converged", bool(np.asarray(okr).all()),
            "")
    X1 = np.asarray(X1)[::sub]
    x0 = X0[::sub]
    for half, name in ((slice(0, comp.nh), "P"), (slice(comp.nh, None), "T")):
        s.close(f"th [{ncol}, {nh} cells] f32 {name} vs cpu f64",
                X1[:, half], np.asarray(Xr)[:, half], x0[:, half], F32_BAND,
                f"f32 card rtol 2e-3, every {sub}th column",
                f32_ref=np.asarray(Xr32)[:, half])


# ---- canopy pipeline ---------------------------------------------------------
def phase_canopy(s, seed):
    jax, jnp = s.jax, s.jax.numpy
    from mpp_tpu.batched.canopy_pipeline import CanopyPipeline

    ncair = WIDTH["canopy"]
    with s.on_cpu():
        pipe = CanopyPipeline(ncair=ncair, dtype=jnp.float32)
        ref = CanopyPipeline(ncair=ncair, dtype=jnp.float64)
    s0 = pipe.initial_state()
    staged = pipe.run_staged(pipe.staged_substep_fns(jax), s0)
    hour = pipe.fused_hour_fn(jax)(s0, pipe.default_forcing)
    with s.on_cpu():
        r0 = ref.initial_state()
        staged_ref = ref.run_staged(ref.staged_substep_fns(jax), r0)
        hour_ref = ref.fused_hour_fn(jax)(r0, ref.default_forcing)
    for tag, got, want in (("run_staged substep", staged, staged_ref),
                           ("fused_hour_fn hour", hour, hour_ref)):
        for f in got._fields:
            s.close(f"canopy {tag} {f} vs cpu f64", getattr(got, f),
                    getattr(want, f), getattr(r0, f), F32_BAND,
                    f"f32 card, ncair={ncair}")


# ---- kernels -------------------------------------------------------------------
def _time(jax, fn, args, K):
    """Seconds per call of ``fn`` chained K times in one program."""
    *mats, b0 = args

    @jax.jit
    def loop(*a):
        *m, b = a
        return jax.lax.fori_loop(0, K, lambda _, bb: fn(*m, bb), b)

    jax.block_until_ready(loop(*mats, b0))
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(loop(*mats, b0))
        ts.append(time.perf_counter() - t0)
    return min(ts) / K


def phase_kernels(s, seed):
    jax, jnp = s.jax, s.jax.numpy
    from jax import lax
    from mpp_tpu.ops.pallas_kernels import tridiag_solve, block_tridiag2_solve
    from mpp_tpu.ops.tridiag import thomas
    from mpp_tpu.ops.block_thomas import block_thomas

    def cusparse(dl, d, du, b):
        dl = dl.at[:, 0].set(0.0)
        du = du.at[:, -1].set(0.0)
        return lax.linalg.tridiagonal_solve(dl, d, du, b[..., None])[..., 0]

    rng = np.random.default_rng(seed)
    rows = []
    for dtype, tol in ((np.float32, 1e-5), (np.float64, 1e-12)):
        for ncol, nz in WIDTH["thomas"]:
            a = [rng.uniform(0.1, 0.3, (ncol, nz)),
                 rng.uniform(1.5, 2.5, (ncol, nz)),
                 rng.uniform(0.1, 0.3, (ncol, nz)),
                 rng.uniform(0.0, 1.0, (ncol, nz))]
            a = [jnp.asarray(v, dtype) for v in a]
            x = jax.jit(tridiag_solve)(*a)
            with s.on_cpu():
                xr = thomas(*(jnp.asarray(np.asarray(v)) for v in a))
            err = float(np.abs(np.asarray(x) - np.asarray(xr)).max())
            s.check(f"thomas kernel [{ncol}, {nz}] "
                    f"{np.dtype(dtype).name}", err <= tol,
                    f"max|kernel-cpu scan| = {err!r} <= {tol:g}")
            t = {k: _time(jax, f, a, 50) * 1e6 for k, f in
                 (("kernel_us", tridiag_solve), ("xla_scan_us", thomas),
                  ("cusparse_us", cusparse))}
            rows.append(dict(op="thomas", dtype=np.dtype(dtype).name,
                             ncol=ncol, nz=nz, **t))
        for ncol, n in WIDTH["block2"]:
            L = rng.standard_normal((ncol, n, 2, 2)) * 0.2
            U = rng.standard_normal((ncol, n, 2, 2)) * 0.2
            D = rng.standard_normal((ncol, n, 2, 2)) * 0.5 + 3.0 * np.eye(2)
            b = rng.standard_normal((ncol, n, 2))
            a = [jnp.asarray(v, dtype) for v in (L, D, U, b)]
            x = jax.jit(block_tridiag2_solve)(*a)
            with s.on_cpu():
                xr = block_thomas(*(jnp.asarray(np.asarray(v)) for v in a))
            err = float(np.abs(np.asarray(x) - np.asarray(xr)).max()
                        / np.abs(np.asarray(xr)).max())
            btol = 1e-4 if dtype == np.float32 else 1e-10
            s.check(f"block-thomas kernel [{ncol}, {n}] "
                    f"{np.dtype(dtype).name}", err <= btol,
                    f"max|kernel-cpu scan|/max|x| = {err!r} <= {btol:g}")
            t = {k: _time(jax, f, a, 20) * 1e6 for k, f in
                 (("kernel_us", block_tridiag2_solve),
                  ("xla_scan_us", block_thomas))}
            rows.append(dict(op="block_thomas2", dtype=np.dtype(dtype).name,
                             ncol=ncol, nz=n, **t))
    for r in rows:
        log("  timing " + json.dumps(r))


# ---- four cards: sharded ALM with lateral UGDM flow ---------------------------
def phase_four_cards(s, seed):
    jax, jnp = s.jax, s.jax.numpy
    from mpp_tpu.driver import alm
    from mpp_tpu.parallel.sharding import column_mesh, shard_columns
    from mpp_tpu.parallel.ugrid import UGrid, lateral_darcy_source_global

    ndev = 4
    nx, ny, nz = WIDTH["four"]             # 4 x 16384 columns
    ncol = nx * ny
    s.check("four cards present", len(jax.devices()) >= ndev,
            f"{len(jax.devices())} devices")
    mesh = column_mesh(ndev)
    ug = UGrid.regular_2d(nx, ny)
    ug.edge_dist[:] = 10.0
    ug.edge_area[:] = 10.0
    soils, forcing = alm_inputs(ncol, nz, seed)
    col = np.arange(ncol)
    soils["P0"] = (3.5355e3 + 2.0e4 * np.sin(0.7 * col))[:, None] \
        * np.ones(nz)
    P0 = soils["P0"]
    prob = alm.alm_vsfm_initialize(lateral_connectivity=True,
                                   device_mesh=mesh, ugrid=ug, **soils)
    prob.P = shard_columns(prob.P, mesh)
    devs = {sh.device for sh in prob.P.addressable_shards}
    s.check("alm state on 4 distinct cards", len(devs) == ndev
            and all(d.platform == "gpu" for d in devs), str(sorted(
                d.id for d in devs)))

    # the sharded lateral source against the one-device global reference
    P = jnp.asarray(P0, prob.P.dtype)
    src = np.asarray(alm._lateral_source(prob, shard_columns(P, mesh)))
    kr = np.asarray(alm._cell_kr(prob, P))
    perm = np.asarray(prob.dyn[0]["perm"][..., 0])
    with s.on_cpu():
        src_ref = np.asarray(lateral_darcy_source_global(
            ug, jnp.asarray(P0), jnp.asarray(kr), jnp.asarray(perm),
            jnp.asarray(prob.dz)))
    err = float(np.abs(src - src_ref).max())
    scale = float(np.abs(src_ref).max())
    s.check("sharded lateral source vs global reference",
            err <= 1e-12 * scale,
            f"max|4 cards - global| = {err!r} <= 1e-12 x {scale!r} kmol/s "
            "(f64)")

    t0 = time.perf_counter()
    out = alm.alm_vsfm_solve(prob, DT_ALM, **forcing)
    jax.block_until_ready(out["soilp"])
    log(f"  sharded ALM step [{ncol}, {nz}] f64 incl. compile "
        f"{time.perf_counter() - t0:.1f} s, newton_iters "
        f"{out['newton_iters']}, attempts {out['attempts']}")
    s.check("sharded alm audit", out["abs_mass_error_col"] < AUDIT_KG,
            f"max per-column mass error {out['abs_mass_error_col']!r} kg")
    qlat = np.asarray(out["qflx_lateral"])
    s.check("lateral flux conserves mass",
            abs(qlat.sum()) <= 1e-10 * np.abs(qlat).max(),
            f"sum {qlat.sum()!r} vs max {np.abs(qlat).max()!r} mm/s")


def main():
    four = "--four-cards" in sys.argv
    seed = int(sys.argv[sys.argv.index("--seed") + 1]) \
        if "--seed" in sys.argv else 0
    if not os.path.isdir(os.path.join(HERE, "mpp_tpu")):
        print("chip_smoke.py: the mpp_tpu package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import jax
    from mpp_tpu.config import enable_compile_cache

    cache = enable_compile_cache()
    jax.config.update("jax_enable_x64", True)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py: no GPU (JAX found {dev.platform}); nothing "
              "run", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}"
        f"; compile cache {cache}; devices {jax.devices()}")

    s = Smoke(jax)
    if four:
        phases = [("four cards: sharded ALM lateral", phase_four_cards)]
    else:
        phases = [("ALM production driver", phase_alm),
                  ("compiled VSFM", phase_vsfm),
                  ("thermal KSP", phase_ksp),
                  ("TH", phase_th),
                  ("canopy pipeline", phase_canopy),
                  ("kernels", phase_kernels)]
    for name, fn in phases:
        s.phase(name, lambda fn=fn: fn(s, seed))
    if s.failed:
        log(f"FAILED: {s.failed}")
        return 1
    log(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
