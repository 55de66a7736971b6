"""End-to-end A/B of the Newton-direction solver on one GPU.

    python tools/solver_ab.py [--steps N] [--only alm,vsfm64,...]

Runs the ALM production step, the compiled VSFM step, the thermal KSP
step and the TH step with each solver behind the choice points of
``mpp_tpu.ops.pallas_kernels``: the Triton kernels (what the program
runs), XLA's ``lax.scan`` references, and cuSPARSE's batched gtsv2
(``lax.linalg.tridiagonal_solve``; tridiagonal systems only).  Each
variant is a fresh trace and compile; the times are the host clock
around each step ending in ``block_until_ready``, after one warm-up
step.  Prints one JSON line per (workload, variant), with the card's
name and power limit first.
"""
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def cusparse_tridiag(dl, d, du, b):
    from jax import lax
    dl = dl.at[:, 0].set(0.0)
    du = du.at[:, -1].set(0.0)
    return lax.linalg.tridiagonal_solve(dl, d, du, b[..., None])[..., 0]


def variants():
    from mpp_tpu.ops import pallas_kernels as pk
    from mpp_tpu.ops.tridiag import thomas
    from mpp_tpu.ops.block_thomas import block_thomas
    return {"kernel": (pk.tridiag_solve, pk.block_tridiag2_solve),
            "xla_scan": (thomas, block_thomas),
            "cusparse": (cusparse_tridiag, None)}


def timed_steps(jax, step, state, nsteps):
    state = step(state)[0]                   # warm-up: compile
    jax.block_until_ready(state)
    ts, its = [], []
    for _ in range(nsteps):
        t0 = time.perf_counter()
        state, it = step(state)
        jax.block_until_ready(state)
        ts.append(time.perf_counter() - t0)
        its.append(it)
    return ts, its


def workloads(jax, jnp, nsteps):
    import __graft_entry__ as g
    from chip_smoke import alm_inputs, DT_ALM
    from mpp_tpu.driver import alm

    def run_alm():
        soils, forcing = alm_inputs(16384, 30, 0)
        prob = alm.alm_vsfm_initialize(dtype=jnp.float64,
                                       escalate_f64=False, **soils)

        def step(_):
            o = alm.alm_vsfm_solve(prob, DT_ALM, **forcing)
            return o["soilp"], o["newton_iters"]
        return timed_steps(jax, step, None, nsteps)

    def run_vsfm(nz):
        def run():
            ncol = 16384
            _, comp = g._build_compiled_celia(nz)
            bc = jnp.stack([jnp.linspace(5.0e4, 9.8e4, ncol,
                                         dtype=jnp.float32),
                            jnp.full((ncol,), 3.5355e3, jnp.float32)], 1)
            ss = jnp.zeros((ncol, 0), jnp.float32)

            def step(X):
                X, it, ok, _ = comp.step_batched(X, (bc,), (ss,), 3600.0)
                return X, int(it)
            return timed_steps(jax, step, jnp.full((ncol, nz), 3.5355e3,
                                                   jnp.float32), nsteps)
        return run

    def run_ksp():
        from mpp_tpu.problems import thermal_mms as tm
        from mpp_tpu.batched.ksp_compiled import compile_ksp
        with jax.default_device(jax.devices("cpu")[0]):
            mpp, _ = tm.run_thermal_mms_problem(1, nx=64)
        comp = compile_ksp(mpp, linear_solver="direct")
        ge = comp.goveqns[0]
        ncol, n = 16384, comp.n
        rng = np.random.default_rng(0)
        f32 = lambda v: jnp.asarray(v, jnp.float32)
        bc = f32(np.broadcast_to(np.asarray(ge.bc_value),
                                 (ncol,) + ge.bc_value.shape))
        ss = f32(np.broadcast_to(np.asarray(ge.ss_values),
                                 (ncol,) + ge.ss_values.shape))
        dyn = ({"liq": f32(5.0 * rng.random((ncol, n)))},)

        def step(T):
            return comp.step_batched(T, (bc,), (ss,), 1800.0,
                                     dyn=dyn)[0], 1
        return timed_steps(jax, step,
                           f32(280.0 + 10.0 * rng.random((ncol, n))),
                           nsteps)

    def run_th():
        from mpp_tpu.problems import th
        from mpp_tpu.batched.th_compiled import compile_th
        ncol = 8192
        with jax.default_device(jax.devices("cpu")[0]):
            mpp, _ = th.run_mass_and_heat(nx=64)
        comp = compile_th(mpp, linear_solver="direct")
        f32 = lambda v: jnp.asarray(np.asarray(v), jnp.float32)
        bc, ss = comp.gather_inputs(ncol)
        bc = [np.array(b) for b in bc]
        bc[1][:, 0] = np.linspace(296.15, 310.15, ncol)
        bc = tuple(f32(b) for b in bc)
        ss = tuple(f32(v) for v in ss)
        dyn = tuple({k: f32(v) for k, v in d.items()}
                    for d in comp._serial_dyn(ncol))

        def step(X):
            X, it, ok, _ = comp.step_batched(X, bc, ss, 3600.0, dyn=dyn,
                                             rtol=2e-3, stol=1e-5)
            return X, int(it)
        X0 = f32(np.broadcast_to(np.asarray(mpp.soe.soln), (ncol, comp.n)))
        return timed_steps(jax, step, X0, nsteps)

    return {"vsfm_f32_16384x64": (run_vsfm(64), "tridiag"),
            "th_f32_8192x64": (run_th, "block2"),
            "alm_f64_16384x30": (run_alm, "tridiag"),
            "ksp_f32_16384x64": (run_ksp, "tridiag"),
            "vsfm_f32_16384x128": (run_vsfm(128), "tridiag")}


def main():
    nsteps = int(sys.argv[sys.argv.index("--steps") + 1]) \
        if "--steps" in sys.argv else 3
    only = sys.argv[sys.argv.index("--only") + 1].split(",") \
        if "--only" in sys.argv else None
    import jax
    import jax.numpy as jnp
    from mpp_tpu.config import enable_compile_cache
    from mpp_tpu.ops import pallas_kernels as pk

    enable_compile_cache()
    jax.config.update("jax_enable_x64", True)
    if jax.devices()[0].platform != "gpu":
        print("solver_ab.py: needs a GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    vs = variants()
    for name, (run, kind) in workloads(jax, jnp, nsteps).items():
        if only and name not in only:
            continue
        for vname, (tri, blk) in vs.items():
            if (tri if kind == "tridiag" else blk) is None:
                continue
            with mock.patch.object(pk, "tridiag_solve", tri or
                                   pk.tridiag_solve), \
                    mock.patch.object(pk, "block_tridiag2_solve", blk or
                                      pk.block_tridiag2_solve):
                t0 = time.perf_counter()
                ts, its = run()
            print(json.dumps({
                "workload": name, "solver": vname,
                "ms_per_step": [t * 1e3 for t in ts],
                "ms_per_step_median": float(np.median(ts)) * 1e3,
                "newton_iters": its,
                "wall_incl_compile_s": time.perf_counter() - t0,
                "device": jax.devices()[0].device_kind}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
