"""Benchmark: interior-point iterations/s on a 1M-variable synthetic topology
problem (the reference's target workload shape) on one GPU, plus the TR, MMA
and eigen-TR flagship rates.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"extra"}, where "device" names the platform, device kind and device count.
The reference publishes no benchmark numbers, so vs_baseline is reported
against the north-star target of 10 IP iterations/s on 1M variables on one
device.

It needs a GPU.  Only with JAX_PLATFORMS=cpu set explicitly does it run the
small CPU shapes in f64 (a smoke test of the script, not a measurement).
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp

TARGET_ITERS_PER_S = 10.0


def main():
    on_cpu = os.environ.get("JAX_PLATFORMS") == "cpu"
    dev = jax.devices()[0]
    if not on_cpu and dev.platform != "gpu":
        sys.stderr.write(f"[bench] needs a GPU (found {dev.platform!r}); "
                         "set JAX_PLATFORMS=cpu for the CPU smoke shapes\n")
        sys.exit(2)
    backend = dev.platform
    dtype = jnp.float64 if on_cpu else jnp.float32
    n = (1 << 17) if on_cpu else (1 << 20)  # 1M vars on the GPU

    from paropt_tpu.utils.compile_cache import enable_compilation_cache
    enable_compilation_cache()

    from paropt_tpu.models.topology import SyntheticTopology
    from paropt_tpu import ip_fused
    from paropt_tpu.ops import qn as qnmod

    prob = SyntheticTopology(n=n, block=8, dtype=dtype)
    model = ip_fused.model_from_problem(prob)
    opts = ip_fused.FusedIPOptions(
        use_quasi_newton_update=True,
        # the REFERENCE operating point (`ParOptInteriorPoint.cpp:4811-4840`
        # converges at abs_res_tol=1e-6, double precision): f32 reaches res
        # ~3e-7 at 1M vars (scripts/precision_study.py), so the headline
        # number is at full reference-grade tolerance
        abs_res_tol=1e-6,
        # f32 converges without iterative refinement
        # (scripts/precision_study.py --solve); f64 keeps one pass
        iterative_refinement_steps=0 if dtype == jnp.float32 else 1)
    fused = ip_fused.FusedIP(model, prob.nvars, prob.ncon, prob.nwcon,
                             prob.nwblock, opts, dtype=dtype)
    data, x0 = ip_fused.data_template_from_problem(prob, dtype=dtype)
    # shipping storage policy: bf16 ring buffer/Phi at f32 on the GPU
    qn0 = qnmod.qn_init(10, prob.nvars, dtype=dtype,
                        storage_dtype=qnmod.default_storage_dtype(dtype))

    t0 = time.time()
    state = fused.init(x0, data, (), qn0, None)
    jax.block_until_ready(state)
    sys.stderr.write(f"[bench] init+compile(init): {time.time()-t0:.1f}s "
                     f"backend={backend} n={n} dtype={dtype.__name__}\n")

    # warm-up / compile the step
    t0 = time.time()
    state = fused.step(state, data, (), None)
    jax.block_until_ready(state)
    sys.stderr.write(f"[bench] compile(step): {time.time()-t0:.1f}s\n")

    # timed iterations: K steps fused into ONE device computation via
    # lax.fori_loop, so host dispatch latency is excluded and the
    # number reflects on-device throughput
    iters = 20

    @jax.jit
    def run_k(state):
        return jax.lax.fori_loop(
            0, iters, lambda i, s: fused._step_jit(s, data, (), None), state)

    t0 = time.time()
    state = run_k(state)
    jax.block_until_ready(state)
    sys.stderr.write(f"[bench] compile(run_k): {time.time()-t0:.1f}s\n")

    # 5 timed windows, report the MEDIAN (with min and max in the log)
    windows = []
    for w in range(5):
        t0 = time.time()
        state = run_k(state)
        jax.block_until_ready(state)
        dt = time.time() - t0
        windows.append(iters / dt)
        sys.stderr.write(
            f"[bench] window {w}: {iters} IP iterations in {dt:.3f}s "
            f"({windows[-1]:.2f} it/s)\n")
    windows.sort()
    its_per_s = windows[len(windows) // 2]
    sys.stderr.write(
        f"[bench] median {its_per_s:.2f} it/s "
        f"(min {windows[0]:.2f}, max {windows[-1]:.2f}); "
        f"fobj={float(state.fobj):.6e} "
        f"res={float(state.res_norm):.3e} mu={float(state.mu):.3e}\n")

    # HBM bytes/step from XLA's own cost analysis of the compiled step —
    # variance-free evidence to accompany the noisy throughput number, and
    # the regression gate for a metric already at the bandwidth roofline
    step_gb = None
    try:
        ca = fused._step_jit.lower(state, data, (), None).compile()\
            .cost_analysis()
        ca = ca[0] if isinstance(ca, (list, tuple)) else ca
        step_gb = ca.get("bytes accessed", 0.0) / 1e9
        sys.stderr.write(f"[bench] step cost analysis: {step_gb:.2f} GB "
                         "HBM accessed/iteration\n")
    except Exception as exc:  # pragma: no cover - backend-dependent API
        sys.stderr.write(f"[bench] cost analysis unavailable: {exc}\n")

    # secondary info: whole-solve wall clock to the f32 KKT tolerance via
    # the zero-round-trip lax.while_loop path (compile excluded)
    try:
        t0 = time.time()
        out = fused.solve(x0, data, (), qn0, None, jit_loop=True)
        jax.block_until_ready(out)
        compile_plus = time.time() - t0
        t0 = time.time()
        out = fused.solve(x0, data, (), qn0, None, jit_loop=True)
        jax.block_until_ready(out)
        solve_wall = time.time() - t0
        sys.stderr.write(
            f"[bench] full solve: converged={bool(out.converged)} "
            f"iters={int(out.k)} res={float(out.res_norm):.2e} "
            f"wall={solve_wall:.2f}s (first incl. compile "
            f"{compile_plus:.1f}s)\n")
    except Exception as exc:  # informational only — never kill the line
        sys.stderr.write(f"[bench] full solve failed: {exc}\n")

    # qn_subspace_auto solve: the documented user-side knob (msub 10 -> 5
    # at >= 2^19 f32 vars; identical iterations on this workload).  The
    # PRIMARY metric keeps the reference-default msub=10 for cross-round
    # comparability; this extra records the tuned-whole-solve rate.
    auto_rate = None
    try:
        from paropt_tpu.ops import qn as _qnmod
        msub_auto = _qnmod.resolve_subspace_size(10, True, n, dtype)
        if msub_auto != 10:
            qn_auto = _qnmod.qn_init(
                msub_auto, n, dtype=dtype,
                storage_dtype=_qnmod.default_storage_dtype(dtype))
            out_a = fused.solve(x0, data, (), qn_auto, None, jit_loop=True)
            jax.block_until_ready(out_a)
            t0 = time.time()
            out_a = fused.solve(x0, data, (), qn_auto, None, jit_loop=True)
            jax.block_until_ready(out_a)
            wall_a = time.time() - t0
            auto_rate = int(out_a.k) / wall_a
            sys.stderr.write(
                f"[bench] qn_subspace_auto (msub={msub_auto}) solve: "
                f"converged={bool(out_a.converged)} iters={int(out_a.k)} "
                f"res={float(out_a.res_norm):.2e} wall={wall_a:.2f}s "
                f"({auto_rate:.1f} it/s)\n")
    except Exception as exc:  # informational only
        sys.stderr.write(f"[bench] qn_subspace_auto solve failed: {exc}\n")

    extra, errors = [], []
    if step_gb is not None:
        extra.append({"metric": f"ip_step_hbm_gb_n{n}",
                      "value": round(step_gb, 3), "unit": "GB/step",
                      "vs_baseline": None})
    if auto_rate is not None:
        extra.append({"metric": f"ip_solve_iterations_per_s_n{n}_msub_auto",
                      "value": round(auto_rate, 3), "unit": "iter/s",
                      "vs_baseline": None})
    if not os.environ.get("PAROPT_TPU_BENCH_IP_ONLY"):
        ex, errors = _flagship_benchmarks(on_cpu)
        extra.extend(ex)

    out = {
        "metric": f"ip_iterations_per_s_n{n}",
        "value": round(its_per_s, 3),
        "unit": "iter/s",
        "vs_baseline": round(its_per_s / TARGET_ITERS_PER_S, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "extra": extra,
    }
    if errors:
        out["errors"] = errors
    print(json.dumps(out))


def _median_metric(name, build, n_windows=5, check=None):
    """Median-of-k flagship measurement: ``build()`` returns a zero-arg
    ``run() -> result_dict`` over an already-constructed solver; the first
    call pays the compile, then ``n_windows`` timed re-runs of the SAME
    compiled solve give median/min/max it/s.

    ``check(res)`` is a CONVERGENCE-QUALITY gate: throughput without a
    converged-state assert silently rewards broken solves, so each
    flagship metric pins its expected final objective band and
    infeasibility; a violation raises and surfaces in the bench tail
    (crash-isolated per metric)."""
    import time as _time
    run = build()
    t0 = _time.time()
    res = run()
    compile_wall = _time.time() - t0
    rates = []
    for _ in range(n_windows):
        t0 = _time.time()
        res = run()
        rates.append(max(res["niter"], 1) / (_time.time() - t0))
    rates.sort()
    med = rates[len(rates) // 2]
    sys.stderr.write(
        f"[bench] {name}: {res['niter']} outer iters, median {med:.2f} it/s "
        f"(min {rates[0]:.2f}, max {rates[-1]:.2f}; first run incl. compile "
        f"{compile_wall:.1f}s), fobj {res['fobj']:.4f}, "
        f"infeas {res['infeas']:.1e}\n")
    if check is not None:
        check(res)
    return {"metric": name, "value": round(med, 3), "unit": "iter/s",
            "vs_baseline": None,
            "min": round(rates[0], 3), "max": round(rates[-1], 3)}


def _flagship_benchmarks(on_cpu):
    """The reference's PRODUCT surface — TR (the default algorithm,
    `ParOptOptimizer.cpp:108-183`), MMA on 2-D/3-D SIMP FEM compliance
    topology problems (its target workload), and the eigen-TR path.
    Each metric is crash-isolated (one failure cannot zero out the
    others) and median-of-5 on the compiled solver."""
    from paropt_tpu.models.fem_topology import FEMTopology
    from paropt_tpu.mma import FusedMMA
    from paropt_tpu.tr import FusedTR

    dt = "float64" if on_cpu else "float32"

    # --- MMA outer-iterations/s on the 96x48 SIMP mesh ---------------------
    # mgcg: V-cycle-preconditioned CG — 25 iterations reach BETTER residual
    # than 700 Jacobi-CG iterations, and the slice/pad stencil matvec needs
    # no gather
    def build_mma2d():
        nex, ney, cg = (24, 12, 25) if on_cpu else (96, 48, 25)
        mma_iters = 20 if on_cpu else 60
        fem = FEMTopology(nex=nex, ney=ney, cg_iters=cg, solver="mgcg")
        solver = FusedMMA(fem, {"mma_max_iterations": mma_iters,
                                "mma_output_file": None, "dtype": dt})
        return lambda: solver.solve()[0]

    # --- TR (SL1QP) outer-iterations/s on the 48x24 SIMP mesh --------------
    # FusedTR: the reference's DEFAULT algorithm with the WHOLE outer loop
    # (steering + QP solves + trial eval + QN update + radius/penalty
    # logic) on-device
    def build_tr2d():
        nex, ney, cg = (12, 6, 25) if on_cpu else (48, 24, 25)
        tr_iters = 10 if on_cpu else 20
        fem_tr = FEMTopology(nex=nex, ney=ney, cg_iters=cg, solver="mgcg")
        tr = FusedTR(fem_tr, {
            "tr_output_file": None, "output_file": None,
            "tr_max_iterations": tr_iters,
            "abs_res_tol": 1e-7 if on_cpu else 1e-6,
            "tr_infeas_tol": 1e-5, "tr_l1_tol": 0.0,
            "tr_linfty_tol": 1e-5, "dtype": dt})
        return lambda: tr.solve()[0]

    # --- MMA outer-iterations/s on a 3-D voxel SIMP mesh -------------------
    # the reference's README headline workload ("large-scale 3D ...
    # topology optimization", README.md:12-31)
    def build_mma3d():
        from paropt_tpu.models.fem_topology3d import FEMTopology3D
        nx, ny, nz = (8, 4, 4) if on_cpu else (32, 16, 16)
        iters3d = 10 if on_cpu else 40
        fem3 = FEMTopology3D(nex=nx, ney=ny, nez=nz, cg_iters=25,
                             solver="mgcg")
        solver3 = FusedMMA(fem3, {"mma_max_iterations": iters3d,
                                  "mma_output_file": None, "dtype": dt})
        return lambda: solver3.solve()[0]

    # --- fused eigen-TR outer-iterations/s (the ParOptEig path) ------------
    def build_eigtr():
        from paropt_tpu.models.fem_frequency import FrequencyTopology
        nx, ny, N = (8, 4, 3) if on_cpu else (24, 12, 4)
        eig_iters = 8 if on_cpu else 20
        freq = FrequencyTopology(nex=nx, ney=ny, N=N, cg_iters=25,
                                 solver="mgcg", lobpcg_iters=50)
        ftr = freq.build_fused_tr({
            "tr_output_file": None, "output_file": None,
            "tr_max_iterations": eig_iters, "tr_init_size": 0.05,
            "tr_max_size": 0.2, "tr_min_size": 1e-6, "abs_res_tol": 1e-8,
            "tr_l1_tol": 1e-4, "tr_linfty_tol": 1e-4,
            "tr_adaptive_gamma_update": True, "penalty_gamma": 10.0,
            "dtype": dt})
        return lambda: ftr.solve()[0]

    cpu_tag = "24x12" if on_cpu else "96x48"
    tr_tag = "12x6" if on_cpu else "48x24"
    m3_tag = "8x4x4" if on_cpu else "32x16x16"
    eig_tag = "8x4" if on_cpu else "24x12"

    def band(lo, hi, max_infeas):
        """Converged-state gate: final objective inside the band observed
        at this config, infeasibility bounded."""
        def check(res):
            assert lo < res["fobj"] < hi, \
                f"fobj {res['fobj']:.4f} outside converged band ({lo}, {hi})"
            assert res["infeas"] < max_infeas, \
                f"infeas {res['infeas']:.2e} > {max_infeas:.1e}"
        return check

    if on_cpu:
        # small smoke shapes stop earlier: looser bands (observed CPU
        # endpoints: mma2d 0.249, tr 0.444, mma3d 0.526, eigtr 0.583 at
        # infeas 1.2e-2 after its 8 truncated iterations)
        checks = [band(0.05, 0.40, 1e-8), band(0.10, 0.60, 1e-6),
                  band(0.30, 0.80, 1e-8), band(0.20, 0.90, 5e-2)]
    else:
        checks = [band(0.10, 0.18, 1e-8), band(0.18, 0.30, 1e-6),
                  band(0.08, 0.14, 1e-8), band(0.25, 0.35, 2e-3)]
    metrics = [
        (f"mma_fem{cpu_tag}_outer_iterations_per_s", build_mma2d),
        (f"tr_fem{tr_tag}_outer_iterations_per_s", build_tr2d),
        (f"mma_fem3d{m3_tag}_outer_iterations_per_s", build_mma3d),
        (f"eigtr_fem{eig_tag}_outer_iterations_per_s", build_eigtr),
    ]
    extra, errors = [], []
    for (name, build), check in zip(metrics, checks):
        try:
            extra.append(_median_metric(name, build, check=check))
        except Exception as exc:  # crash-isolate: one metric can't zero
            msg = f"{name}: {type(exc).__name__}: {exc}"
            sys.stderr.write(f"[bench] FAILED {msg}\n")
            errors.append(msg)
    return extra, errors


if __name__ == "__main__":
    main()
