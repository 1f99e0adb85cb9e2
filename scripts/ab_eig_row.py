"""A/B: quadratic vs linearized eigen-constraint row inside the fused
eigen-TR's inner QP.

The reference's `ParOptEigenSubproblem::evalObjCon` exposes the QUADRATIC
model of the eigen row to the inner IP
(`ParOptCompactEigenvalueApprox.cpp:598-635`); round 3 linearized it and
carried the curvature only through the merged Hessian.  This measures what
the stronger row model buys in outer iterations / final quality on the
frequency-constrained topology problem.

    # CPU (f64):
    JAX_PLATFORMS=cpu python scripts/ab_eig_row.py --nex 16 --ney 8 --iters 60
    # GPU:
    python scripts/ab_eig_row.py --nex 32 --ney 16 --iters 40
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))



def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nex", type=int, default=16)
    ap.add_argument("--ney", type=int, default=8)
    ap.add_argument("--N", type=int, default=4)
    ap.add_argument("--iters", type=int, default=60)
    args = ap.parse_args()

    import jax
    from paropt_tpu.models.fem_frequency import FrequencyTopology

    on_cpu = jax.default_backend() == "cpu"
    opts = {"tr_output_file": None, "output_file": None,
            "tr_max_iterations": args.iters, "tr_init_size": 0.05,
            "tr_max_size": 0.2, "tr_min_size": 1e-6, "abs_res_tol": 1e-8,
            "tr_l1_tol": 1e-4, "tr_linfty_tol": 1e-4,
            "tr_adaptive_gamma_update": True, "penalty_gamma": 10.0,
            "dtype": "float64" if on_cpu else "float32"}

    freq = FrequencyTopology(nex=args.nex, ney=args.ney, N=args.N,
                             cg_iters=25, solver="mgcg", lobpcg_iters=50)
    out = {}
    for mode in ("quadratic", "linear"):
        ftr = freq.build_fused_tr(dict(opts), eig_row_model=mode)
        t0 = time.time()
        res, state = ftr.solve()
        wall1 = time.time() - t0
        t0 = time.time()
        res, state = ftr.solve()
        wall2 = time.time() - t0
        out[mode] = res
        print(f"[{mode:9s}] niter={res['niter']:3d} "
              f"subiters={res['subiters']:5d} fobj={res['fobj']:.6f} "
              f"infeas={res['infeas']:.2e} linf={res['linfty']:.2e} "
              f"converged={res['converged']} "
              f"wall={wall2:.2f}s (first {wall1:.1f}s)")
    q, l = out["quadratic"], out["linear"]
    print(f"\nverdict: quadratic {q['niter']} vs linear {l['niter']} outer "
          f"iters; fobj {q['fobj']:.6f} vs {l['fobj']:.6f}; "
          f"subiters {q['subiters']} vs {l['subiters']}")


if __name__ == "__main__":
    main()
