"""2-D SIMP topology optimization end-to-end (the reference's
`examples/topology_optimization/` role): optimize a cantilever and render
the density field.

    python examples/fem_topology.py [--nex 64] [--ney 32] [-o design.png]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
# persistent compile cache (JAX_COMPILATION_CACHE_DIR, else the checkout's
# .jax_cache): repeat runs skip compilation
from paropt_tpu.utils.compile_cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nex", type=int, default=48)
    ap.add_argument("--ney", type=int, default=24)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--algorithm", default="mma", choices=["ip", "tr", "mma"])
    ap.add_argument("--fused", action="store_true",
                    help="run the whole MMA outer loop as one XLA "
                         "computation (fastest on an accelerator)")
    ap.add_argument("--solver", default="mgcg",
                choices=["jacobi", "mgcg"],
                help="FEM linear solver (mgcg: multigrid-CG, ~5x "
                     "fewer iterations)")
    ap.add_argument("--cg-iters", type=int, default=None)
    ap.add_argument("-o", "--output", default=None)
    args = ap.parse_args()

    from paropt_tpu.models.fem_topology import FEMTopology
    from paropt_tpu.optimizer import Optimizer

    cg = args.cg_iters or (40 if args.solver == "mgcg" else 400)
    prob = FEMTopology(nex=args.nex, ney=args.ney, cg_iters=cg,
                       solver=args.solver, volume_fraction=0.4)
    x0, _, _ = prob.get_vars_and_bounds()
    f0 = float(prob.objective(x0))

    t0 = time.time()
    if args.fused:
        from paropt_tpu.mma import FusedMMA
        solver = FusedMMA(prob, {
            "mma_max_iterations": args.iters, "mma_output_file": None,
            "abs_res_tol": 1e-4, "mma_l1_tol": 1e-30,
            "mma_linfty_tol": 1e-30, "max_major_iters": 50})
        res, _ = solver.solve()
    else:
        opt = Optimizer(prob, {
            "algorithm": args.algorithm,
            "output_file": None, "tr_output_file": None,
            "mma_output_file": "-",
            "mma_max_iterations": args.iters,
            "tr_max_iterations": args.iters,
            "max_major_iters": 300,
            "abs_res_tol": 1e-5,
        })
        res = opt.optimize()
    dt = time.time() - t0
    x = np.asarray(res["x"])
    print(f"\ncompliance: {f0:.4f} -> {res['fobj']:.4f} "
          f"({100 * (1 - res['fobj'] / f0):.1f}% reduction), "
          f"volume slack {float(prob.constraints(res['x'])[0]):+.4f}, "
          f"wall {dt:.1f}s")

    if args.output:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        xf = np.asarray(prob._filter(res["x"]))
        fig, ax = plt.subplots(figsize=(8, 4))
        ax.imshow(xf.reshape(args.nex, args.ney).T[::-1], cmap="gray_r",
                  interpolation="nearest")
        ax.set_title(f"SIMP cantilever {args.nex}x{args.ney} "
                     f"({args.algorithm}); compliance "
                     f"{res['fobj'] / prob.c_scale:.3f}")
        ax.axis("off")
        fig.tight_layout()
        fig.savefig(args.output, dpi=140)
        print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
