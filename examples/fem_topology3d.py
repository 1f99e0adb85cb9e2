"""3-D SIMP cantilever topology optimization, end-to-end on device.

The reference's target application class (large-scale 3-D topology
optimization, README.md:12-31) on the voxel FEM model: the ENTIRE MMA
outer loop — FEM solves, asymptotes, separable subproblems, inner IP —
runs as chunked fused XLA computations.

    python examples/fem_topology3d.py --nex 32 --ney 16 --nez 16
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nex", type=int, default=16)
    ap.add_argument("--ney", type=int, default=8)
    ap.add_argument("--nez", type=int, default=8)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--cg-iters", type=int, default=None)
    ap.add_argument("--solver", default="mgcg",
                    choices=["jacobi", "mgcg"])
    ap.add_argument("--volume", type=float, default=0.3)
    ap.add_argument("--repeat", action="store_true",
                    help="re-run the compiled solve to report steady "
                         "throughput (compile excluded)")
    ap.add_argument("--chunk", default="auto",
                    help="outer iterations per device call: int, 'auto' "
                         "(watchdog-sized), or 'none'")
    args = ap.parse_args()
    chunk = (None if args.chunk == "none"
             else args.chunk if args.chunk == "auto" else int(args.chunk))

    from paropt_tpu.models.fem_topology3d import FEMTopology3D
    from paropt_tpu.mma import FusedMMA

    cg = args.cg_iters or (40 if args.solver == "mgcg" else 400)
    prob = FEMTopology3D(nex=args.nex, ney=args.ney, nez=args.nez,
                         volume_fraction=args.volume,
                         cg_iters=cg, solver=args.solver)
    print(f"elements: {prob.ne}  dofs: {prob.ndof}")
    solver = FusedMMA(prob, {"mma_max_iterations": args.iters,
                             "mma_output_file": None})
    t0 = time.time()
    res, state = solver.solve(chunk=chunk)
    wall = time.time() - t0
    x = np.asarray(res["x"])
    print(f"{args.iters} MMA iterations in {wall:.1f}s "
          f"(incl. compile): compliance {res['fobj']:.4f} "
          f"(vs 1.0 at uniform start), volume {x.mean():.3f} "
          f"(bound {args.volume}), infeas {res['infeas']:.1e}")
    if args.repeat:
        t0 = time.time()
        res, state = solver.solve(chunk=chunk)
        wall = time.time() - t0
        print(f"compiled-reuse: {res['niter']} iterations in {wall:.1f}s "
              f"({res['niter'] / wall:.2f} outer-it/s)")


if __name__ == "__main__":
    main()
