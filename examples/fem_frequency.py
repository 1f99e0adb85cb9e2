"""Frequency-constrained SIMP topology optimization via the compact
eigenvalue-approximation trust-region path (reference analogue:
`examples/eigenvalue/eigenvalue_opt.py`, on the topology workload).

    min   mass(x)
    s.t.  KS min natural frequency >= freq_fraction * lam1(full material)

Usage:  python examples/fem_frequency.py [--nex 32 --ney 16 --N 6]
        python examples/fem_frequency.py --nez 16 --nex 32 --ney 16
        (any --nez > 0 switches to the 3-D voxel model
         FrequencyTopology3D with the grid-form eigensolve)
"""

import argparse
import time
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp
import numpy as np

from paropt_tpu.models.fem_frequency import (FrequencyTopology,
                                             FrequencyTopology3D)
from paropt_tpu.tr import TrustRegion


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nex", type=int, default=32)
    ap.add_argument("--ney", type=int, default=16)
    ap.add_argument("--nez", type=int, default=0,
                    help="> 0: 3-D voxel model (FrequencyTopology3D)")
    ap.add_argument("--N", type=int, default=6)
    ap.add_argument("--freq-fraction", type=float, default=0.5)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--cg-iters", type=int, default=None)
    ap.add_argument("--solver", default="mgcg", choices=["jacobi", "mgcg"])
    ap.add_argument("--mode", default="fused", choices=["fused", "host"],
                    help="fused: WHOLE eigen-TR loop as one on-device "
                         "while_loop (eig_fused.FusedEigenTR — no host "
                         "round-trips); host: the reference-style "
                         "EigenSubproblem + host TrustRegion")
    args = ap.parse_args()

    cg = args.cg_iters or (40 if args.solver == "mgcg" else 300)
    # (non-coarsenable odd meshes fall back to Jacobi automatically)
    if args.nez > 0:
        prob = FrequencyTopology3D(nex=args.nex, ney=args.ney,
                                   nez=args.nez, N=args.N,
                                   solver=args.solver,
                                   freq_fraction=args.freq_fraction,
                                   cg_iters=cg)
    else:
        prob = FrequencyTopology(nex=args.nex, ney=args.ney, N=args.N,
                                 solver=args.solver,
                                 freq_fraction=args.freq_fraction,
                                 cg_iters=cg)

    opts = {"tr_output_file": "fem_frequency.tr", "output_file": None,
            "tr_max_iterations": args.iters, "tr_init_size": 0.05,
            "tr_max_size": 0.2, "tr_min_size": 1e-6, "abs_res_tol": 1e-8,
            "tr_l1_tol": 1e-4, "tr_linfty_tol": 1e-4,
            "tr_adaptive_gamma_update": True, "penalty_gamma": 10.0}
    if args.nez > 0:
        # criterion scale at large n: the mass objective's gradient is
        # 1/n per entry, so the reference-normalized linfty KKT error
        # (computeKKTError, ParOptTrustRegion.cpp:2465-2472 — divide by
        # max(max|g|, max(1, zmax))) STARTS below 1e-4 whenever
        # n > 1e4 and multipliers are O(1).  ||g||_1 = 1, so the l1
        # criterion keeps its meaning at every mesh size — terminate on
        # l1 alone.
        opts["tr_linfty_tol"] = 0.0
        opts["tr_l1_tol"] = 1e-3
    t0 = time.time()
    if args.mode == "fused":
        opts["tr_output_file"] = None
        res, _ = prob.build_fused_tr(opts).solve()
    else:
        sub, eigh = prob.build_tr_subproblem(msub=10)
        res = TrustRegion(prob, opts, subproblem=sub).optimize()
    x = res["x"]
    freqs = prob.frequencies(x)
    print("converged=%s  wall=%.1fs" % (res["converged"], time.time() - t0))
    print("mass: %.4f (from 1.0)" % float(jnp.mean(prob.fem._filter(x))))
    print("target freq: %.6e  achieved lowest: %s"
          % (np.sqrt(prob.lam_target), freqs))


if __name__ == "__main__":
    main()
