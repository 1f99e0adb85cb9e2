"""Profile the 3-D FEM hot path on the GPU: stiffness matvec, MG V-cycle,
full mgcg state solve, objective and gradient — wall time (best of reps)
plus XLA cost-analysis bytes for roofline placement.

    python scripts/profile_fem3d.py --nex 160 --ney 80 --nez 80
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import jax
import jax.numpy as jnp


def _cost(jitted, *args):
    try:
        ca = jitted.lower(*args).compile().cost_analysis()
        ca = ca[0] if isinstance(ca, (list, tuple)) else ca
        return (ca.get("bytes accessed", 0.0) / 1e9,
                ca.get("flops", 0.0) / 1e9)
    except Exception:
        return float("nan"), float("nan")


def timed(name, jitted, *args, reps=3, inner=1):
    out = jitted(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.time()
        out = jitted(*args)
        jax.block_until_ready(out)
        best = min(best, (time.time() - t0) / inner)
    gb, gf = _cost(jitted, *args)
    print(f"[{name:26s}] {best * 1e3:9.2f} ms  {gb / inner:7.3f} GB "
          f"{gf / inner:8.2f} GF  ({gb / inner / max(best, 1e-9):6.1f} GB/s)",
          flush=True)
    return out, best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nex", type=int, default=160)
    ap.add_argument("--ney", type=int, default=80)
    ap.add_argument("--nez", type=int, default=80)
    ap.add_argument("--cg-iters", type=int, default=40)
    ap.add_argument("--loop", type=int, default=20,
                    help="fori_loop batch for the small kernels")
    args = ap.parse_args()

    from paropt_tpu.models.fem_topology3d import FEMTopology3D

    t0 = time.time()
    prob = FEMTopology3D(nex=args.nex, ney=args.ney, nez=args.nez,
                         cg_iters=args.cg_iters, solver="mgcg")
    dt = prob._dtype
    print(f"construct {time.time()-t0:.1f}s; elements {prob.ne} dofs "
          f"{prob.ndof} dtype {dt.__name__} mg dims {prob._mg_dims}",
          flush=True)

    x0, _, _ = prob.get_vars_and_bounds()
    xf = prob._filter(x0)
    E = prob.emin + (prob.e0 - prob.emin) * xf ** prob.penal
    K = args.loop

    @jax.jit
    def kmul_k(E, u):
        # dispatch-free: K dependent matvecs
        return jax.lax.fori_loop(
            0, K, lambda i, v: prob._kmul(E, v / (1.0 + i)), u)

    @jax.jit
    def vcycle_k(E, r):
        from paropt_tpu.models.fem_topology3d import _to_grid3
        Eg = E.reshape(prob.nex, prob.ney, prob.nez)
        rg = _to_grid3(r, prob.nex + 1, prob.ney + 1, prob.nez + 1)
        levels, chol = prob._mg_setup(Eg)
        return jax.lax.fori_loop(
            0, K, lambda i, v: prob._mg_vcycle(levels, chol, v / (1.0 + i)),
            rg)

    @jax.jit
    def mg_setup(E):
        levels, chol = prob._mg_setup(
            E.reshape(prob.nex, prob.ney, prob.nez))
        return levels[0][1], chol[0]

    @jax.jit
    def solve(E):
        return prob._cg(E, prob.f)

    @jax.jit
    def objective(x):
        return prob.objective(x)

    @jax.jit
    def grad(x):
        return jax.grad(prob.objective)(x)

    u = jnp.asarray(prob.f, dt)
    timed(f"kmul x{K} (per-call)", kmul_k, E, u, inner=K)
    timed("mg_setup", mg_setup, E)
    timed(f"vcycle x{K} (per-call)", vcycle_k, E, u, inner=K)
    timed(f"mgcg solve (cg={args.cg_iters})", solve, E)
    timed("objective", objective, x0)
    timed("grad(objective)", grad, x0)


if __name__ == "__main__":
    main()
