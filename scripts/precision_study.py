"""Empirical study: where does the f32 fused-IP residual floor come from,
and which mixed-precision promotions push it to the reference's 1e-6?

Usage (CPU, honest f32 matmuls):
    JAX_PLATFORMS=cpu python scripts/precision_study.py --n 131072

On the default device (a GPU, where default-precision f32 matmuls may use
TF32):
    timeout 1800 python scripts/precision_study.py --n 1048576

Runs the fused IP at tol=1e-7 for a fixed iteration budget and reports the
minimum residual reached under each configuration.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

parser = argparse.ArgumentParser()
parser.add_argument("--n", type=int, default=1 << 17)
parser.add_argument("--iters", type=int, default=60)
parser.add_argument("--configs", type=str, default="")
parser.add_argument("--solve", action="store_true",
                    help="run full while_loop solves at tol=1e-6 instead of "
                         "fixed-iteration residual floors")
args = parser.parse_args()

os.environ["PAROPT_TPU_NO_X64"] = "1"  # keep f32 the package default

import jax
import jax.numpy as jnp

from paropt_tpu.models.topology import SyntheticTopology
from paropt_tpu import ip_fused
from paropt_tpu.ops import qn as qnmod


def run(dtype, matmul_precision, label, n, iters):
    with jax.default_matmul_precision(matmul_precision):
        prob = SyntheticTopology(n=n, block=8, dtype=dtype)
        model = ip_fused.model_from_problem(prob)
        opts = ip_fused.FusedIPOptions(
            use_quasi_newton_update=True, abs_res_tol=1e-7,
            iterative_refinement_steps=1, max_major_iters=iters)
        fused = ip_fused.FusedIP(model, prob.nvars, prob.ncon, prob.nwcon,
                                 prob.nwblock, opts, dtype=dtype)
        data, x0 = ip_fused.data_template_from_problem(prob, dtype=dtype)
        qn0 = qnmod.qn_init(10, prob.nvars, dtype=dtype)
        state = fused.init(x0, data, (), qn0, None)
        jax.block_until_ready(state)
        t0 = time.time()
        min_res = float("inf")
        hist = []
        for k in range(iters):
            state = fused.step(state, data, (), None)
            res = float(state.res_norm)
            hist.append(res)
            min_res = min(min_res, res)
        dt = time.time() - t0
        tail = " ".join(f"{r:.1e}" for r in hist[-8:])
        print(f"[{label}] n={n} dtype={jnp.dtype(dtype).name} "
              f"mm={matmul_precision}: min_res={min_res:.3e} "
              f"final={hist[-1]:.3e} mu={float(state.mu):.1e} "
              f"({dt:.1f}s)  tail: {tail}", flush=True)
        return min_res


def run_solve(dtype, label, n, tol=1e-6, **opt_kw):
    prob = SyntheticTopology(n=n, block=8, dtype=dtype)
    model = ip_fused.model_from_problem(prob)
    opt_kw.setdefault("iterative_refinement_steps", 1)
    opts = ip_fused.FusedIPOptions(
        use_quasi_newton_update=True, abs_res_tol=tol,
        max_major_iters=100, **opt_kw)
    fused = ip_fused.FusedIP(model, prob.nvars, prob.ncon, prob.nwcon,
                             prob.nwblock, opts, dtype=dtype)
    data, x0 = ip_fused.data_template_from_problem(prob, dtype=dtype)
    qn0 = qnmod.qn_init(10, prob.nvars, dtype=dtype)
    out = fused.solve(x0, data, (), qn0, None, jit_loop=True)
    jax.block_until_ready(out)
    t0 = time.time()
    out = fused.solve(x0, data, (), qn0, None, jit_loop=True)
    jax.block_until_ready(out)
    wall = time.time() - t0
    print(f"[{label}] n={n} tol={tol:.0e}: converged={bool(out.converged)} "
          f"iters={int(out.k)} res={float(out.res_norm):.3e} "
          f"mu={float(out.mu):.2e} wall={wall:.2f}s "
          f"({int(out.k)/max(wall,1e-9):.1f} it/s)", flush=True)
    return out


def main():
    n, iters = args.n, args.iters
    if args.solve:
        run_solve(jnp.float32, "solve-f32-ref1", n,
                  iterative_refinement_steps=1)
        run_solve(jnp.float32, "solve-f32-ref0", n,
                  iterative_refinement_steps=0)
        run_solve(jnp.float32, "solve-f32-ref1b", n,
                  iterative_refinement_steps=1)
        run_solve(jnp.float32, "solve-f32-ref0b", n,
                  iterative_refinement_steps=0)
        return
    todo = args.configs.split(",") if args.configs else [
        "f32_default", "f32_highest", "f64"]
    if "f32_default" in todo:
        run(jnp.float32, "default", "f32/default", n, iters)
    if "f32_highest" in todo:
        run(jnp.float32, "highest", "f32/highest", n, iters)
    if "f64" in todo:
        # x64 disabled -> resolve_dtype would downgrade; re-enable just for
        # the reference leg
        jax.config.update("jax_enable_x64", True)
        run(jnp.float64, "highest", "f64/highest", n, iters)


if __name__ == "__main__":
    main()
