"""Capture a jax.profiler trace of fused IP steps (SURVEY.md §5.1: native
per-phase observability — the named_scope phase labels in ip_fused.py show
up as annotations in the trace).

    python scripts/trace_step.py --n 1048576 --steps 10 --out /tmp/trace

View with TensorBoard (`tensorboard --logdir /tmp/trace`) or xprof.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", type=str, default="/tmp/paropt_trace")
    args = ap.parse_args()

    from paropt_tpu import ip_fused
    from paropt_tpu.models.topology import SyntheticTopology
    from paropt_tpu.ops import qn as qnmod

    dtype = jnp.float64 if jax.default_backend() == "cpu" else jnp.float32
    prob = SyntheticTopology(n=args.n, block=8, dtype=dtype)
    model = ip_fused.model_from_problem(prob)
    opts = ip_fused.FusedIPOptions(use_quasi_newton_update=True,
                                   abs_res_tol=1e-6,
                                   iterative_refinement_steps=0)
    fused = ip_fused.FusedIP(model, prob.nvars, prob.ncon, prob.nwcon,
                             prob.nwblock, opts, dtype=dtype)
    data, x0 = ip_fused.data_template_from_problem(prob, dtype=dtype)
    qn0 = qnmod.qn_init(10, prob.nvars, dtype=dtype)
    st = fused.init(x0, data, (), qn0, None)
    st = fused.step(st, data, (), None)  # compile outside the trace
    jax.block_until_ready(st)

    with jax.profiler.trace(args.out):
        for _ in range(args.steps):
            st = fused.step(st, data, (), None)
        jax.block_until_ready(st)
    print(f"trace of {args.steps} steps written to {args.out}")


if __name__ == "__main__":
    main()
