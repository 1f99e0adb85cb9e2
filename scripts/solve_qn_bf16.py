"""Whole-solve convergence check at the bench operating point (1M vars,
tol=1e-6, f32, refinement off) with bf16 vs native QN storage: both must
converge, with comparable iteration counts, for the bf16 default to be
admissible."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from paropt_tpu import ip_fused
from paropt_tpu.models.topology import SyntheticTopology
from paropt_tpu.ops import qn as qnmod


def run(n=1 << 20, tol=1e-6):
    dtype = jnp.float32
    prob = SyntheticTopology(n=n, block=8, dtype=dtype)
    model = ip_fused.model_from_problem(prob)
    opts = ip_fused.FusedIPOptions(use_quasi_newton_update=True,
                                   abs_res_tol=tol, max_major_iters=100,
                                   iterative_refinement_steps=0)
    fused = ip_fused.FusedIP(model, prob.nvars, prob.ncon, prob.nwcon,
                             prob.nwblock, opts, dtype=dtype)
    data, x0 = ip_fused.data_template_from_problem(prob, dtype=dtype)
    for name, storage in (("f32", None), ("bf16", jnp.bfloat16)):
        qn0 = qnmod.qn_init(10, prob.nvars, dtype=dtype,
                            storage_dtype=storage)
        out = fused.solve(x0, data, (), qn0, None, jit_loop=True)
        jax.block_until_ready(out)
        t0 = time.time()
        out = fused.solve(x0, data, (), qn0, None, jit_loop=True)
        jax.block_until_ready(out)
        wall = time.time() - t0
        print(f"[{name}] n={n} tol={tol:.0e}: "
              f"converged={bool(out.converged)} iters={int(out.k)} "
              f"res={float(out.res_norm):.3e} fobj={float(out.fobj):.6e} "
              f"wall={wall:.2f}s ({int(out.k)/max(wall,1e-9):.1f} it/s)",
              flush=True)


if __name__ == "__main__":
    run()
