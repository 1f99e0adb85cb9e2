"""A/B: k whole IP solves batched via FusedIP.solve_batched vs sequential
jit_loop solves, at a latency-bound single-instance size.

Run on the GPU:  timeout 900 python scripts/bench_batched.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import jax
import jax.numpy as jnp
import numpy as np


def main(n=4096, k=32, tol=1e-4, reps=3):
    from paropt_tpu.models.topology import SyntheticTopology
    from paropt_tpu import ip_fused
    from paropt_tpu.ops import qn as qnmod

    dtype = jnp.float32 if jax.default_backend() != "cpu" else jnp.float64
    prob = SyntheticTopology(n=n, block=8, dtype=dtype)
    model = ip_fused.model_from_problem(prob)
    opts = ip_fused.FusedIPOptions(use_quasi_newton_update=True,
                                   abs_res_tol=tol, max_major_iters=200)
    fused = ip_fused.FusedIP(model, prob.nvars, prob.ncon, prob.nwcon,
                             prob.nwblock, opts, dtype=dtype)
    data, x0 = ip_fused.data_template_from_problem(prob, dtype=dtype)
    qn0 = qnmod.qn_init(10, prob.nvars, dtype=dtype,
                        storage_dtype=qnmod.default_storage_dtype(dtype))

    rng = np.random.default_rng(0)
    x0s = jnp.asarray(x0)[None, :] * jnp.asarray(
        rng.uniform(0.5, 1.5, size=(k, n)), dtype)

    # warm both compilations
    t0 = time.time()
    st_b = jax.block_until_ready(fused.solve_batched(x0s, data, (), qn0))
    print(f"[batched] compile+first: {time.time()-t0:.1f}s "
          f"converged={int(jnp.sum(st_b.converged))}/{k} "
          f"iters(max)={int(jnp.max(st_b.k))}", file=sys.stderr)
    t0 = time.time()
    s0 = jax.block_until_ready(fused.solve(x0s[0], data, (), qn0,
                                           jit_loop=True))
    print(f"[single ] compile+first: {time.time()-t0:.1f}s "
          f"converged={bool(s0.converged)} iters={int(s0.k)}",
          file=sys.stderr)

    for r in range(reps):
        t0 = time.time()
        jax.block_until_ready(fused.solve_batched(x0s, data, (), qn0))
        tb = time.time() - t0
        t0 = time.time()
        for i in range(k):
            jax.block_until_ready(fused.solve(x0s[i], data, (), qn0,
                                              jit_loop=True))
        ts = time.time() - t0
        print(f"rep {r}: batched {tb:.3f}s vs {k} sequential {ts:.3f}s "
              f"-> speedup {ts/tb:.1f}x")


if __name__ == "__main__":
    main()
