"""Large-scale synthetic topology optimization with the fused interior point
(the role of `examples/topology_optimization/`): 1M+ design variables,
one dense volume constraint, per-block sparse weighting constraints, the
whole solve as jitted XLA computations over a (shardable) design axis.

    python examples/topology.py [--n 1048576] [--jit-loop]
"""

import argparse
import time

import jax
import jax.numpy as jnp

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
# persistent compile cache (JAX_COMPILATION_CACHE_DIR, else the checkout's
# .jax_cache): repeat runs skip compilation
from paropt_tpu.utils.compile_cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

from paropt_tpu import ip_fused
from paropt_tpu.models.topology import SyntheticTopology
from paropt_tpu.ops import qn as qnmod


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=1 << 17)
    p.add_argument("--jit-loop", action="store_true",
                   help="run the whole solve as one lax.while_loop")
    args = p.parse_args()

    dtype = jnp.float64 if jax.default_backend() == "cpu" else jnp.float32
    prob = SyntheticTopology(n=args.n, block=8, dtype=dtype)
    model = ip_fused.model_from_problem(prob)
    opts = ip_fused.FusedIPOptions(
        use_quasi_newton_update=True,
        abs_res_tol=1e-5 if dtype == jnp.float32 else 1e-6,
        max_major_iters=300)
    fused = ip_fused.FusedIP(model, prob.nvars, prob.ncon, prob.nwcon,
                             prob.nwblock, opts, dtype=dtype)
    data, x0 = ip_fused.data_template_from_problem(prob, dtype=dtype)
    qn0 = qnmod.qn_init(10, prob.nvars, dtype=dtype)

    t0 = time.time()
    out = fused.solve(x0, data, (), qn0, None, jit_loop=args.jit_loop)
    jax.block_until_ready(out)
    dt = time.time() - t0
    print(f"n={args.n}  converged={bool(out.converged)}  "
          f"iters={int(out.k)}  f*={float(out.fobj):.6e}")
    print(f"res={float(out.res_norm):.3e}  mu={float(out.mu):.3e}  "
          f"wall={dt:.2f}s  ({int(out.k) / max(dt, 1e-9):.1f} it/s "
          f"incl. compile)")
    print(f"volume constraint: {float(out.c[0]):.6e} (>= 0)")


if __name__ == "__main__":
    main()
