"""Constrained Rosenbrock with all three algorithms
(the role of `examples/rosenbrock/rosenbrock.py`).

    python examples/rosenbrock.py [--algorithm ip|tr|mma]
"""

import argparse

import numpy as np

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
# persistent compile cache (JAX_COMPILATION_CACHE_DIR, else the checkout's
# .jax_cache): repeat runs skip compilation
from paropt_tpu.utils.compile_cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

from paropt_tpu import Optimizer
from paropt_tpu.models.analytic import Rosenbrock


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--algorithm", default="tr", choices=["ip", "tr", "mma"])
    args = p.parse_args()

    prob = Rosenbrock()
    prob.check_gradients()

    opt = Optimizer(prob, {
        "algorithm": args.algorithm,
        "qn_type": "bfgs",
        "qn_update_type": "damped_update",
        "tr_init_size": 0.5,
        "tr_min_size": 1e-6,
        "tr_max_size": 10.0,
        "tr_eta": 0.1,
        "tr_adaptive_gamma_update": True,
        "tr_max_iterations": 200,
    })
    res = opt.optimize()
    x, z, zw, zl, zu = opt.get_optimized_point()
    print(f"converged: {res['converged']}  f* = {res['fobj']:.8e}")
    print(f"x* = {np.asarray(x)}")


if __name__ == "__main__":
    main()
