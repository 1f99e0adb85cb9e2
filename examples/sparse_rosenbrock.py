"""Rosenbrock with a sparse weighting constraint
(the role of `examples/sparse/sparse_rosenbrock.py`)."""

import numpy as np

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
# persistent compile cache (JAX_COMPILATION_CACHE_DIR, else the checkout's
# .jax_cache): repeat runs skip compilation
from paropt_tpu.utils.compile_cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

from paropt_tpu import InteriorPoint
from paropt_tpu.models.analytic import SparseRosenbrock


def main():
    prob = SparseRosenbrock()
    prob.check_gradients()
    ip = InteriorPoint(prob, {"abs_res_tol": 1e-7, "output_file": "-"})
    res = ip.optimize()
    print(f"\nconverged: {res['converged']}  f* = {res['fobj']:.8e}")
    print(f"x* = {np.asarray(res['x'])}")


if __name__ == "__main__":
    main()
