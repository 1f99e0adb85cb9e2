"""Gallery of small 2-D demo problems with search-history contour plots
(the role of `examples/python/examples.py`): five classic nonconvex test
objectives under the shared constraint x0 + x1 >= 0.5, solved from random
starting points with IP or TR, optionally rendering the iterate paths over
a contour carpet.

    python examples/small_problems.py [--algorithm ip|tr] [-o gallery.png]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
# persistent compile cache (JAX_COMPILATION_CACHE_DIR, else the checkout's
# .jax_cache): repeat runs skip compilation
from paropt_tpu.utils.compile_cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import jax.numpy as jnp
import numpy as np

from paropt_tpu import Problem
from paropt_tpu.optimizer import Optimizer

OBJECTIVES = [
    ("convex quadratic",
     lambda x: 2 * x[0] ** 2 + 2 * x[1] ** 2 + x[0] * x[1]),
    ("quartic-quadratic",
     lambda x: x[0] ** 4 + x[1] ** 2 + 2 * x[0] * x[1] - x[0] - x[1]),
    ("double well",
     lambda x: x[0] ** 4 + x[1] ** 4 + 1 - x[0] ** 2 - x[1] ** 2),
    ("sine saddle",
     lambda x: -10 * x[0] ** 2 + 10 * x[1] ** 2 + 4 * jnp.sin(x[0] * x[1])
     - 2 * x[0] + x[0] ** 4),
    ("rosenbrock",
     lambda x: 100 * (x[1] - x[0] ** 2) ** 2 + (1 - x[0]) ** 2),
]


class Demo2D(Problem):
    """min f(x)  s.t.  x0 + x1 - 0.5 >= 0,  x in [-3, 3]^2."""

    def __init__(self, fobj, x0):
        super().__init__(nvars=2, ncon=1)
        self._f = fobj
        self._x0 = jnp.asarray(x0)
        self.x_hist = []

    def objective(self, x):
        return self._f(x)

    def constraints(self, x):
        return jnp.array([x[0] + x[1] - 0.5])

    def get_vars_and_bounds(self):
        return self._x0, jnp.full(2, -3.0), jnp.full(2, 3.0)

    def write_output(self, it, x):
        self.x_hist.append(np.asarray(x))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--algorithm", default="ip", choices=["ip", "tr"])
    ap.add_argument("--starts", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-o", "--output", default=None)
    args = ap.parse_args()

    rng = np.random.default_rng(args.seed)
    results = []
    for name, f in OBJECTIVES:
        runs = []
        for s in range(args.starts):
            x0 = -2.0 + 4.0 * rng.uniform(size=2)
            prob = Demo2D(f, x0)
            opt = Optimizer(prob, {
                "algorithm": args.algorithm, "output_file": None,
                "tr_output_file": None, "abs_res_tol": 1e-7,
                "write_output_frequency": 1,
                "max_major_iters": 300, "tr_max_iterations": 100})
            res = opt.optimize()
            runs.append((x0, np.asarray(res["x"]), prob.x_hist,
                         float(res["fobj"])))
        best = min(r[3] for r in runs)
        print(f"{name:18s}: best f* = {best:12.6f} over {args.starts} starts"
              f"  (x* of best: "
              f"{runs[int(np.argmin([r[3] for r in runs]))][1].round(4)})")
        results.append((name, f, runs))

    if args.output:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, len(results), figsize=(4 * len(results), 4))
        g1, g2 = np.meshgrid(np.linspace(-4, 4, 120),
                             np.linspace(-3, 3, 120))
        for ax, (name, f, runs) in zip(np.atleast_1d(axes), results):
            r = np.asarray(f([jnp.asarray(g1), jnp.asarray(g2)]))
            levels = r.min() + np.linspace(0, 1, 60) ** 2 * (r.max() - r.min())
            ax.contour(g1, g2, r, levels, linewidths=0.5)
            ax.plot([-2.5, 3.0], [3.0, -2.5], "-k", lw=0.8)  # constraint
            for x0, xs, hist, _ in runs:
                h = np.array(hist) if hist else np.array([x0, xs])
                ax.plot(h[:, 0], h[:, 1], "-o", ms=2, lw=0.8)
                ax.plot([xs[0]], [xs[1]], "r*", ms=8)
            ax.set_title(name, fontsize=9)
            ax.set_xlim(-4, 4)
            ax.set_ylim(-3, 3)
        fig.tight_layout()
        fig.savefig(args.output, dpi=120)
        print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
