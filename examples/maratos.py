"""Maratos-effect demo (the role of `examples/maratos_effect/maratos.py`):
Nocedal & Wright example 15.4 — minimize a quadratic on a circle (one
EQUALITY constraint).  Near the solution, full steps along the linearized
constraint increase both the objective and the violation, so a filter (or an
l1 merit) rejects them and convergence crawls — unless the trust-region
second-order correction re-expands the constraint at the trial point.

    python examples/maratos.py [--algorithm ip|tr] [--no-soc] [-o hist.png]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
# persistent compile cache (JAX_COMPILATION_CACHE_DIR, else the checkout's
# .jax_cache): repeat runs skip compilation
from paropt_tpu.utils.compile_cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import numpy as np

from paropt_tpu.models.analytic import Maratos


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--algorithm", default="tr", choices=["ip", "tr"])
    p.add_argument("--no-soc", action="store_true",
                   help="disable the second-order correction (shows the "
                        "Maratos effect: more rejected steps; tr only)")
    p.add_argument("-o", "--output", default=None,
                   help="render the iterate path over a contour plot")
    args = p.parse_args()

    hist = []

    class TrackedMaratos(Maratos):
        def write_output(self, it, x):
            hist.append(np.asarray(x))

    prob = TrackedMaratos()
    prob.check_gradients()

    if args.algorithm == "tr":
        from paropt_tpu.tr import TrustRegion
        tr = TrustRegion(prob, {
            "tr_init_size": 1.0,
            "tr_min_size": 1e-6,
            "tr_max_size": 100.0,
            "tr_eta": 0.25,
            "penalty_gamma": 100.0,
            "tr_adaptive_gamma_update": False,
            "tr_accept_step_strategy": "filter_method",
            "tr_use_soc": not args.no_soc,
            "tr_max_iterations": 100,
            "tr_write_output_frequency": 1,
        })
        res = tr.optimize()
    else:
        if args.no_soc:
            p.error("--no-soc only applies to --algorithm tr (the "
                    "second-order correction is a trust-region device)")
        from paropt_tpu.ip import InteriorPoint
        ip = InteriorPoint(prob, {"abs_res_tol": 1e-8,
                                  "write_output_frequency": 1})
        res = ip.optimize()

    x = np.asarray(res["x"])
    xstar = np.asarray(prob.solution())
    print(f"converged: {res['converged']}  iters: {res['niter']}  "
          f"f* = {res['fobj']:.8f}")
    print(f"x  = {x}")
    print(f"x* = {xstar}  (error {np.linalg.norm(x - xstar):.2e})")

    if args.output:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        g = np.linspace(-2.0, 2.0, 200)
        X, Y = np.meshgrid(g, g)
        F = 2.0 * (X - 0.5) ** 2 + 2.0 * Y ** 2
        fig, ax = plt.subplots()
        ax.contour(X, Y, F, levels=30, linewidths=0.5)
        th = np.linspace(0, 2 * np.pi, 200)
        ax.plot(np.sqrt(2) * np.cos(th), np.sqrt(2) * np.sin(th), "r-",
                label="c(x) = 0")
        if hist:
            h = np.asarray(hist)
            ax.plot(h[:, 0], h[:, 1], "b.-", ms=4, lw=0.8, label="iterates")
        ax.plot(*xstar, "k*", ms=12, label="x*")
        ax.set_aspect("equal", "box")
        ax.legend()
        fig.tight_layout()
        fig.savefig(args.output, dpi=120)
        print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
