"""Cart-pole swing-up trajectory optimization (the reference's
`examples/cart_pole/` role): minimum-energy force history driving the pole
from hanging at rest to upright at rest.

    python examples/cart_pole.py [--nsteps 63] [-o traj.png]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
# persistent compile cache (JAX_COMPILATION_CACHE_DIR, else the checkout's
# .jax_cache): repeat runs skip compilation
from paropt_tpu.utils.compile_cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nsteps", type=int, default=63)
    ap.add_argument("--algorithm", default="ip", choices=["ip", "tr", "mma"])
    ap.add_argument("-o", "--output", default=None)
    args = ap.parse_args()

    from paropt_tpu.models.cartpole import CartPole
    from paropt_tpu.optimizer import Optimizer

    prob = CartPole(nsteps=args.nsteps)
    t0 = time.time()
    opt = Optimizer(prob, {
        "algorithm": args.algorithm,
        "output_file": None, "tr_output_file": None,
        "max_major_iters": 500,
        "abs_res_tol": 1e-6,
        "init_barrier_param": 10.0,
        "starting_point_strategy": "least_squares_multipliers",
    })
    res = opt.optimize()
    q = np.asarray(prob.trajectory(res["x"]))
    qf = q[-1]
    print(f"converged={res['converged']} fobj={float(res['fobj']):.6f} "
          f"wall={time.time() - t0:.1f}s")
    print(f"terminal state: x={qf[0]:+.5f} theta={qf[1]:+.5f} "
          f"xdot={qf[2]:+.2e} thetadot={qf[3]:+.2e} "
          f"(target 1, pi, 0, 0)")

    if args.output:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        t = np.asarray(prob.t)
        fig, ax = plt.subplots(3, 1, figsize=(7, 7), sharex=True)
        ax[0].plot(t, q[:, 0], label="x")
        ax[0].plot(t, q[:, 1], label="theta")
        ax[0].axhline(np.pi, color="k", ls=":", lw=0.7)
        ax[0].legend(); ax[0].set_ylabel("position")
        ax[1].plot(t, q[:, 2], label="xdot")
        ax[1].plot(t, q[:, 3], label="thetadot")
        ax[1].legend(); ax[1].set_ylabel("velocity")
        ax[2].step(t[:-1], np.asarray(res["x"]), where="post")
        ax[2].set_ylabel("force u"); ax[2].set_xlabel("t")
        fig.tight_layout()
        fig.savefig(args.output, dpi=130)
        print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
