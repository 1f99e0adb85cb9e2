"""Host-loop framework overhead with a pure-numpy callback problem — the
reference's primary usage mode (user physics outside the framework; the
optimizer must add as little per-iteration latency as possible, SURVEY §3.3).

Measures: wall-clock per major iteration of `InteriorPoint.optimize()` minus
the time spent inside the user's own eval callbacks = the framework's
per-iteration overhead (jitted kernel dispatches + host bookkeeping).

    JAX_PLATFORMS=cpu python scripts/bench_callback_overhead.py --n 65536
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 16)
    ap.add_argument("--ncon", type=int, default=2)
    ap.add_argument("--iters", type=int, default=60)
    args = ap.parse_args()

    import jax

    if jax.default_backend() == "cpu":
        jax.config.update("jax_enable_x64", True)

    from paropt_tpu import InteriorPoint
    from paropt_tpu.problem import Problem

    n, m = args.n, args.ncon
    rng = np.random.default_rng(0)

    class NumpyQP(Problem):
        """Separable convex QP evaluated entirely in numpy on the host —
        the framework sees only callback results (reference usage, where
        the physics is an external solver)."""

        def __init__(self):
            super().__init__(nvars=n, ncon=m)
            self.d = 0.5 + rng.random(n)           # diagonal Hessian
            self.b = rng.random(n)
            self.Am = rng.random((m, n)) / n
            self.eval_time = 0.0
            self.neval = 0
            self.ngeval = 0

        def get_vars_and_bounds(self):
            return (0.5 * np.ones(n), np.zeros(n), 10.0 * np.ones(n))

        def eval_obj_con(self, x):
            t0 = time.perf_counter()
            x = np.asarray(x)
            f = 0.5 * float(x @ (self.d * x)) - float(self.b @ x)
            c = self.Am @ x - 0.1
            self.neval += 1
            self.eval_time += time.perf_counter() - t0
            return f, c

        def eval_obj_con_gradient(self, x):
            t0 = time.perf_counter()
            x = np.asarray(x)
            g = self.d * x - self.b
            self.ngeval += 1
            self.eval_time += time.perf_counter() - t0
            return g, self.Am

    prob = NumpyQP()
    ip = InteriorPoint(prob, {"output_file": None, "abs_res_tol": 1e-10,
                              "max_major_iters": args.iters})
    # warm-up solve: compile every jitted kernel once
    ip.optimize()

    prob2 = NumpyQP()
    ip2 = InteriorPoint(prob2, {"output_file": None, "abs_res_tol": 1e-10,
                                "max_major_iters": args.iters})
    t0 = time.perf_counter()
    res = ip2.optimize()
    wall = time.perf_counter() - t0
    iters = max(res["niter"], 1)
    overhead = (wall - prob2.eval_time) / iters

    print(f"n={n} ncon={m} iters={iters} converged={res['converged']} "
          f"res={res['res_norm']:.2e}")
    print(f"wall={wall:.3f}s  user-eval time={prob2.eval_time:.3f}s "
          f"({prob2.neval} evals, {prob2.ngeval} grads)")
    print(f"host-loop cost: {overhead * 1e3:.2f} ms/major-iteration "
          f"excluding user evals (total {(wall - prob2.eval_time):.3f}s)")

    # Reference point: the same per-iteration numerical work as ONE fused
    # XLA computation (jax-native twin problem, fori_loop-batched steps).
    # host-loop-minus-fused = the host loop's dispatch + bookkeeping
    # overhead; the rest is the KKT kernels themselves.
    import jax.numpy as jnp
    from paropt_tpu import ip_fused
    from paropt_tpu.problem import Problem as JProblem

    class JaxQP(JProblem):
        def __init__(self):
            super().__init__(nvars=n, ncon=m)
            self.d = jnp.asarray(prob.d)
            self.b = jnp.asarray(prob.b)
            self.Am = jnp.asarray(prob.Am)

        def get_vars_and_bounds(self):
            return (0.5 * jnp.ones(n), jnp.zeros(n), 10.0 * jnp.ones(n))

        def objective(self, x):
            return 0.5 * x @ (self.d * x) - self.b @ x

        def constraints(self, x):
            return self.Am @ x - 0.1

    jprob = JaxQP()
    model = ip_fused.model_from_problem(jprob)
    # SAME numerical work as the host loop: in-loop L-BFGS updates at the
    # default subspace size (the host loop runs the full QN machinery)
    from paropt_tpu.ops import qn as qnmod
    fused = ip_fused.FusedIP(model, n, m, 0, 1,
                             ip_fused.FusedIPOptions(
                                 max_major_iters=args.iters,
                                 use_quasi_newton_update=True))
    data, x0 = ip_fused.data_template_from_problem(jprob)
    qn0 = qnmod.qn_init(10, n)
    st = fused.init(x0, data, (), qn0, None)
    st = fused.step(st, data, (), None)          # compile
    jax.block_until_ready(st)
    k = 20

    @jax.jit
    def run_k(s):
        return jax.lax.fori_loop(
            0, k, lambda i, ss: fused._step_jit(ss, data, (), None), s)

    st = run_k(st)                                # compile
    jax.block_until_ready(st)
    t0 = time.perf_counter()
    st = run_k(st)
    jax.block_until_ready(st)
    fused_ms = (time.perf_counter() - t0) / k * 1e3
    print(f"fused-IP reference: {fused_ms:.2f} ms/major-iteration "
          f"(same n, jax-native, fori_loop-batched)")
    print(f"host-loop dispatch+bookkeeping overhead: "
          f"{overhead * 1e3 - fused_ms:.2f} ms/major-iteration")


if __name__ == "__main__":
    main()
