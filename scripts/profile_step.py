"""Per-phase bytes and time of the fused IP step.

Two variance-free measurements per step variant:

1. **Compiled-program cost analysis** — XLA's own 'bytes accessed' and flop
   counts for the whole compiled step.  Diffing variants (full vs
   no-refinement vs no-line-search vs no-QN) attributes bytes to phases
   without any timing, dispatch floors, or multiply-counted while_loop
   bodies (the round-1 attribution bug: summing isolated-kernel timings
   re-counted the line-search body).
2. **In-loop timing** — K steps fused into one device computation via
   lax.fori_loop, so host dispatch latency is excluded.

Prints GB/step and ms/step per variant; it divides by no peak rate.

Run on the GPU:  timeout 1800 python scripts/profile_step.py
Run on CPU:      JAX_PLATFORMS=cpu python scripts/profile_step.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time
from functools import partial

import jax
import jax.numpy as jnp

from paropt_tpu import ip_fused
from paropt_tpu.models.topology import SyntheticTopology
from paropt_tpu.ops import qn as qnmod

def cost_of(jitted, *args):
    """(bytes_accessed_GB, flops_G) from the compiled program."""
    ca = jitted.lower(*args).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    return ca.get("bytes accessed", 0.0) / 1e9, ca.get("flops", 0.0) / 1e9


def inloop_ms(step_fn, state, iters=20, reps=3):
    """Median per-step ms over `reps` windows of `iters` fused steps."""
    @jax.jit
    def run_k(s):
        return jax.lax.fori_loop(0, iters, lambda i, t: step_fn(t), s)

    s = run_k(state)
    jax.block_until_ready(s)
    times = []
    for _ in range(reps):
        t0 = time.time()
        s = run_k(state)
        jax.block_until_ready(s)
        times.append((time.time() - t0) / iters * 1e3)
    times.sort()
    return times[len(times) // 2]


def main():
    on_cpu = jax.default_backend() == "cpu"
    n = 1 << 17 if on_cpu else 1 << 20
    dtype = jnp.float64 if on_cpu else jnp.float32
    msub = 10
    prob = SyntheticTopology(n=n, block=8, dtype=dtype)
    model = ip_fused.model_from_problem(prob)
    data, x0 = ip_fused.data_template_from_problem(prob, dtype=dtype)
    qn0 = qnmod.qn_init(msub, prob.nvars, dtype=dtype,
                    storage_dtype=qnmod.default_storage_dtype(dtype))
    print(f"backend={jax.default_backend()} n={n} msub={msub} "
          f"dtype={jnp.dtype(dtype).name}", flush=True)

    base = dict(use_quasi_newton_update=True, abs_res_tol=1e-6)
    variants = [
        ("full step", ip_fused.FusedIPOptions(**base)),
        ("no refinement", ip_fused.FusedIPOptions(
            **base, iterative_refinement_steps=0)),
        ("1 line-search iter", ip_fused.FusedIPOptions(
            **base, max_line_iters=1)),
        ("no line search", ip_fused.FusedIPOptions(
            **base, use_line_search=False)),
        ("no qn update (fixed B)", ip_fused.FusedIPOptions(
            abs_res_tol=1e-6, use_quasi_newton_update=False)),
        ("slm (B = I only)", ip_fused.FusedIPOptions(
            abs_res_tol=1e-6, sequential_linear_method=True)),
    ]

    rows = []
    state0 = None
    for label, opts in variants:
        fused = ip_fused.FusedIP(model, prob.nvars, prob.ncon, prob.nwcon,
                                 prob.nwblock, opts, dtype=dtype)
        st = fused.init(x0, data, (), qn0, None)
        if state0 is None:
            state0 = st
        step = lambda s, _f=fused: _f._step_jit(s, data, (), None)
        gb, gflop = cost_of(jax.jit(step), st)
        ms = inloop_ms(step, st)
        rows.append((label, gb, gflop, ms))

    full_gb = rows[0][1]
    full_ms = rows[0][3]
    print(f"\n{'variant':28s} {'GB/step':>8s} {'Gflop':>7s} {'ms':>7s} "
          f"{'dGB vs full':>11s}")
    for label, gb, gflop, ms in rows:
        print(f"{label:28s} {gb:8.2f} {gflop:7.1f} {ms:7.2f} "
              f"{full_gb - gb:11.2f}", flush=True)
    print(f"\nfull step: {full_gb:.2f} GB, {full_ms:.2f} ms", flush=True)


def kernels():
    """Exact bytes-accessed of the QN-related sub-kernels (cost analysis of
    each compiled kernel; no timing, no dispatch floors)."""
    from paropt_tpu.ops import kkt
    on_cpu = jax.default_backend() == "cpu"
    n = 1 << 17 if on_cpu else 1 << 20
    dtype = jnp.float64 if on_cpu else jnp.float32
    msub = 10
    prob = SyntheticTopology(n=n, block=8, dtype=dtype)
    model = ip_fused.model_from_problem(prob)
    data, x0 = ip_fused.data_template_from_problem(prob, dtype=dtype)
    qn0 = qnmod.qn_init(msub, prob.nvars, dtype=dtype,
                    storage_dtype=qnmod.default_storage_dtype(dtype))
    opts = ip_fused.FusedIPOptions(use_quasi_newton_update=True,
                                   abs_res_tol=1e-6)
    fused = ip_fused.FusedIP(model, prob.nvars, prob.ncon, prob.nwcon,
                             prob.nwblock, opts, dtype=dtype)
    st = fused.init(x0, data, (), qn0, None)
    v = st.vars
    d = ip_fused._refresh_data(data, st.g, st.A, st.c, st.cw)
    cq = qnmod.qn_compact(st.qn)
    mu = st.mu
    r = kkt.kkt_residual(v, d, mu, 1.0)
    f = kkt.setup_kkt_factor(v, d, qn_compact=cq)
    p = kkt.solve_kkt(v, d, f, r)

    probes = [
        ("qn_update", jax.jit(lambda q, s, y: qnmod.qn_update(q, s, y)),
         (st.qn, 0.01 * p.x, 0.02 * p.x)),
        ("qn_compact", jax.jit(qnmod.qn_compact), (st.qn,)),
        # qn_compact passed as DATA (closure-captured constants distort
        # the byte attribution, CLAUDE.md)
        ("factor WITH qn", jax.jit(
            lambda v_, d_, cq_: kkt.setup_kkt_factor(v_, d_, qn_compact=cq_)),
         (v, d, cq)),
        ("factor no qn", jax.jit(
            lambda v_, d_, b0_: kkt.setup_kkt_factor(
                v_, d_, qn_compact=(b0_, None, None))), (v, d, cq[0])),
        ("solve_kkt WITH smw", jax.jit(
            lambda v_, d_, f_, r_: kkt.solve_kkt(v_, d_, f_, r_)),
         (v, d, f, r)),
        ("solve_kkt no smw", jax.jit(
            lambda v_, d_, r_, b0_: kkt.solve_kkt(
                v_, d_, kkt.setup_kkt_factor(
                    v_, d_, qn_compact=(b0_, None, None)), r_)),
         (v, d, r, cq[0])),
        ("kkt_residual", jax.jit(
            lambda v_, d_: kkt.kkt_residual(v_, d_, mu, 1.0)), (v, d)),
        ("apply_kkt (refinement op)", jax.jit(
            lambda v_, d_, p_, cq_: kkt.apply_kkt_matrix(v_, d_, p_, cq_)),
         (v, d, p, cq)),
    ]
    print(f"--- kernel bytes (n={n}, msub={msub}; [2m,n] array = "
          f"{2 * msub * n * jnp.dtype(dtype).itemsize / 1e9:.3f} GB)")
    for label, jitted, args in probes:
        gb, gflop = cost_of(jitted, *args)
        print(f"{label:28s} {gb:8.3f} GB {gflop:8.2f} Gflop", flush=True)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", action="store_true")
    a = ap.parse_args()
    if a.kernels:
        kernels()
    else:
        main()
