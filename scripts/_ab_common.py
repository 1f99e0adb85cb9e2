"""Shared harness for back-to-back A/B scripts (scripts/ab_qn_bf16.py).

Two step variants are built in ONE process and timed in interleaved
windows, so both see the same device and the same neighbours.
Compiled-program cost analysis accompanies the timings as variance-free
evidence — note that closure-captured constants under-count vs
data-as-args.
"""

import time

import jax
import jax.numpy as jnp


def build_step(toggle, variant: bool, n=1 << 20, msub=10, iters=20):
    """Build one fused-IP step variant at the bench operating point.

    ``toggle(variant)`` flips the implementation under test (a module
    global or env var read at trace time) before the variant is traced;
    it may also RETURN a dict of build overrides (currently
    ``qn_storage_dtype``). Returns (run_k, state, step_gb, qn_update_gb,
    iters)."""
    from paropt_tpu import ip_fused
    from paropt_tpu.models.topology import SyntheticTopology
    from paropt_tpu.ops import qn as qnmod

    overrides = toggle(variant) or {}
    dtype = jnp.float32
    prob = SyntheticTopology(n=n, block=8, dtype=dtype)
    model = ip_fused.model_from_problem(prob)
    data, x0 = ip_fused.data_template_from_problem(prob, dtype=dtype)
    qn0 = qnmod.qn_init(msub, prob.nvars, dtype=dtype,
                        storage_dtype=overrides.get("qn_storage_dtype"))
    opts = ip_fused.FusedIPOptions(use_quasi_newton_update=True,
                                   abs_res_tol=1e-6,
                                   iterative_refinement_steps=0)
    fused = ip_fused.FusedIP(model, prob.nvars, prob.ncon, prob.nwcon,
                             prob.nwblock, opts, dtype=dtype)
    st = fused.init(x0, data, (), qn0, None)

    def step(s):
        return fused._step_jit(s, data, (), None)

    @jax.jit
    def run_k(s):
        return jax.lax.fori_loop(0, iters, lambda i, t: step(t), s)

    def cost_gb(jitted, *args):
        ca = jitted.lower(*args).compile().cost_analysis()
        ca = ca[0] if isinstance(ca, (list, tuple)) else ca
        return ca.get("bytes accessed", 0.0) / 1e9

    gb = cost_gb(jax.jit(step), st)

    def upd(state, s_vec, y_vec, acc):
        out, _, _ = qnmod.qn_update(state, s_vec, y_vec, accept=acc)
        return out

    v = jnp.ones(n, dtype)
    gb_upd = cost_gb(jax.jit(upd), qn0, v, v, jnp.asarray(True))

    s = run_k(st)
    jax.block_until_ready(s)
    return run_k, st, gb, gb_upd, iters


def run_ab(label: str, toggle, reps=5):
    """Interleaved A/B of ``toggle(False)`` vs ``toggle(True)`` variants."""
    rk_off, st_off, gb_off, gbu_off, iters = build_step(toggle, False)
    rk_on, st_on, gb_on, gbu_on, _ = build_step(toggle, True)
    print(f"bytes/step: {label} OFF {gb_off:.2f} GB, ON {gb_on:.2f} GB",
          flush=True)
    print(f"bytes qn_update isolated: OFF {gbu_off:.3f} GB, "
          f"ON {gbu_on:.3f} GB", flush=True)
    results = {"off": [], "on": []}
    for rep in range(reps):
        for name, rk, st in (("off", rk_off, st_off), ("on", rk_on, st_on)):
            t0 = time.time()
            out = rk(st)
            jax.block_until_ready(out)
            results[name].append(iters / (time.time() - t0))
    for name, vals in results.items():
        vals.sort()
        print(f"{label} {name:3s}: median {vals[len(vals)//2]:7.1f} it/s "
              f"(min {vals[0]:.1f}, max {vals[-1]:.1f})", flush=True)
    # convergence sanity: both variants reach the same state
    a = rk_off(st_off)
    b = rk_on(st_on)
    print(f"after {iters} steps: res OFF {float(a.res_norm):.3e} / "
          f"ON {float(b.res_norm):.3e}; fobj OFF {float(a.fobj):.6e} / "
          f"ON {float(b.fobj):.6e}", flush=True)
