"""Smoke run of the fused solvers on one NVIDIA GPU, through the public API.

    python chip_smoke.py              # every one-card phase
    python chip_smoke.py --chips 4    # only the sharded path over 4 cards

One process drives the card.  Each phase solves a deployment-sized problem
on the card and compares the answer with the same solve on the host CPU in
this process (or, for the sharded path, with the same solve on card 0
alone, compiled and run in a second thread alongside the sharded solve).
It prints the card (``nvidia-smi`` name and power limit, JAX's
``device_kind``), the JAX version and, per phase, iterations, final residual
or objective, solve wall time with compilation reported apart, and the
card's peak bytes in use.  The last line of standard output is one JSON
object, printed only when every phase passed:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Without a GPU (JAX's first device is not a ``gpu``) it prints no result and
exits non-zero; it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# The host CPU backend carries the in-process reference solves: keep it
# available even when JAX_PLATFORMS names only the GPU platform.
_PLATFORMS = os.environ.get("JAX_PLATFORMS", "")
if _PLATFORMS and "cpu" not in _PLATFORMS.split(","):
    os.environ["JAX_PLATFORMS"] = _PLATFORMS + ",cpu"
# One process drives each card; on the four-card path card 0 holds the
# sharded solve's shard and the one-card reference at once (~14 + ~42 GB
# at n=2^25 f64), more than JAX's default 75 % reservation leaves room for.
os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.9")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

# Full single-card sizes (the deployment widths of the README's workloads).
IP_N = 1 << 20
IP_SCALE_N = 1 << 24
IP_SHARDED_N = 1 << 25
MMA3D_SMALL = (32, 16, 16)
MMA3D_LARGE = (160, 80, 80)      # 1,024,000 voxels, 3.17M dofs
TR2D = (48, 24)
EIGTR = (24, 12)


class PhaseFailure(AssertionError):
    """A phase's result disagrees with its reference or its own checks."""


def _timed(fn, repeat=True, wait=None):
    """-> (result, execute seconds, compile seconds).  The first call pays
    compilation; with ``repeat`` a second call of the compiled program
    gives the execute time, and compile is the first call's excess (else
    the one call's wall time is returned as execute, compile unknown).
    ``wait()``, if given, runs between the two calls (a concurrent
    reference finishing, so the timed call has the cards to itself)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    if not repeat:
        return out, first, None
    if wait is not None:
        wait()
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    again = time.perf_counter() - t0
    return out, again, first - again


def _peak_bytes(dev):
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _check(cond, msg):
    if not cond:
        raise PhaseFailure(msg)


def _close(a, b, rtol, what):
    _check(abs(a - b) <= rtol * max(abs(b), 1e-300),
           f"{what}: {a!r} vs reference {b!r} (rtol {rtol:g})")


def _fmt(fields):
    return " ".join(f"{k}={v}" for k, v in fields.items())


def _report(log, phase, dev, **fields):
    log(f"[{phase}] {_fmt(fields)} peak_bytes_in_use={_peak_bytes(dev)}")


# ---------------------------------------------------------------------------
# fused interior point on the synthetic topology problem
# ---------------------------------------------------------------------------


def _ip_solve(dev, n, dtype, storage_dtype=None, tol=1e-6, refine=1,
              msub=10, place=None, repeat=True, wait=None):
    """FusedIP whole solve (one `lax.while_loop`) built and run on ``dev``.
    ``place(tree)`` optionally re-places the inputs (a sharded mesh).
    Returns (state, execute s, compile s, problem)."""
    from paropt_tpu import ip_fused
    from paropt_tpu.models.topology import SyntheticTopology
    from paropt_tpu.ops import qn as qnmod

    with jax.default_device(dev):
        prob = SyntheticTopology(n=n, block=8, dtype=dtype)
        model = ip_fused.model_from_problem(prob)
        opts = ip_fused.FusedIPOptions(use_quasi_newton_update=True,
                                       abs_res_tol=tol,
                                       iterative_refinement_steps=refine)
        fused = ip_fused.FusedIP(model, prob.nvars, prob.ncon, prob.nwcon,
                                 prob.nwblock, opts, dtype=dtype)
        data, x0 = ip_fused.data_template_from_problem(prob, dtype=dtype)
        qn0 = qnmod.qn_init(msub, prob.nvars, dtype=dtype,
                            storage_dtype=storage_dtype)
        if place is not None:
            x0, data, qn0 = place((x0, data, qn0))
        out, ex, comp = _timed(lambda: fused.solve(x0, data, (), qn0, None,
                                                   jit_loop=True),
                               repeat, wait)
    return out, ex, comp, prob


def _times(ex, comp):
    if comp is None:
        return dict(wall_s=f"{ex:.3f}")
    return dict(solve_s=f"{ex:.4f}", compile_s=f"{comp:.1f}")


def _ip_fields(out, ex, comp):
    return dict(iters=int(out.k), converged=bool(out.converged),
                res=f"{float(out.res_norm):.3e}",
                fobj=f"{float(out.fobj):.12e}", **_times(ex, comp))


def phase_ip_f64(dev, ref_dev, log, n=IP_N):
    """f64 whole solve vs the same solve on the host CPU: both converge,
    iterations within 1, objective to rtol 1e-9 (the two backends sum in
    different orders; f64 leaves ~1e-12 of that in fobj)."""
    out, ex, comp, _ = _ip_solve(dev, n, jnp.float64)
    _report(log, "ip-f64", dev, n=n, **_ip_fields(out, ex, comp))
    ref, rex, rcomp, _ = _ip_solve(ref_dev, n, jnp.float64, repeat=False)
    log(f"[ip-f64] reference on {ref_dev.platform}: "
        + _fmt(_ip_fields(ref, rex, rcomp)))
    _check(bool(out.converged) and bool(ref.converged),
           "ip-f64: a solve did not converge")
    _check(abs(int(out.k) - int(ref.k)) <= 1,
           f"ip-f64: {int(out.k)} iterations vs {int(ref.k)} on the host")
    _close(float(out.fobj), float(ref.fobj), 1e-9, "ip-f64 fobj")
    return float(out.fobj)


def _qn_gram_offdiag(dev, n, updates=4, msub=10):
    """Off-diagonal Gram entries (s_i.s_j, s_i.y_j, i != j) of an f32
    quasi-Newton state after ``updates`` seeded updates, all on ``dev``."""
    from paropt_tpu.ops import qn as qnmod

    rng = np.random.default_rng(1)
    with jax.default_device(dev):
        st = qnmod.qn_init(msub, n, dtype=jnp.float32)
        for _ in range(updates):
            s = rng.standard_normal(n)
            y = s + 0.5 * rng.standard_normal(n)   # y.s > 0: never skipped
            st = qnmod.qn_update(st, jnp.asarray(s, jnp.float32),
                                 jnp.asarray(y, jnp.float32))[0]
        ss, sy = (np.asarray(g, np.float64)[-updates:, -updates:]
                  for g in (st.SS, st.SY))
    off = ~np.eye(updates, dtype=bool)
    return np.concatenate([ss[off], sy[off]])


def _f32_product_error(dev, ref_dev, n):
    """Largest card-vs-host gap of the f32 quasi-Newton Gram products,
    relative to their RMS.  The off-diagonal entries are sums of n terms
    of both signs, so rounding the operands to TF32's 10-bit mantissa
    moves them by 7.1e-4 of that RMS at n=2^20, while full f32 is 2.0e-6
    off the exact sums (both on the host, against f64).  On the H100 the
    gap is 3.8e-6 with the products pinned and 6.9e-4 without."""
    card = _qn_gram_offdiag(dev, n)
    host = _qn_gram_offdiag(ref_dev, n)
    return float(np.max(np.abs(card - host)) / np.sqrt(np.mean(host ** 2)))


def phase_ip_f32(dev, ref_dev, log, fobj_f64, n=IP_N, tol=1e-6, rtol=5e-3,
                 max_product_err=1e-4):
    """The f32 configuration (bf16 ring buffer, no refinement).

    The solve converges below ``tol``, stays volume- and block-feasible
    and lands within ``rtol`` 5e-3 of the f64 objective.  That band is the
    spread of the stopping points, not of the optimum: the objective is
    convex, but at tol 1e-6 the infinity-norm residual test (gradient
    entries of order 1/n) fires while f is still 0.5-0.7 % above its
    minimum (2.40513 at n=2^20, reached only at tol 1e-9), so f64 and f32
    stop at different points of one descent — 2.422304 and 2.417786 on
    the H100 (1.9e-3 apart), 2.412295 unpinned (4.1e-3).  Matmul precision
    is checked directly instead: the f32 quasi-Newton Gram products on the
    card must match the host's to ``max_product_err`` (TF32 gives ~7e-4)."""
    out, ex, comp, prob = _ip_solve(dev, n, jnp.float32, tol=tol,
                                    storage_dtype=jnp.bfloat16, refine=0)
    x = np.asarray(out.vars.x, np.float64)
    vol = float(np.mean(x))
    cap = float(np.max(x.reshape(prob.block, -1).mean(axis=0)))
    err = _f32_product_error(dev, ref_dev, n)
    _report(log, "ip-f32", dev, n=n, **_ip_fields(out, ex, comp),
            volume=f"{vol:.9f}", max_block_mean=f"{cap:.6f}",
            gram_err=f"{err:.2e}")
    _check(bool(out.converged), "ip-f32: did not converge")
    _check(float(out.res_norm) < tol,
           f"ip-f32: final residual {float(out.res_norm):.3e} >= {tol}")
    _check(vol <= prob.volume_fraction + tol,
           f"ip-f32: volume {vol:.9f} > {prob.volume_fraction}")
    _check(cap <= prob.block_cap + tol,
           f"ip-f32: block mean {cap:.9f} > {prob.block_cap}")
    _check(err <= max_product_err,
           f"ip-f32: f32 Gram products off the host's by {err:.2e} "
           f"(> {max_product_err:g}: reduced-precision matmuls)")
    _close(float(out.fobj), fobj_f64, rtol, "ip-f32 fobj vs ip-f64")


def phase_ip_scale(dev, log, n=IP_SCALE_N, tol=1e-6):
    """The deployment size in f64: converges below the tolerance."""
    out, ex, comp, _ = _ip_solve(dev, n, jnp.float64, tol=tol)
    _report(log, "ip-scale", dev, n=n, **_ip_fields(out, ex, comp))
    _check(bool(out.converged), "ip-scale: did not converge")
    _check(float(out.res_norm) < tol,
           f"ip-scale: final residual {float(out.res_norm):.3e} >= {tol}")


# ---------------------------------------------------------------------------
# fused MMA on the 3-D voxel cantilever
# ---------------------------------------------------------------------------


def _mma3d_solve(dev, shape, iters, place=None, repeat=True, wait=None):
    from paropt_tpu.mma import FusedMMA
    from paropt_tpu.models.fem_topology3d import FEMTopology3D

    with jax.default_device(dev):
        prob = FEMTopology3D(*shape, cg_iters=25, solver="mgcg",
                             dtype=jnp.float64)
        solver = FusedMMA(prob, {"mma_max_iterations": iters,
                                 "mma_output_file": None,
                                 "dtype": "float64"})
        state0 = None if place is None else place(solver._state0)
        (res, state), ex, comp = _timed(lambda: solver.solve(state0),
                                        repeat, wait)
    return res, state, ex, comp, prob


def _outer_fields(res, ex, comp):
    """Report fields of an MMA/TR/eigen-TR result dict."""
    return dict(iters=res["niter"], fobj=f"{res['fobj']:.12e}",
                infeas=f"{res['infeas']:.3e}", **_times(ex, comp))


def phase_mma3d(dev, ref_dev, log, small=MMA3D_SMALL, large=MMA3D_LARGE,
                small_iters=10, large_iters=5):
    """Small mesh vs the host CPU (objective rtol 1e-6: 25 multigrid-CG
    iterations per state solve leave ~1e-9 of backend-dependent rounding in
    the compliance, amplified over the outer iterations); the 1M-voxel mesh
    stays finite, volume-feasible and lowers the objective."""
    res, _, ex, comp, _ = _mma3d_solve(dev, small, small_iters)
    _report(log, "mma-3d", dev, mesh="x".join(map(str, small)),
            **_outer_fields(res, ex, comp))
    ref, _, rex, rcomp, _ = _mma3d_solve(ref_dev, small, small_iters,
                                         repeat=False)
    log(f"[mma-3d] reference on {ref_dev.platform}: "
        + _fmt(_outer_fields(ref, rex, rcomp)))
    _check(res["niter"] == ref["niter"],
           f"mma-3d: {res['niter']} iterations vs {ref['niter']} on the host")
    _close(res["fobj"], ref["fobj"], 1e-6, "mma-3d fobj")

    res, _, ex, comp, prob = _mma3d_solve(dev, large, large_iters)
    # the model scales the compliance so that the objective at the
    # uniform starting design is exactly 1
    f0 = 1.0
    _report(log, "mma-3d", dev, mesh="x".join(map(str, large)),
            ndof=prob.ndof, **_outer_fields(res, ex, comp))
    x = np.asarray(res["x"])
    _check(np.all(np.isfinite(x)) and np.isfinite(res["fobj"]),
           "mma-3d large: non-finite design or objective")
    # volume constraint c = vf - mean(x) >= 0, to the MMA subproblem's
    # feasibility tolerance
    _check(float(np.mean(x)) <= prob.volume_fraction + 1e-6,
           f"mma-3d large: volume {float(np.mean(x)):.8f} > "
           f"{prob.volume_fraction}")
    _check(res["fobj"] < f0,
           f"mma-3d large: objective {res['fobj']:.6e} did not fall "
           f"below {f0:.6e}")


# ---------------------------------------------------------------------------
# fused trust region (2-D SIMP) and fused eigen trust region (frequency)
# ---------------------------------------------------------------------------

# settings of the trust-region and eigen-TR workloads in bench.py
TR_OPTS = {"tr_output_file": None, "output_file": None,
           "tr_max_iterations": 20, "abs_res_tol": 1e-6,
           "tr_infeas_tol": 1e-5, "tr_l1_tol": 0.0, "tr_linfty_tol": 1e-5,
           "dtype": "float64"}
EIGTR_OPTS = {"tr_output_file": None, "output_file": None,
              "tr_max_iterations": 20, "tr_init_size": 0.05,
              "tr_max_size": 0.2, "tr_min_size": 1e-6, "abs_res_tol": 1e-8,
              "tr_l1_tol": 1e-4, "tr_linfty_tol": 1e-4,
              "tr_adaptive_gamma_update": True, "penalty_gamma": 10.0,
              "dtype": "float64"}


def _tr_solve(dev, shape, iters, repeat=True):
    from paropt_tpu.models.fem_topology import FEMTopology
    from paropt_tpu.tr import FusedTR

    with jax.default_device(dev):
        fem = FEMTopology(*shape, cg_iters=25, solver="mgcg",
                          dtype=jnp.float64)
        tr = FusedTR(fem, dict(TR_OPTS, tr_max_iterations=iters))
        (res, _), ex, comp = _timed(tr.solve, repeat)
    return res, ex, comp


def _eigtr_solve(dev, shape, iters, N, repeat=True):
    from paropt_tpu.models.fem_frequency import FrequencyTopology

    with jax.default_device(dev):
        freq = FrequencyTopology(*shape, N=N, cg_iters=25, solver="mgcg",
                                 lobpcg_iters=50, dtype=jnp.float64)
        ftr = freq.build_fused_tr(dict(EIGTR_OPTS, tr_max_iterations=iters))
        (res, _), ex, comp = _timed(ftr.solve, repeat)
    return res, ex, comp


def _compare_tr(name, dev, ref_dev, log, run, max_infeas, rtol=1e-6):
    res, ex, comp = run(dev, True)
    _report(log, name, dev, **_outer_fields(res, ex, comp))
    ref, rex, rcomp = run(ref_dev, False)
    log(f"[{name}] reference on {ref_dev.platform}: "
        + _fmt(_outer_fields(ref, rex, rcomp)))
    _check(np.isfinite(res["fobj"]), f"{name}: non-finite objective")
    _close(res["fobj"], ref["fobj"], rtol, f"{name} fobj")
    _check(abs(res["infeas"] - ref["infeas"])
           <= 1e-3 * abs(ref["infeas"]) + 1e-9,
           f"{name}: infeasibility {res['infeas']:.6e} vs reference "
           f"{ref['infeas']:.6e}")
    _check(res["infeas"] < max_infeas,
           f"{name}: infeasibility {res['infeas']:.3e} >= {max_infeas:g}")


def phase_tr2d(dev, ref_dev, log, shape=TR2D, iters=20, max_infeas=1e-6):
    """FusedTR vs the host CPU: objective rtol 1e-6, infeasibility inside
    the trust-region workload's band (1e-6)."""
    _compare_tr("tr-2d", dev, ref_dev, log,
                lambda d, rep: _tr_solve(d, shape, iters, rep), max_infeas)


def phase_eigtr(dev, ref_dev, log, shape=EIGTR, iters=20, N=4,
                max_infeas=5e-3):
    """Fused eigen-TR vs the host CPU: objective rtol 1e-6, infeasibility
    equal to the host's and below 5e-3 (in f64 the 20-iteration run ends at
    2.867e-3 on the H100 and on the host alike; it is truncated, not
    converged — 2e-3 was an f32 endpoint)."""
    _compare_tr("eigtr", dev, ref_dev, log,
                lambda d, rep: _eigtr_solve(d, shape, iters, N, rep),
                max_infeas)


# ---------------------------------------------------------------------------
# host-paced callback loops (README quick start, reference-style compat API)
# ---------------------------------------------------------------------------


def _quick_start():
    from paropt_tpu import Optimizer, Problem

    class Rosenbrock(Problem):
        def __init__(self):
            super().__init__(nvars=2, ncon=1)

        def objective(self, x):
            return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2

        def constraints(self, x):
            return jnp.array([x[0] + x[1] + 5.0])

        def get_vars_and_bounds(self):
            return (jnp.array([-1.5, -1.0]), jnp.full(2, -2.0),
                    jnp.full(2, 2.0))

    opt = Optimizer(Rosenbrock(), {"algorithm": "tr", "output_file": None,
                                   "tr_output_file": None})
    res = opt.optimize()
    x = np.asarray(opt.get_optimized_point()[0])
    return res, x


def _compat_interior_point():
    from paropt_tpu import compat as ParOpt

    class Rosenbrock(ParOpt.Problem):
        def __init__(self):
            super().__init__(None, nvars=2, ncon=1)

        def getVarsAndBounds(self, x, lb, ub):
            x[:] = np.array([-1.5, -1.0])
            lb[:] = -2.0
            ub[:] = 2.0

        def evalObjCon(self, x):
            con = np.array([x[0] + x[1] + 5.0])
            return 0, 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2, con

        def evalObjConGradient(self, x, g, A):
            g[0] = -400.0 * (x[1] - x[0] ** 2) * x[0] - 2.0 * (1.0 - x[0])
            g[1] = 200.0 * (x[1] - x[0] ** 2)
            A[0][0] = 1.0
            A[0][1] = 1.0
            return 0

    ip = ParOpt.InteriorPoint(Rosenbrock(), {"output_file": None,
                                             "abs_res_tol": 1e-7})
    res = ip.optimize()
    return res, np.asarray(ip.getOptimizedPoint()[0])


def phase_callback(dev, log):
    """The host-paced loops on the card: x* = (1, 1) and f* = 0 to 1e-6."""
    for name, run in (("quick-start tr", _quick_start),
                      ("compat interior point", _compat_interior_point)):
        with jax.default_device(dev):
            t0 = time.perf_counter()
            res, x = run()
            wall = time.perf_counter() - t0
        fobj = float(res["fobj"])
        log(f"[callback] {name}: iters={res['niter']} x={x.tolist()} "
            f"fobj={fobj:.3e} wall_s={wall:.2f} (compile included)")
        _check(bool(res["converged"]), f"callback {name}: did not converge")
        _check(np.max(np.abs(x - 1.0)) <= 1e-6,
               f"callback {name}: x {x.tolist()} not within 1e-6 of (1, 1)")
        _check(abs(fobj) <= 1e-6, f"callback {name}: f {fobj:.3e} > 1e-6")


# ---------------------------------------------------------------------------
# the sharded path: design vector over a 1-D mesh of four cards
# ---------------------------------------------------------------------------


def _mesh_placer(mesh, n, log, label):
    """-> place(tree): design-length leaves sharded over ``mesh`` (rows of
    [k, n] stacks by column), everything else replicated.  Logs each
    sharded input's sharding and fails unless it spans every mesh device."""
    from paropt_tpu.parallel import sharding as shlib

    def place(tree):
        def one(leaf):
            leaf = jnp.asarray(leaf)
            if leaf.ndim >= 1 and leaf.shape[-1] == n:
                out = shlib.shard_design(leaf, mesh)
                shards = out.addressable_shards
                devs = {s.device for s in shards}
                log(f"[{label}] input {tuple(leaf.shape)} {leaf.dtype}: "
                    f"{out.sharding} addressable_shards={len(shards)} "
                    f"devices={sorted(d.id for d in devs)}")
                _check(len(devs) == mesh.devices.size
                       and all(s.data.shape[-1] == n // mesh.devices.size
                               for s in shards),
                       f"{label}: input not split over all "
                       f"{mesh.devices.size} devices")
                return out
            return shlib.replicate(leaf, mesh)
        return jax.tree_util.tree_map(one, tree)
    return place


def phase_sharded_ip(devices, log, n=IP_SHARDED_N, dtype=jnp.float64,
                     tol=1e-6):
    """FusedIP over a 1-D design mesh vs the same solve on the first device
    alone: both converge, iterations within 1 (sharded all-reduces sum in
    another order), objective rtol 1e-9.  The one-device reference is
    compiled and run in a second thread while the sharded solve compiles;
    the sharded solve is timed again once it has finished."""
    from paropt_tpu.parallel import sharding as shlib

    mesh = shlib.design_mesh(devices=devices)
    with ThreadPoolExecutor(1) as pool:
        alone = pool.submit(_ip_solve, devices[0], n, dtype, tol=tol,
                            repeat=False)
        out, ex, comp, _ = _ip_solve(
            devices[0], n, dtype, tol=tol, wait=alone.result,
            place=_mesh_placer(mesh, n, log, "ip-sharded"))
        ref, rex, rcomp, _ = alone.result()
    _check(len(out.vars.x.sharding.device_set) == len(devices),
           "ip-sharded: solution not spread over the mesh")
    _report(log, "ip-sharded", devices[0], n=n, devices=len(devices),
            **_ip_fields(out, ex, comp))
    log(f"[ip-sharded] reference on one device: "
        + _fmt(_ip_fields(ref, rex, rcomp)))
    _check(bool(out.converged) and bool(ref.converged),
           "ip-sharded: a solve did not converge")
    _check(abs(int(out.k) - int(ref.k)) <= 1,
           f"ip-sharded: {int(out.k)} iterations vs {int(ref.k)} alone")
    _close(float(out.fobj), float(ref.fobj), 1e-9, "ip-sharded fobj")


def phase_sharded_mma(devices, log, shape=MMA3D_LARGE, iters=5):
    """FusedMMA 3-D over the design mesh vs the first device alone:
    iterations within 1, objective rtol 1e-6.  The reference is built and
    run in a second thread, as in `phase_sharded_ip`."""
    from paropt_tpu.parallel import sharding as shlib

    mesh = shlib.design_mesh(devices=devices)
    n = shape[0] * shape[1] * shape[2]
    with ThreadPoolExecutor(1) as pool:
        alone = pool.submit(_mma3d_solve, devices[0], shape, iters,
                            repeat=False)
        res, state, ex, comp, _ = _mma3d_solve(
            devices[0], shape, iters, wait=alone.result,
            place=_mesh_placer(mesh, n, log, "mma-sharded"))
        ref, _, rex, rcomp, _ = alone.result()
    _check(len(state.x.sharding.device_set) == len(devices),
           "mma-sharded: solution not spread over the mesh")
    _report(log, "mma-sharded", devices[0], mesh="x".join(map(str, shape)),
            devices=len(devices), **_outer_fields(res, ex, comp))
    log(f"[mma-sharded] reference on one device: "
        + _fmt(_outer_fields(ref, rex, rcomp)))
    _check(abs(res["niter"] - ref["niter"]) <= 1,
           f"mma-sharded: {res['niter']} iterations vs {ref['niter']} alone")
    _close(res["fobj"], ref["fobj"], 1e-6, "mma-sharded fobj")


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def _nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the design-mesh path over four cards")
    args = ap.parse_args(argv)

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's first device is "
              f"{dev.platform!r}", file=sys.stderr)
        return 2
    if len(devices) < args.chips:
        print(f"chip_smoke: --chips {args.chips} but JAX sees "
              f"{len(devices)} GPU(s)", file=sys.stderr)
        return 2
    devices = devices[:args.chips]

    from paropt_tpu.utils.compile_cache import enable_compilation_cache

    def log(msg):
        print(msg, flush=True)

    try:
        smi = _nvidia_smi()
    except (OSError, subprocess.SubprocessError) as exc:
        print(f"chip_smoke: nvidia-smi failed: {exc}", file=sys.stderr)
        return 2
    for line in smi[:args.chips]:
        log(line)
    log(f"device_kind={dev.device_kind} jax={jax.__version__} "
        f"count={len(devices)} x64={jax.config.jax_enable_x64} "
        f"compile_cache={enable_compilation_cache()}")

    cpu = jax.devices("cpu")[0]
    if args.chips == 1:
        state = {}
        phases = [
            ("ip-f64", lambda: state.update(
                fobj=phase_ip_f64(dev, cpu, log))),
            ("ip-f32", lambda: phase_ip_f32(dev, cpu, log, state["fobj"])),
            ("ip-scale", lambda: phase_ip_scale(dev, log)),
            ("mma-3d", lambda: phase_mma3d(dev, cpu, log)),
            ("tr-2d", lambda: phase_tr2d(dev, cpu, log)),
            ("eigtr", lambda: phase_eigtr(dev, cpu, log)),
            ("callback", lambda: phase_callback(dev, log)),
        ]
    else:
        phases = [
            ("ip-sharded", lambda: phase_sharded_ip(devices, log)),
            ("mma-sharded", lambda: phase_sharded_mma(devices, log)),
        ]

    failed = []
    t_all = time.perf_counter()
    for name, run in phases:
        t0 = time.perf_counter()
        try:
            run()
            log(f"[{name}] PASS ({time.perf_counter() - t0:.1f} s)")
        except Exception as exc:  # every phase runs; any failure fails
            failed.append(name)
            log(f"[{name}] FAIL: {type(exc).__name__}: {exc}")
    log(f"total {time.perf_counter() - t_all:.1f} s; "
        f"failed phases: {failed or 'none'}")
    if failed:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
