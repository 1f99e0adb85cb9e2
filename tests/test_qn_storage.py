"""Narrow (bfloat16) quasi-Newton storage — the device-memory bandwidth knob
(`qn_init(storage_dtype=...)` / option `qn_storage_dtype`, a documented
extension; no reference analogue — the reference is f64 throughout)."""

import numpy as np
import jax.numpy as jnp

from paropt_tpu import ip_fused
from paropt_tpu.models.topology import SyntheticTopology
from paropt_tpu.ops import qn as qnmod


def test_storage_option_resolution():
    """Option mapping: 'auto' follows the accelerator/f32 policy (None on
    this CPU suite), 'bfloat16' forces narrow storage, 'native' disables."""
    from paropt_tpu.ip import _resolve_qn_storage

    assert _resolve_qn_storage("native", jnp.float32) is None
    assert _resolve_qn_storage("bfloat16", jnp.float64) == jnp.bfloat16
    # CPU backend in this suite: auto = native regardless of dtype
    assert _resolve_qn_storage("auto", jnp.float32) is None
    assert qnmod.default_storage_dtype(jnp.float32) is None


def _updated_states(msub=5, n=512, steps=8, seed=0):
    rng = np.random.default_rng(seed)
    d = 0.5 + rng.uniform(size=n)          # SPD diagonal model Hessian
    st_full = qnmod.qn_init(msub, n, dtype=jnp.float64)
    st_bf16 = qnmod.qn_init(msub, n, dtype=jnp.float64,
                            storage_dtype=jnp.bfloat16)
    for _ in range(steps):
        s = jnp.asarray(rng.standard_normal(n))
        y = jnp.asarray(d * np.asarray(s) + 1e-3 * rng.standard_normal(n))
        st_full, _, _ = qnmod.qn_update(st_full, s, y)
        st_bf16, _, _ = qnmod.qn_update(st_bf16, s, y)
    return st_full, st_bf16


def test_bf16_storage_b_close_and_spd():
    """B from bf16-stored pairs tracks the full-precision B to bf16
    accuracy and remains positive definite (the Gram matrices are computed
    from the QUANTIZED pairs, so the compact form is the exact BNS form of
    the quantized history)."""
    st_full, st_bf16 = _updated_states()
    assert st_bf16.buf.dtype == jnp.bfloat16
    assert st_bf16.SS.dtype == jnp.float64
    assert int(st_bf16.count) == int(st_full.count)
    rng = np.random.default_rng(1)
    for _ in range(5):
        v = jnp.asarray(rng.standard_normal(st_full.nvars))
        bv_full = qnmod.qn_mult(st_full, v)
        bv_bf16 = qnmod.qn_mult(st_bf16, v)
        assert bv_bf16.dtype == jnp.float64
        rel = float(jnp.linalg.norm(bv_bf16 - bv_full)
                    / jnp.linalg.norm(bv_full))
        assert rel < 0.05, rel
        # PSD: v' B v > 0
        assert float(jnp.vdot(v, bv_bf16)) > 0.0


def test_bf16_storage_factor_phi_dtype():
    """The KKT factor's Phi stacks inherit the narrow storage dtype and the
    SMW-corrected solve still satisfies the Newton system to storage
    accuracy (full-precision path as the reference solution)."""
    from paropt_tpu.ops import kkt

    prob = SyntheticTopology(n=256, block=8, dtype=jnp.float64)
    model = ip_fused.model_from_problem(prob)
    opts = ip_fused.FusedIPOptions(use_quasi_newton_update=True)
    fused = ip_fused.FusedIP(model, prob.nvars, prob.ncon, prob.nwcon,
                             prob.nwblock, opts, dtype=jnp.float64)
    data, x0 = ip_fused.data_template_from_problem(prob,
                                                   dtype=jnp.float64)
    st = fused.init(x0, data, (),
                    qnmod.qn_init(5, prob.nvars, dtype=jnp.float64), None)
    for _ in range(3):
        st = fused.step(st, data, (), None)

    d = data
    rng = np.random.default_rng(2)
    # install the SAME history in full and bf16 states
    st_full, st_bf16 = _updated_states(msub=5, n=prob.nvars, steps=6)

    bx = jnp.asarray(rng.standard_normal(prob.nvars))
    bc = jnp.asarray(rng.standard_normal(prob.ncon))
    bw = jnp.asarray(rng.standard_normal(prob.nwcon))

    out = {}
    for name, qst in (("full", st_full), ("bf16", st_bf16)):
        cq = qnmod.qn_compact(qst)
        f = kkt.setup_kkt_factor(st.vars, d, qn_compact=cq)
        if name == "bf16":
            assert f.Zqn.dtype == jnp.bfloat16
            assert f.Phi_x.dtype == jnp.bfloat16
            assert f.Ce_inv.dtype == jnp.float64
        px, pz, pw = kkt._solve_reduced(f, d, bx, bc, bw)
        assert px.dtype == jnp.float64
        out[name] = np.asarray(px)
    rel = (np.linalg.norm(out["bf16"] - out["full"])
           / np.linalg.norm(out["full"]))
    # different (quantized) B => different Newton step, but close
    assert rel < 0.05, rel


def test_fused_ip_converges_with_bf16_storage():
    """Whole-solve: the fused IP reaches the same tolerance/objective with
    bf16 QN storage (steps are exact Newton steps of the quantized model —
    convergence is preserved, possibly with a few extra iterations)."""
    prob = SyntheticTopology(n=1024, block=8)
    model = ip_fused.model_from_problem(prob)
    opts = ip_fused.FusedIPOptions(use_quasi_newton_update=True,
                                   abs_res_tol=1e-6, max_major_iters=400)
    fused = ip_fused.FusedIP(model, prob.nvars, prob.ncon, prob.nwcon,
                             prob.nwblock, opts)
    data, x0 = ip_fused.data_template_from_problem(prob)

    res = {}
    for name, storage in (("full", None), ("bf16", jnp.bfloat16)):
        qn0 = qnmod.qn_init(10, prob.nvars, storage_dtype=storage)
        st = fused.solve(x0, data, (), qn0, None)
        assert bool(st.converged), name
        res[name] = st
    f_full = float(res["full"].fobj)
    f_bf16 = float(res["bf16"].fobj)
    assert abs(f_bf16 - f_full) < 1e-5 * max(1.0, abs(f_full)), \
        (f_full, f_bf16)
    # a few extra iterations are acceptable; wild inflation is not
    assert int(res["bf16"].k) <= int(res["full"].k) + 15, \
        (int(res["full"].k), int(res["bf16"].k))


def test_bf16_quantization_curvature_gate_reports_skip():
    """A pair whose y's > 0 survives the raw curvature ladder but flips
    nonpositive after bf16 quantization (cancellation across components)
    must be rejected AND reported as skipped — storing it would put a
    nonpositive entry on the compact form's D diagonal."""
    n = 256
    s = jnp.zeros(n).at[0].set(1.0).at[1].set(1.0)
    y = jnp.zeros(n).at[0].set(1.0).at[1].set(-1.0 + 1e-4)

    # full precision accepts (yTs = 1e-4 > 0, above the 1e-8*yTy floor)
    st_f = qnmod.qn_init(3, n, dtype=jnp.float64)
    st_f2, skip_f, _ = qnmod.qn_update(st_f, s, y)
    assert int(skip_f) == 0 and int(st_f2.count) == 1

    # bf16 storage: quantized y[1] rounds to -1.0 exactly -> yTs_q = 0
    st_b = qnmod.qn_init(3, n, dtype=jnp.float64,
                         storage_dtype=jnp.bfloat16)
    st_b2, skip_b, damped_b = qnmod.qn_update(st_b, s, y)
    assert int(skip_b) == 1 and int(damped_b) == 0
    assert int(st_b2.count) == 0
    assert np.array_equal(np.asarray(st_b2.buf, np.float32),
                          np.asarray(st_b.buf, np.float32))
