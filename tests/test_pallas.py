"""The plain-JAX paths that replaced the Pallas kernels: the quasi-definite
solve and the quasi-Newton ring roll (`qn._roll_select_dots`, `qn_update`),
each against a hand-written dense reference."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from paropt_tpu.ops import kkt


def test_pallas_matches_kkt_quasi_def_solve():
    """The batched quasi-definite solve on a blocked_t ProblemData satisfies
    [[D, -Aw'], [Aw, C0]] [yx; yw] = [bx; bw] for every right-hand side."""
    rng = np.random.default_rng(3)
    k, nwcon = 4, 128
    n = k * nwcon
    K = 7
    cols = (np.arange(nwcon, dtype=np.int32)[:, None]
            + np.arange(k, dtype=np.int32)[None, :] * nwcon)
    vals = jnp.asarray(rng.standard_normal((nwcon, k)))
    dt = jnp.float64
    d = kkt.ProblemData(
        g=jnp.zeros(n, dt), A=jnp.zeros((0, n), dt), c=jnp.zeros(0, dt),
        cw=jnp.zeros(nwcon, dt), lb=jnp.full(n, -1.0), ub=jnp.full(n, 1.0),
        lb_mask=jnp.ones(n), ub_mask=jnp.ones(n),
        gamma_s=jnp.zeros(0), gamma_t=jnp.zeros(0),
        gamma_sw=jnp.zeros(nwcon), gamma_tw=jnp.full(nwcon, 1e3),
        Aw_cols=jnp.asarray(cols), Aw_vals=vals, nwblock=1,
        Aw_layout="blocked_t")
    Dinv = jnp.asarray(rng.uniform(0.5, 2.0, n))
    C0 = jnp.asarray(rng.uniform(0.5, 1.5, nwcon))
    Cw = C0.reshape(-1, 1, 1) + d.Aw_inner_blocks(Dinv)
    f = kkt.KKTFactor(Dinv=Dinv, Gamma=None, C0=C0,
                      Cw_chol=jnp.sqrt(Cw), Xa=None, Wa=None, G_lu=None,
                      Zqn=None, Phi_x=None, Phi_z=None, Phi_w=None,
                      Ce_inv=None)
    bx = jnp.asarray(rng.standard_normal((K, n)))
    bw = jnp.asarray(rng.standard_normal((K, nwcon)))
    yx, yw = kkt.quasi_def_solve(f, d, bx, bw)
    assert yx.shape == (K, n) and yw.shape == (K, nwcon)
    # dense reference of the same operator
    Aw = np.zeros((nwcon, n))
    Aw[np.arange(nwcon)[:, None], cols] = np.asarray(vals)
    lhs_x = np.asarray(yx) / np.asarray(Dinv) - np.asarray(yw) @ Aw
    lhs_w = np.asarray(yx) @ Aw.T + np.asarray(C0) * np.asarray(yw)
    assert np.allclose(lhs_x, np.asarray(bx), atol=1e-10)
    assert np.allclose(lhs_w, np.asarray(bw), atol=1e-10)


def _dense_roll(buf, s, y):
    """Hand-rolled ring shift: drop the oldest row of each half, append."""
    buf = np.asarray(buf)
    m = buf.shape[0] // 2
    S = np.vstack([buf[1:m], np.asarray(s)[None]])
    Y = np.vstack([buf[m + 1:], np.asarray(y)[None]])
    return np.vstack([S, Y])


def test_qn_roll_update_matches_manual():
    """`_roll_select_dots` vs a hand-rolled roll: rolled/kept buffer per
    the update flag, and the Gram rows taken on the rolled buffer."""
    from paropt_tpu.ops import qn as qnmod

    rng = np.random.default_rng(7)
    m, n = 5, 512
    buf = jnp.asarray(rng.standard_normal((2 * m, n)))
    s = jnp.asarray(rng.standard_normal(n))
    y = jnp.asarray(rng.standard_normal(n))
    rolled = _dense_roll(buf, s, y)
    dots_ref = np.stack([rolled @ np.asarray(s), rolled @ np.asarray(y)],
                        axis=1)
    for upd in (True, False):
        out, dots = jax.jit(qnmod._roll_select_dots)(buf, s, y, s, y,
                                                     jnp.asarray(upd))
        want = rolled if upd else np.asarray(buf)
        assert np.array_equal(np.asarray(out), want)
        # dots are always taken on the rolled buffer
        assert np.allclose(np.asarray(dots), dots_ref, atol=1e-10)


def _drive_updates(qnmod, m, n, qn_type, update_type, storage_dtype=None):
    """m+2 updates with a negated-curvature pair and accept gates; returns
    the final state and, per update, (s, y, skip, damp, accept, newest
    stored y row)."""
    state = qnmod.qn_init(m, n, qn_type=qn_type, update_type=update_type,
                          storage_dtype=storage_dtype)
    rng = np.random.default_rng(5)
    log = []
    for i in range(m + 2):
        s = jnp.asarray(rng.standard_normal(n))
        y = 1.5 * s + 0.2 * jnp.asarray(rng.standard_normal(n))
        if i == 2:
            y = -y  # exercise the skip/damp ladder
        accept = None if i % 2 == 0 else jnp.asarray(i != 3)
        state, skip, damp = qnmod.qn_update(state, s, y, accept=accept)
        log.append((s, y, int(skip), int(damp),
                    True if accept is None else bool(accept),
                    np.asarray(state.buf)[-1]))
    return state, log


@pytest.mark.parametrize("qn_type,update_type", [
    ("bfgs", "skip_negative_curvature"),
    ("bfgs", "damped_update"),
    ("sr1", "skip_negative_curvature"),
])
def test_qn_update_pallas_branch_matches_jnp(qn_type, update_type):
    """qn_update's ring and Gram matrices against a hand-rolled dense
    history: every stored pair is in the buffer in order, SS = S Sᵀ and
    SY = S Yᵀ over the stored rows, and count tracks the stored pairs."""
    from paropt_tpu.ops import qn as qnmod

    m, n = 4, 4096
    state, log = _drive_updates(qnmod, m, n, qn_type, update_type)
    buf = np.zeros((2 * m, n))
    count = 0
    for s, y, skip, damp, accept, y_row in log:
        if accept and not skip:
            # damped: the stored y is θy + (1-θ)Bs, not y
            buf = _dense_roll(buf, s, y_row if damp else y)
            count = min(count + 1, m)
    assert int(state.count) == count
    got = np.asarray(state.buf)
    assert np.allclose(got, buf, rtol=1e-12, atol=1e-12)
    S, Y = got[:m], got[m:]
    assert np.allclose(np.asarray(state.SS), S @ S.T, rtol=1e-9, atol=1e-9)
    assert np.allclose(np.asarray(state.SY), S @ Y.T, rtol=1e-9, atol=1e-9)
    assert count < len(log)   # the rejected step stored nothing


def test_qn_update_accept_false_is_identity():
    """accept=False leaves every leaf of the state unchanged (the fused
    in-loop gate for rejected steps)."""
    from paropt_tpu.ops import qn as qnmod

    rng = np.random.default_rng(9)
    m, n = 3, 64
    state = qnmod.qn_init(m, n)
    for _ in range(2):
        s = jnp.asarray(rng.standard_normal(n))
        y = 2.0 * s
        state, _, _ = qnmod.qn_update(state, s, y)
    s = jnp.asarray(rng.standard_normal(n))
    y = 2.0 * s
    new, skip, _ = qnmod.qn_update(state, s, y, accept=jnp.asarray(False))
    assert int(skip) == 0  # curvature fine; gate is the caller's accept
    for la, lb in zip(jax.tree_util.tree_leaves(state),
                      jax.tree_util.tree_leaves(new)):
        assert np.array_equal(np.asarray(la), np.asarray(lb))


def test_qn_update_scaled_accept_gates_z0():
    """scaled-BFGS: accept=False must freeze z0 along with the history
    (the caller's rejected-step gate), while accept=True refreshes it even
    when the curvature test skips the pair."""
    from paropt_tpu.ops import qn as qnmod

    rng = np.random.default_rng(17)
    n = 64
    state = qnmod.qn_init(3, n, qn_type="scaled_bfgs")
    for _ in range(2):
        s = jnp.asarray(rng.standard_normal(n))
        state, _, _ = qnmod.qn_update(state, s, 2.0 * s, z0=2.0)
    assert float(state.z0) == 2.0

    s = jnp.asarray(rng.standard_normal(n))
    rejected, _, _ = qnmod.qn_update(state, s, 2.0 * s, z0=5.0,
                                     accept=jnp.asarray(False))
    for la, lb in zip(jax.tree_util.tree_leaves(state),
                      jax.tree_util.tree_leaves(rejected)):
        assert np.array_equal(np.asarray(la), np.asarray(lb))

    # accepted but curvature-skipped: z0 still refreshes (the reference's
    # decorator tracks the multiplier independently of the skip test)
    accepted, skip, _ = qnmod.qn_update(state, s, -2.0 * s, z0=5.0,
                                        accept=jnp.asarray(True))
    assert int(skip) == 1
    assert float(accepted.z0) == 5.0
    assert np.array_equal(np.asarray(accepted.buf), np.asarray(state.buf))


def test_qn_update_pallas_bf16_storage():
    """Narrow (bfloat16) ring storage: the buffer holds the QUANTIZED pairs
    in hand-rolled order, and the Gram matrices are formed from those
    quantized values in the compute dtype (f64)."""
    from paropt_tpu.ops import qn as qnmod

    m, n = 4, 4096
    state, log = _drive_updates(qnmod, m, n, "bfgs",
                                "skip_negative_curvature",
                                storage_dtype=jnp.bfloat16)
    assert state.buf.dtype == jnp.bfloat16
    assert state.SS.dtype == jnp.float64

    def q(v):
        return np.asarray(jnp.asarray(v).astype(jnp.bfloat16)
                          .astype(jnp.float64))

    buf = np.zeros((2 * m, n))
    for s, y, skip, damp, accept, _ in log:
        assert damp == 0
        if accept and not skip:
            buf = _dense_roll(buf, q(s), q(y))
    got = np.asarray(state.buf.astype(jnp.float64))
    assert np.array_equal(got, buf)
    S, Y = got[:m], got[m:]
    assert np.allclose(np.asarray(state.SS), S @ S.T, rtol=1e-9, atol=1e-9)
    assert np.allclose(np.asarray(state.SY), S @ Y.T, rtol=1e-9, atol=1e-9)
