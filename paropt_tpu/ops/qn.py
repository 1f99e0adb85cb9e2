"""Compact limited-memory quasi-Newton Hessian approximations.

Role-equivalent of ``ParOptCompactQuasiNewton`` / ``ParOptLBFGS`` /
``ParOptLSR1`` (`src/ParOptQuasiNewton.{h,cpp}`): maintain

    B  ≈  b0 * I  -  Z^T M^{-1} Z

with Z a small stack of design-length vectors and M a small replicated matrix,
so Hessian products cost one [K, n] matmul + one [K, K] solve (one fused
all-reduce when n is sharded — the `mdot` pattern), and the KKT solve can apply
B^{-1} through the Sherman-Morrison-Woodbury identity.

Accelerator-first design: the state is a fixed-shape pytree (ONE stacked
[2m, n] S/Y ring buffer with newest pair in rows m-1 / 2m-1 plus an active
count), so `update`, `mult` and the compact-matrix assembly all `jit`
without retracing; the branchy update safeguards (damping / skip,
`ParOptQuasiNewton.cpp:175-179`, damped update θ = 0.8·sᵀBs/(sᵀBs − yᵀs))
are `jnp.where` selects.

Conventions (self-contained; verified against dense BFGS in tests):

- L-BFGS (Byrd–Nocedal–Schnabel compact form, as in `ParOptQuasiNewton.cpp:
  339-377`): classically Z₀ = [b0*S; Y] (2m rows), M₀ = [[b0*S Sᵀ, L],
  [Lᵀ, -D]], L_ij = s_i·y_j (i > j strictly), D = diag(s_i·y_i).  Here the
  b0 scaling is absorbed into the small matrix (Z = [S; Y] = the raw ring
  buffer, M = [[S Sᵀ/b0, L/b0], [Lᵀ/b0, -D]]) so `qn_compact` is zero-copy
  — see `_assemble_M`.
- L-SR1 (`ParOptQuasiNewton.cpp:593-860`):  W = Y - b0*S (m rows),
  B = b0 I + W^T (D + L + Lᵀ - b0 S Sᵀ)^{-1} W, absorbed into the unified
  minus-sign form via M = b0 S Sᵀ - D - L - Lᵀ, Z = W.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..dtypes import full_precision

__all__ = ["QNState", "qn_init", "qn_reset", "qn_update", "qn_mult",
           "resolve_subspace_size",
           "qn_compact"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class QNState:
    """Fixed-shape limited-memory state.

    The (s, y) history lives in ONE [2m, n] ring buffer `buf` — rows [:m]
    are the S ring, rows [m:] the Y ring, newest pair in rows m-1 / 2m-1.
    This layout makes the BFGS compact form's Z = [S; Y] a zero-copy view
    of the state (the b0 scaling is absorbed into the small M matrix, see
    `_assemble_M`), so `qn_compact` touches no [*, n] memory at all.

    Rows [m-count:m] / [2m-count:] are active; inactive rows are zero.

    ``buf`` may be stored in a NARROWER dtype than the small-matrix /
    scalar state (``storage_dtype='bfloat16'`` in `qn_init`, a device-memory
    bandwidth knob): the Gram matrices are then computed from the
    QUANTIZED pairs (so the compact form stays exactly consistent with
    the stored Z and B stays PSD) while all small algebra runs in the
    compute dtype (`SS.dtype`)."""
    buf: jnp.ndarray        # [2m, n] stacked S/Y ring buffers
    SS: jnp.ndarray         # [m, m] Gram S·Sᵀ, maintained incrementally
    SY: jnp.ndarray         # [m, m] SY[i, j] = s_i · y_j, incremental
    count: jnp.ndarray      # int32 scalar, number of active pairs (<= m)
    b0: jnp.ndarray         # scalar initial diagonal
    z0: jnp.ndarray         # objective-multiplier scale (scaled_bfgs only)
    # static config
    qn_type: str = dataclasses.field(metadata=dict(static=True), default="bfgs")
    update_type: str = dataclasses.field(metadata=dict(static=True),
                                         default="skip_negative_curvature")
    diag_type: str = dataclasses.field(metadata=dict(static=True),
                                       default="yty_over_yts")
    scaled: bool = dataclasses.field(metadata=dict(static=True),
                                     default=False)

    @property
    def S(self) -> jnp.ndarray:
        return self.buf[:self.msub]

    @property
    def Y(self) -> jnp.ndarray:
        return self.buf[self.msub:]

    @property
    def msub(self) -> int:
        return self.buf.shape[0] // 2

    @property
    def nvars(self) -> int:
        return self.buf.shape[1]


def default_storage_dtype(compute_dtype):
    """The shipping QN-storage policy: bfloat16 ring buffers when computing
    in f32 on an accelerator (the [2m, n] history is the step's largest
    stream; the Gram matrices are formed from the quantized pairs, so the
    compact form stays exact for the stored history —
    scripts/solve_qn_bf16.py / scripts/ab_qn_bf16.py compare the two),
    native storage otherwise (f64 keeps full-precision history)."""
    try:
        on_accel = jax.default_backend() != "cpu"
    except Exception:  # pragma: no cover
        on_accel = False
    if on_accel and jnp.dtype(compute_dtype) == jnp.float32:
        return jnp.bfloat16
    return None


def resolve_subspace_size(requested: int, auto: bool, nvars: int,
                          compute_dtype) -> int:
    """qn_subspace_auto policy (`ParOptQuasiNewton.cpp:127` sizing role;
    an extension, not in the reference): the QN machinery is the dominant
    per-iteration device-memory traffic on large problems and scales
    ~linearly with the subspace size, while on the synthetic topology
    workload msub=10/5/3 converge in the same number of iterations.
    'auto' caps the subspace at 5 once the
    problem is big enough to be bandwidth-bound (nvars >= 2^19) in
    32-bit or narrower precision; small problems and f64 keep the
    requested size."""
    if not auto:
        return requested
    if nvars >= (1 << 19) and jnp.dtype(compute_dtype).itemsize <= 4:
        return min(requested, 5)
    return requested


def qn_init(msub: int, nvars: int, dtype=None, qn_type: str = "bfgs",
            update_type: str = "skip_negative_curvature",
            diag_type: str = "yty_over_yts", b0: float = 1.0,
            storage_dtype=None) -> QNState:
    """``storage_dtype`` (e.g. ``jnp.bfloat16``): dtype of the [2m, n] ring
    buffer only — small matrices/scalars stay in ``dtype``.  Halves the QN
    machinery's device-memory traffic at the cost of quantizing the stored
    (s, y) pairs (the approximation B changes smoothly; steps stay exact
    Newton steps of the quantized model)."""
    from ..dtypes import resolve_dtype
    dtype = resolve_dtype(dtype)
    sdtype = dtype if storage_dtype is None else jnp.dtype(storage_dtype)
    scaled = qn_type == "scaled_bfgs"
    return QNState(
        buf=jnp.zeros((2 * msub, nvars), dtype=sdtype),
        SS=jnp.zeros((msub, msub), dtype=dtype),
        SY=jnp.zeros((msub, msub), dtype=dtype),
        count=jnp.zeros((), dtype=jnp.int32),
        b0=jnp.asarray(b0, dtype=dtype),
        z0=jnp.ones((), dtype=dtype),
        qn_type="bfgs" if scaled else qn_type,
        update_type=update_type, diag_type=diag_type, scaled=scaled)


def qn_reset(state: QNState) -> QNState:
    return dataclasses.replace(
        state, buf=jnp.zeros_like(state.buf),
        SS=jnp.zeros_like(state.SS), SY=jnp.zeros_like(state.SY),
        count=jnp.zeros_like(state.count), b0=jnp.ones_like(state.b0))


def _active_mask(state: QNState) -> jnp.ndarray:
    m = state.msub
    idx = jnp.arange(m)
    return (idx >= m - state.count).astype(state.SS.dtype)


def _assemble_M(state: QNState, b0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Build (Z [K, n], M [K, K]) for the unified B = b0 I - Z^T M^{-1} Z form.
    Inactive rows padded with identity on the M diagonal.

    BFGS: the classic BNS form is Z₀ = [b0·S; Y], M₀ = [[b0·SSᵀ, L],
    [Lᵀ, -D]].  With T = diag(b0·I, I) we have Z₀ = T·[S; Y], so
    Z₀ᵀ M₀⁻¹ Z₀ = Zᵀ (T⁻¹ M₀ T⁻¹)⁻¹ Z with Z = [S; Y] — the raw ring
    buffer, ZERO-COPY.  The b0 scaling moves entirely into the small
    matrix:  M = [[SSᵀ/b0, L/b0], [Lᵀ/b0, -D]].  No [*, n] memory is
    touched here at all."""
    m = state.msub
    mask = _active_mask(state)
    # Gram matrices are maintained incrementally in the state (one small
    # stacked matvec per update) — no [m, n] matmuls here
    SS = state.SS
    SY = state.SY                           # SY[i,j] = s_i . y_j
    D = jnp.diag(jnp.diag(SY))
    Lmat = jnp.tril(SY, k=-1)               # strictly lower: s_i.y_j, i > j
    if state.qn_type in ("bfgs", "scaled_bfgs"):
        Z = state.buf                                     # [2m, n] view
        M = jnp.block([[SS / b0, Lmat / b0], [Lmat.T / b0, -D]])
        act = jnp.concatenate([mask, mask])
    elif state.qn_type == "sr1":
        Z = state.Y - b0 * state.S
        M = b0 * SS - D - Lmat - Lmat.T
        act = mask
    else:
        raise ValueError(f"unknown qn_type {state.qn_type!r}")
    # pad inactive with identity.  Z needs NO masking: inactive S/Y rows
    # are zero by construction (qn_init/qn_reset zero the buffers and the
    # ring roll shifts those zeros), so the buffer rows are already zero —
    # skipping the [2m, n] mask multiply saves a full read+write pass
    K = M.shape[0]
    eye = jnp.eye(K, dtype=M.dtype)
    outer = act[:, None] * act[None, :]
    M = jnp.where(outer > 0, M, eye)
    return Z, M


def qn_compact(state: QNState):
    """-> (b0, Z [K, n], M [K, K]) with B = b0 I - Z^T M^{-1} Z.

    The analogue of `getCompactMat` (`ParOptQuasiNewton.h:32-67`); when
    count == 0, Z is all zero and M the identity, so B = b0 I exactly.
    For BFGS, Z is the state's ring buffer itself (no [2m, n] copy — see
    `_assemble_M`).  For the scaled-BFGS decorator
    (`ParOptScaledQuasiNewton.h:7-103`) the inner approximation is scaled
    by the objective multiplier: B = z0·B_inner = z0·b0·I - Zᵀ(M/z0)⁻¹Z,
    again without touching Z."""
    Z, M = _assemble_M(state, state.b0)
    if state.scaled:
        return state.z0 * state.b0, Z, M / state.z0
    return state.b0, Z, M


@full_precision
def qn_mult(state: QNState, x: jnp.ndarray,
            compact=None) -> jnp.ndarray:
    """B @ x.  Pass a precomputed ``compact`` to avoid re-assembly."""
    b0, Z, M = compact if compact is not None else qn_compact(state)
    return b0 * x - Z.T @ jnp.linalg.solve(M, Z @ x)


def _new_b0(state: QNState, s, y, yTs, yTy, sTs):
    dt = state.diag_type
    # reference quirk preserved (`ParOptQuasiNewton.cpp:200-203`): ONLY the
    # exact 'yts_over_sts' selects yTs/sTs — 'inner_yts_over_sts' falls
    # through the else branch to yTy/yTs like the other two types
    if dt == "yts_over_sts":
        val = yTs / sTs
    else:  # yty_over_yts, inner_yty_over_yts, inner_yts_over_sts
        val = yTy / yTs
    return jnp.where(yTs > 0.0, val, state.b0)


def _roll_select_dots(buf, s_st, y_st, s_g, y_g, upd):
    """Shift the (s, y) pair into the ring buffer and form the new Gram
    rows: ``rolled = [buf[1:m]; s; buf[m+1:]; y]``, ``dots = rolled @ [s,
    y]ᵀ`` ([2m, 2], taken on the rolled buffer whether or not ``upd``
    holds), and the buffer returned is ``rolled`` where ``upd`` else
    ``buf``.  ``s_st``/``y_st`` are the pair in the storage dtype, and
    ``s_g``/``y_g`` the same values in the compute dtype.  Kept as plain
    JAX: inside the fused IP step XLA fuses it with its neighbours, and a
    hand-written one-pass kernel measured slower there (CHANGES.md, PR 1)."""
    m = buf.shape[0] // 2
    rolled = jnp.concatenate(
        [buf[1:m], s_st[None, :], buf[m + 1:], y_st[None, :]], axis=0)
    dots = rolled @ jnp.stack([s_g, y_g]).T
    return jnp.where(upd, rolled, buf), dots


@jax.jit
@full_precision
def qn_update(state: QNState, s: jnp.ndarray, y: jnp.ndarray,
              z0: Optional[jnp.ndarray] = None, compact=None,
              accept=None) -> Tuple[QNState, jnp.ndarray, jnp.ndarray]:
    """Apply one (s, y) update.

    Jitted at the source: the host-loop callers (ip.py/tr.py/eig.py) would
    otherwise dispatch the roll + scatter + Gram chain op-by-op — measured
    at ~40% of the host loop's per-iteration cost at n=2^18 (the .at[].set
    scatters alone copy the full [m, m] matrices eagerly).  Inside already-
    jitted callers (ip_fused) the nested jit is inlined at trace time.

    Returns (new_state, skipped, damped) with int32 flags.  Behavior matches
    the reference ladder (`ParOptQuasiNewton.cpp:130-280`):

    - skip test: |yᵀs| <= 1e-8 * yᵀy  =>  no update (`:175-179`)
    - 'damped_update' (BFGS): if yᵀs < 0.2·sᵀBs use
      θ = 0.8·sᵀBs/(sᵀBs − yᵀs), y ← θ·y + (1−θ)·Bs
    - 'skip_negative_curvature' (BFGS): skip when yᵀs <= 0 after the skip test
    - SR1: standard skip when |sᵀ(y − Bs)| small relative test

    ``accept`` (optional bool scalar) gates the whole update (a rejected
    line-search step): it is folded into the same select as the skip test so
    callers don't pay a second full pass over the [m, n] buffers.  The
    returned flags still report the curvature skip/damp decisions.
    """
    dtype = state.SS.dtype
    s = s.astype(dtype)
    y = y.astype(dtype)
    z0_old = state.z0
    # Bs = B @ s is needed only by the damped-BFGS update and the SR1 skip
    # test; the default skip_negative_curvature BFGS ladder uses pure
    # (s, y) scalars — skipping the product saves two [2m, n] passes
    need_Bs = (state.qn_type == "sr1"
               or state.update_type == "damped_update")
    if state.scaled:
        # scaled-BFGS decorator: the inner approximation models the
        # Lagrangian Hessian divided by the objective multiplier z0
        # (`ParOptScaledQuasiNewton.h:22-103`)
        z0_new = (jnp.maximum(jnp.abs(jnp.asarray(z0, dtype)), 1e-8)
                  if z0 is not None else state.z0)
        state = dataclasses.replace(state, z0=z0_new)
        y = y / z0_new
        # the curvature/damping tests below operate on the INNER
        # approximation B0 (the decorator delegates, ScaledQuasiNewton.h)
        Bs = (qn_mult(dataclasses.replace(state, scaled=False), s)
              if need_Bs else jnp.zeros_like(s))
    else:
        Bs = (qn_mult(state, s, compact=compact) if need_Bs
              else jnp.zeros_like(s))
    # one fused reduction for all the scalars (mdot pattern)
    if need_Bs:
        G = jnp.stack([s, y, Bs]) @ jnp.stack([s, y]).T  # [3, 2]
        sTs, yTs, yTy, sBs = G[0, 0], G[1, 0], G[1, 1], G[2, 0]
    else:
        G = jnp.stack([s, y]) @ jnp.stack([s, y]).T      # [2, 2]
        sTs, yTs, yTy = G[0, 0], G[1, 0], G[1, 1]
        sBs = jnp.zeros((), dtype)

    if state.qn_type in ("bfgs", "scaled_bfgs"):
        nocedal_skip = jnp.abs(yTs) <= 1e-8 * yTy
        if state.update_type == "damped_update":
            need_damp = yTs < 0.2 * sBs
            theta = jnp.where(need_damp, 0.8 * sBs / (sBs - yTs), 1.0)
            y_use = theta * y + (1.0 - theta) * Bs
            damped = need_damp & ~nocedal_skip
            skip = nocedal_skip
        else:
            y_use = y
            damped = jnp.zeros((), dtype=bool)
            skip = nocedal_skip | (yTs <= 0.0)
    else:  # sr1: skip if |s.(y - Bs)| <= 1e-8 * |s| * |y - Bs|
        w = y - Bs
        sw = jnp.vdot(s, w)
        skip = jnp.abs(sw) <= 1e-8 * jnp.sqrt(sTs * jnp.vdot(w, w) + 1e-300)
        y_use = y
        damped = jnp.zeros((), dtype=bool)

    # fold the caller's acceptance gate into the same select as the skip
    # test: one pass over the [m, n] buffers instead of two
    upd = ~skip if accept is None else \
        (~skip) & jnp.asarray(accept).astype(bool)

    m = state.msub
    # narrow storage: quantization can flip a marginal (possibly damped)
    # y's > 0, which would put a nonpositive entry on the compact form's
    # D diagonal — re-apply the curvature gate to the QUANTIZED scalars
    # (BFGS forms only; SR1's M is allowed to be indefinite).  The
    # rejection is reported through the returned `skip` flag so logs and
    # counters reflect that no update was stored.
    q_narrow = (state.buf.dtype != dtype
                and state.qn_type in ("bfgs", "scaled_bfgs"))
    # narrow storage: quantize the pair BEFORE the Gram dots so the small
    # matrices stay exactly consistent with the stored Z (the compact form
    # is then the exact BNS form of the quantized history — B stays PSD)
    if state.buf.dtype != dtype:
        s_st = s.astype(state.buf.dtype)
        y_st = y_use.astype(state.buf.dtype)
        s_g = s_st.astype(dtype)
        y_g = y_st.astype(dtype)
    else:
        s_st, y_st, s_g, y_g = s, y_use, s, y_use
    sTs_u = sTs if s_g is s else jnp.vdot(s_g, s_g)
    yTs_use = jnp.vdot(y_g, s_g)
    yTy_use = jnp.vdot(y_g, y_g)
    q_reject = jnp.zeros((), dtype=bool)
    if q_narrow:
        q_reject = yTs_use <= 1e-8 * yTy_use
        upd = upd & ~q_reject
    # ring-buffer shift within each half (newest pair in rows m-1 / 2m-1)
    # and the incremental Gram rows in ONE stacked matvec (mdot pattern)
    buf_sel, dots = _roll_select_dots(state.buf, s_st, y_st, s_g, y_g, upd)
    Ss = dots[:m, 0]          # S_new · s
    Sy = dots[:m, 1]          # S_new · y_use  (new SY column)
    Ys = dots[m:, 0]          # Y_new · s      (new SY row)

    b0_new = _new_b0(state, s, y_use, yTs_use, yTy_use, sTs_u)
    if state.qn_type == "sr1":
        # SR1 allows indefinite curvature; keep b0 positive
        b0_new = jnp.where(b0_new > 0.0, b0_new, state.b0)

    cnt_new = jnp.minimum(state.count + 1, state.msub)
    SS_new = jnp.roll(state.SS, shift=(-1, -1), axis=(0, 1))
    SS_new = SS_new.at[-1, :].set(Ss).at[:, -1].set(Ss)
    SY_new = jnp.roll(state.SY, shift=(-1, -1), axis=(0, 1))
    SY_new = SY_new.at[:, -1].set(Sy).at[-1, :].set(Ys)

    new_state = dataclasses.replace(
        state,
        buf=buf_sel,
        SS=jnp.where(upd, SS_new, state.SS),
        SY=jnp.where(upd, SY_new, state.SY),
        count=jnp.where(upd, cnt_new, state.count),
        b0=jnp.where(upd, b0_new, state.b0))
    if state.scaled and accept is not None:
        # the z0 refresh tracks the multiplier independently of the skip
        # test, but a rejected step must not move it either
        new_state = dataclasses.replace(
            new_state, z0=jnp.where(jnp.asarray(accept).astype(bool),
                                    new_state.z0, z0_old))
    skip = skip | q_reject
    damped = damped & ~q_reject
    return new_state, skip.astype(jnp.int32), damped.astype(jnp.int32)
