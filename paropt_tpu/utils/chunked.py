"""Watchdog-safe execution of fused outer loops.

A single `lax.while_loop` device execution spanning a whole optimization can
run for minutes on a large problem and trip runtime watchdogs (observed: a
crashed device worker on a 192x96 FEM topology with cg_iters=800 in ONE
call).
`run_chunked` bounds each device execution: with chunk='auto' it TIMES one
outer iteration through the same compiled program and sizes the calls to
~target_s seconds, so no problem configuration can compile a
watchdog-killing program.  Host dispatch between chunks is one call per
chunk (negligible), and convergence stops the loop early.
"""

from __future__ import annotations

import time

import jax

AUTO_CHUNK_TARGET_S = 10.0
AUTO_CHUNK_MAX = 64


def run_chunked(run_jit, state, max_it: int, chunk="auto",
                target_s: float = AUTO_CHUNK_TARGET_S,
                chunk_max: int = AUTO_CHUNK_MAX, on_chunk=None):
    """Drive ``run_jit(state, k_stop) -> state`` (a jitted while_loop whose
    cond is ``~converged & (k < k_stop)``) to ``max_it`` outer iterations in
    bounded device executions.  ``state`` must expose integer ``.k`` and
    boolean ``.converged`` fields.

    ``on_chunk(state)`` (optional) is invoked after EVERY device call —
    the chunk boundaries are the free host-visible points of a fused
    solve, so this is where mid-solve user output and checkpoints live
    (see ``make_write_output_hook``; the reference writes solution +
    checkpoint files every `write_output_frequency` iterations during
    `optimize()`, `ParOptInteriorPoint.cpp:4620-4631`)."""
    if chunk is not None and chunk != "auto" and int(chunk) < 1:
        raise ValueError(f"chunk must be a positive int, 'auto', or None; "
                         f"got {chunk!r}")
    if chunk == "auto":
        k0 = int(state.k)
        if k0 < max_it and not bool(state.converged):
            # first single-iteration call pays the compile
            state = run_jit(state, k0 + 1)
            jax.block_until_ready(state)
            if on_chunk is not None:
                on_chunk(state)
        k1 = int(state.k)
        if k1 < max_it and not bool(state.converged):
            t0 = time.time()
            state = run_jit(state, k1 + 1)
            jax.block_until_ready(state)
            dt = max(time.time() - t0, 1e-6)
            chunk = int(max(1, min(chunk_max, target_s / dt)))
            if on_chunk is not None:
                on_chunk(state)
        else:
            chunk = 1
    if chunk is None or chunk >= max_it:
        state = run_jit(state, max_it)
        if on_chunk is not None:
            on_chunk(state)
        return state
    while True:
        k_stop = min(int(state.k) + chunk, max_it)
        state = run_jit(state, k_stop)
        if on_chunk is not None:
            on_chunk(state)
        if bool(state.converged) or int(state.k) >= max_it:
            return state


def user_write_output(problem):
    """The problem's ``write_output`` bound method only if the problem
    class OVERRIDES it.  The base ``Problem.write_output`` is a no-op —
    but routing it through the chunk hook still costs an ``int(state.k)``
    device sync per chunk boundary, a host round trip that slows
    default-config fused solves when the device is remote or the chunks
    are short.  Returning None lets ``make_write_output_hook``
    collapse to no hook at all."""
    from ..problem import Problem
    if "write_output" in vars(problem):     # instance-assigned hook
        return problem.write_output
    fn = getattr(type(problem), "write_output", None)
    if fn is None or fn is Problem.write_output:
        return None
    return problem.write_output


def make_write_output_hook(write_output, freq, get_x=lambda st: st.xk,
                           checkpoint_path=None):
    """Build an ``on_chunk`` callback firing the problem's
    ``write_output(it, x)`` hook and (optionally) an Orbax checkpoint of
    the FULL solver state every ~``freq`` outer iterations.

    Chunk boundaries are the only host-visible points of a fused solve, so
    cadence is approximate: the hook fires at the first boundary at or
    past each multiple of ``freq`` (the host loops fire exactly at
    ``it % freq == 0`` — `tr.py:662`, matching
    `ParOptInteriorPoint.cpp:4620-4631`).  Returns None when ``freq`` <= 0
    (disabled), so callers can pass the result straight to ``run_chunked``.
    """
    if freq is None or int(freq) <= 0:
        return None
    if write_output is None and checkpoint_path is None:
        return None          # nothing to fire: avoid the per-chunk sync
    freq = int(freq)
    next_k = [0]

    def hook(state):
        k = int(state.k)
        if k < next_k[0]:
            return
        next_k[0] = (k // freq + 1) * freq
        if write_output is not None:
            write_output(k, get_x(state))
        if checkpoint_path is not None:
            from .checkpoint import save_state
            save_state(checkpoint_path, state)

    return hook


class _BatchView:
    """Scalar k/converged view over a batched (leading-axis) state so the
    chunked driver can pace a vmapped while_loop: advance until EVERY
    instance is converged or at the cap (frozen instances cost nothing)."""

    def __init__(self, st):
        self.st = st

    def block_until_ready(self):
        # jax.block_until_ready sees this wrapper as an opaque leaf and
        # calls this method; without it the auto-chunk timing probe only
        # measures async dispatch and always saturates at AUTO_CHUNK_MAX.
        jax.block_until_ready(self.st)
        return self

    @property
    def k(self):
        import jax.numpy as jnp
        return jnp.min(self.st.k)

    @property
    def converged(self):
        import jax.numpy as jnp
        return jnp.all(self.st.converged)


def run_chunked_batched(run_jit, state, max_it: int, chunk="auto",
                        on_chunk=None):
    """`run_chunked` over a batched state (every leaf has a leading k
    axis); ``run_jit(state, k_stop) -> state`` is the vmapped loop.
    ``on_chunk`` receives the underlying batched state."""
    hook = None if on_chunk is None else (lambda v: on_chunk(v.st))
    view = run_chunked(lambda v, k_stop: _BatchView(run_jit(v.st, k_stop)),
                       _BatchView(state), max_it, chunk, on_chunk=hook)
    return view.st
