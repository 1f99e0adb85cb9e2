"""Default floating dtype resolution.

The reference is double precision everywhere; this framework follows
(float64) wherever x64 is enabled, and falls back to float32 when it is not
(PAROPT_TPU_NO_X64 set; see docs/design.md)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = ["default_float", "resolve_dtype", "full_precision"]


def default_float():
    """jnp.float64 when x64 is enabled, else jnp.float32."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def resolve_dtype(dtype):
    """Pass through an explicit dtype; resolve None to the default, and
    downgrade float64 to float32 when x64 is disabled (it would silently
    truncate anyway — this keeps the choice explicit and warning-free)."""
    if dtype is None:
        return default_float()
    if jnp.dtype(dtype) == jnp.float64 and not jax.config.jax_enable_x64:
        return jnp.float32
    return dtype


def full_precision(fn):
    """Trace ``fn`` with float32 matrix products at full precision.

    At default precision XLA may run f32 products with reduced-precision
    inputs (TF32 on NVIDIA GPUs, about 3 decimal digits); the KKT and
    quasi-Newton algebra needs all of f32's digits to reach the reference
    tolerance.  Products in f64, and on the CPU, are unaffected."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return wrapped
