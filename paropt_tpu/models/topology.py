"""Synthetic large-scale topology-optimization-style problem.

The reference's target workload is large-scale (10⁶–10⁸ variable) multi-
material topology optimization with a distributed design vector, one or a few
global dense resource constraints, and many separable per-region weighting
constraints (`README.md:12-31`, `docs/ParOpt_theory_manual.tex:27-28`,
`examples/topology_optimization/`, `examples/dmo_truss/`).

This model reproduces that *structure* with a synthetic, fully differentiable
objective (so it runs standalone without a FEM solver and still exercises the
same optimizer paths and communication pattern):

    min  Σ w_i / (eps + xf_i)          xf = smoothing filter applied to x
    s.t. V - mean(x) >= 0              (1 dense volume constraint)
         cap - blockmean(x) >= 0       (n/block sparse weighting constraints)
         0 <= x <= 1

The filter is a fixed-width stencil (a 1-D convolution), giving the objective
gradient a neighborhood structure like a density-filtered compliance problem.
Everything — gradients, Jacobian products, block inner products — is derived
by autodiff / the structured SparseJacobian, and the whole IP iteration runs
as one fused XLA computation on n-sharded arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..problem import Problem, SparseJacobian

__all__ = ["SyntheticTopology"]


class SyntheticTopology(Problem):
    def __init__(self, n: int = 1 << 20, block: int = 8,
                 filter_width: int = 5, volume_fraction: float = 0.4,
                 block_cap: float = 0.6, seed: int = 0,
                 use_sparse: bool = True, dtype=None):
        assert n % block == 0
        nwcon = n // block if use_sparse else 0
        super().__init__(nvars=n, ncon=1, nwcon=nwcon, nwblock=1)
        self.block = block
        self.volume_fraction = volume_fraction
        self.block_cap = block_cap
        rng = np.random.default_rng(seed)
        dt = dtype or jnp.float64
        self.w = jnp.asarray(0.5 + rng.random(n), dt)
        k = jnp.asarray(np.hanning(filter_width + 2)[1:-1], dt)
        self.kernel = k / jnp.sum(k)
        self.eps = 0.01
        if use_sparse:
            # transposed partition (variable i in block i mod nwcon): every
            # Jacobian product keeps the large axis minor (see
            # kkt.detect_aw_layout)
            cols = (np.arange(nwcon, dtype=np.int32)[:, None]
                    + np.arange(block, dtype=np.int32)[None, :] * nwcon)
            vals = -np.full((nwcon, block), 1.0 / block)
            self._jac = SparseJacobian(nvars=n, cols=jnp.asarray(cols),
                                       vals=jnp.asarray(vals, dt), nwblock=1)
        self._dtype = dt

    def _filter(self, x):
        # shift-and-add stencil: explicit shifts are elementwise work that
        # XLA fuses (and so is the autodiff transpose)
        pad = self.kernel.shape[0] // 2
        xp = jnp.pad(x, pad, mode="edge")
        n = x.shape[0]
        out = jnp.zeros_like(x)
        for j in range(self.kernel.shape[0]):
            out = out + self.kernel[j] * jax.lax.dynamic_slice(xp, (j,), (n,))
        return out

    def objective(self, x):
        xf = self._filter(x)
        return jnp.sum(self.w / (self.eps + xf)) / x.shape[0]

    def constraints(self, x):
        return jnp.array([self.volume_fraction - jnp.mean(x)])

    def sparse_constraints(self, x):
        bm = jnp.mean(x.reshape(self.block, self.nwcon), axis=0)
        return self.block_cap - bm

    def sparse_jacobian(self, x):
        return self._jac

    def get_vars_and_bounds(self):
        n = self.nvars
        x0 = jnp.full(n, 0.3, self._dtype)
        return x0, jnp.zeros(n, self._dtype), jnp.ones(n, self._dtype)
