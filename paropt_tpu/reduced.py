"""Reduced problems: optimize over a subset of the design variables.

Role-equivalent of the reference's reduced-problem pattern
(`examples/reduced_problem/reduced.py:62-116`): wrap an existing problem,
fix a chosen subset of design variables at given values, and present the
free variables as a smaller problem to any of the optimizers.  Useful for
continuation strategies, design freezes, and debugging subsets of a large
design space.

accelerator-first notes: the expansion free->full is a static scatter (the fixed
values are baked into a constant full-size template and the free values are
written through a precomputed index array), so the wrapped evaluations stay
jittable and autodiff flows through to the free subset automatically.
"""

from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp
import numpy as np

from .problem import Problem

__all__ = ["ReducedProblem"]


class ReducedProblem(Problem):
    """Present ``problem`` restricted to its non-fixed design variables.

    Parameters
    ----------
    problem : Problem
        The full-size problem.
    fixed_idx : sequence of int
        Indices (into the full design vector) of the variables to fix.
    fixed_vals : sequence of float
        Values for the fixed variables (same length as ``fixed_idx``).

    Sparse (``nwcon``) constraints are not supported — fixing variables can
    break the separable partition structure the sparse path relies on.
    """

    def __init__(self, problem: Problem, fixed_idx: Sequence[int],
                 fixed_vals: Sequence[float]):
        if problem.nwcon:
            raise ValueError(
                "ReducedProblem does not support sparse (nwcon) constraints")
        fixed_idx = np.asarray(fixed_idx, dtype=np.int64)
        fixed_vals = np.asarray(fixed_vals, dtype=np.float64)
        if fixed_idx.shape != fixed_vals.shape:
            raise ValueError("fixed_idx and fixed_vals length mismatch")
        if fixed_idx.size != np.unique(fixed_idx).size:
            raise ValueError("fixed_idx contains duplicates")
        mask = np.zeros(problem.nvars, dtype=bool)
        mask[fixed_idx] = True
        self.problem = problem
        self.fixed_idx = jnp.asarray(fixed_idx)
        self.free_idx = jnp.asarray(np.nonzero(~mask)[0])
        self._template = jnp.zeros(problem.nvars).at[self.fixed_idx].set(
            jnp.asarray(fixed_vals))
        super().__init__(nvars=int(self.free_idx.shape[0]),
                         ncon=problem.ncon,
                         ninequality=problem.ninequality)

    # -- expansion -----------------------------------------------------------
    def expand(self, x):
        """Full-size design vector with the fixed values filled in."""
        return self._template.at[self.free_idx].set(jnp.asarray(x))

    def restrict(self, xfull):
        """Free components of a full-size vector."""
        return jnp.asarray(xfull)[self.free_idx]

    # -- Problem surface (delegates to the wrapped problem) ------------------
    def get_vars_and_bounds(self):
        x0, lb, ub = self.problem.get_vars_and_bounds()
        return self.restrict(x0), self.restrict(lb), self.restrict(ub)

    def eval_obj_con(self, x):
        return self.problem.eval_obj_con(self.expand(x))

    def eval_obj_con_gradient(self, x):
        g, A = self.problem.eval_obj_con_gradient(self.expand(x))
        return self.restrict(g), jnp.asarray(A)[:, self.free_idx]

    def eval_hvec_product(self, x, z, zw, px):
        # lift the free-space direction with ZERO in the fixed slots (the
        # fixed coordinates do not move), then restrict the product
        pfull = jnp.zeros(self.problem.nvars).at[self.free_idx].set(
            jnp.asarray(px))
        hv = self.problem.eval_hvec_product(self.expand(x), z, zw, pfull)
        return self.restrict(hv)

    def eval_hessian_diag(self, x, z, zw):
        d = self.problem.eval_hessian_diag(self.expand(x), z, zw)
        return self.restrict(d)

    def write_output(self, it, x):
        self.problem.write_output(it, self.expand(x))
