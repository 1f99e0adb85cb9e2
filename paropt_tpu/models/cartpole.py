"""Cart-pole swing-up trajectory optimization.

Role-equivalent of the reference's `examples/cart_pole/cart_pole.py` (the
problem is from M. Kelly, "An Introduction to Trajectory Optimization",
SIAM Review 59(4)): find the control force history u(t) of minimum energy
∫u² dt that swings the pole from hanging at rest to upright at rest, as a
single-shooting problem with 4 terminal equality constraints.

Standard cart-pole equations of motion (cart mass m1, pole point-mass m2 at
length L, state q = [x, θ, ẋ, θ̇], force u on the cart):

    ẍ = ( L·m2·sinθ·θ̇² + u + m2·g·cosθ·sinθ ) / (m1 + m2·sin²θ)
    θ̈ = −( L·m2·cosθ·sinθ·θ̇² + u·cosθ + (m1+m2)·g·sinθ )
         / ( L·(m1 + m2·sin²θ) )

accelerator-first design vs the reference:

- The implicit-midpoint time march is a `lax.scan`; each step runs a FIXED
  number of Newton iterations on the 4-dimensional implicit residual (tiny
  4x4 solves), so the whole trajectory is one compiled computation.
- Gradients come from `jax.grad` THROUGH the scan — replacing the
  reference's hand-derived discrete adjoint (`computeAdjointDeriv`,
  `cart_pole.py:260+`) and sympy-generated Jacobian code.  Hessian-vector
  products for the GMRES phase come for free the same way.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..problem import Problem

__all__ = ["CartPole"]


class CartPole(Problem):
    """Swing-up: nvars = nsteps control forces, ncon = 4 terminal
    equalities (x=1, θ=π, ẋ=0, θ̇=0), bounds |u| <= 20."""

    def __init__(self, nsteps: int = 63, tfinal: float = 2.0,
                 m1: float = 1.0, m2: float = 0.3, L: float = 0.5,
                 newton_iters: int = 8):
        super().__init__(nvars=nsteps, ncon=4, ninequality=0)
        self.m1, self.m2, self.L, self.grav = m1, m2, L, 9.81
        self.t = jnp.linspace(0.0, tfinal, nsteps + 1)
        self.h = self.t[1:] - self.t[:-1]
        self.newton_iters = newton_iters
        # the reference scales the tiny objective up and the constraints
        # to O(1) (`cart_pole.py:77-78`)
        self.fobj_scale = 0.01
        self.con_scale = 10.0
        self.qtarget = jnp.array([1.0, jnp.pi, 0.0, 0.0])

    # -- dynamics ------------------------------------------------------------
    def _qdot(self, q, u):
        """Explicit state derivative f(q, u)."""
        theta, xd, td = q[1], q[2], q[3]
        st, ct = jnp.sin(theta), jnp.cos(theta)
        denom = self.m1 + self.m2 * st * st
        xdd = (self.L * self.m2 * st * td ** 2 + u
               + self.m2 * self.grav * ct * st) / denom
        tdd = -(self.L * self.m2 * ct * st * td ** 2 + u * ct
                + (self.m1 + self.m2) * self.grav * st) / (self.L * denom)
        return jnp.array([xd, td, xdd, tdd])

    def _step(self, q_prev, hu):
        """One implicit-midpoint step: solve r(q) = (q - q_prev)/h -
        f((q + q_prev)/2, u) = 0 by a fixed number of Newton iterations."""
        h, u = hu

        def resid(qn):
            return (qn - q_prev) / h - self._qdot(0.5 * (qn + q_prev), u)

        def newton(qn, _):
            J = jax.jacfwd(resid)(qn)
            return qn - jnp.linalg.solve(J, resid(qn)), None

        qn, _ = jax.lax.scan(newton, q_prev, None, length=self.newton_iters)
        return qn, qn

    def trajectory(self, u):
        """Integrate the full state history [nsteps+1, 4] from rest."""
        q0 = jnp.zeros(4)
        _, qs = jax.lax.scan(self._step, q0, (self.h, jnp.asarray(u)))
        return jnp.concatenate([q0[None, :], qs], axis=0)

    # -- Problem surface -----------------------------------------------------
    def objective(self, x):
        return self.fobj_scale * jnp.sum(self.h * jnp.asarray(x) ** 2)

    def constraints(self, x):
        qf = self.trajectory(x)[-1]
        return self.con_scale * (qf - self.qtarget)

    def get_vars_and_bounds(self):
        n = self.nvars
        return jnp.ones(n), jnp.full(n, -20.0), jnp.full(n, 20.0)
