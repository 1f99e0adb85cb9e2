"""Drop-in compatibility layer for reference-ParOpt user code.

The reference's Python surface (`paropt/ParOpt.pyx`) has users subclass
``ParOpt.Problem`` with *fill-style* callbacks:

    class MyProblem(ParOpt.Problem):
        def __init__(self):
            super().__init__(comm, nvars=..., ncon=...)
        def getVarsAndBounds(self, x, lb, ub):  x[:] = ...; lb[:] = ...
        def evalObjCon(self, x):                return fail, fobj, con
        def evalObjConGradient(self, x, g, A):  g[:] = ...; A[i][:] = ...

This module reproduces that surface on top of the JAX-native framework so
reference scripts port with only the import changed:

    from paropt_tpu import compat as ParOpt
    ...
    opt = ParOpt.Optimizer(problem, options)
    opt.optimize()

The ``comm`` argument is accepted and ignored (SPMD replaces MPI), and the
sparse-constraint variants (`nwcon`/`nwblock` block path, `rowp`/`cols` CSR
path) mirror `ParOpt.pyx:787-907`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax.numpy as jnp
import numpy as np

from . import problem as _problem
from .ip import InteriorPoint as _InteriorPoint
from .mma import MMA as _MMA
from .optimizer import Optimizer as _Optimizer
from .tr import TrustRegion as _TrustRegion
from .utils.logging import (unpack_mma_output, unpack_output,
                            unpack_tr_2nd_output, unpack_tr_output)

__all__ = ["Problem", "Optimizer", "InteriorPoint", "TrustRegion", "MMA",
           "LBFGS", "LSR1", "CompactQuasiNewton", "QuadraticSubproblem",
           "ReducedProblem", "getOptionsInfo", "printOptionSummary",
           "unpack_checkpoint", "unpack_output", "unpack_tr_output",
           "unpack_tr_2nd_output", "unpack_mma_output", "dtype"]

# the reference exposes ParOpt.dtype (double, or complex in the complex
# build); derivatives here are exact via autodiff so the real dtype suffices
# `ParOpt.dtype` analogue: double wherever x64 is on, else f32
import jax as _jax
dtype = np.float64 if _jax.config.jax_enable_x64 else np.float32


class Problem(_problem.Problem):
    """Reference-style fill-callback problem base class."""

    # numpy fill callbacks cannot trace under jax.jit — the fused
    # whole-loop solvers (use_fused_loop) must use the host loops instead
    jit_traceable = False

    def __init__(self, comm=None, nvars: int = 0, ncon: int = 0,
                 num_dense_inequalities: Optional[int] = None,
                 nwcon: int = 0, nwblock: int = 1,
                 num_sparse_constraints: Optional[int] = None,
                 num_sparse_inequalities: Optional[int] = None,
                 rowp=None, cols=None, **kwargs):
        self.comm = comm  # accepted for signature parity; SPMD replaces MPI
        if num_sparse_constraints is not None:
            nwcon = num_sparse_constraints
        self._csr = None
        if rowp is not None and cols is not None:
            # general CSR sparse-constraint variant (ParOpt.pyx:837-907)
            self._csr = (np.asarray(rowp, np.int32),
                         np.asarray(cols, np.int32))
            nwcon = len(rowp) - 1
        super(Problem, self).__init__(
            nvars=nvars, ncon=ncon, nwcon=nwcon, nwblock=nwblock,
            ninequality=num_dense_inequalities,
            nwinequality=num_sparse_inequalities)
        if self._csr is not None:
            self.use_csr_path = True
            self.csr_rowp, self.csr_cols = self._csr
            counts = np.diff(self.csr_rowp)
            self._kmax = int(counts.max()) if nwcon else 0
            pad_cols = np.zeros((nwcon, self._kmax), dtype=np.int32)
            for i in range(nwcon):
                k = counts[i]
                pad_cols[i, :k] = self.csr_cols[
                    self.csr_rowp[i]:self.csr_rowp[i + 1]]
            self._pad_cols = jnp.asarray(pad_cols)
            self._data = np.zeros(self.csr_rowp[-1])

    # -- reference-style fill callbacks (users override these) --------------
    def getVarsAndBounds(self, x, lb, ub):
        raise NotImplementedError

    def evalObjCon(self, x):
        """-> (fail, fobj, con) — reference convention."""
        raise NotImplementedError

    def evalObjConGradient(self, x, g, A):
        """Fill g[:] and A[i][:] in place; return fail."""
        raise NotImplementedError

    def evalSparseCon(self, x, out):
        out[:] = 0.0

    def addSparseJacobian(self, alpha, x, px, out):
        raise NotImplementedError

    def addSparseJacobianTranspose(self, alpha, x, pz, out):
        raise NotImplementedError

    def addSparseInnerProduct(self, alpha, x, c, A):
        raise NotImplementedError

    def evalSparseObjCon(self, x, sparse_con):
        """CSR variant: fill sparse_con[:], return (fail, fobj, con)."""
        raise NotImplementedError

    def evalSparseObjConGradient(self, x, g, A, data):
        """CSR variant: fill g[:] and the CSR data[:]; return fail."""
        raise NotImplementedError

    def checkGradients(self, dh=1e-6, x=None, check_hvec_product=False):
        return self.check_gradients(dh, x=x,
                                    check_hvec_product=check_hvec_product)

    # -- adapters to the framework surface ----------------------------------
    def get_vars_and_bounds(self):
        x = np.zeros(self.nvars)
        lb = np.zeros(self.nvars)
        ub = np.zeros(self.nvars)
        self.getVarsAndBounds(x, lb, ub)
        return jnp.asarray(x), jnp.asarray(lb), jnp.asarray(ub)

    def eval_obj_con(self, x):
        xnp = np.asarray(x)
        if self._csr is not None:
            cw = np.zeros(self.nwcon)
            fail, fobj, con = self.evalSparseObjCon(xnp, cw)
            # cache keyed on the evaluation point so eval_sparse_con() can
            # reuse it instead of paying a second full user evaluation
            self._cw_cache = cw
            self._cw_cache_x = xnp.copy()
            self._cw_cache_fail = bool(fail)
        else:
            fail, fobj, con = self.evalObjCon(xnp)
        if fail:
            return jnp.asarray(np.nan), jnp.full(self.ncon, np.nan)
        con = np.asarray(con, dtype=float).reshape(self.ncon)
        return jnp.asarray(float(fobj)), jnp.asarray(con)

    def eval_obj_con_gradient(self, x):
        xnp = np.asarray(x)
        g = np.zeros(self.nvars)
        if self._csr is not None:
            data = np.zeros(self.csr_rowp[-1])
            A = [np.zeros(self.nvars) for _ in range(self.ncon)]
            fail = self.evalSparseObjConGradient(xnp, g, A, data)
            self._data = data
        else:
            A = [np.zeros(self.nvars) for _ in range(self.ncon)]
            fail = self.evalObjConGradient(xnp, g, A)
        Amat = (np.stack(A) if self.ncon
                else np.zeros((0, self.nvars)))
        return jnp.asarray(g), jnp.asarray(Amat)

    # -- sparse-constraint surface -------------------------------------------
    def eval_sparse_con(self, x):
        xnp = np.asarray(x)
        if self._csr is not None:
            cached_x = getattr(self, "_cw_cache_x", None)
            if (cached_x is not None and cached_x.shape == xnp.shape
                    and np.array_equal(cached_x, xnp)):
                if self._cw_cache_fail:
                    return jnp.full(self.nwcon, np.nan)
                return jnp.asarray(self._cw_cache)
            cw = np.zeros(self.nwcon)
            fail, _, _ = self.evalSparseObjCon(xnp, cw)
            if fail:
                return jnp.full(self.nwcon, np.nan)
            return jnp.asarray(cw)
        out = np.zeros(self.nwcon)
        self.evalSparseCon(xnp, out)
        return jnp.asarray(out)

    def sparse_jacobian_vec(self, x, px):
        if self._csr is not None:
            return self.sparse_jacobian(x).matvec(px)
        out = np.zeros(self.nwcon)
        self.addSparseJacobian(1.0, np.asarray(x), np.asarray(px), out)
        return jnp.asarray(out)

    def sparse_jacobian_tvec(self, x, zw):
        if self._csr is not None:
            return self.sparse_jacobian(x).rmatvec(zw)
        out = np.zeros(self.nvars)
        self.addSparseJacobianTranspose(1.0, np.asarray(x), np.asarray(zw),
                                        out)
        return jnp.asarray(out)

    def sparse_inner_product(self, x, cvec):
        if self._csr is not None:
            return self.sparse_jacobian(x).inner_product_blocks(cvec)
        nb = self.nwblock
        A = np.zeros((self.nwcon // nb, nb, nb))
        self.addSparseInnerProduct(1.0, np.asarray(x), np.asarray(cvec),
                                   A.reshape(-1) if nb == 1 else A)
        return jnp.asarray(A.reshape(self.nwcon // nb, nb, nb))

    def sparse_jacobian(self, x):
        if self._csr is not None:
            counts = np.diff(self.csr_rowp)
            vals = np.zeros((self.nwcon, self._kmax))
            for i in range(self.nwcon):
                k = counts[i]
                vals[i, :k] = self._data[
                    self.csr_rowp[i]:self.csr_rowp[i + 1]]
            return _problem.SparseJacobian(self.nvars, self._pad_cols,
                                           jnp.asarray(vals), nwblock=1)
        # block-callback variant: materialize the padded pattern once by
        # probing the transpose operator with basis vectors is too costly;
        # require nwblock-structured problems to use the framework surface.
        raise NotImplementedError(
            "block sparse callbacks: override sparse_jacobian() or use the "
            "framework Problem surface")

    def create_quasi_def_mat(self):
        from .ops.sparse_native import CSRQuasiDefMat
        return CSRQuasiDefMat(self.nvars, self.csr_rowp, self.csr_cols)


def _wrap_options(options):
    return dict(options) if options else {}


class Optimizer(_Optimizer):
    """`ParOpt.Optimizer(problem, options)` facade (ParOpt.pyx:1461-1522)."""

    def __init__(self, problem, options: Optional[Dict[str, Any]] = None):
        super().__init__(problem, _wrap_options(options))

    def getOptimizedPoint(self):
        x, z, zw, zl, zu = self.get_optimized_point()
        return np.asarray(x), np.asarray(z), np.asarray(zw), \
            np.asarray(zl), np.asarray(zu)

    def setTrustRegionSubproblem(self, subproblem):
        """Install a custom TR subproblem (the eigenvalue path's entry,
        `ParOptOptimizer.cpp:226-237`)."""
        return self.set_trust_region_subproblem(subproblem)


class InteriorPoint(_InteriorPoint):
    def getOptimizedPoint(self):
        return tuple(np.asarray(v) for v in self.get_optimized_point())

    def checkGradients(self, dh):
        return self.problem.check_gradients(dh)

    # camelCase aliases for the reference surface (ParOpt.pyx:1229-1365)
    def setPenaltyGamma(self, gamma):
        return self.set_penalty_gamma(gamma)

    def getBarrierParameter(self):
        return self.get_barrier_parameter()

    def setBarrierParameter(self, mu):
        return self.set_barrier_parameter(mu)

    def getComplementarity(self):
        return self.get_complementarity()

    def writeSolutionFile(self, path):
        return self.write_solution_file(path)

    def readSolutionFile(self, path):
        return self.read_solution_file(path)

    def getIterationCounters(self):
        return self.get_iteration_counters()

    def resetDesignAndBounds(self):
        return self.reset_design_and_bounds()


# quasi-Newton enum constants (`ParOpt.pyx:52-59`), usable as the
# update_type / diag_type arguments of LBFGS / LSR1
SKIP_NEGATIVE_CURVATURE = "skip_negative_curvature"
DAMPED_UPDATE = "damped_update"
YTY_OVER_YTS = "yty_over_yts"
YTS_OVER_STS = "yts_over_sts"
INNER_PRODUCT_YTY_OVER_YTS = "inner_yty_over_yts"
INNER_PRODUCT_YTS_OVER_STS = "inner_yts_over_sts"


class CompactQuasiNewton:
    """Reference-style limited-memory Hessian object (`ParOpt.pyx:
    1190-1227`): holds a QNState in a shared holder dict that
    `InteriorPoint.setQuasiNewton` installs, and supports direct
    `update`/`mult`/`multAdd` driving (the `examples/limited_memory_test`
    usage mode)."""

    _qn_type = "bfgs"

    def __init__(self, problem, subspace: int = 10,
                 update_type: str = SKIP_NEGATIVE_CURVATURE,
                 diag_type: str = YTY_OVER_YTS,
                 storage_dtype: str = "auto"):
        """``storage_dtype``: 'auto' (the shipping policy — bfloat16 ring
        buffers at f32-on-accelerator), 'native', or 'bfloat16' — the
        extension `qn_storage_dtype` option for this reference-API
        surface."""
        from .ops.qn import qn_init
        from .dtypes import resolve_dtype
        from .ip import _resolve_qn_storage
        self.holder = {"state": qn_init(
            subspace, problem.nvars, qn_type=self._qn_type,
            update_type=update_type, diag_type=diag_type,
            storage_dtype=_resolve_qn_storage(storage_dtype,
                                              resolve_dtype(None)))}

    def reset(self):
        from .ops.qn import qn_reset
        self.holder["state"] = qn_reset(self.holder["state"])

    def update(self, s, y):
        """Apply one (s, y) pair (`ParOpt.pyx:1198-1200`)."""
        from .ops.qn import qn_update
        self.holder["state"], skipped, damped = qn_update(
            self.holder["state"], jnp.asarray(s), jnp.asarray(y))
        return int(skipped), int(damped)

    def mult(self, x, y=None):
        """y = B @ x; fills ``y`` in place when given an ndarray
        (`ParOpt.pyx:1202-1204`), else returns the product."""
        from .ops.qn import qn_mult
        out = np.asarray(qn_mult(self.holder["state"], jnp.asarray(x)))
        if y is not None:
            y[:] = out
            return None
        return out

    def multAdd(self, alpha, x, y):
        """y += alpha * B @ x (`ParOpt.pyx:1206-1208`)."""
        from .ops.qn import qn_mult
        y[:] = np.asarray(y) + alpha * np.asarray(
            qn_mult(self.holder["state"], jnp.asarray(x)))


class LBFGS(CompactQuasiNewton):
    """`ParOpt.pyx:1210-1219` role."""
    _qn_type = "bfgs"


class LSR1(CompactQuasiNewton):
    """`ParOpt.pyx:1221-1227` role (no update_type: SR1 has a single
    update rule; the curvature skip test is built in)."""
    _qn_type = "sr1"

    def __init__(self, problem, subspace: int = 10,
                 diag_type: str = YTY_OVER_YTS):
        super().__init__(problem, subspace, diag_type=diag_type)


def _ip_set_quasi_newton(self, qn):
    if qn is None:
        from .ops.qn import qn_init  # noqa: F401 (documented path)
        self.set_quasi_newton_holder({"state": None})
    else:
        self.set_quasi_newton_holder(qn.holder)


InteriorPoint.setQuasiNewton = _ip_set_quasi_newton


def _ip_get_optimized_slacks(self):
    """`getOptimizedSlacks` (ParOpt.pyx:1291-1310): -> (s, t, sw, tw)."""
    return tuple(np.asarray(v) for v in self.get_optimized_slacks())


def _ip_set_multiple_penalty_gamma(self, gamma):
    """`setMultiplePenaltyGamma` (ParOpt.pyx:1330-1340): one gamma per
    dense constraint."""
    return self.set_penalty_gamma(np.asarray(gamma, dtype=float))


def _ip_reset_qn(self):
    return self.reset_quasi_newton_hessian()


InteriorPoint.getOptimizedSlacks = _ip_get_optimized_slacks
InteriorPoint.setMultiplePenaltyGamma = _ip_set_multiple_penalty_gamma
InteriorPoint.resetQuasiNewtonHessian = _ip_reset_qn

TrustRegion = _TrustRegion
MMA = _MMA
MMA.getAsymptotes = lambda self: tuple(np.asarray(v)
                                       for v in self.get_asymptotes())
MMA.getDesignHistory = lambda self: tuple(np.asarray(v)
                                          for v in self.get_design_history())


def unpack_checkpoint(filename):
    """Read a checkpoint written by `writeSolutionFile` into python objects
    — the reference contract (`ParOpt.pyx:318-355`): returns
    (barrier, s, z, x, zl, zu).  This framework's checkpoints are npz."""
    if not filename.endswith(".npz"):
        filename = filename + ".npz"
    dat = np.load(filename)
    return (float(dat["mu"]), np.asarray(dat["s"]), np.asarray(dat["z"]),
            np.asarray(dat["x"]), np.asarray(dat["zl"]),
            np.asarray(dat["zu"]))


def printOptionSummary():
    """Print a summary of every option in all optimizers
    (`ParOpt.pyx:417-425`)."""
    info = getOptionsInfo()
    for name in info:
        print(info[name].descript)


class _OptionInfo:
    """One entry of getOptionsInfo() — the reference's introspection record
    (`ParOpt.pyx:447-518`): option_type / default / values / descript."""

    def __init__(self, desc):
        self.name = desc.name
        self.option_type = desc.otype if desc.otype != "enum" else "str"
        self.default = desc.default
        if desc.otype == "enum":
            self.values = list(desc.values)
        elif desc.low is not None:
            self.values = [desc.low, desc.high]
        else:
            self.values = None
        self.descript = desc.doc

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"OptionInfo({self.name}: {self.option_type}, "
                f"default={self.default!r})")


def getOptionsInfo():
    """{name: info} over every registered option — drivers use this to
    auto-declare their own option surfaces (`ParOpt.pyx:447-518`,
    `paropt_driver.py:51-92`, `paropt_pyoptsparse.py:164-190`)."""
    from .utils.options import make_options
    return {d.name: _OptionInfo(d) for d in make_options().descriptors()}

from .tr import QuadraticSubproblem  # noqa: E402,F401  (ParOpt.pyx:1395)
from .reduced import ReducedProblem  # noqa: E402,F401
