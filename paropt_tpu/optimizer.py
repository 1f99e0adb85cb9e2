"""Unified optimizer facade.

Role of `ParOptOptimizer` (`src/ParOptOptimizer.{h,cpp}`): one entry point
that dispatches on the `algorithm` option ('ip' | 'tr' | 'mma', default 'tr'),
wires up the quasi-Newton approximation per `qn_type`, runs, and exposes the
optimized point uniformly (`ParOptOptimizer.cpp:65-221`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .ip import InteriorPoint
from .utils.options import OptionRegistry, make_options

__all__ = ["Optimizer"]


class Optimizer:
    def __init__(self, problem, options: Optional[Any] = None):
        self.problem = problem
        if isinstance(options, OptionRegistry):
            self.options = options
        else:
            self.options = make_options(options, which="facade")
        self.algorithm = self.options["algorithm"]
        self._inner = None
        self._subproblem = None
        self._fused_state = None
        self._result: Optional[Dict[str, Any]] = None

    def set_trust_region_subproblem(self, subproblem) -> None:
        """Install a custom TR subproblem — the eigenvalue-approximation
        path's entry (`ParOptOptimizer::setTrustRegionSubproblem`,
        `ParOptOptimizer.cpp:226-237`; used by
        `examples/eigenvalue/eigenvalue_opt.py:298-306`)."""
        self._subproblem = subproblem

    def optimize(self) -> Dict[str, Any]:
        algo = self.options["algorithm"]
        if self.options["use_fused_loop"]:
            return self._optimize_fused(algo)
        if algo == "ip":
            self._inner = InteriorPoint(self.problem, self.options)
            ckpt = self.options["ip_checkpoint_file"]
            self._result = self._inner.optimize(checkpoint=ckpt)
        elif algo == "tr":
            from .tr import TrustRegion
            self._inner = TrustRegion(self.problem, self.options,
                                      subproblem=self._subproblem)
            self._result = self._inner.optimize()
        elif algo == "mma":
            from .mma import MMA
            self._inner = MMA(self.problem, self.options)
            self._result = self._inner.optimize()
        else:  # pragma: no cover - registry validates
            raise ValueError(f"unknown algorithm {algo!r}")
        return self._result

    def _optimize_fused(self, algo: str) -> Dict[str, Any]:
        """extension: the selected algorithm's WHOLE loop on-device
        (`use_fused_loop` option). Requires a jax-native problem."""
        if not getattr(self.problem, "jit_traceable", True):
            raise ValueError(
                "use_fused_loop requires a jax-native problem (autodiff "
                "or jit-traceable eval_* methods); fill-callback (compat) "
                "problems run the host loops — drop use_fused_loop")
        if algo == "ip":
            from .ip_fused import fused_ip_optimize
            self._result, self._fused_state = fused_ip_optimize(
                self.problem, self.options)
        elif algo == "tr":
            if self._subproblem is not None:
                raise ValueError(
                    "use_fused_loop does not support a custom TR "
                    "subproblem; use the host TrustRegion")
            from .tr import FusedTR
            self._inner = FusedTR(self.problem, self.options)
            self._result, self._fused_state = self._inner.solve()
        elif algo == "mma":
            from .mma import FusedMMA
            self._inner = FusedMMA(self.problem, self.options)
            self._result, self._fused_state = self._inner.solve()
        else:  # pragma: no cover - registry validates
            raise ValueError(f"unknown algorithm {algo!r}")
        return self._result

    def get_optimized_point(self):
        """-> (x, z, zw, zl, zu) like `ParOptOptimizer::getOptimizedPoint`."""
        if self._fused_state is not None:
            st = self._fused_state
            if self.algorithm == "ip":
                v = st.vars
                return v.x, v.z, v.zw, v.zl, v.zu
            if self.algorithm == "mma":
                return st.x, st.z, st.zw, st.zl, st.zu
            raise RuntimeError(
                "multipliers live inside FusedTR's on-device QP; use the "
                "host TrustRegion (use_fused_loop=False) for "
                "getOptimizedPoint multiplier access")
        if self._inner is None:
            raise RuntimeError("call optimize() first")
        if self.algorithm == "ip":
            return self._inner.get_optimized_point()
        if self.algorithm == "tr":
            tr = self._inner
            ip = tr.ip
            _, z, zw, zl, zu = ip.get_optimized_point()
            return tr.subproblem.xk, z, zw, zl, zu
        mma = self._inner
        return mma.x, mma.z, mma.zw, mma.zl, mma.zu

    @property
    def result(self) -> Optional[Dict[str, Any]]:
        return self._result
