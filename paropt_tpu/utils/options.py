"""Typed option registry for the JAX-native ParOpt framework.

Mirrors the reference option system (``src/ParOptOptions.{h,cpp}``: typed entries
with defaults, ranges and docstrings, set-tracking and iteration/introspection,
``ParOptOptions.h:20-61``) but is implemented as a plain-Python registry of
frozen option descriptors.  Option *names, defaults, ranges and meanings* match
the reference registrations:

- interior point:  ``src/ParOptInteriorPoint.cpp:536-727``
- trust region:    ``src/ParOptTrustRegion.cpp:739-847``
- MMA:             ``src/ParOptMMA.cpp:234-289``
- facade:          ``src/ParOptOptimizer.cpp:39-50``

so a ParOpt user can carry their options dict over unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

__all__ = [
    "OptionDescriptor",
    "OptionRegistry",
    "add_ip_options",
    "add_tr_options",
    "add_mma_options",
    "add_facade_options",
    "make_options",
]


@dataclasses.dataclass(frozen=True)
class OptionDescriptor:
    """One typed option: name, type, default, optional range/enum, docstring."""

    name: str
    otype: str  # 'str' | 'bool' | 'int' | 'float' | 'enum'
    default: Any
    low: Optional[float] = None
    high: Optional[float] = None
    values: Optional[Tuple[str, ...]] = None
    doc: str = ""

    def validate(self, value: Any) -> Any:
        if self.otype == "str":
            if value is not None and not isinstance(value, str):
                raise TypeError(f"option '{self.name}' expects str, got {value!r}")
            return value
        if self.otype == "bool":
            if isinstance(value, (bool, int)):
                return bool(value)
            raise TypeError(f"option '{self.name}' expects bool, got {value!r}")
        if self.otype == "int":
            if isinstance(value, bool) or not isinstance(value, int):
                raise TypeError(f"option '{self.name}' expects int, got {value!r}")
            if self.low is not None and not (self.low <= value <= self.high):
                raise ValueError(
                    f"option '{self.name}'={value} outside range "
                    f"[{self.low}, {self.high}]"
                )
            return int(value)
        if self.otype == "float":
            if not isinstance(value, (int, float)):
                raise TypeError(f"option '{self.name}' expects float, got {value!r}")
            value = float(value)
            if self.low is not None and not (self.low <= value <= self.high):
                raise ValueError(
                    f"option '{self.name}'={value} outside range "
                    f"[{self.low}, {self.high}]"
                )
            return value
        if self.otype == "enum":
            if value not in self.values:
                raise ValueError(
                    f"option '{self.name}'={value!r} not one of {self.values}"
                )
            return value
        raise AssertionError(f"unknown option type {self.otype}")


class OptionRegistry:
    """Dictionary-like registry of typed options with set-tracking.

    Equivalent in role to ``ParOptOptions`` (``ParOptOptions.h:20-61``): options
    self-document (default + range + docstring), remember whether the user set
    them, and are iterable for auto-generated docs / driver integration.
    """

    def __init__(self) -> None:
        self._desc: Dict[str, OptionDescriptor] = {}
        self._values: Dict[str, Any] = {}
        self._is_set: Dict[str, bool] = {}

    # -- registration -------------------------------------------------------
    def add(self, desc: OptionDescriptor) -> None:
        if desc.name in self._desc:
            # Same-named registrations must agree (e.g. 'output_level' is
            # registered by IP, TR and MMA alike in the reference).
            return
        self._desc[desc.name] = desc
        self._values[desc.name] = desc.default
        self._is_set[desc.name] = False

    def add_string(self, name: str, default: Optional[str], doc: str = "") -> None:
        self.add(OptionDescriptor(name, "str", default, doc=doc))

    def add_bool(self, name: str, default: bool, doc: str = "") -> None:
        self.add(OptionDescriptor(name, "bool", bool(default), doc=doc))

    def add_int(self, name: str, default: int, low: int, high: int, doc: str = "") -> None:
        self.add(OptionDescriptor(name, "int", default, low, high, doc=doc))

    def add_float(
        self, name: str, default: float, low: float, high: float, doc: str = ""
    ) -> None:
        self.add(OptionDescriptor(name, "float", default, low, high, doc=doc))

    def add_enum(
        self, name: str, default: str, values: Sequence[str], doc: str = ""
    ) -> None:
        self.add(OptionDescriptor(name, "enum", default, values=tuple(values), doc=doc))

    # -- access -------------------------------------------------------------
    def __contains__(self, name: str) -> bool:
        return name in self._desc

    def __getitem__(self, name: str) -> Any:
        try:
            return self._values[name]
        except KeyError:
            raise KeyError(f"unknown option '{name}'") from None

    def __setitem__(self, name: str, value: Any) -> None:
        if name not in self._desc:
            raise KeyError(f"unknown option '{name}'")
        self._values[name] = self._desc[name].validate(value)
        self._is_set[name] = True

    def get(self, name: str, default: Any = None) -> Any:
        return self._values.get(name, default)

    def is_set(self, name: str) -> bool:
        return self._is_set.get(name, False)

    def descriptor(self, name: str) -> OptionDescriptor:
        return self._desc[name]

    def update(self, values: Optional[Dict[str, Any]]) -> "OptionRegistry":
        if values:
            for k, v in values.items():
                self[k] = v
        return self

    def __iter__(self) -> Iterator[str]:
        return iter(self._desc)

    def items(self):
        return self._values.items()

    def descriptors(self) -> Iterator[OptionDescriptor]:
        return iter(self._desc.values())

    def summary(self) -> str:
        """Human-readable option summary (``ParOptOptions::printSummary``)."""
        lines = []
        for name in self._desc:
            mark = "*" if self._is_set[name] else " "
            lines.append(f"{mark} {name} = {self._values[name]!r}")
        return "\n".join(lines)

    def copy(self) -> "OptionRegistry":
        out = OptionRegistry()
        out._desc = dict(self._desc)
        out._values = dict(self._values)
        out._is_set = dict(self._is_set)
        return out


# ---------------------------------------------------------------------------
# Default option tables (names/defaults/ranges match the reference).
# ---------------------------------------------------------------------------


def add_ip_options(opts: OptionRegistry) -> OptionRegistry:
    """Interior-point options (``ParOptInteriorPoint.cpp:536-727``)."""
    o = opts
    o.add_string("output_file", "paropt.out", "Output file name")
    o.add_string("problem_name", None, "The problem name")
    o.add_float("max_bound_value", 1e20, 0.0, 1e300,
                "Maximum bound value at which bound constraints are omitted")
    o.add_float("abs_res_tol", 1e-6, 0.0, 1e20, "Absolute stopping criterion")
    o.add_float("rel_func_tol", 0.0, 0.0, 1e20,
                "Relative function value stopping criterion")
    o.add_float("abs_step_tol", 0.0, 0.0, 1e20,
                "Absolute stopping norm on the step size")
    o.add_float("init_barrier_param", 0.1, 0.0, 1e20,
                "The initial value of the barrier parameter")
    o.add_float("penalty_gamma", 1000.0, 0.0, 1e20,
                "l1 penalty parameter applied to slack variables")
    o.add_float("penalty_descent_fraction", 0.3, 1e-6, 1.0,
                "Fraction of infeasibility used to enforce a descent direction")
    o.add_float("min_rho_penalty_search", 0.0, 0.0, 1e20,
                "Minimum value of the line search penalty parameter")
    o.add_float("init_rho_penalty_search", 0.0, 0.0, 1e20,
                "Initial value of the line search penalty parameter")
    o.add_float("armijo_constant", 1e-5, 0.0, 1.0,
                "The Armijo constant for the line search")
    o.add_float("monotone_barrier_fraction", 0.25, 0.0, 1.0,
                "Factor applied to the barrier update < 1")
    o.add_float("monotone_barrier_power", 1.1, 1.0, 10.0,
                "Exponent for barrier parameter update > 1")
    o.add_float("rel_bound_barrier", 1.0, 0.0, 1e20,
                "Relative factor applied to barrier parameter for bound constraints")
    o.add_float("min_fraction_to_boundary", 0.95, 0.0, 1.0,
                "Minimum fraction to the boundary rule < 1")
    o.add_float("qn_sigma", 0.0, 0.0, 1e20,
                "Scalar added to the diagonal of the quasi-Newton approximation > 0")
    o.add_float("nk_switch_tol", 1e-3, 0.0, 1e20,
                "Switch to the Newton-Krylov method at this residual tolerance")
    o.add_float("eisenstat_walker_alpha", 1.5, 0.0, 2.0,
                "Exponent in the Eisenstat-Walker INK forcing equation")
    o.add_float("eisenstat_walker_gamma", 1.0, 0.0, 1.0,
                "Multiplier in the Eisenstat-Walker INK forcing equation")
    o.add_float("max_gmres_rtol", 0.1, 0.0, 1.0,
                "The maximum relative tolerance used for GMRES, above this "
                "the quasi-Newton approximation is used")
    o.add_float("gmres_atol", 1e-30, 0.0, 1.0,
                "The absolute GMRES tolerance (almost never relevant)")
    o.add_float("function_precision", 1e-10, 0.0, 1.0,
                "The absolute precision of the function and constraints")
    o.add_float("design_precision", 1e-14, 0.0, 1.0,
                "The absolute precision of the design variables")
    o.add_float("start_affine_multiplier_min", 1.0, 0.0, 1e20,
                "Minimum multiplier for the affine step initialization strategy")
    o.add_bool("use_line_search", True, "Perform or skip the line search")
    o.add_bool("use_backtracking_alpha", False, "Perform a back-tracking line search")
    o.add_bool("sequential_linear_method", False,
               "Discard the quasi-Newton approximation (but not necessarily the "
               "exact Hessian)")
    o.add_bool("use_quasi_newton_update", True,
               "Update the quasi-Newton approximation at each iteration")
    o.add_bool("use_hvec_product", False, "Use or do not use Hessian-vector products")
    o.add_bool("use_diag_hessian", False,
               "Use or do not use the diagonal Hessian computation")
    o.add_bool("use_qn_gmres_precon", True,
               "Use or do not use the quasi-Newton method as a preconditioner")
    o.add_float("gradient_check_step_length", 1e-6, 0.0, 1.0,
                "Step length used to check the gradient")
    o.add_int("qn_subspace_size", 10, 0, 1000,
              "The maximum dimension of the quasi-Newton approximation")
    o.add_int("max_major_iters", 5000, 0, 1000000,
              "The maximum number of major iterations before quiting")
    o.add_int("max_line_iters", 10, 1, 100, "Maximum number of line search iterations")
    o.add_int("iterative_refinement_steps", 1, 0, 10,
              "Number of iterative refinement steps performed in the KKT system "
              "solution procedure")
    o.add_int("gmres_subspace_size", 0, 0, 1000, "The subspace size for GMRES")
    o.add_int("write_output_frequency", 10, 0, 1000000,
              "Write out the solution file and checkpoint file at this frequency")
    o.add_int("step_verification_frequency", -1, -1000000, 1000000,
              "Print to screen the output of the step check at this frequency "
              "during an optimization")
    o.add_int("gradient_verification_frequency", -1, -1000000, 1000000,
              "Print to screen the output of the gradient check at this frequency "
              "during an optimization")
    o.add_int("hessian_reset_freq", 1000000, 1, 1000000,
              "Do a hard reset of the Hessian at this specified major iteration "
              "frequency")
    o.add_int("output_level", 0, 0, 1000000,
              "Output level indicating how verbose the output should be")
    o.add_enum("qn_type", "bfgs", ("bfgs", "scaled_bfgs", "sr1", "none"),
               "The type of quasi-Newton approximation to use, note that "
               "scaled_bfgs should be only used when there's single constraint "
               "and objective is linear")
    o.add_enum("qn_update_type", "skip_negative_curvature",
               ("skip_negative_curvature", "damped_update"),
               "The type of BFGS update to apply when the curvature condition fails")
    o.add_enum("qn_diag_type", "yty_over_yts",
               ("yty_over_yts", "yts_over_sts", "inner_yty_over_yts",
                "inner_yts_over_sts"),
               "The type of initial diagonal to use in the quasi-Newton "
               "approximation")
    o.add_enum("norm_type", "infinity", ("infinity", "l1", "l2"),
               "The type of norm to use in all computations")
    o.add_enum("barrier_strategy", "monotone",
               ("monotone", "mehrotra", "mehrotra_predictor_corrector",
                "complementarity_fraction"),
               "The type of barrier update strategy to use")
    o.add_enum("starting_point_strategy", "affine_step",
               ("least_squares_multipliers", "affine_step", "no_start_strategy"),
               "Initialize the Lagrange multiplier estimates and slack variables")
    # Extensions (not in the reference):
    o.add_enum("dtype", "float64", ("float64", "float32"),
               "Floating-point precision of the optimizer state and KKT solves")
    o.add_enum("qn_storage_dtype", "auto", ("auto", "native", "bfloat16"),
               "Storage dtype of the quasi-Newton ring buffer and the factor's "
               "Phi stacks (a device-memory bandwidth knob). 'auto' = "
               "bfloat16 when computing in float32 on an accelerator, "
               "otherwise native; 'native' = optimizer dtype")
    o.add_bool("qn_subspace_auto",
               False,
               "Shrink qn_subspace_size on large bandwidth-bound problems "
               "(a device-memory knob): the QN machinery's per-iteration "
               "memory traffic scales ~linearly with the subspace size, "
               "and on the >= 0.5M-variable f32 topology workload msub=5 "
               "converges in the same iterations as msub=10. 'auto' caps "
               "the "
               "subspace at 5 when nvars >= 2^19 in 32-bit precision; "
               "smaller problems keep the requested size")
    return o


def add_tr_options(opts: OptionRegistry) -> OptionRegistry:
    """Trust-region options (``ParOptTrustRegion.cpp:739-847``)."""
    o = opts
    o.add_string("tr_output_file", "paropt.tr", "Trust region output file")
    o.add_int("output_level", 0, 0, 1000000,
              "Output level indicating how verbose the output should be")
    o.add_float("tr_init_size", 0.1, 0.0, 1e20, "The initial trust region radius")
    o.add_float("tr_min_size", 1e-3, 0.0, 1e20, "The minimum trust region radius")
    o.add_float("tr_max_size", 1.0, 0.0, 1e20, "The maximum trust region radius")
    o.add_float("tr_eta", 0.25, 0.0, 1.0, "Trust region trial step acceptance ratio")
    o.add_float("tr_bound_relax", 1e-4, 0.0, 1e20,
                "Upper and lower bound relaxing parameter")
    o.add_int("tr_write_output_frequency", 10, 0, 1000000, "Write output frequency")
    o.add_float("function_precision", 1e-10, 0.0, 1.0,
                "The absolute precision of the function and constraints")
    o.add_float("design_precision", 1e-14, 0.0, 1.0,
                "The absolute precision of the design variables")
    o.add_bool("tr_adaptive_gamma_update", True, "Adaptive penalty parameter update")
    o.add_enum("tr_accept_step_strategy", "penalty_method",
               ("penalty_method", "filter_method"),
               "Which strategy to use to decide if a trial point can be accepted "
               "or not")
    o.add_bool("filter_sufficient_reduction", True,
               "Use sufficient reduction criteria for filter")
    o.add_float("filter_gamma", 1e-5, 0.0, 1.0,
                "A small value that controls slanting envelope of the filter")
    o.add_bool("filter_has_feas_restore_phase", True,
               "Use feasibility restoration for filter method")
    o.add_bool("tr_use_soc", False,
               "Use second order correction when trial step is rejected")
    o.add_bool("tr_soc_update_qn", False,
               "Update quasi-Newton approximation in second order correction steps")
    o.add_int("tr_max_soc_iterations", 20, 0, 1000000,
              "Maximum number of second-order-correction iterations")
    o.add_int("tr_max_iterations", 200, 0, 1000000,
              "Maximum number of trust region iterations")
    o.add_float("tr_l1_tol", 1e-6, 0.0, 1e20,
                "l1 tolerance for the optimality tolerance")
    o.add_float("tr_linfty_tol", 1e-6, 0.0, 1e20,
                "l-infinity tolerance for the optimality tolerance")
    o.add_float("tr_infeas_tol", 1e-5, 0.0, 1e20, "Infeasibility tolerance")
    o.add_float("tr_penalty_gamma_max", 1e4, 0.0, 1e20,
                "Maximum value for the penalty parameter")
    o.add_float("tr_penalty_gamma_min", 0.0, 0.0, 1e20,
                "Minimum value for the penalty parameter")
    o.add_enum("tr_adaptive_objective", "linear_objective",
               ("constant_objective", "linear_objective", "subproblem_objective"),
               "The type of objective to use for the adaptive penalty subproblem")
    o.add_enum("tr_adaptive_constraint", "linear_constraint",
               ("linear_constraint", "subproblem_constraint"),
               "The type of constraint to use for the adaptive penalty subproblem")
    o.add_enum("tr_steering_barrier_strategy", "mehrotra_predictor_corrector",
               ("monotone", "mehrotra", "mehrotra_predictor_corrector",
                "complementarity_fraction", "default"),
               "The barrier update strategy to use for the steering method "
               "subproblem")
    o.add_enum("tr_steering_starting_point_strategy", "affine_step",
               ("least_squares_multipliers", "affine_step", "no_start_strategy",
                "default"),
               "The starting point strategy to use for the steering method "
               "subproblem")
    return o


def add_mma_options(opts: OptionRegistry) -> OptionRegistry:
    """MMA options (``ParOptMMA.cpp:234-289``)."""
    o = opts
    o.add_string("mma_output_file", "paropt.mma", "Ouput file name for MMA")
    o.add_int("mma_max_iterations", 200, 0, 1000000, "Maximum number of iterations")
    o.add_float("mma_l1_tol", 1e-6, 0.0, 1e20,
                "l1 tolerance for the optimality tolerance")
    o.add_float("mma_linfty_tol", 1e-6, 0.0, 1e20,
                "l-infinity tolerance for the optimality tolerance")
    o.add_float("mma_infeas_tol", 1e-5, 0.0, 1e20, "Infeasibility tolerance")
    o.add_int("output_level", 0, 0, 1000000,
              "Output level indicating how verbose the output should be")
    o.add_bool("mma_use_constraint_linearization", False,
               "Use a linearization of the constraints in the MMA subproblem")
    o.add_float("mma_asymptote_contract", 0.7, 0.0, 1.0,
                "Contraction factor applied to the asymptotes")
    o.add_float("mma_asymptote_relax", 1.2, 1.0, 1e20,
                "Expansion factor applied to the asymptotes")
    o.add_float("mma_init_asymptote_offset", 0.5, 0.0, 1.0,
                "Initial asymptote offset from the variable bounds")
    o.add_float("mma_min_asymptote_offset", 0.01, 0.0, 1e20,
                "Minimum asymptote offset from the variable bounds")
    o.add_float("mma_max_asymptote_offset", 10.0, 0.0, 1e20,
                "Maximum asymptote offset from the variable bounds")
    o.add_float("mma_bound_relax", 0.0, 0.0, 1e20,
                "Relaxation bound for computing the error in the KKT conditions")
    o.add_float("mma_eps_regularization", 1e-5, 0.0, 1e20,
                "Regularization term applied in the MMA approximation")
    o.add_float("mma_delta_regularization", 1e-3, 0.0, 1e20,
                "Regularization term applied in the MMA approximation")
    o.add_float("mma_move_limit", 0.2, 0.0, 1e20,
                "Move limit for design variables to prevent oscillation")
    # Extension (not in the reference): the reference's
    # absolute l1/linfty stationarity tests (`ParOptMMA.cpp:406-488`) sit
    # at dtype-noise level for float32 at 10^6+ variables (the projected
    # gradient cannot cancel below ~eps*|g|); 'gradient' scales the
    # tolerances by max(1, ||g||_1) / max(1, ||g||_inf) of the objective
    # gradient, making the criterion dtype- and n-aware (a RELATIVE
    # stationarity measure).
    o.add_enum("mma_kkt_error_scaling", "none", ("none", "gradient"),
               "Scaling of the MMA KKT stationarity tolerances: 'none' = "
               "absolute (reference behavior); 'gradient' = relative to the "
               "objective gradient norms (use for float32 / large n)")
    # Extension (not in the reference): in float32 the MMA
    # outer loop stalls at an arithmetic-noise stationarity floor well
    # above the double-precision tolerances (the inner-solve accuracy
    # limits the multiplier quality, so l1 saw-tooths instead of
    # converging).  A no-improvement window — the analogue of the
    # reference IP's own no-improvement exit
    # (`ParOptInteriorPoint.cpp:4649-4684`) — terminates at the achievable
    # floor whatever the dtype/n: stop (converged, stalled=True) when the
    # best l1 stationarity has not improved for this many consecutive
    # outer iterations AND the iterate is feasible.  0 disables.
    o.add_int("mma_max_no_improvement", 0, 0, 1000000,
              "Terminate MMA (converged, stalled flagged) when the best l1 "
              "stationarity has not improved for this many consecutive "
              "outer iterations AND the current iterate is feasible "
              "(0 = disabled; dtype/n-robust stopping for float32)")
    return o


def add_facade_options(opts: OptionRegistry) -> OptionRegistry:
    """Facade options (``ParOptOptimizer.cpp:39-50``)."""
    opts.add_enum("algorithm", "tr", ("ip", "tr", "mma"),
                  "The type of optimization algorithm")
    opts.add_string("ip_checkpoint_file", None,
                    "Checkpoint file for the interior point method")
    # Extension (not in the reference): route the facade to
    # the fused whole-loop solvers (FusedIP/FusedTR/FusedMMA) — the entire
    # outer loop runs as one XLA computation with zero host round-trips.
    # Requires a jax-native problem (autodiff gradients, constant sparse
    # Jacobian pattern); host-callback problems keep the host loops.
    opts.add_bool("use_fused_loop", False,
                  "Run the selected algorithm's WHOLE loop on-device "
                  "(fused lax.while_loop solvers; jax-native problems only)")
    return opts


def make_options(values: Optional[Dict[str, Any]] = None,
                 which: str = "all") -> OptionRegistry:
    """Build a full registry (IP + TR + MMA + facade) and apply user values."""
    opts = OptionRegistry()
    if which in ("all", "facade"):
        add_facade_options(opts)
    if which in ("all", "ip", "facade"):
        add_ip_options(opts)
    if which in ("all", "tr", "facade"):
        add_tr_options(opts)
    if which in ("all", "mma", "facade"):
        add_mma_options(opts)
    return opts.update(values)
