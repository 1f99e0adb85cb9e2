"""paropt_tpu — a JAX-native large-scale nonlinear-programming framework.

A ground-up JAX/XLA re-design with the capabilities of smdogroup/paropt:
interior-point, l∞ trust-region / SL1QP and MMA optimizers for problems with a
distributed (mesh-sharded) design vector, a few dense global constraints, many
separable sparse weighting constraints, and bound constraints.  See SURVEY.md
for the structural analysis of the reference this build follows.

Precision note: the optimizers default to float64 (the reference is double
everywhere); importing this package enables jax x64 mode unless the
environment variable PAROPT_TPU_NO_X64 is set to a non-empty value, in which
case float32 is the default.
"""

import os as _os

import jax as _jax

if not _os.environ.get("PAROPT_TPU_NO_X64"):
    try:
        _jax.config.update("jax_enable_x64", True)
    except Exception:  # pragma: no cover - config locked after init
        pass

from .problem import Problem, SparseJacobian, check_gradients  # noqa: E402
from .ip import InteriorPoint  # noqa: E402
from .utils.options import make_options, OptionRegistry  # noqa: E402
from .utils.logging import (unpack_output, unpack_tr_output,  # noqa: E402
                            unpack_mma_output)
from .ops.qn import qn_init, QNState  # noqa: E402

__all__ = [
    "Problem", "SparseJacobian", "check_gradients", "InteriorPoint",
    "make_options", "OptionRegistry", "unpack_output", "unpack_tr_output",
    "unpack_mma_output", "qn_init", "QNState",
]

__version__ = "0.1.0"


def __getattr__(name):
    # heavier optional modules loaded lazily
    if name == "TrustRegion":
        from .tr import TrustRegion
        return TrustRegion
    if name == "MMA":
        from .mma import MMA
        return MMA
    if name == "Optimizer":
        from .optimizer import Optimizer
        return Optimizer
    if name == "ReducedProblem":
        from .reduced import ReducedProblem
        return ReducedProblem
    if name == "FusedMMA":
        from .mma import FusedMMA
        return FusedMMA
    if name == "FusedTR":
        from .tr import FusedTR
        return FusedTR
    if name == "FusedIP":
        from .ip_fused import FusedIP
        return FusedIP
    raise AttributeError(name)
