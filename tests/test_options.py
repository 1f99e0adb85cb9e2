"""Typed option registry behavior (the ParOptOptions contract)."""

import pytest

from paropt_tpu import make_options
from paropt_tpu.utils.options import OptionRegistry, add_ip_options


def test_defaults_match_reference():
    o = make_options()
    # spot-check names/defaults against the reference registrations
    assert o["algorithm"] == "tr"
    assert o["abs_res_tol"] == 1e-6
    assert o["penalty_gamma"] == 1000.0
    assert o["qn_subspace_size"] == 10
    assert o["barrier_strategy"] == "monotone"
    assert o["starting_point_strategy"] == "affine_step"
    assert o["tr_eta"] == 0.25
    assert o["mma_asymptote_contract"] == 0.7
    assert o["max_major_iters"] == 5000


def test_type_and_range_validation():
    o = make_options()
    with pytest.raises(KeyError):
        o["no_such_option"] = 1
    with pytest.raises(ValueError):
        o["monotone_barrier_fraction"] = 1.5  # outside [0, 1]
    with pytest.raises(ValueError):
        o["barrier_strategy"] = "bogus"
    with pytest.raises(TypeError):
        o["max_major_iters"] = "many"
    o["abs_res_tol"] = 1e-8
    assert o.is_set("abs_res_tol")
    assert not o.is_set("rel_func_tol")


def test_introspection_for_autodoc():
    o = OptionRegistry()
    add_ip_options(o)
    descs = list(o.descriptors())
    assert all(d.doc for d in descs if d.name != "problem_name")
    names = [d.name for d in descs]
    assert "qn_type" in names and "norm_type" in names
    # summary marks set options
    o["abs_res_tol"] = 1e-9
    assert "* abs_res_tol" in o.summary()


def test_copy_independent():
    a = make_options()
    b = a.copy()
    b["abs_res_tol"] = 1e-12
    assert a["abs_res_tol"] == 1e-6


def test_option_registry_name_parity():
    """Every LIVE option registration in the reference sources has a
    matching entry here (audited 2026-08-17: 92/92; `soc_rank_gamma` is
    commented out in the reference; `dtype` is our documented an
    extension)."""
    from paropt_tpu.utils.options import make_options

    ours = set(make_options())
    # names present in the reference registration calls
    # (`ParOptInteriorPoint.cpp:536-727`, `ParOptTrustRegion.cpp:739-847`,
    # `ParOptMMA.cpp:234-289`, `ParOptOptimizer.cpp:39-50`)
    expected_absent = {"soc_rank_gamma"}          # commented out upstream
    extensions = {"dtype", "qn_storage_dtype", "qn_subspace_auto",
                  "mma_kkt_error_scaling",
                  "mma_max_no_improvement",
                  "use_fused_loop"}              # JAX-native extensions
    assert extensions <= ours
    assert not (expected_absent & ours)
    # spot-check a few from each group
    for name in ("abs_res_tol", "barrier_strategy", "qn_subspace_size",
                 "tr_adaptive_gamma_update", "tr_use_soc",
                 "mma_asymptote_contract", "algorithm",
                 "ip_checkpoint_file", "gmres_subspace_size",
                 "eisenstat_walker_gamma", "nk_switch_tol"):
        assert name in ours, name


def test_full_option_table_parity():
    """Mechanical parity check against the VENDORED reference option table.

    `reference_options.json` was extracted from the reference registration
    calls (`ParOptInteriorPoint.cpp:536-727`, `ParOptTrustRegion.cpp:739-847`,
    `ParOptMMA.cpp:234-289`, `ParOptOptimizer.cpp:39-50`; comment-stripped so
    the commented-out `soc_rank_gamma` is excluded). Renaming, dropping, or
    changing the default/range/enum-values of ANY option fails this test.
    """
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "reference_options.json")
    with open(path) as f:
        groups = json.load(f)
    ref = {}
    for grp in groups.values():
        for name, desc in grp.items():
            if name in ref:
                # output_level / function_precision / design_precision are
                # registered by more than one optimizer with identical specs
                assert ref[name] == desc, name
            ref[name] = desc

    ours = make_options()
    extensions = {"dtype", "qn_storage_dtype", "qn_subspace_auto",
                  "mma_kkt_error_scaling",
                  "mma_max_no_improvement",
                  "use_fused_loop"}  # documented JAX-native extensions
    assert set(ref) - set(ours) == set(), "missing reference options"
    assert set(ours) - set(ref) == extensions, "undocumented extra options"

    type_map = {"str": "str", "bool": "bool", "int": "int",
                "float": "float", "enum": "enum"}
    for name, spec in sorted(ref.items()):
        d = ours.descriptor(name)
        assert d.otype == type_map[spec["type"]], name
        assert ours[name] == spec["default"], (
            name, ours[name], spec["default"])
        if spec["type"] in ("int", "float"):
            assert float(d.low) == float(spec["low"]), name
            assert float(d.high) == float(spec["high"]), name
        if spec["type"] == "enum":
            assert list(d.values) == list(spec["values"]), name


def test_qn_subspace_auto_policy():
    """qn_subspace_auto: caps msub at 5 only for large bandwidth-bound
    32-bit problems; plumbed through the solvers."""
    import jax.numpy as jnp
    from paropt_tpu.ops.qn import resolve_subspace_size
    assert resolve_subspace_size(10, False, 1 << 20, jnp.float32) == 10
    assert resolve_subspace_size(10, True, 1 << 20, jnp.float32) == 5
    assert resolve_subspace_size(10, True, 1 << 20, jnp.float64) == 10
    assert resolve_subspace_size(10, True, 1 << 16, jnp.float32) == 10
    assert resolve_subspace_size(3, True, 1 << 20, jnp.float32) == 3

    # option accepted end-to-end (small problem: size unchanged)
    from paropt_tpu import InteriorPoint
    from paropt_tpu.models.analytic import Rosenbrock
    ip = InteriorPoint(Rosenbrock(), {"output_file": None,
                                      "abs_res_tol": 1e-8,
                                      "qn_subspace_auto": True})
    res = ip.optimize()
    assert res["converged"]
    assert ip.qn.msub == 10
