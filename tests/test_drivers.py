"""Driver-layer tests: FunctionProblem (callback adapter) + plot_history
+ import-gating of the pyOptSparse/OpenMDAO drivers."""

import importlib.util

import numpy as np
import pytest

from paropt_tpu import InteriorPoint
from paropt_tpu.drivers import FunctionProblem


def test_function_problem_with_gradients():
    Q = np.diag([1.0, 2.0, 3.0])
    prob = FunctionProblem(
        x0=[2.0, 2.0, 2.0], lb=[-5] * 3, ub=[5] * 3,
        objective=lambda x: 0.5 * x @ Q @ x,
        gradient=lambda x: Q @ x,
        constraints=lambda x: np.array([x.sum() - 1.0]),
        jacobian=lambda x: np.ones((1, 3)))
    ip = InteriorPoint(prob, {"output_file": None, "abs_res_tol": 1e-8})
    res = ip.optimize()
    assert res["converged"], res
    x = np.asarray(res["x"])
    # analytic solution of min 1/2 x'Qx st sum(x)=1 active:
    # x = lambda * Q^{-1} 1 with sum = 1
    qinv1 = np.linalg.solve(Q, np.ones(3))
    want = qinv1 / qinv1.sum()
    assert np.allclose(x, want, atol=1e-5), (x, want)


def test_function_problem_fd_gradients():
    prob = FunctionProblem(
        x0=[0.0, 0.0], lb=[-2] * 2, ub=[2] * 2,
        objective=lambda x: (x[0] - 1.0) ** 2 + (x[1] + 0.5) ** 2)
    ip = InteriorPoint(prob, {"output_file": None, "abs_res_tol": 1e-5})
    res = ip.optimize()
    assert res["converged"], res
    assert np.allclose(np.asarray(res["x"]), [1.0, -0.5], atol=1e-3)
    assert prob.ngeval > 0


def test_plot_history(tmp_path):
    from paropt_tpu.models.analytic import Rosenbrock
    from paropt_tpu.utils.plot_history import plot_history
    path = str(tmp_path / "paropt.out")
    ip = InteriorPoint(Rosenbrock(), {"output_file": path,
                                      "abs_res_tol": 1e-6})
    ip.optimize()
    out = str(tmp_path / "hist.png")
    fig = plot_history(path, output=out)
    assert fig is not None
    import os
    assert os.path.exists(out)


@pytest.mark.skipif(importlib.util.find_spec("pyoptsparse") is None,
                    reason="pyoptsparse not installed")
def test_pyoptsparse_driver_import():
    from paropt_tpu.drivers.pyoptsparse_driver import ParOpt  # noqa: F401


@pytest.mark.skipif(importlib.util.find_spec("openmdao") is None,
                    reason="openmdao not installed")
def test_openmdao_driver_import():
    from paropt_tpu.drivers.openmdao_driver import ParOptDriver  # noqa: F401


@pytest.mark.skipif(importlib.util.find_spec("openmdao") is None,
                    reason="openmdao not installed")
def test_openmdao_sparse_driver_import():
    from paropt_tpu.drivers.openmdao_sparse_driver import (  # noqa: F401
        ParOptSparseDriver)


def test_plot_history_tr_and_mma_logs(tmp_path):
    """plot_history renders TR and MMA logs too (the reference's
    plot_history.py handles all three formats)."""
    import matplotlib
    matplotlib.use("Agg")
    from paropt_tpu.models.analytic import Rosenbrock
    from paropt_tpu.optimizer import Optimizer
    from paropt_tpu.utils.plot_history import plot_history

    tr_log = str(tmp_path / "paropt.tr")
    Optimizer(Rosenbrock(), {"algorithm": "tr", "output_file": None,
                             "tr_output_file": tr_log,
                             "tr_max_iterations": 15}).optimize()
    fig = plot_history(tr_log)
    assert fig is not None

    mma_log = str(tmp_path / "paropt.mma")
    Optimizer(Rosenbrock(), {"algorithm": "mma", "output_file": None,
                             "mma_output_file": mma_log,
                             "mma_max_iterations": 10}).optimize()
    fig = plot_history(mma_log)
    assert fig is not None


def test_ip_checkpoint_cadence(tmp_path):
    """`optimize(checkpoint=path)` writes the solution file every
    write_output_frequency iterations and the result resumes
    (`ParOptInteriorPoint.cpp:4620-4629` role, facade option
    ip_checkpoint_file)."""
    import os
    from paropt_tpu.models.analytic import Rosenbrock
    from paropt_tpu.optimizer import Optimizer

    ckpt = str(tmp_path / "state.npz")
    opt = Optimizer(Rosenbrock(), {
        "algorithm": "ip", "output_file": None,
        "write_output_frequency": 5, "ip_checkpoint_file": ckpt,
        "max_major_iters": 120, "abs_res_tol": 1e-8})
    res = opt.optimize()
    assert res["converged"]
    assert os.path.exists(ckpt)
    # resume from the checkpoint: immediately (re)converges
    ip2 = InteriorPoint(Rosenbrock(), {"output_file": None,
                                       "abs_res_tol": 1e-8})
    ip2.read_solution_file(ckpt)
    res2 = ip2.optimize()
    assert res2["converged"]


def _install_fake_openmdao(monkeypatch):
    import sys
    import types
    from tests import _fake_openmdao as fake

    om_api = types.ModuleType("openmdao.api")
    om_api.Driver = fake.Driver
    om_pkg = types.ModuleType("openmdao")
    om_pkg.api = om_api
    monkeypatch.setitem(sys.modules, "openmdao", om_pkg)
    monkeypatch.setitem(sys.modules, "openmdao.api", om_api)
    return fake


def test_openmdao_driver_with_fake(monkeypatch):
    """Drive ParOptDriver end-to-end against a minimal OpenMDAO stand-in:
    bound/constraint transcription, gradients via compute_totals, and the
    final design pushed back into the model."""
    import importlib
    import sys
    fake = _install_fake_openmdao(monkeypatch)
    for mod in ("paropt_tpu.drivers.openmdao_driver",
                "paropt_tpu.drivers.openmdao_sparse_driver"):
        sys.modules.pop(mod, None)
    drv_mod = importlib.import_module("paropt_tpu.drivers.openmdao_driver")

    om_prob = fake.QuadProblem(n=6)
    driver = drv_mod.ParOptDriver()
    driver.options["algorithm"] = "ip"
    driver.options["output_file"] = None
    driver.options["abs_res_tol"] = 1e-8
    driver._setup_driver(om_prob)
    failed = driver.run()
    assert not failed
    x = om_prob.vals["x"]
    # optimum: x_i = 0.8 is NOT active (sum(x)=6*1 > 2); x -> target but
    # capped by local <= 0.8
    assert np.allclose(x, 0.8, atol=1e-3), x


def test_openmdao_sparse_driver_with_fake(monkeypatch):
    """ParOptSparseDriver routes the per-element constraint through the
    separable CSR path."""
    import importlib
    import sys
    fake = _install_fake_openmdao(monkeypatch)
    for mod in ("paropt_tpu.drivers.openmdao_driver",
                "paropt_tpu.drivers.openmdao_sparse_driver"):
        sys.modules.pop(mod, None)
    drv_mod = importlib.import_module(
        "paropt_tpu.drivers.openmdao_sparse_driver")

    om_prob = fake.QuadProblem(n=6)
    driver = drv_mod.ParOptSparseDriver()
    driver.options["algorithm"] = "ip"
    driver.options["output_file"] = None
    driver.options["abs_res_tol"] = 1e-8
    driver._setup_driver(om_prob)
    driver.set_sparse_constraints(["local"])
    failed = driver.run()
    assert not failed
    x = om_prob.vals["x"]
    assert np.allclose(x, 0.8, atol=1e-3), x
    # the per-element constraints went through the CSR sparse path (nwcon),
    # not the dense Schur block
    adapter = driver._paropt_problem
    assert adapter.nwcon == 6, adapter.nwcon
    assert adapter.ncon == 1, adapter.ncon  # only the global sum stays dense
    assert adapter.csr_rowp[-1] == adapter.nwcon * 6  # dense-row fallback


def test_facade_use_fused_loop_routes_all_algorithms():
    """extension option `use_fused_loop`: the facade runs the WHOLE
    selected loop on-device (FusedIP/FusedTR/FusedMMA) and matches the
    host loops' solutions on a jax-native problem."""
    import numpy as np
    from paropt_tpu.models.fem_topology import FEMTopology
    from paropt_tpu.optimizer import Optimizer

    def build():
        return FEMTopology(nex=8, ney=4, cg_iters=25, solver="mgcg")

    # ip: fused whole-solve matches the host InteriorPoint result
    base = {"output_file": None, "abs_res_tol": 1e-6,
            "max_major_iters": 150}
    res_host = Optimizer(build(), {"algorithm": "ip", **base}).optimize()
    opt = Optimizer(build(), {"algorithm": "ip", "use_fused_loop": True,
                              **base})
    res_f = opt.optimize()
    assert res_f["converged"]
    np.testing.assert_allclose(res_f["fobj"], res_host["fobj"], rtol=1e-5)
    x, z, zw, zl, zu = opt.get_optimized_point()
    assert x.shape == (32,) and zl.shape == (32,)

    # tr: fused SL1QP loop runs and improves compliance
    tro = {"algorithm": "tr", "use_fused_loop": True, "output_file": None,
           "tr_output_file": None, "tr_max_iterations": 10}
    opt = Optimizer(build(), tro)
    res_tr = opt.optimize()
    assert res_tr["fobj"] < 0.9 and res_tr["infeas"] < 1e-6

    # mma: fused loop + multipliers through getOptimizedPoint
    mo = {"algorithm": "mma", "use_fused_loop": True, "output_file": None,
          "mma_output_file": None, "mma_max_iterations": 10}
    opt = Optimizer(build(), mo)
    res_mma = opt.optimize()
    assert res_mma["fobj"] < 0.9
    x, z, zw, zl, zu = opt.get_optimized_point()
    assert x.shape == (32,) and z.shape == (1,)


def test_use_fused_loop_rejects_callback_problems():
    """Fill-callback (compat) problems cannot trace under jit: the facade
    must reject use_fused_loop with a clear error, not a tracer leak."""
    import pytest
    from paropt_tpu import compat as ParOpt
    from paropt_tpu.optimizer import Optimizer

    class P(ParOpt.Problem):
        def __init__(self):
            super().__init__(nvars=2, ncon=1)

        def getVarsAndBounds(self, x, lb, ub):
            x[:] = 0.5
            lb[:] = -1.0
            ub[:] = 2.0

        def evalObjCon(self, x):
            import numpy as np
            return 0, float(np.sum(x ** 2)), np.array([x[0] + x[1]])

        def evalObjConGradient(self, x, g, A):
            g[:] = 2 * x
            A[0][:] = 1.0
            return 0

    opt = Optimizer(P(), {"algorithm": "tr", "use_fused_loop": True,
                          "output_file": None, "tr_output_file": None})
    with pytest.raises(ValueError, match="jax-native"):
        opt.optimize()
