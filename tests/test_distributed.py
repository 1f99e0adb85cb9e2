"""REAL multi-process execution: 2 `jax.distributed` CPU processes run the
fused IP solve over the hybrid (process x local-device) mesh and must
reproduce the single-process trajectory.

This is the analogue of the reference's `mpirun -np N` deployment mode —
every vector op rank-distributed, all coupling collective
(`ParOptVec.cpp:63-143`; 124 MPI call sites in `ParOptInteriorPoint.cpp`).
Here each process owns 2 virtual CPU devices; cross-process collectives run
over gloo (the DCN stand-in), exercising `parallel/sharding.init_distributed`
and `hybrid_design_mesh` end-to-end."""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "distributed_solve.py")
FEM_WORKER = os.path.join(REPO, "scripts", "distributed_fem_mma.py")

N = 16384
TOL = 1e-6
MAX_ITERS = 120
MSUB = 10


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker_env(local_devices):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={local_devices}")
    # share the suite's persistent compilation cache
    env.setdefault("JAX_COMPILATION_CACHE_DIR",
                   os.path.join(REPO, "tests", ".jax_cache"))
    return env


def _single_process_trajectory():
    """The same solve, in-process, over a 1-D 4-device mesh (the same
    4-block design-axis layout the 2x2 hybrid mesh produces)."""
    from paropt_tpu import ip_fused
    from paropt_tpu.models.topology import SyntheticTopology
    from paropt_tpu.ops import qn as qnmod
    from paropt_tpu.parallel import sharding as shlib

    prob = SyntheticTopology(n=N, block=8, dtype=jnp.float64)
    model = ip_fused.model_from_problem(prob)
    opts = ip_fused.FusedIPOptions(use_quasi_newton_update=True,
                                   abs_res_tol=TOL,
                                   max_major_iters=MAX_ITERS)
    fused = ip_fused.FusedIP(model, prob.nvars, prob.ncon, prob.nwcon,
                             prob.nwblock, opts, dtype=jnp.float64)
    data, x0 = ip_fused.data_template_from_problem(prob, dtype=jnp.float64)
    qn0 = qnmod.qn_init(MSUB, prob.nvars, dtype=jnp.float64)

    mesh = shlib.design_mesh(devices=jax.devices()[:4])

    def place(leaf):
        leaf = jnp.asarray(leaf)
        if leaf.ndim >= 1 and leaf.shape[-1] == N:
            sh = (shlib.design_sharding(mesh) if leaf.ndim == 1
                  else shlib.row_sharding(mesh))
            return jax.device_put(leaf, sh)
        return jax.device_put(leaf, shlib.replicated_sharding(mesh))

    state = jax.tree_util.tree_map(place, fused.init(x0, data, (), qn0,
                                                     None))
    data = jax.tree_util.tree_map(place, data)
    traj = []
    for _ in range(MAX_ITERS):
        state = fused.step(state, data, (), None)
        traj.append({"k": int(state.k), "fobj": float(state.fobj),
                     "res": float(state.res_norm), "mu": float(state.mu)})
        if bool(state.converged):
            break
    return traj, bool(state.converged)


@pytest.fixture(scope="module")
def single_process_baseline():
    traj, conv = _single_process_trajectory()
    assert conv
    return traj


# rank-count-agnostic, like the reference's testflo N_PROCS runs: the same
# 4-block design-axis layout reached as 2 procs x 2 devices and as
# 4 procs x 1 device must both reproduce the single-process trajectory
@pytest.mark.parametrize("nproc,local", [(2, 2), (4, 1)])
def test_multi_process_solve_matches_single_process(
        nproc, local, tmp_path, single_process_baseline):
    port = _free_port()
    procs, outs = [], []
    for pid in range(nproc):
        out = tmp_path / f"rank{pid}.json"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER,
             "--process-id", str(pid), "--num-processes", str(nproc),
             "--port", str(port), "--local-devices", str(local),
             "--n", str(N), "--tol", str(TOL),
             "--max-iters", str(MAX_ITERS), "--msub", str(MSUB),
             "--out", str(out)],
            env=_worker_env(local), stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True))

    single_traj = single_process_baseline

    for p in procs:
        _, err = p.communicate(timeout=540)
        assert p.returncode == 0, err[-4000:]

    ranks = [json.loads(out.read_text()) for out in outs]
    # the multi-process run used the FULL global device view
    assert ranks[0]["num_processes"] == nproc
    assert ranks[0]["global_devices"] == nproc * local

    # (a) SPMD determinism: every process observed the identical trajectory
    # (the analogue of the reference's root-broadcast branch discipline)
    for r in ranks[1:]:
        assert r["trajectory"] == ranks[0]["trajectory"]
        assert r["converged"]
    assert ranks[0]["converged"]

    # (b) trajectory identity with the single-process run, iteration by
    # iteration (same reduction structure; only fp association may differ
    # between gloo cross-process all-reduce and in-process all-reduce)
    mp = ranks[0]["trajectory"]
    assert len(mp) == len(single_traj)
    for a, b in zip(mp, single_traj):
        assert a["k"] == b["k"]
        np.testing.assert_allclose(a["fobj"], b["fobj"], rtol=1e-10)
        np.testing.assert_allclose(a["res"], b["res"], rtol=1e-7)
        np.testing.assert_allclose(a["mu"], b["mu"], rtol=1e-10)


# ---------------------------------------------------------------------------
# Flagship FEM workload cross-process: the stencil matvec halo exchanges and
# multigrid restriction/prolongation are the most sharding-sensitive code in
# the framework — 2 real processes must reproduce the
# single-process FusedMMA trajectory.
# ---------------------------------------------------------------------------

FEM_NEX, FEM_NEY, FEM_ITERS = 16, 8, 8


def _fem_single_process_trajectory():
    from paropt_tpu.mma import FusedMMA
    from paropt_tpu.models.fem_topology import FEMTopology
    from paropt_tpu.parallel import sharding as shlib

    prob = FEMTopology(nex=FEM_NEX, ney=FEM_NEY, cg_iters=25,
                       solver="mgcg")
    solver = FusedMMA(prob, {"mma_max_iterations": FEM_ITERS,
                             "mma_output_file": None, "dtype": "float64"})
    mesh = shlib.design_mesh(devices=jax.devices()[:4])
    n = prob.nvars

    def place(leaf):
        leaf = jnp.asarray(leaf)
        if leaf.ndim >= 1 and leaf.shape[-1] == n:
            sh = (shlib.design_sharding(mesh) if leaf.ndim == 1
                  else shlib.row_sharding(mesh))
            return jax.device_put(leaf, sh)
        return jax.device_put(leaf, shlib.replicated_sharding(mesh))

    state = jax.tree_util.tree_map(place, solver._state0)
    traj = []
    for _ in range(FEM_ITERS):
        state = solver._step_jit(state)
        traj.append({"k": int(state.k), "fobj": float(state.fobj),
                     "infeas": float(state.infeas),
                     "l1": float(state.l1)})
        if bool(state.converged):
            break
    return traj


def test_multi_process_fem_mma_matches_single_process(tmp_path):
    nproc, local = 2, 2
    port = _free_port()
    procs, outs = [], []
    for pid in range(nproc):
        out = tmp_path / f"fem_rank{pid}.json"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, FEM_WORKER,
             "--process-id", str(pid), "--num-processes", str(nproc),
             "--port", str(port), "--local-devices", str(local),
             "--nex", str(FEM_NEX), "--ney", str(FEM_NEY),
             "--max-iters", str(FEM_ITERS), "--out", str(out)],
            env=_worker_env(local), stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True))

    single_traj = _fem_single_process_trajectory()

    for p in procs:
        _, err = p.communicate(timeout=540)
        assert p.returncode == 0, err[-4000:]

    ranks = [json.loads(out.read_text()) for out in outs]
    assert ranks[0]["num_processes"] == nproc
    assert ranks[0]["global_devices"] == nproc * local

    # SPMD determinism across ranks
    for r in ranks[1:]:
        assert r["trajectory"] == ranks[0]["trajectory"]

    # trajectory identity with the single-process 4-device run (same
    # 4-block design-axis layout; only fp association may differ between
    # gloo cross-process and in-process all-reduce)
    mp = ranks[0]["trajectory"]
    assert len(mp) == len(single_traj)
    for a, b in zip(mp, single_traj):
        assert a["k"] == b["k"]
        np.testing.assert_allclose(a["fobj"], b["fobj"], rtol=1e-9)
        np.testing.assert_allclose(a["infeas"], b["infeas"], atol=1e-9)
        np.testing.assert_allclose(a["l1"], b["l1"], rtol=1e-6)


# ---------------------------------------------------------------------------
# 3-D grid-form path cross-process at 4 processes: the [3, nnx, nny, nnz]
# stencil's pad/slice pattern generates DIFFERENT collectives than the 2-D
# model (halos along three axes + the 3-D multigrid transfers), and 4
# single-device processes put every halo on the cross-process (gloo) leg.
# ---------------------------------------------------------------------------

FEM3D_NEX, FEM3D_NEY, FEM3D_NEZ, FEM3D_ITERS = 8, 4, 4, 6


def _fem3d_single_process_trajectory():
    from paropt_tpu.mma import FusedMMA
    from paropt_tpu.models.fem_topology3d import FEMTopology3D
    from paropt_tpu.parallel import sharding as shlib

    prob = FEMTopology3D(nex=FEM3D_NEX, ney=FEM3D_NEY, nez=FEM3D_NEZ,
                         cg_iters=25, solver="mgcg")
    solver = FusedMMA(prob, {"mma_max_iterations": FEM3D_ITERS,
                             "mma_output_file": None, "dtype": "float64"})
    mesh = shlib.design_mesh(devices=jax.devices()[:4])
    n = prob.nvars

    def place(leaf):
        leaf = jnp.asarray(leaf)
        if leaf.ndim >= 1 and leaf.shape[-1] == n:
            sh = (shlib.design_sharding(mesh) if leaf.ndim == 1
                  else shlib.row_sharding(mesh))
            return jax.device_put(leaf, sh)
        return jax.device_put(leaf, shlib.replicated_sharding(mesh))

    state = jax.tree_util.tree_map(place, solver._state0)
    traj = []
    for _ in range(FEM3D_ITERS):
        state = solver._step_jit(state)
        traj.append({"k": int(state.k), "fobj": float(state.fobj),
                     "infeas": float(state.infeas),
                     "l1": float(state.l1)})
        if bool(state.converged):
            break
    return traj


def test_four_process_fem3d_mma_matches_single_process(tmp_path):
    nproc, local = 4, 1
    port = _free_port()
    procs, outs = [], []
    for pid in range(nproc):
        out = tmp_path / f"fem3d_rank{pid}.json"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, FEM_WORKER,
             "--process-id", str(pid), "--num-processes", str(nproc),
             "--port", str(port), "--local-devices", str(local),
             "--nex", str(FEM3D_NEX), "--ney", str(FEM3D_NEY),
             "--nez", str(FEM3D_NEZ),
             "--max-iters", str(FEM3D_ITERS), "--out", str(out)],
            env=_worker_env(local), stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True))

    single_traj = _fem3d_single_process_trajectory()

    for p in procs:
        _, err = p.communicate(timeout=540)
        assert p.returncode == 0, err[-4000:]

    ranks = [json.loads(out.read_text()) for out in outs]
    assert ranks[0]["num_processes"] == nproc
    assert ranks[0]["global_devices"] == nproc * local

    # SPMD determinism across all 4 ranks
    for r in ranks[1:]:
        assert r["trajectory"] == ranks[0]["trajectory"]

    # trajectory identity with the single-process 4-device run
    mp = ranks[0]["trajectory"]
    assert len(mp) == len(single_traj)
    for a, b in zip(mp, single_traj):
        assert a["k"] == b["k"]
        np.testing.assert_allclose(a["fobj"], b["fobj"], rtol=1e-9)
        np.testing.assert_allclose(a["infeas"], b["infeas"], atol=1e-9)
        np.testing.assert_allclose(a["l1"], b["l1"], rtol=1e-6)
