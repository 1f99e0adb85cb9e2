"""Time one 3-D multigrid-CG state solve with each stiffness layout.

    python scripts/fem3d_layout.py [--grid-from 48] [MESH ...]

For each mesh (default 32x16x16 160x80x80), `FEMTopology3D._solve` at the
uniform starting design, f64, 25 CG iterations, built twice: with
layout='auto' as shipped (the [ne, 24] AoS matmul on every multigrid level)
and with the grid-form stencil on the levels whose node-grid minor width is
at least --grid-from (0: every level).  Prints the device's name (and, on
an NVIDIA card, its power limit), then per build the best of 5 solves, the
first call including compilation, the compliance, and the largest gap
between the two displacement fields.  This is the measurement that sets
`fem_topology3d._grid_min_nnz`.
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paropt_tpu.models.fem_topology3d import FEMTopology3D  # noqa: E402

ENV = "PAROPT_TPU_FEM3D_GRID_MIN_NNZ"


def solve_once(shape, grid_from):
    """-> (best solve s, first call s, compliance, displacements)."""
    if grid_from is None:
        os.environ.pop(ENV, None)
    else:
        os.environ[ENV] = str(grid_from)
    prob = FEMTopology3D(*shape, cg_iters=25, solver="mgcg",
                         dtype=jnp.float64)
    x0 = prob.get_vars_and_bounds()[0]
    E = prob.emin + (prob.e0 - prob.emin) * prob._filter(x0) ** 3
    solve = jax.jit(prob._solve)
    t0 = time.perf_counter()
    u = jax.block_until_ready(solve(E))
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(solve(E))
        best = min(best, time.perf_counter() - t0)
    return best, first, float(jnp.vdot(prob.f, u)), u


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--grid-from", type=int, default=48,
                    help="smallest node-grid minor width given the stencil")
    ap.add_argument("meshes", nargs="*", default=["32x16x16", "160x80x80"])
    args = ap.parse_args()
    dev = jax.devices()[0]
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = "nvidia-smi: not available"
    print(f"{smi}\ndevice_kind={dev.device_kind} jax={jax.__version__}",
          flush=True)
    for mesh in args.meshes:
        shape = tuple(int(v) for v in mesh.split("x"))
        aos = solve_once(shape, None)
        grid = solve_once(shape, args.grid_from)
        gap = float(jnp.max(jnp.abs(aos[3] - grid[3])))
        for name, (best, first, comp, _) in (
                ("auto (AoS)", aos),
                (f"grid from nnz {args.grid_from}", grid)):
            print(f"[layout] {mesh} {name}: {best * 1e3:.3f} ms/solve, "
                  f"first call {first:.1f} s (compile included), "
                  f"compliance {comp:.12e}", flush=True)
        print(f"[layout] {mesh}: max |u_aos - u_grid| = {gap:.2e}",
              flush=True)


if __name__ == "__main__":
    main()
