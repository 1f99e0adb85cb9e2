"""Multi-process (jax.distributed) FEM FusedMMA solve — one worker/process.

The flagship SIMP topology workload under REAL multi-process SPMD: the
stencil FEM matvec's slices/pads become cross-process halo exchanges and
the multigrid V-cycle's restriction/prolongation distribute over the hybrid
(process x local-device) mesh — the most sharding-sensitive code in the
framework, previously covered only on a single-process virtual mesh
(`tests/test_sharding.py::test_fused_mma_fem_topology_sharded`).

CPU-only: every process runs on virtual CPU devices (JAX_PLATFORMS is
forced to cpu).  On GPUs, one process drives all cards of a host over a
design mesh (`python chip_smoke.py --chips 4`).

Single-host testing (2 processes x 2 virtual CPU devices):

    for i in 0 1; do
      python scripts/distributed_fem_mma.py --process-id $i \
          --num-processes 2 --port 12356 --local-devices 2 \
          --nex 16 --ney 8 --out /tmp/fem_rank$i.json &
    done; wait

Host branches read REPLICATED scalars only (fobj/infeas/convergence), so
every process branches identically — the SPMD analogue of the reference's
root-broadcast discipline (`ParOptInteriorPoint.cpp:4835`).
"""

import argparse
import json
import os
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--port", type=int, default=12356)
    ap.add_argument("--local-devices", type=int, default=2)
    ap.add_argument("--nex", type=int, default=16)
    ap.add_argument("--ney", type=int, default=8)
    ap.add_argument("--nez", type=int, default=0,
                    help="> 0 selects the 3-D voxel model (grid-form "
                         "stencil: different halo/collective pattern)")
    ap.add_argument("--cg-iters", type=int, default=25)
    ap.add_argument("--max-iters", type=int, default=8)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    # environment must be fixed before jax imports
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count="
                    f"{args.local_devices}").strip()

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

    import jax

    # distributed init MUST precede any backend-initializing call
    if args.num_processes > 1:
        from paropt_tpu.parallel.sharding import init_distributed
        init_distributed(coordinator_address=f"localhost:{args.port}",
                         num_processes=args.num_processes,
                         process_id=args.process_id)

    jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp
    import numpy as np

    from paropt_tpu.mma import FusedMMA
    from paropt_tpu.parallel import sharding as shlib

    dtype = "float64"
    if args.nez > 0:
        from paropt_tpu.models.fem_topology3d import FEMTopology3D
        prob = FEMTopology3D(nex=args.nex, ney=args.ney, nez=args.nez,
                             cg_iters=args.cg_iters, solver="mgcg")
    else:
        from paropt_tpu.models.fem_topology import FEMTopology
        prob = FEMTopology(nex=args.nex, ney=args.ney,
                           cg_iters=args.cg_iters, solver="mgcg")
    solver = FusedMMA(prob, {"mma_max_iterations": args.max_iters,
                             "mma_output_file": None, "dtype": dtype})

    if jax.process_count() > 1:
        mesh = shlib.hybrid_design_mesh()
    else:
        mesh = shlib.design_mesh()

    n = prob.nvars

    def place(leaf):
        leaf = jnp.asarray(leaf)
        if leaf.ndim >= 1 and leaf.shape[-1] == n:
            sh = (shlib.design_sharding(mesh) if leaf.ndim == 1
                  else shlib.row_sharding(mesh))
            return jax.device_put(leaf, sh)
        return jax.device_put(leaf, shlib.replicated_sharding(mesh))

    state = jax.tree_util.tree_map(place, solver._state0)

    trajectory = []
    for _ in range(args.max_iters):
        state = solver._step_jit(state)
        trajectory.append({"k": int(state.k), "fobj": float(state.fobj),
                           "infeas": float(state.infeas),
                           "l1": float(state.l1)})
        if bool(state.converged):
            break

    result = {
        "process_id": jax.process_index(),
        "num_processes": jax.process_count(),
        "global_devices": len(jax.devices()),
        "mesh": str(tuple(mesh.shape.items())),
        "nex": args.nex, "ney": args.ney, "nez": args.nez,
        "iters": int(state.k),
        "fobj": float(state.fobj),
        "infeas": float(state.infeas),
        "converged": bool(state.converged),
        "x_mean": float(jnp.mean(state.x)),
        "trajectory": trajectory,
    }
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
