"""Multi-process (jax.distributed) fused-IP solve — one worker per process.

The SPMD analogue of the reference's `mpirun -np N` deployment mode
(`ParOptVec.cpp:63-143`: every vector op is rank-distributed; all coupling
is collective).  Every process runs this same program; `jax.distributed`
wires the global device view, the design axis shards over the hybrid
(process x local-device) mesh, and all reductions inside the jitted step
lower to cross-process collectives (gloo).

CPU-only: every process runs on virtual CPU devices (JAX_PLATFORMS is
forced to cpu).  On GPUs, one process drives all cards of a host over a
design mesh (`python chip_smoke.py --chips 4`).

Single-host testing (2 processes x 2 virtual CPU devices):

    for i in 0 1; do
      python scripts/distributed_solve.py --process-id $i --num-processes 2 \
          --port 12355 --local-devices 2 --n 4096 --out /tmp/rank$i.json &
    done; wait

With --num-processes 1 it runs the identical solve single-process (the
trajectory-identity baseline used by tests/test_distributed.py).  The host
paces the jitted steps so the per-iteration trajectory (fobj, residual, mu)
is recorded; all host branches read REPLICATED scalars, so every process
branches identically (the SPMD analogue of the reference's root-broadcast
discipline, `ParOptInteriorPoint.cpp:4835`).
"""

import argparse
import json
import os
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--port", type=int, default=12355)
    ap.add_argument("--local-devices", type=int, default=2,
                    help="virtual CPU devices per process")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--msub", type=int, default=5)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--barrier", type=str, default="monotone")
    ap.add_argument("--max-iters", type=int, default=100)
    ap.add_argument("--unsharded", action="store_true",
                    help="single-process only: skip the mesh entirely")
    ap.add_argument("--out", type=str, default=None,
                    help="write the result JSON here (default: stdout)")
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
    # (jax.devices / default_backend / device_put)
    if args.num_processes > 1:
        from paropt_tpu.parallel.sharding import init_distributed
        init_distributed(coordinator_address=f"localhost:{args.port}",
                         num_processes=args.num_processes,
                         process_id=args.process_id)

    jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp
    import numpy as np

    from paropt_tpu import ip_fused
    from paropt_tpu.models.topology import SyntheticTopology
    from paropt_tpu.ops import qn as qnmod
    from paropt_tpu.parallel import sharding as shlib

    dtype = jnp.float64
    prob = SyntheticTopology(n=args.n, block=8, dtype=dtype)
    model = ip_fused.model_from_problem(prob)
    opts = ip_fused.FusedIPOptions(use_quasi_newton_update=True,
                                   abs_res_tol=args.tol,
                                   barrier_strategy=args.barrier,
                                   max_major_iters=args.max_iters)
    fused = ip_fused.FusedIP(model, prob.nvars, prob.ncon, prob.nwcon,
                             prob.nwblock, opts, dtype=dtype)
    data, x0 = ip_fused.data_template_from_problem(prob, dtype=dtype)
    qn0 = qnmod.qn_init(args.msub, prob.nvars, dtype=dtype)

    if args.unsharded:
        assert args.num_processes == 1, "--unsharded is single-process only"
        mesh = None
    elif jax.process_count() > 1:
        mesh = shlib.hybrid_design_mesh()
    else:
        mesh = shlib.design_mesh()

    def place(leaf):
        leaf = np.asarray(leaf)
        if mesh is None:
            return jnp.asarray(leaf)
        if leaf.ndim >= 1 and leaf.shape[-1] == args.n:
            sh = (shlib.design_sharding(mesh) if leaf.ndim == 1
                  else shlib.row_sharding(mesh))
            return jax.device_put(leaf, sh)
        return jax.device_put(leaf, shlib.replicated_sharding(mesh))

    state = jax.tree_util.tree_map(place, fused.init(x0, data, (), qn0,
                                                     None))
    data = jax.tree_util.tree_map(place, data)

    # host-paced steps: the trajectory scalars below are REPLICATED, so
    # reading them (and branching on convergence) is process-consistent
    trajectory = []
    for _ in range(args.max_iters):
        state = fused.step(state, data, (), None)
        trajectory.append({"k": int(state.k),
                           "fobj": float(state.fobj),
                           "res": float(state.res_norm),
                           "mu": float(state.mu)})
        if bool(state.converged):
            break

    result = {
        "process_id": jax.process_index(),
        "num_processes": jax.process_count(),
        "global_devices": len(jax.devices()),
        "mesh": "none" if mesh is None else str(tuple(mesh.shape.items())),
        "n": args.n,
        "iters": int(state.k),
        "fobj": float(state.fobj),
        "res": float(state.res_norm),
        "converged": bool(state.converged),
        "trajectory": trajectory,
    }
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
