"""Weak/strong scaling harness: fused IP iterations/s vs mesh size.

On real multi-GPU hardware this measures NVLink scaling; on CPU with
xla_force_host_platform_device_count it validates the collective path and
gives a (meaningless for absolute perf) sanity curve.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scripts/scaling.py --n 1048576
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 17)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--distributed", action="store_true",
                    help="multi-process run: call jax.distributed."
                         "initialize() (coordinator from the standard env "
                         "vars) and measure over a hybrid "
                         "(hosts x local-devices) mesh")
    ap.add_argument("--coordinator", type=str, default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args()

    if args.distributed:
        from paropt_tpu.parallel.sharding import init_distributed
        init_distributed(args.coordinator, args.num_processes,
                         args.process_id)

    from paropt_tpu import ip_fused
    from paropt_tpu.models.topology import SyntheticTopology
    from paropt_tpu.ops import qn as qnmod

    dtype = jnp.float64 if jax.default_backend() == "cpu" else jnp.float32
    ndev_all = len(jax.devices())
    sizes = [d for d in (1, 2, 4, 8, 16, 32) if d <= ndev_all]

    prob = SyntheticTopology(n=args.n, block=8, dtype=dtype)
    model = ip_fused.model_from_problem(prob)
    opts = ip_fused.FusedIPOptions(use_quasi_newton_update=True)
    fused = ip_fused.FusedIP(model, prob.nvars, prob.ncon, prob.nwcon,
                             prob.nwblock, opts, dtype=dtype)
    data, x0 = ip_fused.data_template_from_problem(prob, dtype=dtype)
    qn0 = qnmod.qn_init(10, prob.nvars, dtype=dtype)

    from paropt_tpu.parallel import sharding as shlib

    base = None
    for nd in sizes:
        if args.distributed and jax.process_count() > 1:
            # hybrid (hosts x local) mesh: DCN outer axis, ICI inner; the
            # design axis shards over both so each chip owns a contiguous
            # block and reductions ride ICI first
            if nd < len(jax.devices()):
                continue  # measure only the full global mesh per process
            mesh = shlib.hybrid_design_mesh()
        else:
            mesh = Mesh(np.asarray(jax.devices()[:nd]), ("d",))
        shard_n = shlib.design_sharding(mesh)
        shard_rows = shlib.row_sharding(mesh)
        repl = shlib.replicated_sharding(mesh)

        def place(leaf):
            leaf = jnp.asarray(leaf)
            if leaf.ndim >= 1 and leaf.shape[-1] == args.n:
                return jax.device_put(
                    leaf, shard_n if leaf.ndim == 1 else shard_rows)
            return jax.device_put(leaf, repl)

        st = jax.tree_util.tree_map(place, fused.init(x0, data, (), qn0,
                                                      None))
        dd = jax.tree_util.tree_map(place, data)
        st = fused.step(st, dd, (), None)  # compile+warm
        jax.block_until_ready(st)
        t0 = time.time()
        for _ in range(args.iters):
            st = fused.step(st, dd, (), None)
        jax.block_until_ready(st)
        dt = time.time() - t0
        its = args.iters / dt
        if base is None:
            base = its
        print(f"devices={nd:3d}  {its:8.2f} it/s  "
              f"efficiency={its / base:.2f}  fobj={float(st.fobj):.6f}")


if __name__ == "__main__":
    main()
