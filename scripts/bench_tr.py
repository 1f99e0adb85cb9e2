"""Trust-region (the default algorithm) at scale on the current backend:
SL1QP on the synthetic topology problem, fused inner IP solves."""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp


def main():
    on_cpu = jax.default_backend() == "cpu"
    dtype = jnp.float64 if on_cpu else jnp.float32
    n = (1 << 15) if on_cpu else (1 << 18)

    from paropt_tpu.models.topology import SyntheticTopology
    from paropt_tpu.tr import TrustRegion

    prob = SyntheticTopology(n=n, block=8, dtype=dtype)
    tol = 1e-6 if on_cpu else 1e-4
    tr = TrustRegion(prob, {
        "tr_output_file": "-", "output_file": None,
        "tr_max_iterations": 60,
        "tr_infeas_tol": 1e-4 if not on_cpu else 1e-5,
        "tr_l1_tol": 0.0,  # disabled: converge on the l-infinity test
        "tr_linfty_tol": 2e-4 if not on_cpu else 1e-4,
        "abs_res_tol": tol,
        "dtype": "float32" if not on_cpu else "float64",
        "tr_adaptive_gamma_update": True,
    })
    t0 = time.time()
    res = tr.optimize()
    dt = time.time() - t0
    sys.stderr.write(
        f"\n[bench_tr] n={n} converged={res['converged']} "
        f"outer_iters={res['niter']} f*={res['fobj']:.6e} "
        f"infeas={res['infeas']:.2e} linfty={res['linfty']:.2e} "
        f"wall={dt:.1f}s (incl. compile)\n")


if __name__ == "__main__":
    main()
