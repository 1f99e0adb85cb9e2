"""Multi-material (DMO) 2-D topology design: choose between materials of
different stiffness/weight per element under a total mass cap (the
continuum analogue of `examples/dmo_truss/`).

    python examples/dmo_topology.py [--nex 32 --ney 16] [-o design.png]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
# persistent compile cache (JAX_COMPILATION_CACHE_DIR, else the checkout's
# .jax_cache): repeat runs skip compilation
from paropt_tpu.utils.compile_cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nex", type=int, default=32)
    ap.add_argument("--ney", type=int, default=16)
    ap.add_argument("--mass", type=float, default=0.3)
    ap.add_argument("-o", "--output", default=None)
    args = ap.parse_args()

    from paropt_tpu.ip import InteriorPoint
    from paropt_tpu.models.fem_topology import DMOFEMTopology

    prob = DMOFEMTopology(nex=args.nex, ney=args.ney,
                          mass_fraction=args.mass, cg_iters=30,
                          solver="mgcg")
    t0 = time.time()
    ip = InteriorPoint(prob, {"output_file": None, "max_major_iters": 300,
                              "abs_res_tol": 1e-5})
    res = ip.optimize()
    x = np.asarray(res["x"])
    xm = x.reshape(prob.ne, prob.nmat)
    mass = float(np.mean(xm @ np.asarray(prob.rho_mats)))
    mats = prob.material_field(x)
    print(f"converged={res['converged']} compliance(norm)="
          f"{float(res['fobj']):.5f} mass={mass:.4f} (cap {args.mass}) "
          f"wall={time.time() - t0:.1f}s")
    counts = {int(m): int((mats == m).sum()) for m in np.unique(mats)}
    print("material usage (-1 = void):", counts)

    if args.output:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        field = mats.reshape(args.nex, args.ney).T[::-1].astype(float)
        field[field < 0] = np.nan                      # void -> blank
        fig, ax = plt.subplots(figsize=(8, 4))
        im = ax.imshow(field, cmap="viridis", interpolation="nearest")
        ax.set_title(f"DMO {args.nex}x{args.ney}: material index per "
                     f"element (mass cap {args.mass})")
        ax.axis("off")
        fig.colorbar(im, ax=ax, shrink=0.75)
        fig.tight_layout()
        fig.savefig(args.output, dpi=140)
        print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
