"""Direct driver for the native sparse Cholesky
(the role of `examples/cholesky/cholesky.py`): factor a 2-D Laplacian with
natural vs minimum-degree ordering and compare fill-in."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
# persistent compile cache (JAX_COMPILATION_CACHE_DIR, else the checkout's
# .jax_cache): repeat runs skip compilation
from paropt_tpu.utils.compile_cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

from paropt_tpu.ops import sparse_native as sn


def laplacian_2d(nx):
    n = nx * nx
    rowp = [0]
    cols, vals = [], []
    for j in range(nx):
        for i in range(nx):
            row = j * nx + i
            entries = [(row, 4.0)]
            if i > 0:
                entries.append((row - 1, -1.0))
            if i < nx - 1:
                entries.append((row + 1, -1.0))
            if j > 0:
                entries.append((row - nx, -1.0))
            if j < nx - 1:
                entries.append((row + nx, -1.0))
            for c, v in sorted(entries):
                cols.append(c)
                vals.append(v)
            rowp.append(len(cols))
    return (n, np.asarray(rowp, np.int32), np.asarray(cols, np.int32),
            np.asarray(vals))


def main():
    for nx in (16, 32, 64):
        n, rowp, cols, vals = laplacian_2d(nx)
        nat = sn.SparseCholesky(rowp, cols, ordering="natural")
        amd = sn.SparseCholesky(rowp, cols, ordering="amd")
        amd.factor(vals)
        b = np.ones(n)
        x = amd.solve(b)
        # residual check
        r = np.zeros(n)
        for i in range(n):
            r[i] = sum(vals[p] * x[cols[p]]
                       for p in range(rowp[i], rowp[i + 1])) - b[i]
        print(f"nx={nx:3d} n={n:5d}  nnz(A)={rowp[-1]:7d}  "
              f"nnz(L) natural={nat.nnz:8d}  amd={amd.nnz:8d}  "
              f"fill ratio {nat.nnz / max(amd.nnz, 1):.2f}x  "
              f"|Ax-b|={np.abs(r).max():.2e}")


if __name__ == "__main__":
    main()
