"""Back-to-back A/B: fused step with bfloat16 quasi-Newton storage
(`qn_init(storage_dtype=bf16)` — quantizes the [2m, n] ring buffer AND the
factor's Phi stacks) vs native f32 storage.  One process, interleaved
windows (_ab_common).

Convergence check: the final res/fobj lines must both reach the 1e-6
operating point for the ON variant to be admissible.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402

from _ab_common import run_ab  # noqa: E402


def toggle(on: bool):
    return {"qn_storage_dtype": jnp.bfloat16 if on else None}


if __name__ == "__main__":
    run_ab("qn-bf16", toggle)
