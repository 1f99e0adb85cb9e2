"""Multi-material DMO truss (`examples/dmo_truss` role): MMA outer loop with
per-bar weighting constraints."""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
# persistent compile cache (JAX_COMPILATION_CACHE_DIR, else the checkout's
# .jax_cache): repeat runs skip compilation
from paropt_tpu.utils.compile_cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()
import numpy as np  # noqa: E402
from paropt_tpu.mma import MMA  # noqa: E402
from paropt_tpu.models.truss import DMOTruss  # noqa: E402

prob = DMOTruss(nx=5, ny=3)
mma = MMA(prob, {"mma_output_file": "-", "output_file": None,
                 "mma_max_iterations": 80})
res = mma.optimize()
w = np.asarray(res["x"]).reshape(prob.fem.nbars, prob.nmat)
print(f"\ncompliance = {res['fobj']:.6e}  "
      f"mass slack = {float(prob.constraints(res['x'])[0]):.4f}")
print("dominant material per bar:", w.argmax(axis=1))
