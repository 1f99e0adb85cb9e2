"""Sellar problem (`examples/sellar/sellar.py` role)."""
import numpy as np
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
# persistent compile cache (JAX_COMPILATION_CACHE_DIR, else the checkout's
# .jax_cache): repeat runs skip compilation
from paropt_tpu.utils.compile_cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
from test_examples import Sellar  # noqa: E402
from paropt_tpu import InteriorPoint  # noqa: E402

ip = InteriorPoint(Sellar(), {"output_file": "-", "abs_res_tol": 1e-8})
res = ip.optimize()
print(f"\nconverged: {res['converged']}  f* = {res['fobj']:.8e}")
print("x* =", np.asarray(res["x"]))
