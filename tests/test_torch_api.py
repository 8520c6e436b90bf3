"""The port's public API against the JAX package's: every package exports
every name of its JAX counterpart's ``__all__``, bound to the port's own
object, except the documented exception:

* ``ops.pick_tile`` — it picked the Pallas grid's tile; K1's launch is
  planned by ``ops.cuda_spmv.k1_plan``.

Importing ``ca_lanczos_tpu_torch.parallel`` imports no JAX and starts no
process group (checked in a fresh interpreter).
"""

import importlib
import subprocess
import sys

import pytest

EXCEPTIONS = {
    "": set(),
    ".ops": {"pick_tile"},
    ".harness": set(),
    ".utils": set(),
    ".solvers": set(),
    ".basis": set(),
    ".parallel": set(),
}


@pytest.mark.parametrize("sub", sorted(EXCEPTIONS))
def test_exports_match_jax(sub):
    jmod = importlib.import_module("ca_lanczos_tpu" + sub)
    tmod = importlib.import_module("ca_lanczos_tpu_torch" + sub)
    missing = set(jmod.__all__) - set(tmod.__all__)
    assert missing == EXCEPTIONS[sub]
    assert set(tmod.__all__) <= set(jmod.__all__)
    for name in tmod.__all__:
        obj = getattr(tmod, name)
        mod = getattr(obj, "__module__", None)
        assert mod is None or mod.startswith("ca_lanczos_tpu_torch"), (name, mod)


def test_importing_parallel_imports_no_jax_and_starts_no_group():
    code = ("import sys, torch.distributed as d, ca_lanczos_tpu_torch.parallel; "
            "print('jax' in sys.modules, d.is_initialized())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=120).stdout.split()
    assert out == ["False", "False"]
