"""The port's public API against the JAX package's: every package exports
every name of its JAX counterpart's ``__all__``, bound to the port's own
object, except the documented exceptions:

* ``ops.pick_tile`` — it picked the Pallas grid's tile; K1's launch is
  planned by ``ops.cuda_spmv.k1_plan``;
* ``utils.cross_device_consistency`` — it waits for the port of
  ``parallel/``.
"""

import importlib

import pytest

EXCEPTIONS = {
    "": set(),
    ".ops": {"pick_tile"},
    ".harness": set(),
    ".utils": {"cross_device_consistency"},
    ".solvers": set(),
    ".basis": set(),
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
