"""PyTorch port, harness/corpus.py and harness/matrix_info.matrix_info
against the JAX package (``device="cpu"``, float64); mirrors
tests/test_harness.py::TestMatrixInfo.

Tolerances: the corpus has the JAX package's 23 keys, each oracle equals
JAX's to 1e-12 and each operator (same format) to 1e-14 on ``to_dense``;
``matrix_info`` has JAX's keys, its values equal to 1e-12 and ``normest``
to 1e-10 (relative)."""

import numpy as np
import pytest
import torch

from ca_lanczos_tpu.harness import matrix_info as jinfo
from ca_lanczos_tpu.harness.corpus import build_corpus as jcorpus
from ca_lanczos_tpu.utils.matrices import diag_spectrum as jdiag
from ca_lanczos_tpu_torch.harness import matrix_info
from ca_lanczos_tpu_torch.harness.corpus import build_corpus
from ca_lanczos_tpu_torch.utils.interop import operator_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpora():
    return build_corpus(small=True, device="cpu"), jcorpus(small=True)


def test_corpus_matches_jax(corpora):
    ct, cj = corpora
    assert list(ct) == list(cj) and len(ct) == 23
    for name in ct:
        (A, exact), (Aj, exact_j) = ct[name], cj[name]
        assert type(A).__name__ == type(Aj).__name__, name
        assert A.device.type == "cpu" and A.dtype == torch.float64, name
        np.testing.assert_allclose(exact, exact_j, rtol=0, atol=1e-12, err_msg=name)
        np.testing.assert_allclose(A.to_dense().numpy(), np.asarray(Aj.to_dense()), rtol=0,
                                   atol=1e-14, err_msg=name)
        if hasattr(A, "offsets"):
            assert A.offsets == Aj.offsets, name


def _same_info(it, ij):
    assert set(it) == set(ij)
    for k in it:
        if k == "normest":
            np.testing.assert_allclose(it[k], ij[k], rtol=1e-10)
        elif isinstance(ij[k], float):
            np.testing.assert_allclose(it[k], ij[k], rtol=0, atol=1e-12, err_msg=k)
        else:
            assert it[k] == ij[k], k


def test_matrix_info_diag():
    Aj = jdiag(100, 1.0, 10.0)
    info = matrix_info(operator_from_numpy(Aj, device="cpu"), "diag100")
    assert info["n"] == 100
    np.testing.assert_allclose(info["eig_max"], 10.0)
    np.testing.assert_allclose(info["eig_min"], 1.0)
    np.testing.assert_allclose(info["cond"], 10.0)
    np.testing.assert_allclose(info["normest"], 10.0, rtol=1e-3)
    _same_info(info, jinfo(Aj, "diag100"))


@pytest.mark.parametrize("name", ["stiff_beam4", "graph_er_rcm", "finan_blockring",
                                  "indef_shifted_mesh"])
@pytest.mark.parametrize("cutoff", [2000, 10])
def test_matrix_info_matches_jax(corpora, name, cutoff):
    """DIA and ELL members, with the dense eigenvalues (n <= cutoff) and
    without them (normest only)."""
    ct, cj = corpora
    it = matrix_info(ct[name][0], name, dense_cutoff=cutoff)
    ij = jinfo(cj[name][0], name, dense_cutoff=cutoff)
    assert ("eig_max" in it) == (cutoff == 2000)
    _same_info(it, ij)
