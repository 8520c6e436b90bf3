"""PyTorch port, ``python -m ca_lanczos_tpu_torch`` (``__main__.main``)
against the JAX package's CLI (``--device cpu`` against JAX on the CPU,
float64); mirrors tests/test_harness.py::TestSolveCli without the mesh
cases, and runs ``info``, ``sweep`` and ``propagation`` of both.

Tolerances: a ``solve`` record has JAX's keys, and the same matrix, n,
nnz, format, reordering, route notes, solver label, escalation,
convergence and restart count; its eigenvalues equal JAX's to 1e-10
(and the dense oracle's to rtol 1e-7, as the JAX test).  ``info`` values
as tests/test_torch_corpus.py (1e-12, normest 1e-10 relative); ``sweep``
and ``propagation`` records as tests/test_torch_experiments.py (errors
1e-9 absolute, counts and flags equal, wall times only positive)."""

import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ca_lanczos_tpu.__main__ import main as jmain
from ca_lanczos_tpu_torch import bench
from ca_lanczos_tpu_torch.__main__ import main
from ca_lanczos_tpu_torch.utils.mmio import save_mtx

TIMES = ("wall_s",)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _band(tmp_path, n):
    d = np.linspace(1.0, 40.0, n)
    d[-6:] = np.linspace(45.0, 50.0, 6)  # a separated top: few restarts
    a = sp.diags([d, 0.05 * np.ones(n - 1), 0.05 * np.ones(n - 1)], [0, -1, 1])
    path = str(tmp_path / "band.mtx")
    save_mtx(path, a)
    return path, a


def _records(tmp_path, argv, port: bool):
    out = str(tmp_path / ("t.jsonl" if port else "j.jsonl"))
    rc = main(["--device", "cpu", *argv, "--out", out]) if port else jmain([*argv, "--out", out])
    assert rc == 0
    return [json.loads(line) for line in open(out).read().splitlines()]


def _same(rt, rj, exact=(), tol=1e-9):
    assert len(rt) == len(rj)
    for a, b in zip(rt, rj):
        assert set(a) == set(b)
        for k in a:
            if k in TIMES:
                assert a[k] > 0 and b[k] > 0
            elif k == "normest":
                np.testing.assert_allclose(a[k], b[k], rtol=1e-10)
            elif isinstance(b[k], float) and k not in exact:
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=tol, err_msg=k)
            else:
                assert a[k] == b[k], k


@pytest.mark.parametrize("n,fmt", [(400, "dense"), (2500, "dia")])
def test_solve_mtx_matches_jax(tmp_path, n, fmt):
    """.mtx -> loader -> router -> escalating drivers -> JSON record."""
    path, a = _band(tmp_path, n)
    argv = ["solve", "--mtx", path, "--n-wanted", "4", "--max-lanczos", "32", "--s", "4"]
    (rt,), (rj,) = _records(tmp_path, argv, True), _records(tmp_path, argv, False)
    assert rt["format"] == fmt and rt["converged"] and rt["n"] == n
    np.testing.assert_allclose(rt["eigs"], rj["eigs"], rtol=0, atol=1e-10)
    _same([{k: v for k, v in rt.items() if k != "eigs"}],
          [{k: v for k, v in rj.items() if k != "eigs"}])
    exact = np.sort(np.linalg.eigvalsh(a.toarray()))[::-1][:4]
    np.testing.assert_allclose(rt["eigs"][:4], exact, rtol=1e-7)


def test_solve_synthetic_polish_matches_jax(tmp_path):
    """No --mtx: the synthetic diagonal; the two-stage flags and the
    smallest end pass through."""
    argv = ["solve", "--n", "3000", "--n-wanted", "3", "--s", "4", "--max-lanczos", "32",
            "--tol", "1e-6", "--polish", "4", "--over-lock", "2", "--which", "smallest"]
    (rt,), (rj,) = _records(tmp_path, argv, True), _records(tmp_path, argv, False)
    assert rt["solver"].endswith("+polish4") and rt["converged"]
    np.testing.assert_allclose(rt["eigs"], rj["eigs"], rtol=0, atol=1e-10)
    _same([{k: v for k, v in rt.items() if k != "eigs"}],
          [{k: v for k, v in rj.items() if k != "eigs"}])


def test_info_matches_jax(tmp_path):
    path, _ = _band(tmp_path, 300)
    rt = _records(tmp_path, ["info", "--mtx", path], True)
    _same(rt, _records(tmp_path, ["info", "--mtx", path], False), tol=1e-12)
    assert rt[0]["n"] == 300 and "eig_max" in rt[0]
    # no --mtx: the default synthetic matrix
    _same(_records(tmp_path, ["info"], True), _records(tmp_path, ["info"], False), tol=1e-12)


def test_sweep_matches_jax(tmp_path):
    argv = ["sweep", "--s", "4", "--orth", "full", "--max-lanczos", "24", "--n-wanted", "4"]
    rt = _records(tmp_path, argv, True)
    assert len(rt) == 2 and all(r["converged"] for r in rt)
    _same(rt, _records(tmp_path, argv, False))
    path, _ = _band(tmp_path, 200)
    argv = ["sweep", "--mtx", path, "--s", "2", "--orth", "full", "--max-lanczos", "24",
            "--n-wanted", "3"]
    _same(_records(tmp_path, argv, True), _records(tmp_path, argv, False))


def test_propagation_matches_jax(tmp_path):
    argv = ["propagation", "--n", "64", "--steps", "5", "--krylov", "12", "--s", "3"]
    rt = _records(tmp_path, argv, True)
    assert [r["solver"] for r in rt] == ["std-lanczos", "ca-newton", "ca-monomial"]
    assert all(r["max_abs_err"] < 1e-7 for r in rt)
    _same(rt, _records(tmp_path, argv, False))


def test_stdout_record_and_unported_commands(capsys):
    """Without --out the record goes to stdout as one JSON line; every
    command of the JAX CLI is there (``scaling`` and ``solve --mesh`` came
    with parallel/), and ``solve --mesh`` on the default device refuses
    when fewer cards are visible than ranks asked for."""
    assert main(["--device", "cpu", "info"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["name"] == "diag_1e2"
    with pytest.raises(SystemExit):
        main(["--help"])
    usage = capsys.readouterr().out
    assert "scaling" in usage and "wait for parallel/" not in usage
    with pytest.raises(SystemExit):
        main(["solve", "--help"])
    assert "--mesh" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA device"):
            main(["solve", "--n", "64", "--mesh", "2"])


def test_bench_refuses_without_a_card(monkeypatch, capsys):
    """The benchmark measures the card: with no CUDA device it exits 2 and
    prints no result line."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main() == 2
    assert capsys.readouterr().out == ""
    data, q = bench.bench_operator()
    assert data.shape == (9, 1 << 22) and data.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(q), 1.0, rtol=1e-6)
