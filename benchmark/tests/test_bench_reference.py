"""The plain float64 residual against scipy's products."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from benchmark.problems import lattice_poisson, unstructured_elasticity
from benchmark.reference import residual


def _problems():
    A, _ = lattice_poisson.generate(9)
    yield A
    A, _ = unstructured_elasticity.generate(4, 3, 1e3, 0.3, 0, 0)
    yield A
    n = 7
    data = np.arange(3 * n, dtype=float).reshape(3, n) + 1.0
    yield sp.dia_matrix((data, [-2, 0, 3]), shape=(n, n))


@pytest.mark.parametrize("k", range(3))
def test_operator_is_scipys_product(k):
    A = list(_problems())[k]
    x = np.random.default_rng(k).standard_normal(A.shape[0])
    y = residual.Operator(A, "cpu")(torch.from_numpy(x)).numpy()
    assert np.allclose(y, A @ x, rtol=1e-13, atol=1e-13 * np.abs(A @ x).max())


def test_relres_of_an_exact_solve_and_of_bad_answers():
    A, _ = lattice_poisson.generate(9)
    x = np.random.default_rng(1).standard_normal(A.shape[0])
    b = A @ x
    op = residual.Operator(A, "cpu")
    assert residual.relres(op, b, x) < 1e-14
    assert residual.relres(op, b, torch.from_numpy(x)) < 1e-14
    assert residual.relres(op, b, np.zeros_like(x)) == pytest.approx(1.0)
    assert residual.relres(op, b, x[:-1]) == float("inf")
    bad = x.copy()
    bad[3] = np.nan
    assert residual.relres(op, b, bad) == float("inf")


def test_reference_imports_nothing_of_the_program():
    import ast
    from pathlib import Path

    for path in (Path(residual.__file__).parent).glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in (
                    "ngsamg_tpu_torch", "ngsamg_tpu", "jax"), (path, name)
