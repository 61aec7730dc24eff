"""``benchmark/roofline.py`` against counts by hand on tiny matrices."""

import numpy as np
import pytest
import scipy.sparse as sp

from benchmark import roofline
from benchmark.problems import lattice_poisson


def test_lattice_counts_taps_x_and_y():
    # 1D Laplacian, n = 5: 3 taps, 13 stored nonzeros
    n = 5
    data = np.array([[-1.0] * n, [2.0] * n, [-1.0] * n])
    A = sp.dia_matrix((data, [-1, 0, 1]), shape=(n, n))
    assert roofline.lattice_matvec_work(A) == (2 * 13, 4 * 3 + 2 * 4 * n)


def test_lattice_leaves_out_an_empty_diagonal():
    n = 4
    data = np.array([[0.0] * n, [3.0] * n, [0.0] * n])
    A = sp.dia_matrix((data, [-2, 0, 2]), shape=(n, n))
    assert roofline.lattice_matvec_work(A) == (2 * 4, 4 * 1 + 2 * 4 * n)


def test_lattice_poisson_is_seven_points():
    # the Kuhn stencil's CSR row holds 15 entries, 8 of them zero: the P1
    # Laplacian on Kuhn tets is the 7-point one
    n = 10
    m = n - 1
    A, _ = lattice_poisson.generate(n)
    ops, nbytes = roofline.lattice_matvec_work(A)
    nnz = m**3 + 3 * 2 * (m - 1) * m * m
    assert (ops, nbytes) == (2 * nnz, 4 * 7 + 2 * 4 * m**3)


def test_block_counts_blocks_with_a_nonzero():
    # 2x2 blocks: (0,0) full, (0,1) one entry, (1,1) full, (1,0) an
    # explicit zero only, which is no block
    rows = [0, 0, 0, 1, 1, 2, 2, 3, 3, 2]
    cols = [0, 1, 3, 0, 1, 2, 3, 2, 3, 0]
    vals = [1.0, 2.0, 5.0, 3.0, 4.0, 6.0, 7.0, 8.0, 9.0, 0.0]
    A = sp.coo_matrix((vals, (rows, cols)), shape=(4, 4)).tocsr()
    assert A.nnz == 10  # the explicit zero is stored
    assert roofline.block_matvec_work(A, 2) == (
        2 * 4 * 3, 3 * (4 * 4 + 4) + 4 * (2 + 1) + 2 * 4 * 4)
    assert roofline.matvec_work(A, 2) == roofline.block_matvec_work(A, 2)


def test_block_refuses_a_size_not_in_blocks():
    with pytest.raises(ValueError):
        roofline.block_matvec_work(sp.eye(5, format="csr"), 3)


def test_bound_names_what_sets_it():
    t, by = roofline.bound_s(1, 3_350_000)
    assert by == "bytes" and t == pytest.approx(1e-6)
    t, by = roofline.bound_s(67_000_000, 1)
    assert by == "ops" and t == pytest.approx(1e-6)
