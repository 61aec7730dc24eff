"""The benchmark's frozen copies against the program's originals."""

import inspect

import numpy as np
import pytest
import torch

from benchmark import timing
from benchmark.problems import lattice_poisson, unstructured_elasticity
from ngsamg_tpu_torch.utils import fem
from ngsamg_tpu_torch.utils import timing as port_timing


def _same(A, B):
    assert A.shape == B.shape
    D = (A.tocsr() - B.tocsr()).tocsr()
    assert D.nnz == 0 or np.abs(D.data).max() == 0.0


@pytest.mark.parametrize("n", [8, 12, 21])
def test_lattice_poisson_is_poisson_3d(n):
    A, coords = lattice_poisson.generate(n)
    p = fem.poisson_3d(n)
    assert A.format == p.A.format == "dia"
    assert np.array_equal(A.offsets, p.A.offsets)
    assert np.array_equal(A.data, p.A.data)
    assert np.array_equal(coords, p.coords)


@pytest.mark.parametrize("n,dim,refine", [(4, 3, 0), (5, 3, 1), (9, 2, 1)])
def test_unstructured_elasticity_is_the_original(n, dim, refine):
    A, coords = unstructured_elasticity.generate(n, dim, 1e3, 0.3, 0, refine)
    p = fem.unstructured_elasticity(n, dim=dim, E=1e3, nu=0.3, seed=0,
                                    refine=refine)
    _same(A, p.A)
    assert np.array_equal(coords, p.coords)


def test_cold_ms_is_the_original():
    assert timing.L2_SWEEP_BYTES == port_timing.L2_SWEEP_BYTES
    assert (inspect.getsource(timing.cold_ms)
            == inspect.getsource(port_timing.cold_ms))


@pytest.mark.cuda
def test_cold_ms_reads_like_the_original_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x = torch.randn(1 << 24, device="cuda")
    ours = timing.cold_ms(lambda: x.mul_(1.0))
    theirs = port_timing.cold_ms(lambda: x.mul_(1.0))
    assert 0.5 < ours / theirs < 2.0
