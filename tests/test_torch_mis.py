"""MIS-seeded aggregation: the port against the JAX package.

`luby_mis` and `mis_aggregate` of ngsamg_tpu_torch/coarsen/mis.py are numpy
copies of ngsamg_tpu/coarsen/mis.py with the same seeded priorities, so on
the same strength graph (made from a seed with numpy) they return the same
arrays bit for bit: distance-1 and distance-2 seeds, with and without an
``active`` mask, on a graph with isolated vertices and self-loops.

`unstructured_poisson(16, 3)` (4,096 DoF) with ``coarsen.algo = MIS`` is
then set up and solved by both packages on the CPU: the same level sizes
and operator complexity, iterations within one of each other, and a true
relative residual (host, f64, scipy) within the solve tolerance 1e-8.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ngsamg_tpu
import ngsamg_tpu_torch
from ngsamg_tpu.coarsen import mis as jmis
from ngsamg_tpu_torch.coarsen import mis as tmis
from ngsamg_tpu_torch.utils import fem

torch.set_num_threads(2)


def _strength_graph(n, degree, seed, isolated=0, self_loops=False):
    """A symmetric random strength graph: positive weights over a few
    orders of magnitude, ``isolated`` vertices without an edge."""
    rng = np.random.default_rng(seed)
    m = n - isolated
    i = rng.integers(0, m, size=degree * m // 2)
    j = rng.integers(0, m, size=degree * m // 2)
    keep = i != j
    i, j = i[keep], j[keep]
    w = 10.0 ** rng.uniform(-3, 0, size=len(i))
    S = sp.coo_matrix((w, (i, j)), shape=(n, n)).tocsr()
    S = S.maximum(S.T).tocsr()
    if self_loops:
        S = (S + sp.diags(rng.random(n))).tocsr()
    S.sort_indices()
    return S


GRAPHS = [(200, 4, 0, 0), (1000, 6, 1, 7), (3000, 8, 2, 0), (500, 3, 3, 40)]


@pytest.mark.parametrize("n,degree,seed,isolated", GRAPHS)
@pytest.mark.parametrize("dist2", [False, True], ids=["dist1", "dist2"])
@pytest.mark.parametrize("self_loops", [False, True], ids=["plain", "loops"])
def test_luby_mis_equals_jax(n, degree, seed, isolated, dist2, self_loops):
    S = _strength_graph(n, degree, seed, isolated, self_loops)
    for mis_seed in (0, 5):
        got = tmis.luby_mis(S.copy(), seed=mis_seed, dist2=dist2)
        ref = jmis.luby_mis(S.copy(), seed=mis_seed, dist2=dist2)
        assert got.dtype == ref.dtype == bool
        np.testing.assert_array_equal(got, ref)
    # a maximal independent set of the distance-1 graph without self-loops
    G = S.tolil()
    G.setdiag(0.0)
    G = G.tocsr()
    G.eliminate_zeros()
    nbr_in = (G @ got.astype(np.float64)) > 0
    assert not (got & nbr_in).any()
    if not dist2:
        assert (got | nbr_in).all()


@pytest.mark.parametrize("n,degree,seed,isolated", GRAPHS)
@pytest.mark.parametrize("dist2", [False, True], ids=["dist1", "dist2"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "active"])
@pytest.mark.parametrize("theta", [0.08, 0.5])
def test_mis_aggregate_equals_jax(n, degree, seed, isolated, dist2, masked,
                                  theta):
    S = _strength_graph(n, degree, seed, isolated)
    active = None
    if masked:
        active = np.random.default_rng(seed + 100).random(n) < 0.8
    # each call gets its own copy: the weak-edge filter compacts the
    # index arrays it shares with its input
    v_t, n_t = tmis.mis_aggregate(S.copy(), theta=theta, dist2=dist2,
                                  active=active)
    v_j, n_j = jmis.mis_aggregate(S.copy(), theta=theta, dist2=dist2,
                                  active=active)
    assert n_t == n_j
    assert v_t.dtype == v_j.dtype == np.int64
    np.testing.assert_array_equal(v_t, v_j)
    # every active vertex in exactly one aggregate, no aggregate empty
    on = np.ones(n, bool) if active is None else active
    assert (v_t[~on] == -1).all()
    assert sorted(np.unique(v_t[on])) == list(range(n_t))


def _mis_opts(pkg):
    return pkg.AMGOptions(
        smoother=pkg.config.SmootherOptions(
            type=pkg.config.SmootherType.CHEBYSHEV
        ),
        coarsen=pkg.config.CoarsenOptions(algo=pkg.config.CoarsenType.MIS),
    )


@pytest.fixture(scope="module")
def mis_solved():
    p = fem.unstructured_poisson(16, dim=3)
    out = {}
    for name, pkg, kw in (
        ("jax", ngsamg_tpu, {}),
        ("torch", ngsamg_tpu_torch, {"device": "cpu"}),
    ):
        pc = pkg.AMGPreconditioner(
            p.A, coords=p.coords, options=_mis_opts(pkg), **kw
        ).setup()
        x, info = pc.solve(p.b, tol=1e-8)
        out[name] = (pc, np.asarray(x), info)
    return p, out


def test_mis_hierarchy_equals_jax(mis_solved):
    _, out = mis_solved
    pj, pt = out["jax"][0], out["torch"][0]
    assert pt.num_levels == pj.num_levels >= 2
    assert [int(v) for v in pt.log_.nvs] == [int(v) for v in pj.log_.nvs]
    assert pt.operator_complexity == pj.operator_complexity
    for lj, lt in zip(pj.setup_levels_[:-1], pt.setup_levels_[:-1]):
        np.testing.assert_array_equal(lt.v2agg, lj.v2agg)


def test_mis_solve_matches_jax(mis_solved):
    p, out = mis_solved
    (_, xj, ij), (_, xt, it) = out["jax"], out["torch"]
    assert ij.converged and it.converged
    assert abs(it.iterations - ij.iterations) <= 1
    for x in (xj, xt):
        relres = np.linalg.norm(p.b - p.A @ x) / np.linalg.norm(p.b)
        assert relres <= 1e-8
    assert np.linalg.norm(xt - xj) / np.linalg.norm(xj) <= 1e-6


def test_mis_differs_from_pairwise(mis_solved):
    """``algo=MIS`` really takes the MIS coarsener: its first coarse level
    differs from the pairwise (default) one."""
    p, out = mis_solved
    pt = out["torch"][0]
    base = ngsamg_tpu_torch.AMGPreconditioner(
        p.A, coords=p.coords, device="cpu",
        options=_mis_opts(ngsamg_tpu_torch).replace(
            coarsen=ngsamg_tpu_torch.config.CoarsenOptions()),
    ).setup()
    assert [int(v) for v in base.log_.nvs] != [int(v) for v in pt.log_.nvs]
