"""Port parity for the unstructured (generic level loop) setup and staging.

Two perturbed-Delaunay P1 Poisson problems made from a numpy seed,
`unstructured_poisson(16, dim=3, refine=1)` (32,720 DoF) and
`unstructured_poisson(40, dim=2, refine=1)` (6,241 DoF), go through both
packages' `AMGPreconditioner(..., Chebyshev).setup()`.

Both packages run their native setup and staging kernels here (the
default switch; tests/test_torch_native.py holds that run bitwise), and
the bounds below also hold either package's numpy branches:
- the finest mesh's edges and edge weights, every level's aggregation
  (`v2agg`), the level sizes and nnz, the row orders and the cluster sets
  are compared exactly;
- the vertex L2 weights (clamped row sums, roundoff-sized on interior rows)
  to 1e-12 of the largest diagonal, and the strengths derived from them to
  rtol 1e-12;
- the smoothed prolongations and coarse matrices in f64 to 1e-12
  relative (summation order differs between the two);
- staged f32 data to one f32 ulp, tile-ELL matvecs to rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ngsamg_tpu
import ngsamg_tpu.sparse.formats as jformats
import ngsamg_tpu_torch
import ngsamg_tpu_torch.sparse.formats as tformats
from ngsamg_tpu.apps.h1 import H1Energy as JH1
from ngsamg_tpu.coarsen import pairwise as jpw
from ngsamg_tpu.mesh import topo as jtopo
from ngsamg_tpu.smoothers import cluster_corr as jcc
from ngsamg_tpu.utils import fem as jfem
from ngsamg_tpu_torch.apps.h1 import H1Energy as TH1
from ngsamg_tpu_torch.coarsen import pairwise as tpw
from ngsamg_tpu_torch.mesh import topo as ttopo
from ngsamg_tpu_torch.smoothers import cluster_corr as tcc
from ngsamg_tpu_torch.utils import fem as tfem

torch.set_num_threads(2)

F32_ULP = 2.0 ** -23
CASES = [(16, 3, 1), (40, 2, 1)]


def _cheb(pkg):
    return pkg.AMGOptions(
        smoother=pkg.config.SmootherOptions(
            type=pkg.config.SmootherType.CHEBYSHEV
        )
    )


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "n%d_d%d_r%d" % c)
def pair(request):
    n, dim, refine = request.param
    p = tfem.unstructured_poisson(n, dim=dim, refine=refine)
    pj = ngsamg_tpu.AMGPreconditioner(
        p.A, coords=p.coords, options=_cheb(ngsamg_tpu)
    ).setup()
    pt = ngsamg_tpu_torch.AMGPreconditioner(
        p.A, coords=p.coords, options=_cheb(ngsamg_tpu_torch), device="cpu"
    ).setup()
    return request.param, p, pj, pt


def _rel_max(a, b):
    return abs(a - b).max() / abs(b).max()


def test_fem_matches_jax(pair):
    (n, dim, refine), p, _, _ = pair
    q = jfem.unstructured_poisson(n, dim=dim, refine=refine)
    assert (p.A != q.A).nnz == 0 and p.A.nnz == q.A.nnz
    np.testing.assert_array_equal(p.b, q.b)
    np.testing.assert_array_equal(p.coords, q.coords)


def test_finest_mesh_matches(pair):
    _, p, _, _ = pair
    mj = JH1().build_finest_mesh(p.A.tocsr(), p.coords)
    mt = TH1().build_finest_mesh(p.A.tocsr(), p.coords)
    assert mt.nv == mj.nv
    np.testing.assert_array_equal(mt.edges, mj.edges)
    np.testing.assert_array_equal(mt.edge_data["wt"], mj.edge_data["wt"])
    for k in ("diag", "pos"):
        np.testing.assert_array_equal(mt.vertex_data[k], mj.vertex_data[k])
    d = mj.vertex_data["diag"]
    np.testing.assert_allclose(
        mt.vertex_data["l2wt"], mj.vertex_data["l2wt"], rtol=0,
        atol=1e-12 * d.max(),
    )
    np.testing.assert_allclose(TH1().soc(mt), JH1().soc(mj), rtol=1e-12)
    Rt, Rj = TH1().replacement_matrix(mt), JH1().replacement_matrix(mj)
    assert Rt.nnz == Rj.nnz and _rel_max(Rt, Rj) <= 1e-12


def test_levels_match(pair):
    """Sizes, nnz, operator complexity and every level's aggregation."""
    _, _, pj, pt = pair
    assert pt.log_.nvs == pj.log_.nvs
    assert pt.log_.nnzs == pj.log_.nnzs
    assert pt.operator_complexity == pj.operator_complexity
    assert pt.num_levels == pj.num_levels >= 3
    for lj, lt in zip(pj.setup_levels_, pt.setup_levels_):
        assert lt.stencil is None and lt.lattice_transfer is None
        if lj.v2agg is None:
            assert lt.v2agg is None
            continue
        np.testing.assert_array_equal(lt.v2agg, lj.v2agg)


def test_prolongations_and_coarse_matrices(pair):
    _, _, pj, pt = pair
    for lj, lt in zip(pj.setup_levels_, pt.setup_levels_):
        if lj.P is not None:
            Pj, Pt = lj.P.tocsr(), lt.P.tocsr()
            assert Pt.shape == Pj.shape and Pt.nnz == Pj.nnz
            assert _rel_max(Pt, Pj) <= 1e-12
        Aj, At = lj.A.tocsr(), lt.A.tocsr()
        assert At.shape == Aj.shape and At.nnz == Aj.nnz
        assert _rel_max(At, Aj) <= 1e-12


def test_row_orders_and_scaling(pair):
    _, _, pj, pt = pair
    np.testing.assert_array_equal(pt._perm0, pj._perm0)
    np.testing.assert_array_equal(pt._iperm0, pj._iperm0)
    np.testing.assert_allclose(pt._scale0, pj._scale0, rtol=1e-14)


def test_staged_formats(pair):
    """Level formats, the DIA/tile-ELL choice and the tile-ELL layout."""
    _, _, pj, pt = pair
    for dj, dt in zip(pj.op.levels, pt.op.levels):
        Aj, At = dj.A, dt.A
        assert type(At).__name__ == type(Aj).__name__
        assert At.nrows == Aj.nrows and At.nrows_pad == Aj.nrows_pad
        if isinstance(At, tformats.TileELLStack):
            assert At.ncols_pad == Aj.ncols_pad
            assert len(At.blocks) == len(Aj.blocks)
            for bj, bt in zip(Aj.blocks, At.blocks):
                assert bt.chunk_c == bj.chunk_c == tformats.TILE_CHUNK
                assert bt.nrows == bj.nrows
                np.testing.assert_array_equal(bt.cols.numpy(), bj.cols)
                np.testing.assert_allclose(
                    bt.data.numpy(), np.asarray(bj.data), rtol=F32_ULP,
                    atol=0,
                )
        elif isinstance(At, tformats.DiaMatrix):
            assert At.offsets == Aj.offsets and not At.sym_half
            np.testing.assert_allclose(
                At.data.numpy(), np.asarray(Aj.data), rtol=F32_ULP, atol=0
            )
        else:
            np.testing.assert_allclose(
                At.data.numpy(), np.asarray(Aj.data), rtol=F32_ULP, atol=0
            )
    assert isinstance(pt.op.levels[0].A, tformats.TileELLStack)
    assert isinstance(pt.op.levels[-1].A, tformats.DenseMatrix)


def test_transfers_and_coarse_inverse(pair):
    _, _, pj, pt = pair
    rng = np.random.default_rng(3)
    for dj, dt in zip(pj.op.levels[:-1], pt.op.levels[:-1]):
        for Tj, Tt in ((dj.P, dt.P), (dj.R, dt.R)):
            assert isinstance(Tt, tformats.TileELL) and Tt.chunk_c == 1
            # TileELL with the native packer, SupernodeELL without it
            assert type(Tj).__name__ in ("TileELL", "SupernodeELL")
            x = np.zeros((Tt.ncols_pad, 1), dtype=np.float32)
            n_in = Tt.ncols_pad
            x[:n_in, 0] = rng.standard_normal(n_in)
            yj = np.asarray(jformats.matvec(Tj, jnp.asarray(x)))
            yt = tformats.matvec(Tt, torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(
                yt, yj, rtol=1e-5, atol=1e-5 * np.abs(yj).max()
            )
            if type(Tj).__name__ == "TileELL":
                np.testing.assert_array_equal(Tt.cols.numpy(), Tj.cols)
    cj, ct = np.asarray(pj.op.coarse_inv), pt.op.coarse_inv.numpy()
    assert ct.dtype == cj.dtype == np.float64 and ct.shape == cj.shape
    np.testing.assert_allclose(ct, cj, rtol=1e-9, atol=1e-9 * np.abs(cj).max())


def _clusters(cc):
    idx, inv = np.asarray(cc.idx), np.asarray(cc.inv)
    used = np.abs(inv).sum(axis=2) > 0
    return {tuple(sorted(int(v) for v in r[u])) for r, u in zip(idx, used)}


def test_cluster_correction(pair):
    """Same defective clusters (sets of permuted rows) and the same action
    of the correction on a random residual."""
    _, _, pj, pt = pair
    cj, ct = pj.op.cluster_corr, pt.op.cluster_corr
    assert ct is not None and cj is not None
    assert tuple(ct.idx.shape) == tuple(np.asarray(cj.idx).shape)
    assert ct.idx.dtype == torch.int64
    assert _clusters(ct) == _clusters(cj)
    A0 = pt.op.levels[0].A
    r = np.zeros((A0.nrows_pad, 1), dtype=np.float32)
    r[: A0.nrows, 0] = np.random.default_rng(5).standard_normal(A0.nrows)
    zj = np.asarray(jcc.cluster_apply(cj, jnp.asarray(r)))
    zt = tcc.cluster_apply(ct, torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(zt, zj, rtol=1e-5, atol=1e-5 * np.abs(zj).max())


@pytest.mark.parametrize("what", ["A", "P", "R"])
def test_tile_ell_packers(pair, what):
    """The port's packers against the scipy product and the JAX matvec on
    the JAX package's packing of the same matrix: the permuted finest
    matrix (bucketed, chunked stack) and its prolongation/restriction
    (plain tile-ELL)."""
    _, _, pj, pt = pair
    lev = pt.setup_levels_[0]
    perm = tformats.plan_reorder(lev.A, 1)
    np.testing.assert_array_equal(
        perm,
        jformats.plan_reorder(
            lev.A, 1, 8, tile_sort_chunk=jformats.TILE_CHUNK
        ),
    )
    if what == "A":
        M = lev.A[perm][:, perm].tocsr()
        Tt = tformats.tile_ell_stack_from_scipy(M, np.float32)
        Tj = jformats.tile_ell_stack_from_scipy(M, np.float32, stage=True)
        jmv = jformats._tile_ell_stack_matvec
    else:
        M = lev.P.tocsr() if what == "P" else lev.P.T.tocsr()
        Tt = tformats.tile_ell_from_scipy(M, np.float32)
        Tj = jformats.tile_ell_from_scipy(M, np.float32, stage=True)
        if Tj is None:  # JAX package without its native packer
            Tj = jformats.supernode_from_scipy(
                M, np.float32, nr_pad=Tt.nrows_pad, nc_pad=Tt.ncols_pad,
                stage=True,
            )
        jmv = jformats.matvec
    x = np.zeros((Tt.ncols_pad, 1), dtype=np.float32)
    x[: M.shape[1], 0] = np.random.default_rng(11).standard_normal(M.shape[1])
    y_ref = M @ x[: M.shape[1], 0].astype(np.float64)
    yt = tformats.matvec(Tt, torch.from_numpy(x)).numpy()[:, 0]
    assert yt.shape == (Tt.nrows_pad,)
    np.testing.assert_allclose(
        yt[: M.shape[0]], y_ref, rtol=1e-5, atol=1e-5 * np.abs(y_ref).max()
    )
    np.testing.assert_array_equal(yt[M.shape[0]:], 0.0)
    op = jax.tree_util.tree_map(jnp.asarray, Tj)
    yj = np.asarray(jmv(op, jnp.asarray(x)))[:, 0]
    np.testing.assert_allclose(
        yt, yj[: len(yt)], rtol=1e-5, atol=1e-5 * np.abs(yj).max()
    )


def test_mesh_helpers_match(pair):
    """map_edges, scatter_add and mesh_from_matrix_graph on the finest
    mesh and its first aggregation."""
    _, p, pj, _ = pair
    lev = pj.setup_levels_[0]
    mj = JH1().build_finest_mesh(p.A.tocsr(), p.coords)
    mt = TH1().build_finest_mesh(p.A.tocsr(), p.coords)
    n_agg = int(lev.v2agg.max()) + 1
    for a, b in zip(
        ttopo.map_edges(mt, lev.v2agg, n_agg),
        jtopo.map_edges(mj, lev.v2agg, n_agg),
    ):
        np.testing.assert_array_equal(a, b)
    vals = np.random.default_rng(2).standard_normal((mt.nv, 3))
    np.testing.assert_array_equal(
        ttopo.scatter_add(lev.v2agg, vals, n_agg),
        jtopo.scatter_add(lev.v2agg, vals, n_agg),
    )
    W = abs(p.A.tocsr())
    np.testing.assert_array_equal(
        ttopo.mesh_from_matrix_graph(W).edges,
        jtopo.mesh_from_matrix_graph(W).edges,
    )
    Gt, Gj = mt.edge_graph(TH1().soc(mt)), mj.edge_graph(JH1().soc(mj))
    np.testing.assert_array_equal(Gt.indptr, Gj.indptr)
    np.testing.assert_array_equal(Gt.indices, Gj.indices)
    np.testing.assert_allclose(Gt.data, Gj.data, rtol=1e-12)


def test_graph_spw_matches(pair):
    """The strength-graph SPW (two rounds + orphan adoption) and its
    Galerkin-collapsed coarse graph."""
    _, p, _, _ = pair
    mt = TH1().build_finest_mesh(p.A.tocsr(), p.coords)
    S = mt.edge_graph(TH1().soc(mt))
    vt, nt = tpw.spw_aggregate(S, rounds=2, theta=0.08)
    vj, nj = jpw.spw_aggregate(S, rounds=2, theta=0.08)
    assert nt == nj
    np.testing.assert_array_equal(vt, vj)
    Ct = tpw.coarse_strength_graph(S, vt, nt)
    Cj = jpw.coarse_strength_graph(S, vj, nj)
    assert Ct.nnz == Cj.nnz
    assert _rel_max(Ct, Cj) <= 1e-12


def test_detect_clusters_alone(pair):
    """detect_clusters on the permuted, scaled finest matrix equals the
    JAX package's (whichever branch it runs)."""
    _, _, pj, pt = pair
    lev = pt.setup_levels_[0]
    perm = pt._perm0
    A = lev.A[perm][:, perm].tocsr()
    s = 1.0 / np.sqrt(A.diagonal())
    A = sp.diags(s) @ A @ sp.diags(s)
    ct = tcc.detect_clusters(A)
    cj = jcc.detect_clusters(A)
    assert _clusters(ct) == _clusters(cj) == _clusters(pt.op.cluster_corr)
