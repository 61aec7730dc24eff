"""The port's distributed Stokes setup (parallel/dist_stokes.py) against
the JAX package's.

Mirrors tests/test_dist_stokes.py (its collective-transport case is in
tests/test_torch_collective_transport.py): the same problems go through
``ngsamg_tpu.parallel.dist_stokes`` (on its numpy branches,
``native.HAVE_NATIVE = False``) and the port's copy. Aggregates and
coarse edges are held bitwise, flows and volumes to rtol 1e-12, P and A
to the JAX tests' tolerances (P 1e-11 / 1e-10, A 1e-5 of max |A|; the HDiv
P 1e-9, A 1e-8); the port's distributed hierarchy is also held to its own
serial one there, as the JAX tests hold theirs. The end-to-end solves run
``StokesAMG``/``StokesHDivAMG`` with ``dist_setup = 3`` on the CPU: true
relres below 1e-7, iterations within the JAX tests' band of the port's
serial run and within one of the JAX package's distributed run.
"""

import contextlib

import numpy as np
import pytest
import scipy.sparse as sp

import ngsamg_tpu
import ngsamg_tpu.native as jnative
import ngsamg_tpu_torch
from ngsamg_tpu.parallel import dist_stokes as jdst
from ngsamg_tpu.precond import stokes as jpre
from ngsamg_tpu.utils import stokes_fem as jsf
from ngsamg_tpu_torch.parallel import dist_stokes as tdst
from ngsamg_tpu_torch.precond import stokes as tpre
from ngsamg_tpu_torch.utils import stokes_fem as tsf


@contextlib.contextmanager
def numpy_branches():
    old = jnative.HAVE_NATIVE
    jnative.HAVE_NATIVE = False
    try:
        yield
    finally:
        jnative.HAVE_NATIVE = old


def _opts(pkg, mcs, piecewise=False, **kw):
    o = pkg.AMGOptions(**kw)
    o.levels.max_coarse_size = mcs
    if piecewise:
        o.prol.type = pkg.SpecOpt(pkg.config.ProlType.PIECEWISE)
    return o


def _geo(p):
    return dict(cell_pos=p.cell_pos, cell_vol=p.cell_vol,
                facet_cells=p.facet_cells, facet_flow=p.facet_flow)


def _both(gen, args, kw, mcs, n_shards, piecewise, serial=False):
    """(JAX distributed levels, port distributed levels, port serial
    levels or None, port facet block size)."""
    pj = gen[0](*args, **kw)
    pj = pj[0] if isinstance(pj, tuple) else pj
    pt = gen[1](*args, **kw)
    pt = pt[0] if isinstance(pt, tuple) else pt
    oj = _opts(ngsamg_tpu, mcs, piecewise)
    ot = _opts(ngsamg_tpu_torch, mcs, piecewise)
    cj = jpre.StokesAMG(pj.A, **_geo(pj), options=oj)
    ct = tpre.StokesAMG(pt.A, **_geo(pt), options=ot, device="cpu")
    bs = ct.facet_bs
    with numpy_branches():
        jl = jdst.dist_stokes_levels(cj.A_host, cj.mesh0, bs, oj, n_shards)
    tl = tdst.dist_stokes_levels(ct.A_host, ct.mesh0, bs, ot, n_shards)
    sl = ct.setup().setup_levels_ if serial else None
    return jl, tl, sl, bs


def _div_op(mesh, bs):
    """Flow-weighted divergence of a level's dual mesh."""
    e = mesh.edges
    fl = mesh.edge_data["flow"]
    if bs == 1:
        rows = np.concatenate([e[:, 0], e[:, 1]])
        cols = np.concatenate([np.arange(mesh.ne)] * 2)
        vals = np.concatenate([fl, -fl])
        return sp.coo_matrix((vals, (rows, cols)),
                             shape=(mesh.nv, mesh.ne)).tocsr()
    dim = fl.shape[1]
    dofs = (np.arange(mesh.ne)[:, None] * dim + np.arange(dim)).ravel()
    rows = np.concatenate(
        [np.repeat(e[:, 0], dim), np.repeat(e[:, 1], dim)]
    )
    cols = np.concatenate([dofs, dofs])
    vals = np.concatenate([fl.ravel(), -fl.ravel()])
    return sp.coo_matrix(
        (vals, (rows, cols)), shape=(mesh.nv, mesh.ne * dim)
    ).tocsr()


def _parity(ref, tl, p_tol, flows=True):
    assert len(ref) == len(tl) >= 2
    for i, (rl, dl) in enumerate(zip(ref, tl)):
        assert rl.mesh.nv == dl.mesh.nv and rl.mesh.ne == dl.mesh.ne, i
        if rl.v2agg is not None:
            np.testing.assert_array_equal(rl.v2agg, dl.v2agg)
            np.testing.assert_array_equal(rl.mesh.edges, dl.mesh.edges)
        if flows and i > 0:
            np.testing.assert_allclose(
                rl.mesh.edge_data["flow"], dl.mesh.edge_data["flow"],
                rtol=1e-12, atol=1e-14,
            )
            np.testing.assert_allclose(
                rl.mesh.vertex_data["vol"], dl.mesh.vertex_data["vol"],
                rtol=1e-12,
            )
        if rl.P is not None:
            dP = abs(rl.P - dl.P).max()
            assert dP < p_tol, f"level {i} P differs {dP:.2e}"
        scale = max(abs(rl.A).max(), 1e-300)
        dA = abs(rl.A - dl.A).max()
        assert dA < 1e-5 * scale, f"level {i} A differs {dA:.2e}"


@pytest.mark.parametrize("n_shards", [2, 3])
def test_dist_stokes_scalar_piecewise_parity(n_shards):
    jl, tl, sl, _ = _both((jsf.stokes_tri, tsf.stokes_tri), (10,),
                          dict(dim=2, alpha=10.0), 60, n_shards, True,
                          serial=True)
    _parity(jl, tl, 1e-11)
    _parity(sl, tl, 1e-11)


def test_dist_stokes_3d_piecewise_parity():
    """Tet-mesh (3D) scalar facet-flux distributed setup."""
    jl, tl, sl, _ = _both((jsf.stokes_tri, tsf.stokes_tri), (5,),
                          dict(dim=3, alpha=10.0), 120, 3, True,
                          serial=True)
    _parity(jl, tl, 1e-10, flows=False)
    _parity(sl, tl, 1e-10, flows=False)
    for dl in tl:
        if dl.C is not None:
            D = _div_op(dl.mesh, 1)
            assert np.abs(D @ dl.C).max() < 1e-10 * max(
                np.abs(D.data).max(), 1.0
            )


@pytest.mark.parametrize("n_shards", [3])
def test_dist_stokes_vector_piecewise_parity(n_shards):
    jl, tl, sl, bs = _both((jsf.stokes_cr, tsf.stokes_cr), (8,),
                           dict(dim=2, alpha=10.0), 80, n_shards, True,
                           serial=True)
    assert bs == 2
    _parity(jl, tl, 1e-10, flows=False)
    _parity(sl, tl, 1e-10, flows=False)


@pytest.mark.parametrize("dim,gen,bs", [(2, "stokes_tri", 1),
                                        (2, "stokes_cr", 2)])
def test_dist_stokes_loops_span_kernel(dim, gen, bs):
    """The distributed loop basis spans exactly ker(D) on every level, and
    is the JAX package's basis."""
    jl, tl, _, tbs = _both((getattr(jsf, gen), getattr(tsf, gen)), (8,),
                           dict(dim=dim, alpha=10.0), 60, 3, False)
    assert tbs == bs
    assert len(tl) == len(jl) >= 2
    for i, (jd, dl) in enumerate(zip(jl, tl)):
        assert (jd.C is None) == (dl.C is None)
        if dl.C is None:
            continue
        assert abs(jd.C - dl.C).max() < 1e-12, i
        D = _div_op(dl.mesh, bs)
        dmax = np.abs(D @ dl.C).max()
        fmax = max(np.abs(D.data).max(), 1.0)
        assert dmax < 1e-10 * fmax, f"level {i}: D C = {dmax:.2e}"
        want = dl.mesh.ne * bs - np.linalg.matrix_rank(D.toarray())
        rank = np.linalg.matrix_rank(dl.C.toarray())
        assert rank == dl.C.shape[1] == want, (i, rank, dl.C.shape, want)


def _solve_both(gen, mcs, maxiter):
    pj = gen[0]()
    pj = pj[0] if isinstance(pj, tuple) else pj
    pt = gen[1]()
    pt = pt[0] if isinstance(pt, tuple) else pt
    out = {}
    for name, dist in (("serial", 0), ("dist", 3)):
        o = _opts(ngsamg_tpu_torch, mcs, dist_setup=dist)
        pc = tpre.StokesAMG(pt.A, **_geo(pt), options=o, device="cpu")
        x, info = pc.setup().solve(pt.b, tol=1e-8, maxiter=maxiter)
        r = np.linalg.norm(pt.A @ x - pt.b) / np.linalg.norm(pt.b)
        out[name] = (info, r)
    with numpy_branches():
        o = _opts(ngsamg_tpu, mcs, dist_setup=3)
        pc = jpre.StokesAMG(pj.A, **_geo(pj), options=o).setup()
        _x, info_j = pc.solve(pj.b, tol=1e-8, maxiter=maxiter)
    return out, info_j


def test_dist_stokes_solve_end_to_end():
    """StokesAMG through options.dist_setup: the smoothed prolongation on
    the distributed loop basis; convergence as the serial setup's."""
    out, info_j = _solve_both(
        (lambda: jsf.stokes_tri(12, dim=2, alpha=10.0),
         lambda: tsf.stokes_tri(12, dim=2, alpha=10.0)), 80, 150,
    )
    (info_s, _), (info_d, r) = out["serial"], out["dist"]
    assert info_s.converged and info_d.converged and r < 1e-7
    assert info_d.iterations <= info_s.iterations + 10
    assert abs(info_d.iterations - info_j.iterations) <= 1, (
        info_d.iterations, info_j.iterations,
    )


def test_dist_stokes_vector_solve_end_to_end():
    """CR (vector facet dofs), the distributed curl-space prolongation
    smoothing included, end to end."""
    out, info_j = _solve_both(
        (lambda: jsf.stokes_cr(8, dim=2, alpha=10.0),
         lambda: tsf.stokes_cr(8, dim=2, alpha=10.0)), 100, 200,
    )
    (info_s, _), (info_d, r) = out["serial"], out["dist"]
    assert info_s.converged and info_d.converged and r < 1e-7
    assert info_d.iterations <= info_s.iterations + 15
    assert abs(info_d.iterations - info_j.iterations) <= 1, (
        info_d.iterations, info_j.iterations,
    )


def test_dist_stokes_hdiv_parity():
    """The distributed HDiv setup (variable facet dofs, preserved vectors)
    equals the JAX package's and the port's serial one; preservation stays
    exact; the hierarchy solves."""
    pj, cj, Vj = jsf.stokes_tri_hdiv(8, dim=2, alpha=10.0)
    pt, ct, Vt = tsf.stokes_tri_hdiv(8, dim=2, alpha=10.0)

    def build(pkg, pre, p, counts, V, dist, **kw):
        o = _opts(pkg, 120, dist_setup=3 if dist else 0)
        return pre.StokesHDivAMG(
            p.A, **_geo(p), facet_dof_counts=counts, preserved=V,
            options=o, **kw,
        ).setup()

    with numpy_branches():
        pc_j = build(ngsamg_tpu, jpre, pj, cj, Vj, True)
    pc_s = build(ngsamg_tpu_torch, tpre, pt, ct, Vt, False, device="cpu")
    pc_d = build(ngsamg_tpu_torch, tpre, pt, ct, Vt, True, device="cpu")
    d_levels = pc_d.setup_levels_
    for ref in (pc_j.setup_levels_, pc_s.setup_levels_):
        assert len(ref) == len(d_levels) >= 2
        for i, (sl, dl) in enumerate(zip(ref, d_levels)):
            np.testing.assert_array_equal(sl.dofs.offsets, dl.dofs.offsets)
            if sl.v2agg is not None:
                np.testing.assert_array_equal(sl.v2agg, dl.v2agg)
            if sl.P is not None:
                dP = abs(sl.P - dl.P).max()
                assert dP < 1e-9, f"level {i} P differs {dP:.2e}"
            scale = max(abs(sl.A).max(), 1e-300)
            assert abs(sl.A - dl.A).max() < 1e-8 * scale, i
    s_levels = pc_s.setup_levels_
    for i, (sl, dl) in enumerate(zip(s_levels, d_levels)):
        if sl.P is not None:
            Vf = sl.pres.vectors
            dV = np.abs(dl.P @ d_levels[i + 1].pres.vectors - Vf).max()
            dVs = np.abs(sl.P @ s_levels[i + 1].pres.vectors - Vf).max()
            assert dV < max(5 * dVs, 1e-9), (i, dV, dVs)
    x, info = pc_d.solve(pt.b, tol=1e-8, maxiter=200)
    r = np.linalg.norm(pt.A @ x - pt.b) / np.linalg.norm(pt.b)
    assert info.converged and r < 1e-7
