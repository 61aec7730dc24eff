"""Port parity for the Stokes host setup (facet AMG on the dual mesh).

The same seeded problems go through the JAX package and ngsamg_tpu_torch:
- every ``stokes_fem`` generator gives equal matrices, right-hand sides
  and geometry arrays at a small size;
- ``build_dual_mesh``, ``coarsen_cells``, ``map_stokes_mesh``, the flow
  prolongations (scalar and vector), the loop bases (lattice 4-cycles,
  spanning-forest cycles, vector lifts, short geometric loops) and their
  level contraction, ``preserved_prolongation``, ``_truncate_columns``
  and ``_curl_smooth_prol`` agree exactly, or to 1e-12 where sums
  reorder;
- the level loops of ``StokesAMG`` and ``StokesHDivAMG`` build the levels
  of the JAX package's numpy branches (``native.HAVE_NATIVE = False`` in
  both packages):
  operators, aggregates and curl matrices exactly, prolongations to
  1e-12;
- the invariants of the JAX package's ``tests/test_stokes.py`` and
  ``tests/test_stokes_loops.py`` hold on the port: loops that are exact
  cycles spanning ker(D), divergence-free and flux-preserving
  prolongations, ``P @ V_c == V_f``;
- ``HiptmairSmoother`` staging, the f32 -> bf16 cast of a staged
  Hiptmair level, the errors: ``dist_setup > 1`` names ROADMAP item 8c,
  ``device="cuda"`` without CUDA raises.
"""

import contextlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ngsamg_tpu
import ngsamg_tpu.native as jnative
import ngsamg_tpu_torch
import ngsamg_tpu_torch.native as tnative
from ngsamg_tpu.apps import stokes as jst
from ngsamg_tpu.apps import stokes_hdiv as jhd
from ngsamg_tpu.mesh.topo import map_edges as jmap_edges
from ngsamg_tpu.precond import stokes as jpre
from ngsamg_tpu.utils import stokes_fem as jsf
from ngsamg_tpu_torch.apps import stokes as tst
from ngsamg_tpu_torch.apps import stokes_hdiv as thd
from ngsamg_tpu_torch.mesh.topo import map_edges as tmap_edges
from ngsamg_tpu_torch.precond import stokes as tpre
from ngsamg_tpu_torch.utils import stokes_fem as tsf

torch.set_num_threads(2)


@contextlib.contextmanager
def reference_numpy():
    """Both packages on their numpy branches (the JAX package's native RAP
    sums in another order, and ``_truncate_columns`` then breaks the
    lattice's exact ties differently: P differs by a few per cent on
    curl-smoothed levels)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "HAVE_NATIVE", False)
        mp.setattr(tnative, "HAVE_NATIVE", False)
        yield


# (label, generator call) at a small size; each returns a StokesProblem,
# or a tuple whose arrays are compared one by one
GENERATORS = {
    "mac_2d": lambda m: m.stokes_mac_2d(6, alpha=10.0),
    "mac_2d_hdiv": lambda m: m.stokes_mac_2d_hdiv(6),
    "mac_3d": lambda m: m.stokes_mac_3d(3),
    "tri_2d": lambda m: m.stokes_tri(6, dim=2),
    "tri_3d": lambda m: m.stokes_tri(3, dim=3, seed=2),
    "cr_2d": lambda m: m.stokes_cr(5, dim=2),
    "cr_3d": lambda m: m.stokes_cr(3, dim=3),
    "tri_hdiv_2d": lambda m: m.stokes_tri_hdiv(6),
    "tri_hdiv_3d": lambda m: m.stokes_tri_hdiv(3, dim=3),
    "hdg_p1_2d": lambda m: m.stokes_hdg_p1(4),
    "hdg_p1_3d": lambda m: m.stokes_hdg_p1(3, dim=3),
}


def _leaves(obj, label="out"):
    """(label, value) of every array, matrix and scalar in a generator's
    output."""
    if isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            yield from _leaves(v, f"{label}[{i}]")
    elif isinstance(obj, dict):
        for k in sorted(obj):
            yield from _leaves(obj[k], f"{label}.{k}")
    elif type(obj).__name__ == "StokesProblem":
        for k in sorted(vars(obj)):
            yield from _leaves(getattr(obj, k), f"{label}.{k}")
    else:
        yield label, obj


def _assert_same(a, b, label, rtol=0.0):
    if sp.issparse(a) or sp.issparse(b):
        assert sp.issparse(a) and sp.issparse(b), label
        assert a.shape == b.shape, label
        d = abs(sp.csr_matrix(a) - sp.csr_matrix(b))
        scale = max(abs(sp.csr_matrix(b)).max(), 1e-300)
        assert d.max() <= rtol * scale, (label, d.max(), scale)
    elif a is None or b is None:
        assert a is None and b is None, label
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, label
        if rtol:
            np.testing.assert_allclose(a, b, rtol=0, atol=rtol * max(
                np.abs(b).max(initial=0.0), 1e-300), err_msg=label)
        else:
            np.testing.assert_array_equal(a, b, err_msg=label)


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_match(name):
    out_j = GENERATORS[name](jsf)
    out_t = GENERATORS[name](tsf)
    lj, lt = list(_leaves(out_j)), list(_leaves(out_t))
    assert [k for k, _ in lj] == [k for k, _ in lt]
    for (k, a), (_, b) in zip(lt, lj):
        _assert_same(a, b, f"{name} {k}")


# --- one coarsening step in both packages --------------------------------


def _problem(name):
    out = GENERATORS[name]
    pj, pt = out(jsf), out(tsf)
    if isinstance(pj, tuple):
        pj, pt = pj[0], pt[0]
    return pj, pt


def _step(st, map_edges, p, vec=False):
    mesh, interior = st.build_dual_mesh(
        p.cell_pos, p.cell_vol, p.facet_cells, p.facet_flow
    )
    v2agg, n_agg = st.coarsen_cells(mesh)
    ce, e2ce = map_edges(mesh, v2agg, n_agg)
    cmesh = st.map_stokes_mesh(mesh, v2agg, n_agg, ce, e2ce)
    prol = st.flow_prolongation_vec if vec else st.flow_prolongation
    P = prol(mesh, cmesh, v2agg, e2ce)
    return dict(mesh=mesh, interior=interior, v2agg=v2agg, n_agg=n_agg,
                ce=ce, e2ce=e2ce, cmesh=cmesh, P=P)


STEP_CASES = {  # problem, vector dofs, perturbed cell centres
    "mac_2d": ("mac_2d", False, False),
    "mac_2d_perturbed": ("mac_2d", False, True),
    "mac_3d": ("mac_3d", False, False),
    "tri_2d": ("tri_2d", False, False),
    "tri_3d": ("tri_3d", False, False),
    "cr_2d": ("cr_2d", True, False),
    "cr_3d": ("cr_3d", True, False),
}


def _perturbed(p):
    rng = np.random.default_rng(5)
    p.cell_pos = p.cell_pos + rng.uniform(-0.2, 0.2, p.cell_pos.shape) / 6
    return p


@pytest.fixture(scope="module", params=sorted(STEP_CASES))
def step(request):
    name, vec, perturb = STEP_CASES[request.param]
    pj, pt = _problem(name)
    if perturb:
        pj, pt = _perturbed(pj), _perturbed(pt)
    return (request.param, vec, pt,
            _step(jst, jmap_edges, pj, vec), _step(tst, tmap_edges, pt, vec))


def test_dual_mesh_and_coarsening_match(step):
    name, _vec, _p, j, t = step
    for key in ("interior", "v2agg", "ce", "e2ce"):
        _assert_same(t[key], j[key], f"{name} {key}")
    assert t["n_agg"] == j["n_agg"]
    for lvl in ("mesh", "cmesh"):
        mj, mt = j[lvl], t[lvl]
        assert mt.nv == mj.nv
        _assert_same(mt.edges, mj.edges, f"{name} {lvl} edges")
        for k in ("pos", "vol"):
            if k in mj.vertex_data:
                _assert_same(mt.vertex_data[k], mj.vertex_data[k],
                             f"{name} {lvl} {k}", rtol=1e-12)
        _assert_same(mt.edge_data["flow"], mj.edge_data["flow"],
                     f"{name} {lvl} flow", rtol=1e-12)


def test_flow_prolongation_matches(step):
    name, _vec, _p, j, t = step
    _assert_same(t["P"], j["P"], f"{name} P", rtol=1e-12)


def _loops(st, s, vec, incidence=None):
    build = st.build_loops_vec if vec else st.build_loops
    return build(s["mesh"], incidence=incidence), \
        build(s["cmesh"], incidence=None)


def test_loops_match(step):
    """Lattice 4-cycles on lattices, spanning-forest cycles off them,
    vector lifts for CR: the same curl matrices on both levels."""
    name, vec, _p, j, t = step
    for a, b, lvl in zip(_loops(tst, t, vec), _loops(jst, j, vec),
                         ("fine", "coarse")):
        _assert_same(a, b, f"{name} {lvl} loops")


@pytest.mark.parametrize("name", ["tri_2d", "tri_3d", "cr_2d"])
def test_geometric_and_contracted_loops_match(name):
    """Short geometric loops of the finest level and their contraction
    through one coarsening step."""
    pj, pt = _problem(name)
    vec = name.startswith("cr")
    outs = []
    for st, me, p in ((jst, jmap_edges, pj), (tst, tmap_edges, pt)):
        s = _step(st, me, p, vec)
        Y = st.geometric_loops(s["mesh"], p.facet_verts, p.vert_pos,
                               p.bnd_facet_verts)
        Yc = st.contract_loops(Y, s["mesh"], s["v2agg"], s["ce"], s["e2ce"])
        build = st.build_loops_vec if vec else st.build_loops
        outs.append((Y, Yc, build(s["mesh"], incidence=Y),
                     build(s["cmesh"], incidence=Yc)))
    for a, b, k in zip(outs[1], outs[0], ("Y", "Yc", "C", "Cc")):
        assert a is not None, (name, k)
        _assert_same(a, b, f"{name} {k}")


def test_zero_flow_loops_match():
    """Facets whose oriented flow sums cancelled (the JAX package's
    test_loops_with_zero_flow_facets_span_kernel), in both packages."""
    rng = np.random.default_rng(0)
    edges = np.array([[0, 1], [1, 2], [2, 3], [0, 3], [1, 3]])
    pos = rng.standard_normal((4, 2))
    flow = np.array([1.0, 2.0, 0.0, 1.5, -0.7])
    vflow = np.stack([flow, rng.standard_normal(5) * (flow != 0)], axis=1)
    outs = []
    for st in (jst, tst):
        mesh = st.AlgebraicMesh(nv=4, edges=edges)
        mesh.vertex_data["pos"] = pos
        mesh.vertex_data["vol"] = np.ones(4)
        mesh.edge_data["flow"] = flow
        C = st.build_loops_tree(mesh)
        mesh.edge_data["flow"] = vflow
        outs.append((C, st.build_loops_vec(mesh)))
    (Cj, Cvj), (Ct, Cvt) = outs
    _assert_same(Ct, Cj, "scalar")
    _assert_same(Cvt, Cvj, "vector")
    D = sp.coo_matrix(
        (np.concatenate([flow, -flow]),
         (np.concatenate([edges[:, 0], edges[:, 1]]),
          np.concatenate([np.arange(5)] * 2))),
        shape=(4, 5),
    ).tocsr()
    assert np.abs(D @ Ct).max() < 1e-14
    want = 5 - np.linalg.matrix_rank(D.toarray())
    assert np.linalg.matrix_rank(Ct.toarray()) == Ct.shape[1] == want


def test_truncate_columns_and_curl_smoothing_match():
    rng = np.random.default_rng(3)
    Y = sp.random(40, 25, density=0.5, random_state=rng, format="csc")
    for k, f in ((4, 0.0), (40, 0.5), (3, 0.1)):
        _assert_same(tpre._truncate_columns(Y, k, f),
                     jpre._truncate_columns(Y, k, f), f"truncate {k} {f}")
    T = tpre._truncate_columns(Y, 4, 0.0)
    assert (np.diff(T.indptr) <= 4).all()
    for j in range(25):
        col = np.abs(Y[:, j].toarray().ravel())
        kept = np.abs(T[:, j].toarray().ravel())
        nk = int((kept > 0).sum())
        if nk:
            assert kept.max() == col.max()
            assert (col[kept > 0] >= np.sort(col[col > 0])[-nk]).all()
    pj, pt = _problem("mac_2d")
    outs = []
    for st, pre, me, p in ((jst, jpre, jmap_edges, pj),
                           (tst, tpre, tmap_edges, pt)):
        s = _step(st, me, p)
        C = st.build_loops(s["mesh"])
        outs.append(pre._curl_smooth_prol(p.A, C, s["P"], 4.0 / 3.0, 8,
                                          0.02))
    _assert_same(outs[1], outs[0], "curl-smoothed P", rtol=1e-12)
    # the correction is curl-valued: divergence preservation survives
    s = _step(tst, tmap_edges, pt)
    Cc = tst.build_loops(s["cmesh"])
    U = Cc @ np.random.default_rng(0).standard_normal(Cc.shape[1])
    assert np.abs(pt.D @ (outs[1] @ U)).max() < 1e-10


@pytest.mark.parametrize("name", ["mac_2d_hdiv", "tri_hdiv_2d",
                                  "tri_hdiv_3d"])
def test_preserved_prolongation_matches(name):
    out = GENERATORS[name]
    (pj, cj, Vj), (pt, ct, Vt) = out(jsf), out(tsf)
    res = []
    for st, hd, me, p, c, V in ((jst, jhd, jmap_edges, pj, cj, Vj),
                                (tst, thd, tmap_edges, pt, ct, Vt)):
        s = _step(st, me, p)
        res.append(hd.preserved_prolongation(
            s["mesh"], s["cmesh"], s["v2agg"], s["e2ce"],
            hd.MeshDOFs.from_counts(c), hd.PreservedVectors(1, V), s["P"],
        ))
    (Pj, dj, vj), (Pt, dt, vt) = res
    _assert_same(Pt, Pj, f"{name} P", rtol=1e-12)
    _assert_same(dt.offsets, dj.offsets, f"{name} coarse offsets")
    _assert_same(vt.vectors, vj.vectors, f"{name} coarse vectors",
                 rtol=1e-12)
    assert vt.n_special == vj.n_special == 1


# --- the JAX package's invariants on the port ------------------------------


def test_loops_span_kernel():
    p = tsf.stokes_mac_2d(8)
    mesh, _ = tst.build_dual_mesh(p.cell_pos, p.cell_vol, p.facet_cells,
                                  p.facet_flow)
    C = tst.build_loops(mesh)
    assert np.abs(p.D @ C).max() == 0.0
    ker_dim = p.n - np.linalg.matrix_rank(p.D.toarray())
    assert np.linalg.matrix_rank(C.toarray()) == ker_dim
    # off the lattice: spanning-forest cycles span ker(D) too
    p = _perturbed(tsf.stokes_mac_2d(8))
    mesh, _ = tst.build_dual_mesh(p.cell_pos, p.cell_vol, p.facet_cells,
                                  p.facet_flow)
    from ngsamg_tpu_torch.coarsen.lattice import detect_lattice

    assert detect_lattice(mesh.vertex_data["pos"]) is None
    C = tst.build_loops(mesh)
    assert np.abs(p.D @ C).max() == 0.0
    assert np.linalg.matrix_rank(C.toarray()) == ker_dim


@pytest.mark.parametrize("name", ["mac_2d", "tri_2d", "tri_3d"])
def test_prolongation_preserves_divergence_and_flux(name):
    # tri_3d at n = 6: on stokes_tri(n <= 5, dim=3) coarse facets whose
    # oriented flows cancel take singleton loop columns that D_f P does
    # not map to zero, in both packages (ROADMAP section 3)
    p = tsf.stokes_tri(6, dim=3)[0] if name == "tri_3d" else \
        _problem(name)[1]
    s = _step(tst, tmap_edges, p)
    mesh, cmesh, P, v2agg, e2ce = (s[k] for k in ("mesh", "cmesh", "P",
                                                   "v2agg", "e2ce"))
    Cc = tst.build_loops(cmesh)
    rng = np.random.default_rng(0)
    U = Cc @ rng.standard_normal(Cc.shape[1])
    assert np.abs(p.D @ (P @ U)).max() < 1e-10
    U = rng.standard_normal(cmesh.ne)
    u = P @ U
    sgn = np.where(
        v2agg[mesh.edges[:, 0]] == cmesh.edges[np.maximum(e2ce, 0), 0],
        1.0, -1.0,
    )
    tot = np.zeros(cmesh.ne)
    m = e2ce >= 0
    np.add.at(tot, e2ce[m], (sgn * mesh.edge_data["flow"] * u)[m])
    np.testing.assert_allclose(tot, cmesh.edge_data["flow"] * U,
                               atol=1e-12)


def test_cr_vector_invariants():
    dim = 2
    p, _n = tsf.stokes_cr(10, dim=dim)
    s = _step(tst, tmap_edges, p, vec=True)
    mesh, cmesh, P, v2agg = s["mesh"], s["cmesh"], s["P"], s["v2agg"]
    C = tst.build_loops_vec(mesh)
    assert np.abs(p.D @ C).max() < 1e-12
    ncell = len(p.cell_vol)
    cnt = np.bincount(p.facet_cells.ravel(), minlength=ncell)
    agg_bnd = np.zeros(s["n_agg"], dtype=bool)
    np.maximum.at(agg_bnd, v2agg, cnt < dim + 1)
    fac_ok = ~(agg_bnd[v2agg[mesh.edges[:, 0]]]
               | agg_bnd[v2agg[mesh.edges[:, 1]]])
    sel = np.repeat(fac_ok, dim)
    for k in range(dim):
        U = np.zeros(cmesh.ne * dim)
        U[k::dim] = 1.0
        err = np.abs((P @ U - np.tile(np.eye(dim)[k], mesh.ne))[sel]).max()
        assert err < 1e-10, err
    Cc = tst.build_loops_vec(cmesh)
    U = Cc @ np.random.default_rng(0).standard_normal(Cc.shape[1])
    assert np.abs(p.D @ (P @ U)).max() < 1e-10


@pytest.mark.parametrize("dim,n", [(2, 16), (3, 7)])
def test_geometric_loops_are_exact_cycles(dim, n):
    p, _ = tsf.stokes_tri(n, dim=dim)
    mesh, _ = tst.build_dual_mesh(p.cell_pos, p.cell_vol, p.facet_cells,
                                  p.facet_flow)
    Y = tst.geometric_loops(mesh, np.asarray(p.facet_verts), p.vert_pos,
                            p.bnd_facet_verts)
    assert Y is not None and Y.shape[1] > 0
    assert np.diff(Y.tocsc().indptr).max() <= 16
    C = tst.build_loops(mesh, incidence=Y)
    assert np.abs(p.D @ C).max() < 1e-12
    if dim == 2:  # the bounded faces of the planar dual: a full basis
        ker_dim = p.n - np.linalg.matrix_rank(p.D.toarray())
        assert np.linalg.matrix_rank(C.toarray()) == ker_dim


def test_hdiv_preserved_vectors_exact():
    """P @ V_c == V_f away from the no-slip boundary, divergence kept."""
    n = 12
    p, counts, V = tsf.stokes_mac_2d_hdiv(n)
    s = _step(tst, tmap_edges, p)
    mesh, v2agg, e2ce = s["mesh"], s["v2agg"], s["e2ce"]
    dofs = thd.MeshDOFs.from_counts(counts)
    P, dofs_c, pres_c = thd.preserved_prolongation(
        mesh, s["cmesh"], v2agg, e2ce, dofs, thd.PreservedVectors(1, V),
        s["P"],
    )
    assert P.shape == (dofs.ndof, dofs_c.ndof)
    assert dofs_c.counts().min() >= 1 and dofs_c.counts().max() >= 2
    E = np.abs(P @ pres_c.vectors - V)
    h = 1.0 / n
    cellpos = mesh.vertex_data["pos"]
    bnd_cell = (cellpos.min(axis=1) < 1.1 * h) | (
        cellpos.max(axis=1) > 1 - 1.1 * h)
    agg_bnd = np.zeros(s["n_agg"], dtype=bool)
    np.maximum.at(agg_bnd, v2agg, bnd_cell)
    fac = np.searchsorted(dofs.offsets, np.arange(dofs.ndof), "right") - 1
    excusable = ((e2ce[fac] < 0) & agg_bnd[v2agg[mesh.edges[fac, 0]]]
                 & np.isin(np.arange(dofs.ndof), dofs.offsets[:-1]))
    assert E[~excusable].max() < 1e-10
    assert E.max() < 2 * h
    Cc = tst.build_loops(s["cmesh"])
    Uc = np.zeros(dofs_c.ndof)
    Uc[dofs_c.offsets[:-1]] = Cc @ np.random.default_rng(0).standard_normal(
        Cc.shape[1])
    assert np.abs(p.D @ (P @ Uc)).max() < 1e-10


# --- the level loops --------------------------------------------------------


def _geo(p):
    return dict(facet_verts=p.facet_verts, vert_pos=p.vert_pos,
                bnd_facet_verts=p.bnd_facet_verts)


LOOP_CASES = {  # problem, max_coarse_size, geometric loops
    "tri_2d_geo": (lambda m: m.stokes_tri(20, dim=2)[0], 80, True),
    "tri_3d_geo": (lambda m: m.stokes_tri(5, dim=3)[0], 80, True),
    "mac_2d": (lambda m: m.stokes_mac_2d(16), 60, False),
    "cr_2d_geo": (lambda m: m.stokes_cr(10, dim=2)[0], 120, True),
}


def _amg(pkg, pre, p, mcs, geometric, **kw):
    opts = pkg.AMGOptions()
    opts.levels.max_coarse_size = mcs
    return pre.StokesAMG(
        p.A, cell_pos=p.cell_pos, cell_vol=p.cell_vol,
        facet_cells=p.facet_cells, facet_flow=p.facet_flow, options=opts,
        **(_geo(p) if geometric else {}), **kw,
    )


@pytest.mark.parametrize("name", sorted(LOOP_CASES))
def test_stokes_levels_match(name):
    """StokesAMG's level loop: the same levels, aggregates, prolongations,
    curl matrices and (f32 RAP) operators as the JAX package's numpy
    branches; the contracted loops stay exact cycles on every level."""
    mk, mcs, geo = LOOP_CASES[name]
    pj, pt = mk(jsf), mk(tsf)
    with reference_numpy():
        jl = _amg(ngsamg_tpu, jpre, pj, mcs, geo).setup().setup_levels_
        pc = _amg(ngsamg_tpu_torch, tpre, pt, mcs, geo, device="cpu").setup()
    tl = pc.setup_levels_
    assert [c.A.shape for c in tl] == [c.A.shape for c in jl]
    assert len(tl) >= 3
    for i, (a, b) in enumerate(zip(tl, jl)):
        _assert_same(a.A, b.A, f"{name} A{i}")
        _assert_same(a.C, b.C, f"{name} C{i}", rtol=1e-12)
        _assert_same(a.P, b.P, f"{name} P{i}", rtol=1e-12)
        _assert_same(a.v2agg, b.v2agg, f"{name} v2agg{i}")
        if a.C is None:
            continue
        mesh = a.mesh
        flow, e = mesh.edge_data["flow"], mesh.edges
        if flow.ndim == 1:
            D = sp.coo_matrix(
                (np.concatenate([flow, -flow]),
                 (np.concatenate([e[:, 0], e[:, 1]]),
                  np.concatenate([np.arange(len(e))] * 2))),
                shape=(mesh.nv, len(e)),
            ).tocsr()
            scale = max(1.0, np.abs(flow).max())
            assert np.abs(D @ a.C).max() < 1e-10 * scale, f"level {i}"
    if geo:
        assert pc._loops0 is not None


def test_geo_loops_operator_complexity():
    p, _ = tsf.stokes_tri(9, dim=3)
    pc = _amg(ngsamg_tpu_torch, tpre, p, 80, True, device="cpu").setup()
    nnz = sum(c.A.nnz for c in pc.setup_levels_)
    assert nnz / pc.setup_levels_[0].A.nnz < 4.0
    for cap in pc.setup_levels_[:-1]:
        assert cap.A.nnz / cap.A.shape[0] < 60


def test_hdiv_levels_match():
    (pj, cj, Vj), (pt, ct, Vt) = (jsf.stokes_tri_hdiv(14),
                                  tsf.stokes_tri_hdiv(14))
    out = []
    for pkg, pre, p, c, V, kw in (
        (ngsamg_tpu, jpre, pj, cj, Vj, {}),
        (ngsamg_tpu_torch, tpre, pt, ct, Vt, {"device": "cpu"}),
    ):
        opts = pkg.AMGOptions()
        opts.levels.max_coarse_size = 120
        with reference_numpy():
            out.append(pre.StokesHDivAMG(
                p.A, cell_pos=p.cell_pos, cell_vol=p.cell_vol,
                facet_cells=p.facet_cells, facet_flow=p.facet_flow,
                facet_dof_counts=c, preserved=V, options=opts, **kw,
            ).setup().setup_levels_)
    jl, tl = out
    assert [c.A.shape for c in tl] == [c.A.shape for c in jl]
    for i, (a, b) in enumerate(zip(tl, jl)):
        _assert_same(a.A, b.A, f"A{i}")
        _assert_same(a.P, b.P, f"P{i}", rtol=1e-12)
        _assert_same(a.dofs.offsets, b.dofs.offsets, f"offsets{i}")


def test_hdiv_boundary_facets_reindexed():
    """Counts and preserved vectors given over ALL facets (boundary ones
    included) are re-indexed onto the interior facets, as in the JAX
    package."""
    p, counts, V = tsf.stokes_tri_hdiv(8)
    fc = np.concatenate([p.facet_cells, [[0, -1], [3, -1]]])
    flow = np.concatenate([p.facet_flow, [1.0, 1.0]])
    c_all = np.concatenate([counts, [1, 2]])
    V_all = np.concatenate([V, np.ones((3, V.shape[1]))])
    kw = dict(cell_pos=p.cell_pos, cell_vol=p.cell_vol, facet_cells=fc,
              facet_flow=flow, facet_dof_counts=c_all, preserved=V_all)
    t = tpre.StokesHDivAMG(p.A, device="cpu", **kw)
    j = jpre.StokesHDivAMG(p.A, **kw)
    _assert_same(t.dofs0.offsets, j.dofs0.offsets, "offsets")
    _assert_same(t.pres0.vectors, j.pres0.vectors, "vectors")
    with pytest.raises(ValueError, match="interior facet counts"):
        tpre.StokesHDivAMG(p.A[:-1, :-1], device="cpu", **kw)


# --- staging and errors ----------------------------------------------------


def _tiny_stokes(**kw):
    p = tsf.stokes_mac_2d(8)
    opts = ngsamg_tpu_torch.AMGOptions(**kw)
    opts.levels.max_coarse_size = 40
    return p, tpre.StokesAMG(
        p.A, cell_pos=p.cell_pos, cell_vol=p.cell_vol,
        facet_cells=p.facet_cells, facet_flow=p.facet_flow, options=opts,
        device="cpu",
    )


def test_hiptmair_staging_and_cast():
    """The staged Hiptmair level holds its inner smoothers and three
    operators as tensors on the device, which ``stage_smoother`` moves
    from the host build; ``_cast_floats`` (the bf16 cast of the H1 path)
    walks it like any staged smoother."""
    from ngsamg_tpu_torch.precond.amg import _cast_floats
    from ngsamg_tpu_torch.smoothers.build import stage_smoother
    from ngsamg_tpu_torch.smoothers.hiptmair import HiptmairSmoother

    _p, pc = _tiny_stokes()
    pc.setup()
    sm = pc.op.levels[0].smoother
    assert isinstance(sm, HiptmairSmoother)
    assert isinstance(sm.range_sm.Dinv, torch.Tensor)
    assert isinstance(sm.pot_sm.Dinv, torch.Tensor)
    assert sm.C.nrows_pad == pc.op.levels[0].A.nrows_pad
    assert sm.CT.nrows_pad == sm.A_pot.nrows_pad == sm.C.ncols_pad
    host = pc._build_hiptmair(pc.setup_levels_[0], sm.C.nrows_pad, 0)
    assert isinstance(host.range_sm.Dinv, np.ndarray)
    again = stage_smoother(host, "cpu")
    assert isinstance(again, HiptmairSmoother)
    for a, b in ((again.C.data, sm.C.data), (again.CT.cols, sm.CT.cols),
                 (again.pot_sm.Dinv, sm.pot_sm.Dinv)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    bf = _cast_floats(sm, torch.bfloat16, {})
    assert isinstance(bf, HiptmairSmoother)
    assert bf.range_sm.Dinv.dtype == torch.bfloat16
    assert bf.C.data.dtype == torch.bfloat16
    assert bf.C.cols.dtype == torch.int64


def test_dist_setup_names_item_8c():
    """``dist_setup > 1`` (ROADMAP item 8c): off a lattice the StokesAMG
    and StokesHDivAMG hierarchies come from the distributed Stokes setup
    (parallel/dist_stokes.py) and solve; on a lattice the serial path
    runs, as in the JAX package."""
    from ngsamg_tpu_torch.parallel import dist_stokes as tdst

    p, _ = tsf.stokes_tri(6, dim=2)
    opts = ngsamg_tpu_torch.AMGOptions(dist_setup=2)
    opts.levels.max_coarse_size = 30
    pc = tpre.StokesAMG(
        p.A, cell_pos=p.cell_pos, cell_vol=p.cell_vol,
        facet_cells=p.facet_cells, facet_flow=p.facet_flow,
        options=opts, device="cpu",
    ).setup()
    ref = tdst.dist_stokes_levels(pc.A_host, pc.mesh0, 1, opts, 2)
    assert pc.num_levels == len(ref) >= 2
    for lev, r in zip(pc.setup_levels_, ref):
        assert abs(lev.A - r.A).max() == 0.0
    assert pc.log_.peak_shard_bytes > 0
    x, info = pc.solve(p.b, tol=1e-8, maxiter=100)
    assert info.converged
    ph, counts, V = tsf.stokes_tri_hdiv(6)
    ph_pc = tpre.StokesHDivAMG(
        ph.A, cell_pos=ph.cell_pos, cell_vol=ph.cell_vol,
        facet_cells=ph.facet_cells, facet_flow=ph.facet_flow,
        facet_dof_counts=counts, preserved=V, options=opts,
        device="cpu",
    ).setup()
    ref = tdst.dist_stokes_hdiv_levels(
        ph_pc.A_host, ph_pc.mesh0, ph_pc.dofs0, ph_pc.pres0, opts, 2
    )
    assert ph_pc.num_levels == len(ref) >= 2
    for lev, r in zip(ph_pc.setup_levels_, ref):
        assert abs(lev.A - r.A).max() == 0.0
    x, info = ph_pc.solve(ph.b, tol=1e-8, maxiter=200)
    assert info.converged
    _p, pc = _tiny_stokes(dist_setup=2)
    assert pc.setup().num_levels >= 2


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = tsf.stokes_mac_2d(6)
    geo = dict(cell_pos=p.cell_pos, cell_vol=p.cell_vol,
               facet_cells=p.facet_cells, facet_flow=p.facet_flow)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpre.StokesAMG(p.A, **geo)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpre.StokesHDivAMG(p.A, facet_dof_counts=np.ones(p.n, int),
                           preserved=np.zeros((p.n, 2)), **geo)
    S, _b, E, hgeo = tsf.stokes_hdg_p1(3)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpre.StokesHDGEmbeddedAMG(S, E, **hgeo)
