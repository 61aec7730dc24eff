"""Port parity for the front-end inputs of ``AMGPreconditioner``.

Each case builds the same seeded input, sets it up and solves it in the
JAX package and in ngsamg_tpu_torch (``device="cpu"``), and compares: level
count, level sizes and nnz equal; PCG iterations within one; ``converged``
the same; the true relative residual in the external (free-DOF) space at
most 1e-8 wherever the JAX package reaches it, and otherwise within a
factor 2 of the JAX package's; solutions within 1e-6 relative. The JAX
package sets up on the numpy branches of its host setup
(``ngsamg_tpu.native.HAVE_NATIVE = False``, its coloring kept on the native
greedy kernel), and so does the port; the vector-H1 case runs both on their
native kernels (the JAX package's numpy branch corrupts a cached BSR view
there).

The cases mirror the JAX package's tests:
- ``freedofs`` as a DOF subset, and as partial Dirichlet constraints (the
  scalFreeRows projection, ``test_frontend.py::
  test_partial_dirichlet_scalfreerows``);
- ``dof_layout="compound"`` (``test_h1.py::test_vec_h1_compound_layout``);
- ``elmat_data`` (``test_components.py::test_elmat_energy_mode``), and the
  accumulator's "alg", "sc" and "lsq" variants, the matrix graph and the
  LSQ weights (``test_elmat_accumulator_matches_matrix_graph``,
  ``test_elmat_lsq_variant``);
- ``nodalp2`` (``test_frontend.py::test_nodalp2_two_parent_embedding``);
- ``anisotropic_poisson_2d`` at angles 0 and pi/4
  (``test_h1.py::test_anisotropic_diffusion``);
- the two generators the port copies, bit for bit.
"""

import contextlib

import numpy as np
import pytest
import torch

import ngsamg_tpu
import ngsamg_tpu.native as jnative
import ngsamg_tpu_torch
import ngsamg_tpu_torch.native as tnative
from ngsamg_tpu.apps import elmat as jelmat
from ngsamg_tpu.factory import levels as jlevels
from ngsamg_tpu.utils import fem as jfem
from ngsamg_tpu_torch.apps import elmat as telmat
from ngsamg_tpu_torch.factory import levels as tlevels
from ngsamg_tpu_torch.utils import fem as tfem

torch.set_num_threads(2)


def _native_color(indptr, indices):
    return np.asarray(
        jnative._nat.greedy_color(*jnative._csr_idx(indptr, indices))
    )


@contextlib.contextmanager
def numpy_branches():
    """Both packages on the numpy branches of their host setup; the JAX
    package's GS coloring stays on the native greedy kernel, which the
    port copies."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "HAVE_NATIVE", False)
        mp.setattr(tnative, "HAVE_NATIVE", False)
        if getattr(jnative, "_nat", None) is not None:
            mp.setattr(jnative, "greedy_color", _native_color)
        yield


# ---------------------------------------------------------------------------
# the generators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jump", [False, True])
def test_poisson_2d_elmats_bitwise(jump):
    pj, dj, ej = jfem.poisson_2d_elmats(12, jump=jump)
    pt, dt, et = tfem.poisson_2d_elmats(12, jump=jump)
    assert (pt.A != pj.A).nnz == 0 and pt.A.nnz == pj.A.nnz
    np.testing.assert_array_equal(pt.b, pj.b)
    np.testing.assert_array_equal(pt.coords, pj.coords)
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(et, ej)


@pytest.mark.parametrize("angle", [0.0, np.pi / 4])
def test_anisotropic_poisson_2d_bitwise(angle):
    pj = jfem.anisotropic_poisson_2d(16, eps=1e-3, angle=angle)
    pt = tfem.anisotropic_poisson_2d(16, eps=1e-3, angle=angle)
    assert (pt.A != pj.A).nnz == 0 and pt.A.nnz == pj.A.nnz
    np.testing.assert_array_equal(pt.b, pj.b)
    np.testing.assert_array_equal(pt.coords, pj.coords)


# ---------------------------------------------------------------------------
# front-end cases
# ---------------------------------------------------------------------------


def _opts(pkg, dtype="float32", max_coarse=None):
    o = pkg.AMGOptions(dtype=dtype)
    if max_coarse is not None:
        o.levels.max_coarse_size = max_coarse
    return o


def _nodalp2_case():
    """The fine unit-square grid viewed as P2 over the half-resolution
    vertex grid; midnodes embed as parent averages (the construction of
    the JAX package's test_nodalp2_two_parent_embedding, with the vertices
    at the odd interior coordinates, so that every midnode's parents are
    interior nodes)."""
    n = 32
    prob = tfem.poisson_2d(n)
    m = n - 1
    idx = np.arange(m * m)
    pi, pj = idx // m + 1, idx % m + 1
    is_vert = (pi % 2 == 1) & (pj % 2 == 1)
    trips = []
    for t in np.flatnonzero(~is_vert):
        ti, tj = pi[t], pj[t]
        if ti % 2 == 0 and tj % 2:  # horizontal midnode
            p1, p2 = (ti - 1, tj), (ti + 1, tj)
        elif ti % 2:  # vertical midnode
            p1, p2 = (ti, tj - 1), (ti, tj + 1)
        else:  # diagonal midnode
            p1, p2 = (ti - 1, tj - 1), (ti + 1, tj + 1)
        trips.append((t, (p1[0] - 1) * m + p1[1] - 1,
                      (p2[0] - 1) * m + p2[1] - 1))
    return prob, np.asarray(trips, dtype=np.int64), is_vert


def _case(name):
    """(A, b, A_ext, b_ext, kwargs(pkg)): the matrix and right-hand side
    handed to the preconditioner, the external-space operator and
    right-hand side the true residual is taken in, and the constructor's
    keyword arguments for a package."""
    if name == "freedofs-subset":
        p = tfem.poisson_2d(40)
        fd = np.random.default_rng(0).random(p.n) > 0.1
        idx = np.flatnonzero(fd)
        A_ext = p.A[idx][:, idx].tocsr()
        return p.A, p.b[idx], A_ext, p.b[idx], lambda pkg: dict(
            coords=p.coords, freedofs=fd, options=_opts(pkg))
    if name == "partial-dirichlet":
        p = tfem.elasticity_2d(8, length=6)
        fd = np.ones(p.n, dtype=bool)
        fixed_v = np.random.default_rng(0).choice(p.n // 2, 10, replace=False)
        fd[fixed_v * 2 + 1] = False
        idx = np.flatnonzero(fd)
        A_ext = p.A[idx][:, idx].tocsr()
        return p.A, p.b[idx], A_ext, p.b[idx], lambda pkg: dict(
            energy="elasticity", block_size=2, coords=p.coords,
            freedofs=fd, options=_opts(pkg, "float64", max_coarse=60))
    if name == "compound":
        base = tfem.poisson_2d(24)
        prob = tfem.vector_poisson(base, 2)
        nv = base.n
        perm = (np.arange(2)[None, :] * nv + np.arange(nv)[:, None]).ravel()
        inv = np.argsort(perm)
        A_c = prob.A[inv][:, inv].tocsr()
        return A_c, prob.b[inv], A_c, prob.b[inv], lambda pkg: dict(
            block_size=2, coords=prob.coords, dof_layout="compound",
            options=_opts(pkg))
    if name == "elmat":
        p, dnums, elmats = tfem.poisson_2d_elmats(32)
        return p.A, p.b, p.A, p.b, lambda pkg: dict(
            coords=p.coords, elmat_data=(dnums, elmats), options=_opts(pkg))
    if name == "nodalp2":
        p, trips, is_vert = _nodalp2_case()
        return p.A, p.b, p.A, p.b, lambda pkg: dict(
            coords=p.coords[is_vert], nodalp2=trips,
            options=_opts(pkg, "float64"))
    if name.startswith("anisotropic"):
        angle = 0.0 if name.endswith("-0") else np.pi / 4
        p = tfem.anisotropic_poisson_2d(48, eps=1e-2, angle=angle)
        return p.A, p.b, p.A, p.b, lambda pkg: dict(
            coords=p.coords, options=_opts(pkg, "float64"))
    raise KeyError(name)


CASES = ["freedofs-subset", "partial-dirichlet", "compound", "elmat",
         "nodalp2", "anisotropic-0", "anisotropic-pi4"]


def _pair(name):
    A, b, A_ext, b_ext, kw = _case(name)
    ctx = contextlib.nullcontext() if name == "compound" else numpy_branches()
    with ctx:
        pj = ngsamg_tpu.AMGPreconditioner(A, **kw(ngsamg_tpu)).setup()
        pt = ngsamg_tpu_torch.AMGPreconditioner(
            A, device="cpu", **kw(ngsamg_tpu_torch)).setup()
    return pj, pt, A_ext, b_ext


def _relres(A, b, x):
    return float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))


@pytest.mark.parametrize("name", CASES)
def test_frontend_matches_jax(name):
    pj, pt, A_ext, b_ext = _pair(name)
    assert pt.num_levels == pj.num_levels >= 2
    assert pt.log_.nvs == pj.log_.nvs
    assert pt.log_.nnzs == pj.log_.nnzs
    xj, ij = pj.solve(b_ext, tol=1e-8, maxiter=100)
    xt, it = pt.solve(b_ext, tol=1e-8, maxiter=100)
    xj = np.asarray(xj)
    assert xt.shape == xj.shape == b_ext.shape
    assert abs(it.iterations - ij.iterations) <= 1, (it, ij)
    assert it.converged == ij.converged
    rj, rt = _relres(A_ext, b_ext, xj), _relres(A_ext, b_ext, xt)
    if rj <= 1e-8:
        assert rt <= 1e-8, (rt, rj)
    else:
        assert rt <= 2 * rj, (rt, rj)
    assert np.linalg.norm(xt - xj) <= 1e-6 * np.linalg.norm(xj)
    # apply and matvec_free work in the same external space
    r = np.random.default_rng(5).standard_normal(len(b_ext))
    np.testing.assert_allclose(pt.matvec_free(r), pj.matvec_free(r),
                               rtol=1e-12, atol=1e-12 * np.abs(r).max())
    zj, zt = np.asarray(pj.apply(r)), pt.apply(r)
    assert zt.shape == r.shape
    tol = 1e-10 if pt.dtype == torch.float64 else 1e-4
    assert np.linalg.norm(zt - zj) <= tol * np.linalg.norm(zj)


def test_external_space_maps():
    """Partial Dirichlet keeps every DOF of a touched vertex: the internal
    matrix has the kept size, the constrained components are projected
    (row and column zero but the diagonal), and the external map picks the
    free DOFs; the subset form and the interleaved layout map nothing."""
    A, b, A_ext, _b_ext, kw = _case("partial-dirichlet")
    pj = ngsamg_tpu.AMGPreconditioner(A, **kw(ngsamg_tpu))
    pt = ngsamg_tpu_torch.AMGPreconditioner(
        A, device="cpu", **kw(ngsamg_tpu_torch))
    np.testing.assert_array_equal(pt._ext_free, pj._ext_free)
    assert (pt.A_host != pj.A_host).nnz == 0
    np.testing.assert_array_equal(pt.coords, pj.coords)
    assert len(pt._ext_free) == A_ext.shape[0] < pt.n
    con = np.setdiff1d(np.arange(pt.n), pt._ext_free)
    Ac = pt.A_host.tocsc()[:, con].tocoo()
    assert (Ac.row == con[Ac.col]).all()  # constrained columns: diagonal only
    v = np.random.default_rng(2).standard_normal(len(pt._ext_free))
    np.testing.assert_array_equal(pt._contract_ext(pt._expand_ext(v)), v)
    A, _b, _A_ext, _b_ext, kw = _case("freedofs-subset")
    pt = ngsamg_tpu_torch.AMGPreconditioner(
        A, device="cpu", **kw(ngsamg_tpu_torch))
    assert pt._ext_free is None and pt.n == int(kw(ngsamg_tpu_torch)["freedofs"].sum())
    with pytest.raises(ValueError, match="compound layout"):
        ngsamg_tpu_torch.AMGPreconditioner(
            A, device="cpu", freedofs=np.ones(A.shape[0], bool),
            dof_layout="compound")
    with pytest.raises(ValueError, match="unknown dof_layout"):
        ngsamg_tpu_torch.AMGPreconditioner(A, device="cpu", dof_layout="x")


def test_compound_return_device_is_host_array():
    """``return_device=True`` returns a device tensor only without an
    external DOF map; the compound layout gets a host array in its own
    (component-major) order."""
    A, b, A_ext, b_ext, kw = _case("compound")
    pt = ngsamg_tpu_torch.AMGPreconditioner(
        A, device="cpu", **kw(ngsamg_tpu_torch)).setup()
    x, info = pt.solve(b_ext, tol=1e-8, return_device=True)
    assert isinstance(x, np.ndarray) and x.shape == b_ext.shape
    assert info.converged and _relres(A_ext, b_ext, x) <= 1e-8
    x0, info0 = pt.solve(np.zeros_like(b_ext), return_device=True)
    assert isinstance(x0, np.ndarray) and not x0.any() and info0.iterations == 0


def test_nodalp2_level_zero():
    """Level 0 is the full matrix on a mesh without edges, level 1 the
    vertex subspace; P = E (two-parent averages) as BSR, in both packages;
    the port stages level 0's transfer as tile-ELL (scalar) like every
    scalar explicit transfer."""
    pj, pt, _A, _b = _pair("nodalp2")
    lj, lt = pj.setup_levels_[0], pt.setup_levels_[0]
    assert lt.mesh.ne == lj.mesh.ne == 0
    assert lt.P.format == lj.P.format == "bsr"
    assert (lt.P.tocsr() != lj.P.tocsr()).nnz == 0
    _p, _t, is_vert = _nodalp2_case()
    assert pt.setup_levels_[1].A.shape[0] == int(is_vert.sum())
    assert type(pt.op.levels[0].P).__name__ == "TileELL"


@pytest.mark.parametrize("bs", [1, 2])
def test_nodalp2_embedding_matches(bs):
    """The embedding E of both packages on a block problem too (vector
    H1, two DOFs a node)."""
    p, trips, is_vert = _nodalp2_case()
    if bs > 1:
        p = tfem.vector_poisson(p, bs)
    kw = dict(block_size=bs, coords=p.coords[is_vert], nodalp2=trips)
    Ej = ngsamg_tpu.AMGPreconditioner(p.A, **kw)._nodalp2_embedding(bs)
    Et = ngsamg_tpu_torch.AMGPreconditioner(
        p.A, device="cpu", **kw)._nodalp2_embedding(bs)
    assert (Et != Ej).nnz == 0
    np.testing.assert_allclose(np.asarray(Et.sum(axis=1)).ravel(), 1.0)


# ---------------------------------------------------------------------------
# the ELMAT accumulator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["alg", "sc", "lsq"])
def test_elmat_variants_match_jax(variant):
    """The accumulator's mesh bit for bit, and the hierarchy that
    ``setup_levels(..., finest_mesh=)`` builds on it, in both packages."""
    p, dnums, elmats = tfem.poisson_2d_elmats(32, jump=True)
    meshes = []
    for mod in (jelmat, telmat):
        acc = mod.ElmatAccumulator(p.n, variant=variant)
        half = len(dnums) // 2  # in two chunks
        acc.add_batch(dnums[:half], elmats[:half])
        acc.add_batch(dnums[half:], elmats[half:])
        meshes.append(acc.finalize(p.coords))
    mj, mt = meshes
    np.testing.assert_array_equal(mt.edges, mj.edges)
    for k in mj.edge_data:
        np.testing.assert_array_equal(mt.edge_data[k], mj.edge_data[k])
    for k in mj.vertex_data:
        np.testing.assert_array_equal(mt.vertex_data[k], mj.vertex_data[k])
    runs = []
    for pkg, levels, mesh in ((ngsamg_tpu, jlevels, mj),
                              (ngsamg_tpu_torch, tlevels, mt)):
        opts = pkg.AMGOptions(dtype="float64")
        energy = pkg.precond.amg.H1Energy(bs=1)
        with numpy_branches():
            runs.append(levels.setup_levels(p.A, energy, opts, p.coords,
                                            finest_mesh=mesh))
    (lj, logj), (lt, logt) = runs
    assert logt.nvs == logj.nvs and logt.nnzs == logj.nnzs
    assert len(lt) >= 2
    for a, c in zip(lt, lj):
        if c.v2agg is not None:
            np.testing.assert_array_equal(a.v2agg, c.v2agg)
        assert abs(a.A - c.A).max() <= 1e-12 * abs(c.A).max()


def test_elmat_accumulator_matches_matrix_graph():
    """The "alg" variant reproduces the assembled off-diagonal pattern."""
    from ngsamg_tpu_torch.apps.h1 import H1Energy

    p, dnums, elmats = tfem.poisson_2d_elmats(12)
    acc = telmat.ElmatAccumulator(p.n, variant="alg")
    acc.add_batch(dnums, elmats)
    mesh = acc.finalize(p.coords)
    ref = H1Energy(1).build_finest_mesh(p.A, p.coords)
    assert mesh.ne == ref.ne
    np.testing.assert_array_equal(mesh.edges, ref.edges)


def test_elmat_lsq_weights_are_the_off_diagonals():
    """On P1 Laplace elements the LSQ fit is exact: each edge weight is the
    negated assembled off-diagonal."""
    p, dnums, elmats = tfem.poisson_2d_elmats(16)
    acc = telmat.ElmatAccumulator(p.n, variant="lsq")
    acc.add_batch(dnums, elmats)
    mesh = acc.finalize(p.coords)
    W = dict(zip(map(tuple, mesh.edges.tolist()), mesh.edge_data["wt"]))
    A = p.A.tocoo()
    checked = 0
    for i, j, v in zip(A.row, A.col, A.data):
        if i < j and (int(i), int(j)) in W and abs(v) > 1e-12:
            np.testing.assert_allclose(W[(int(i), int(j))], -v, rtol=1e-9)
            checked += 1
    assert checked > 50
    with pytest.raises(ValueError):
        telmat.ElmatAccumulator(4, variant="qr")
