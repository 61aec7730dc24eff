"""The port's native setup extension (``ngsamg_tpu_torch.native``).

- Both extensions are built here: the JAX package's (``setup.py`` or its
  autobuild) and the port's (``native/build.py``, on first use). A test
  that compares them asserts that both are loaded; none skips.
- Each of the 33 methods is BITWISE equal to the JAX extension's on inputs
  made with numpy from a seed (``np.array_equal``, no tolerance): the 31
  wrappers through both packages' wrappers, ``ell_slots`` and
  ``collapse_signed`` on both modules directly.
- The four checks of tests/test_native_kernels.py on the port, at their
  tolerances: ``rap_bsr`` for four block shapes, ``truncate_prol_blocks``,
  ``elast_ahat_bsr``, ``rho_power`` against the port's numpy branches.
- Every block-setup wrapper (``native/parity.py``
  ``block_setup_parity``) and every scalar-setup and staging wrapper
  (``scalar_setup_parity``) against the numpy branch beside its call.
- The hierarchies with ``HAVE_NATIVE`` on in both packages: elasticity
  (2D, 3D) and vector H1, and the scalar problems (unstructured Poisson
  with Chebyshev, a lattice Poisson with the default Gauss-Seidel options,
  a lattice Poisson with a CSR tail, the distributed setup): level sizes,
  operator complexity, nnz and aggregates equal, every A and P to 1e-12
  relative (in fact bitwise on this machine), the same native calls as the
  JAX package, the staged row orders, colours, cluster sets and tile-ELL
  columns equal, and the mixed PCG's iteration count within one.
- Declines: a caller that does not send an input to its wrapper, where
  the JAX package's caller does not either, counts it as declined and
  takes its numpy branch.
- Faults: ``greedy_color`` on a 257-vertex clique raises; a compiler that
  does not exist, or fails, raises ``RuntimeError`` and leaves no library;
  with ``HAVE_NATIVE`` off nothing is built, for a block or a scalar setup;
  an MP setup takes the parent's switch on every rank, and a scalar rank's
  hierarchy is the JAX package's native one.
- The module imports neither ``jax``, the JAX package nor ``torch``.
"""

import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ngsamg_tpu
import ngsamg_tpu.native as jnative
import ngsamg_tpu_torch
import ngsamg_tpu_torch.native as tnative
from ngsamg_tpu_torch.apps.elasticity import ElasticityEnergy as TEl
from ngsamg_tpu_torch.mesh.topo import AlgebraicMesh, map_edges, scatter_add
from ngsamg_tpu_torch.native import build as tbuild
from ngsamg_tpu_torch.utils import fem as tfem

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIRECT = ("ell_slots", "collapse_signed")  # methods no wrapper reaches


@contextlib.contextmanager
def switches(on: bool):
    """``HAVE_NATIVE`` set in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "HAVE_NATIVE", on)
        mp.setattr(tnative, "HAVE_NATIVE", on)
        yield


def _jax_ext():
    assert jnative.HAVE_NATIVE and jnative._nat is not None, (
        "the JAX package's native extension is not built"
    )
    return jnative._nat


def test_both_extensions_are_built():
    j, t = _jax_ext(), tnative.extension()
    names = {k for k in dir(j) if not k.startswith("_")}
    assert names == {k for k in dir(t) if not k.startswith("_")}
    assert len(names) == 33
    assert names == set(tnative.WRAPPERS) | set(DIRECT)
    assert t.__file__.startswith(str(tbuild.BUILD_ROOT))


# ---------------------------------------------------------------------------
# inputs from a seed
# ---------------------------------------------------------------------------


def _defective_pairs(A, rng, k=6):
    """A plus k strongly coupled, nearly singular vertex pairs (clusters
    that ``cluster_detect`` reports)."""
    n = A.shape[0]
    big = 1e3 * A.diagonal().max()
    i = rng.choice(n - 1, k, replace=False)
    r = np.concatenate([i, i + 1, i, i + 1])
    c = np.concatenate([i, i + 1, i + 1, i])
    v = np.concatenate([np.full(2 * k, big), np.full(2 * k, -0.999 * big)])
    return (A + sp.csr_matrix((v, (r, c)), shape=A.shape)).tocsr()


def _block_prol(rng, nf, ncv, d, fan=(1, 9)):
    """A sorted random BSR prolongation with (d, d) blocks."""
    rows, cols, blocks = [], [], []
    for i in range(nf):
        for c in np.sort(rng.choice(ncv, rng.integers(*fan), replace=False)):
            rows.append(i)
            cols.append(c)
            blocks.append(rng.standard_normal((d, d)))
    indptr = np.zeros(nf + 1, dtype=np.int64)
    np.add.at(indptr, np.array(rows) + 1, 1)
    P = sp.bsr_matrix(
        (np.array(blocks), np.array(cols, dtype=np.int32), np.cumsum(indptr)),
        shape=(nf * d, ncv * d),
    )
    P.has_sorted_indices = True
    return P


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    d = {}
    # scalar: an unstructured 2D Poisson matrix and a random aggregation
    A = tfem.unstructured_poisson(8, dim=2).A.tocsr()
    n = A.shape[0]
    n_agg = n // 3
    v2agg = np.concatenate(
        [np.arange(n_agg), rng.integers(0, n_agg, n - n_agg)]
    )[rng.permutation(n)].astype(np.int64)
    coo = sp.triu(A, k=1).tocoo()
    edges = np.stack([coo.row, coo.col], axis=1).astype(np.int64)
    w_signed = -coo.data
    l2 = np.abs(np.asarray(A.sum(axis=1)).ravel()) + 0.01
    P_pw = sp.csr_matrix(
        (np.ones(n), (np.arange(n), v2agg)), shape=(n, n_agg)
    )
    Dinv = sp.diags(1.0 / A.diagonal())
    W = abs(A - sp.diags(A.diagonal())).tocsr()
    W.eliminate_zeros()
    d.update(
        A=A, n=n, n_agg=n_agg, v2agg=v2agg, edges=edges, w=w_signed,
        l2=l2, P=(P_pw - 0.6 * (Dinv @ (A @ P_pw))).tocsr(), W=W,
        Ac=_defective_pairs(A, rng), x0=rng.standard_normal(n),
        rowperm=rng.permutation(n), colperm=rng.permutation(n),
        cm=(rng.random(n) < 0.9).astype(np.uint8),
    )
    # elasticity: the finest mesh of an unstructured 3D problem, its aux
    # diagonal, a random aggregation and the coarse mesh data
    p = tfem.unstructured_elasticity(6, dim=3)
    en = TEl(3)
    with switches(False):
        mesh = en.build_finest_mesh(p.A.tocsr(), p.coords)
        D = en.aux_diagonal(mesh)
        Ahat = en.replacement_matrix(mesh)
    nv = mesh.nv
    nc = nv // 4
    e2agg = np.concatenate(
        [np.arange(nc), rng.integers(0, nc, nv - nc)]
    )[rng.permutation(nv)].astype(np.int64)
    cedges, e2ce = map_edges(mesh, e2agg, nc)
    pos = mesh.vertex_data["pos"]
    cpos = scatter_add(e2agg, pos, nc) / np.bincount(e2agg)[:, None]
    Ahat.sort_indices()
    from ngsamg_tpu_torch.sparse.host import block_diagonal_fast

    Dinv_b = np.linalg.pinv(block_diagonal_fast(Ahat, 6))
    Ppw_b = sp.bsr_matrix(
        (rng.standard_normal((nv, 6, 6)), e2agg.astype(np.int32),
         np.arange(nv + 1)),
        shape=(nv * 6, nc * 6),
    )
    d.update(
        pos=pos, eedges=mesh.edges, E=mesh.edge_data["mat"], D=D,
        el2=mesh.vertex_data["l2wt"], s=en._s, nc=nc, cedges=cedges,
        e2ce=e2ce, cpos=cpos, Ahat=Ahat, Dinv_b=Dinv_b, Ppw_b=Ppw_b,
        Pb=_block_prol(rng, nv, nc, 6),
        # (3, 3) x (3, 6): the rectangular product of a level-0 transfer
        A3=sp.bsr_matrix(sp.kron(A, np.eye(3) * 2 + 1), blocksize=(3, 3)),
        B36=sp.bsr_matrix(
            sp.kron(P_pw, rng.standard_normal((3, 6))), blocksize=(3, 6)
        ),
        xb=rng.standard_normal(nv * 6),
    )
    return d


def _unit_scale(M):
    """The staging's scaling vector (precond/amg.py ``_sym_scale``)."""
    d = M.diagonal()
    return np.where(d > 0, 1.0 / np.sqrt(np.where(d > 0, d, 1.0)), 1.0)


def _tile_fill(nat, d):
    A, M, chunk = d["A"], 8, 4
    T = -(-A.shape[0] // M)
    cnt = nat.tile_chunk_counts(A.indptr, A.indices, M, chunk, T)
    K = int(cnt.max())
    out = []
    for dt in (np.float64, np.float32):
        Ad = sp.csr_matrix((A.data.astype(dt), A.indices, A.indptr),
                           shape=A.shape)
        od = np.zeros((T, K, chunk, M), dtype=dt)
        oc = np.zeros((T, K), dtype=np.int32)
        ok = nat.tile_ell_fill_range(Ad, M, chunk, 0, T, K, od, oc)
        out += [ok, od, oc]
    return out


def _direct(ext, name, d):
    A = d["A"]
    if name == "ell_slots":
        return ext.ell_slots(A.indptr.astype(np.int64))
    return ext.collapse_signed(
        A.indptr, A.indices, A.data.astype(np.float64), d["v2agg"],
        d["n_agg"],
    )


# each wrapper's calls on one package's module ``m``; several input
# variants where the method has modes
CALLS = {
    "greedy_color": lambda m, d: [m.greedy_color(d["A"].indptr,
                                                 d["A"].indices)],
    "rap_csr": lambda m, d: [
        m.rap_csr(d["A"], d["P"]),
        m.rap_csr(d["A"], d["P"], dtype=np.float32, symmetrize=True),
    ],
    "handshake_match": lambda m, d: [
        m.handshake_match(d["W"].indptr, d["W"].indices, d["W"].data,
                          d["cm"], 0.05, iters=8, jitter=j)
        for j in (False, True)
    ],
    "edges_to_adj": lambda m, d: [
        m.edges_to_adj(d["edges"], d["w"], d["n"])
    ],
    "map_edges_agg": lambda m, d: [
        m.map_edges_agg(d["edges"], d["v2agg"], d["n_agg"])
    ],
    "rho_power_h1": lambda m, d: [
        m.rho_power_h1(d["edges"], d["w"], d["l2"] + 2.0, d["x0"], 10)
    ],
    "tile_chunk_counts": lambda m, d: [
        m.tile_chunk_counts(d["A"].indptr, d["A"].indices, 8, 4,
                            -(-d["n"] // 8))
    ],
    "tile_ell_fill_range": _tile_fill,
    "tile_ell_pack": lambda m, d: [
        m.tile_ell_pack(d["A"], 8, -(-d["n"] // 8))
    ],
    "collapse_graph": lambda m, d: [
        m.collapse_graph(d["W"], d["v2agg"], d["n_agg"])
    ],
    "smoothed_prol_scalar": lambda m, d: [
        m.smoothed_prol_scalar(
            d["A"], d["edges"], np.abs(d["w"]), d["l2"], d["v2agg"],
            d["n_agg"], 0.6, 0.55, 4, 5, 0.1, filter_pos=f,
        )
        for f in (False, True)
    ],
    "finest_mesh_scal": lambda m, d: [
        m.finest_mesh_scal(d["A"], neg_only=a, signed_wt=b)
        for a, b in ((False, False), (True, False), (False, True))
    ],
    "csr_permute": lambda m, d: [
        m.csr_permute(d["A"], d["rowperm"], d["colperm"]),
        m.csr_permute(d["A"], rowperm=d["rowperm"]),
        m.csr_permute(d["A"], colperm=d["colperm"]),
    ],
    "cluster_detect": lambda m, d: [
        m.cluster_detect(d["Ac"], 0.35, 0.3, 16)
    ],
    "spw_round_h1": lambda m, d: [
        m.spw_round_h1(d["edges"], d["w"], d["l2"], cm, 0.05, iters=8)
        for cm in (None, d["cm"])
    ],
    "bsr_from_edge_blocks": lambda m, d: [
        m.bsr_from_edge_blocks(
            d["eedges"],
            *m.rigid_edge_blocks(d["pos"], d["eedges"], d["E"], d["s"]),
            d["D"],
        )
    ],
    "pencil_extreme_eig": lambda m, d: [
        m.pencil_extreme_eig(d["E"], d["D"][d["eedges"][:, 0]], tol=1e-10,
                             reduction=r)
        for r in ("min", "max")
    ],
    "harmonic_mean_sym": lambda m, d: [
        m.harmonic_mean_sym(d["D"][d["eedges"][:, 0]],
                            d["D"][d["eedges"][:, 1]], rcond=rc)
        for rc in (1e-10, 1e-12)
    ],
    "csr_sym_scale": lambda m, d: [
        m.csr_sym_scale(d["A"], _unit_scale(d["A"]))
    ],
    "frob2_sym": lambda m, d: [m.frob2_sym(d["E"]), m.frob2_sym(d["D"])],
    "bsr_sym_scale": lambda m, d: [
        m.bsr_sym_scale(d["Ahat"], _unit_scale(d["Ahat"]))
    ],
    "elast_rm_diag": lambda m, d: [
        m.elast_rm_diag(d["pos"], d["eedges"], d["E"], d["s"])
    ],
    "bsr_mm": lambda m, d: [
        m.bsr_mm(d["Ahat"], d["Ppw_b"]),
        m.bsr_mm(d["A3"], d["B36"]),
    ],
    "elast_map_edge_mats": lambda m, d: [
        m.elast_map_edge_mats(
            d["pos"], d["cpos"], d["eedges"][d["e2ce"] >= 0],
            d["e2ce"][d["e2ce"] >= 0], d["cedges"],
            d["E"][d["e2ce"] >= 0], d["s"],
        )
    ],
    "elast_soc_robust": lambda m, d: [
        m.elast_soc_robust(d["pos"], d["eedges"], d["E"], d["D"], d["s"],
                           tol=1e-10, reduction=r)
        for r in ("min", "max")
    ],
    "rap_bsr": lambda m, d: [
        m.rap_bsr(d["Ahat"], d["Pb"]),
        m.rap_bsr(d["Ahat"], d["Pb"], symmetrize=False),
    ],
    "bsr_smooth_update": lambda m, d: [
        m.bsr_smooth_update(d["Ahat"], d["Ppw_b"], d["Dinv_b"], 0.37)
    ],
    "truncate_prol_blocks": lambda m, d: [
        m.truncate_prol_blocks(d["Pb"], pc, d["s"], 4, 0.1)
        for pc in (d["cpos"], None)
    ],
    "elast_ahat_bsr": lambda m, d: [
        m.elast_ahat_bsr(d["pos"], d["eedges"], d["E"], d["s"], d["el2"])
    ],
    "rho_power": lambda m, d: [
        m.rho_power(d["Ahat"], d["Dinv_b"], d["xb"], 10),
        m.rho_power(d["A"], (1.0 / d["A"].diagonal())[:, None, None],
                    d["x0"], 12),
    ],
    "rigid_edge_blocks": lambda m, d: [
        m.rigid_edge_blocks(d["pos"], d["eedges"], d["E"], d["s"])
    ],
}


def _assert_bitwise(a, b, what):
    if sp.issparse(b):
        assert sp.issparse(a) and a.format == b.format, what
        assert a.shape == b.shape, what
        if b.format == "bsr":
            assert a.blocksize == b.blocksize, what
        for k in ("indptr", "indices", "data"):
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype and np.array_equal(x, y), (what, k)
    elif isinstance(b, (tuple, list)):
        assert isinstance(a, (tuple, list)) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bitwise(x, y, f"{what}[{i}]")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), what
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert np.array_equal(a, b), what
    else:
        assert type(a) is type(b) and a == b, what


@pytest.mark.parametrize("name", sorted(set(CALLS) | set(DIRECT)))
def test_method_bitwise_equals_jax_extension(name, data):
    """The port's build of a method against the JAX extension's, on the
    same seeded inputs: equal arrays (and dtypes), no tolerance."""
    j = _jax_ext()
    if name in DIRECT:
        _assert_bitwise(_direct(tnative.extension(), name, data),
                        _direct(j, name, data), name)
        return
    before = tnative.CALLS[name]["native"]
    with switches(True):
        out_t = CALLS[name](tnative, data)
        out_j = CALLS[name](jnative, data)
    assert out_t and all(o is not None for o in out_t), name
    assert tnative.CALLS[name]["native"] > before  # the C++ ran
    _assert_bitwise(out_t, out_j, name)


def test_wrappers_cover_every_method():
    assert set(CALLS) == set(tnative.WRAPPERS)
    assert len(tnative.WRAPPERS) == 31


def test_shape_declines_are_counted(data):
    """A wrapper returns None where the JAX package's does for the input's
    shape, and counts it as declined, not as a native call."""
    A3, B36, Pb = data["A3"], data["B36"], data["Pb"]
    P36 = sp.bsr_matrix(B36, blocksize=(3, 6))
    with switches(True):
        c0 = {k: dict(v) for k, v in tnative.CALLS.items()}
        cases = [
            ("bsr_mm", lambda m: m.bsr_mm(B36, B36)),  # 6 != 3
            ("rap_bsr", lambda m: m.rap_bsr(data["Ahat"], P36)),
            ("bsr_smooth_update",
             lambda m: m.bsr_smooth_update(data["Ahat"], Pb,
                                           data["Dinv_b"], 0.3)),
            ("truncate_prol_blocks",
             lambda m: m.truncate_prol_blocks(P36, None, 1.0, 4, 0.1)),
        ]
        for name, call in cases:
            assert call(jnative) is None and call(tnative) is None, name
            assert tnative.CALLS[name]["declined"] == (
                c0[name]["declined"] + 1
            ), name
            assert tnative.CALLS[name]["native"] == c0[name]["native"]


# ---------------------------------------------------------------------------
# tests/test_native_kernels.py on the port: native against numpy branches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("br,bc", [(3, 6), (6, 6), (2, 3), (1, 1)])
def test_rap_bsr_matches_scipy(br, bc):
    rng = np.random.default_rng(0)
    n, nc = 120, 40
    A = sp.random(n, n, density=0.06, random_state=1, format="csr")
    A = A + A.T + sp.eye(n) * 3
    Ab = sp.bsr_matrix(sp.kron(A, np.ones((br, br))), blocksize=(br, br))
    Pr = sp.random(
        n, nc, density=0.04, random_state=2, format="csr"
    ) + sp.csr_matrix(
        (np.ones(n), (np.arange(n), rng.integers(0, nc, n))),
        shape=(n, nc),
    )
    Pb = sp.bsr_matrix(
        sp.kron(Pr, rng.standard_normal((br, bc))), blocksize=(br, bc)
    )
    C = tnative.rap_bsr(Ab, Pb, symmetrize=True)
    ref = (Pb.T @ (Ab @ Pb)).tocsr()
    ref = ((ref + ref.T) * 0.5).tocsr()
    scale = max(abs(ref).max(), 1.0)
    assert abs(C.tocsr() - ref).max() < 1e-12 * scale
    # emitted rows are sorted BSR
    assert (np.diff(C.indptr) >= 0).all()
    for i in range(min(10, C.shape[0] // bc)):
        cols = C.indices[C.indptr[i]:C.indptr[i + 1]]
        assert (np.diff(cols) > 0).all()


def test_truncate_prol_blocks_matches_numpy():
    """Native truncation == the padded numpy branch: identical structure,
    values to FMA tolerance, for the rigid transport."""
    from ngsamg_tpu_torch.transfer import prolongation as tp

    rng = np.random.default_rng(3)
    en = TEl(3, rot_scale=2.0)
    nf, ncv, d = 150, 40, 6
    P = _block_prol(rng, nf, ncv, d)
    mesh_c = AlgebraicMesh(nv=ncv, edges=np.zeros((0, 2), dtype=np.int64))
    mesh_c.vertex_data["pos"] = rng.standard_normal((ncv, 3))
    nat = tnative.truncate_prol_blocks(
        P, mesh_c.vertex_data["pos"], en._s, 4, 0.04
    )
    with switches(False):
        ref = tp.truncate_prol(
            en, mesh_c, P.copy(), max_per_row=4, min_frac=0.04
        )
    assert (np.asarray(ref.indptr) == nat.indptr).all()
    assert (np.asarray(ref.indices) == nat.indices).all()
    assert abs(ref.tocsr() - nat.tocsr()).max() < 1e-12


def test_elast_ahat_bsr_matches_pipeline():
    """Fused A-hat assembly is bitwise equal to the two-kernel path."""
    rng = np.random.default_rng(4)
    nv = 100
    pos = rng.standard_normal((nv, 3))
    e = np.unique(np.sort(rng.integers(0, nv, (300, 2)), axis=1), axis=0)
    e = e[e[:, 0] != e[:, 1]]
    E = rng.standard_normal((len(e), 6, 6))
    E = E + np.transpose(E, (0, 2, 1))
    l2 = np.abs(rng.standard_normal(nv))
    new = tnative.elast_ahat_bsr(pos, e, E, 2.0, l2)
    Bii, Bij, Bji, Bjj = tnative.rigid_edge_blocks(pos, e, E, 2.0)
    Dv = np.zeros((nv, 6, 6))
    idx = np.arange(3)
    Dv[:, idx, idx] = l2[:, None]
    old = tnative.bsr_from_edge_blocks(e, Bii, Bij, Bji, Bjj, Dv)
    assert abs(new.tocsr() - old.tocsr()).max() == 0.0


def test_rho_power_matches_numpy_power_iteration():
    from ngsamg_tpu_torch.smoothers.build import _lam_max_estimate
    from ngsamg_tpu_torch.sparse.host import block_diagonal_fast

    rng = np.random.default_rng(5)
    n = 120
    A = sp.random(n, n, density=0.06, random_state=1, format="csr")
    A = A + A.T + sp.eye(n) * 3
    Ab = sp.kron(A, rng.standard_normal((3, 3)) + np.eye(3) * 5).tocsr()
    Ab = ((Ab + Ab.T) * 0.5).tocsr()
    Dinv = np.linalg.pinv(block_diagonal_fast(Ab, 3))
    x0 = np.random.default_rng(0).standard_normal(Ab.shape[0])
    with switches(False):
        ref = _lam_max_estimate(Ab, 3, Dinv)  # the numpy branch
    scal = tnative.rho_power(Ab, Dinv, x0, 12) * 1.05
    bsr = tnative.rho_power(
        sp.bsr_matrix(Ab, blocksize=(3, 3)), Dinv, x0, 12
    ) * 1.05
    assert abs(scal - ref) / ref < 1e-10
    assert abs(bsr - ref) / ref < 1e-10


def test_block_setup_wrappers_match_numpy_branches():
    """Every block-setup wrapper against the numpy branch beside its call,
    on the finest level of a 3D elasticity hierarchy, at the tolerances
    chip_smoke.py's ``[native]`` phase holds on the card's host
    (``native/parity.py``)."""
    from ngsamg_tpu_torch.native import parity

    p = tfem.unstructured_elasticity(10, dim=3)
    rows = parity.block_setup_parity(p.A, p.coords, 3)
    assert [r["wrapper"] for r in rows] == list(parity.TOLERANCES)
    assert len(rows) == 15
    assert max(parity.TOLERANCES.values()) <= 1e-8
    for r in rows:
        assert r["ok"], r


# ---------------------------------------------------------------------------
# the hierarchies against the JAX package's native run
# ---------------------------------------------------------------------------

def _opts(pkg, max_coarse):
    o = pkg.AMGOptions(smoother=pkg.config.SmootherOptions(
        type=pkg.config.SmootherType.CHEBYSHEV))
    if max_coarse is not None:
        o.levels.max_coarse_size = max_coarse
    return o


def _cheb(pkg):
    return _opts(pkg, None)


def _dist(pkg):
    o = _opts(pkg, None)
    o.dist_setup = 4
    return o


# the scalar-setup and staging wrappers (ROADMAP item 10c) the unstructured
# scalar setup reaches with its staging
SCALAR_STAGING = {"finest_mesh_scal", "spw_round_h1", "map_edges_agg",
                  "edges_to_adj", "rho_power_h1", "smoothed_prol_scalar",
                  "rap_csr", "csr_permute", "csr_sym_scale",
                  "tile_chunk_counts", "tile_ell_fill_range",
                  "tile_ell_pack", "cluster_detect"}

# name: (problem, energy, options, wrappers the setup must reach)
PROBLEMS = {
    "el2d": (lambda: tfem.unstructured_elasticity(40, dim=2), "elasticity",
             _cheb, {"rap_bsr", "rho_power", "bsr_sym_scale",
                     "truncate_prol_blocks"}),
    "el3d": (lambda: tfem.unstructured_elasticity(10, dim=3), "elasticity",
             lambda pkg: _opts(pkg, 40),
             {"rap_bsr", "rho_power", "bsr_sym_scale",
              "truncate_prol_blocks"}),
    "vh1": (lambda: tfem.vector_poisson(tfem.poisson_2d(32), 2), "h1",
            _cheb, {"rap_bsr", "rho_power", "bsr_sym_scale",
                    "truncate_prol_blocks", "finest_mesh_scal"}),
    # the generic level loop and the tile-ELL staging
    "h1_unstructured": (
        lambda: tfem.unstructured_poisson(16, dim=3, refine=1), "h1", _cheb,
        SCALAR_STAGING | {"rho_power"}),
    # AMGOptions() unchanged: multicolor GS levels
    "h1_gs": (lambda: tfem.poisson_3d(16), "h1",
              lambda pkg: pkg.AMGOptions(),
              {"greedy_color", "finest_mesh_scal", "map_edges_agg",
               "rap_csr", "csr_permute", "tile_ell_pack"}),
    # the stencil domain with a CSR tail
    "h1_lattice": (lambda: tfem.poisson_3d(24), "h1", _cheb,
                   {"rap_csr", "rho_power"}),
    # the host-distributed level loop (4 shards) and the tile-ELL staging
    "h1_dist": (
        lambda: tfem.unstructured_poisson(16, dim=3, refine=1), "h1", _dist,
        {"truncate_prol_blocks", "csr_permute", "csr_sym_scale",
         "tile_chunk_counts", "tile_ell_fill_range", "tile_ell_pack",
         "cluster_detect"}),
}


@contextlib.contextmanager
def counting_jax_wrappers(counts):
    """Count the JAX package's wrapper calls (its callers look each wrapper
    up on the module at call time)."""
    with pytest.MonkeyPatch.context() as mp:
        for name in tnative.WRAPPERS:
            f = getattr(jnative, name)

            def counted(*a, _f=f, _n=name, **k):
                counts[_n] = counts.get(_n, 0) + 1
                return _f(*a, **k)

            mp.setattr(jnative, name, counted)
        yield


@pytest.fixture(scope="module", params=sorted(PROBLEMS))
def native_pair(request):
    make, energy, options, _reach = PROBLEMS[request.param]
    p = make()
    _jax_ext()
    jcalls = {}
    with switches(True):
        with counting_jax_wrappers(jcalls):
            pj = ngsamg_tpu.AMGPreconditioner(
                p.A, energy=energy, block_size=p.block_size,
                coords=p.coords, options=options(ngsamg_tpu),
            ).setup()
        tnative.reset_calls()
        pt = ngsamg_tpu_torch.AMGPreconditioner(
            p.A, energy=energy, block_size=p.block_size, coords=p.coords,
            options=options(ngsamg_tpu_torch), device="cpu",
        ).setup()
        tcalls = {
            k: v["native"] + v["declined"] for k, v in tnative.CALLS.items()
            if v["native"] + v["declined"]
        }
    return request.param, p, pj, pt, jcalls, tcalls


def test_hierarchy_equals_jax_native_run(native_pair):
    name, _p, pj, pt, _jc, _tc = native_pair
    assert pt.log_.nvs == pj.log_.nvs and pt.log_.nnzs == pj.log_.nnzs
    assert len(pt.setup_levels_) == len(pj.setup_levels_) >= 2, name
    assert pt.operator_complexity == pj.operator_complexity
    for i, (lj, lt) in enumerate(zip(pj.setup_levels_, pt.setup_levels_)):
        for what in ("A", "P"):
            Mj, Mt = getattr(lj, what), getattr(lt, what)
            if Mj is None:
                assert Mt is None, (name, what, i)
                continue
            Mj, Mt = Mj.tocsr(), Mt.tocsr()
            assert Mt.shape == Mj.shape and Mt.nnz == Mj.nnz, (name, what, i)
            assert abs(Mt - Mj).max() <= 1e-12 * abs(Mj).max(), (
                name, what, i)
        if lj.v2agg is not None:
            np.testing.assert_array_equal(lt.v2agg, lj.v2agg)


def test_same_native_calls_as_jax(native_pair):
    """The port makes the JAX package's native calls: every wrapper the
    JAX package reaches, as often, and none it does not."""
    name, _p, _pj, _pt, jcalls, tcalls = native_pair
    assert tcalls == jcalls, name
    assert PROBLEMS[name][3] <= set(tcalls), name
    assert not any(v["declined"] for v in tnative.CALLS.values()), name


def _same_ints(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.array_equal(a, b), what


def test_staging_equals_jax_native_run(native_pair):
    """The staged hierarchy: the finest row order, each level's format and
    its column indices (tile-ELL slots, block-ELL blocks), every GS level's
    colours (bounds and per-colour columns), the transfers' columns and the
    cluster sets, all equal to the JAX package's."""
    name, _p, pj, pt, _jc, _tc = native_pair
    if pj._perm0 is None:
        assert pt._perm0 is None, name
    else:
        _same_ints(pt._perm0, pj._perm0, (name, "perm0"))
    for i, (dj, dt) in enumerate(zip(pj.op.levels, pt.op.levels)):
        for what in ("A", "P", "R"):
            Fj, Ft = getattr(dj, what), getattr(dt, what)
            assert type(Ft).__name__ == type(Fj).__name__, (name, i, what)
            bj = getattr(Fj, "blocks", (Fj,))
            bt = getattr(Ft, "blocks", (Ft,))
            assert len(bt) == len(bj), (name, i, what)
            for k, (fj, ft) in enumerate(zip(bj, bt)):
                if hasattr(fj, "cols"):  # tile-ELL slots, block-ELL blocks
                    _same_ints(ft.cols.numpy(), fj.cols, (name, i, what, k))
        sj, st = dj.smoother, dt.smoother
        if hasattr(sj, "color_bounds"):
            assert tuple(st.color_bounds) == tuple(sj.color_bounds), (name, i)
            assert len(st.ccols) == len(sj.ccols), (name, i)
            for c, (cj, ct) in enumerate(zip(sj.ccols, st.ccols)):
                _same_ints(ct.numpy(), cj, (name, i, "colour", c))
    cj, ct = pj.op.cluster_corr, pt.op.cluster_corr
    assert (cj is None) == (ct is None), name
    if cj is not None:
        assert _clusters(ct) == _clusters(cj), name


def _clusters(cc):
    """A cluster correction's clusters, as sets of (permuted) rows."""
    idx, inv = np.asarray(cc.idx), np.asarray(cc.inv)
    used = np.abs(inv).sum(axis=2) > 0
    return {tuple(sorted(int(v) for v in r[u])) for r, u in zip(idx, used)}


def test_mixed_solve_within_one_iteration(native_pair):
    _name, p, pj, pt, _jc, _tc = native_pair
    _xj, ij = pj.solve(p.b, tol=1e-8, mixed=True)
    xt, it = pt.solve(p.b, tol=1e-8, mixed=True)
    rel = np.linalg.norm(p.b - p.A @ xt) / np.linalg.norm(p.b)
    assert it.converged and rel <= 1e-8
    assert abs(it.iterations - ij.iterations) <= 1


def test_galerkin_block_branch_equals_jax():
    """``transfer.galerkin.rap`` with block sizes runs the JAX package's
    native block RAP (two ``bsr_mm`` passes), bitwise."""
    from ngsamg_tpu.transfer.galerkin import rap as jrap
    from ngsamg_tpu_torch.transfer.galerkin import rap as trap

    rng = np.random.default_rng(6)
    A = tfem.unstructured_poisson(6, dim=2).A
    Ab = sp.kron(A, np.eye(3) * 2 + 1).tocsr()
    P = sp.kron(
        sp.csr_matrix((np.ones(A.shape[0]), (np.arange(A.shape[0]),
                       rng.integers(0, 9, A.shape[0]))),
                      shape=(A.shape[0], 9)),
        rng.standard_normal((3, 6)),
    ).tocsr()
    with switches(True):
        c0 = tnative.CALLS["bsr_mm"]["native"]
        Ct = trap(Ab, P, dtype=np.float64, bs_r=3, bs_c=6)
        Cj = jrap(Ab, P, dtype=np.float64, bs_r=3, bs_c=6)
        assert tnative.CALLS["bsr_mm"]["native"] == c0 + 2
    _assert_bitwise(Ct, Cj, "rap")


# ---------------------------------------------------------------------------
# faults
# ---------------------------------------------------------------------------


def test_greedy_color_raises_past_256_colors():
    """The JAX extension would write color 256 past its mark array; the
    port's build raises, as the port's Python coloring does."""
    from ngsamg_tpu_torch.smoothers.coloring import jones_plassmann_coloring

    K = sp.csr_matrix(np.ones((257, 257)) - np.eye(257))
    with switches(True):
        with pytest.raises(RuntimeError, match="256 colors"):
            tnative.greedy_color(K.indptr, K.indices)
    with pytest.raises(RuntimeError, match="256 colors"):
        jones_plassmann_coloring(K)
    K256 = sp.csr_matrix(np.ones((256, 256)) - np.eye(256))
    with switches(True):
        np.testing.assert_array_equal(
            tnative.greedy_color(K256.indptr, K256.indices), np.arange(256)
        )


def test_missing_compiler_raises_and_leaves_no_library(tmp_path):
    cxx = str(tmp_path / "no-such-g++")
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        tbuild.build(cxx=cxx, root=tmp_path / "out")
    assert not list(tmp_path.rglob("*.so*"))


def test_failed_compile_raises_with_the_output(tmp_path):
    """A compiler that answers ``--version`` and then fails: the command
    and its whole output are in the error, and no library is left."""
    fake = tmp_path / "fake-g++"
    fake.write_text(
        "#!/bin/sh\n"
        'if [ "$1" = --version ]; then echo fake 1.0; exit 0; fi\n'
        "echo 'kernels.cpp:1: error: no good' >&2\nexit 3\n"
    )
    fake.chmod(0o755)
    with pytest.raises(RuntimeError) as e:
        tbuild.build(cxx=str(fake), root=tmp_path / "out")
    msg = str(e.value)
    assert "(3)" in msg and "no good" in msg and str(fake) in msg
    assert "kernels.cpp" in msg and "-march=native" in msg
    assert not list((tmp_path / "out").rglob("*.so*"))


def test_switch_off_builds_nothing(monkeypatch):
    """With ``HAVE_NATIVE`` off a whole block setup, and every caller of the
    scalar-setup and staging wrappers (a scalar setup with Chebyshev and
    with GS, and with them the tile-ELL staging, the cluster detection and
    the coloring; the graph matcher, the collapse and the edge-list
    spectral radius called directly), run without asking for the
    extension, and count no call."""
    from ngsamg_tpu_torch.apps.h1 import H1Energy as TH1
    from ngsamg_tpu_torch.coarsen import pairwise as tpw
    from ngsamg_tpu_torch.transfer.prolongation import _rho_estimate_h1_edges

    def no_build():
        raise AssertionError("the extension was asked for")

    monkeypatch.setattr(tnative, "HAVE_NATIVE", False)
    monkeypatch.setattr(tnative, "extension", no_build)
    tnative.reset_calls()
    p = tfem.unstructured_elasticity(8, dim=3)
    pc = ngsamg_tpu_torch.AMGPreconditioner(
        p.A, energy="elasticity", block_size=3, coords=p.coords,
        options=_opts(ngsamg_tpu_torch, 40), device="cpu",
    ).setup()
    assert pc.num_levels >= 2
    q = tfem.unstructured_poisson(12, dim=3, refine=1)
    pc = ngsamg_tpu_torch.AMGPreconditioner(
        q.A, coords=q.coords, options=_cheb(ngsamg_tpu_torch), device="cpu",
    ).setup()
    assert pc.num_levels >= 3 and pc.op.cluster_corr is not None
    assert isinstance(pc.op.levels[0].A,
                      ngsamg_tpu_torch.sparse.formats.TileELLStack)
    g = tfem.poisson_3d(12)
    pc = ngsamg_tpu_torch.AMGPreconditioner(
        g.A, options=ngsamg_tpu_torch.AMGOptions(), device="cpu",
    ).setup()
    assert len(pc.op.levels[0].smoother.color_bounds) > 2
    mesh = TH1().build_finest_mesh(q.A.tocsr())
    S = mesh.edge_graph(weights=TH1().soc(mesh))
    v2agg, n_agg = tpw.spw_aggregate(S, rounds=2)
    assert n_agg < mesh.nv
    assert tpw.coarse_strength_graph(S, v2agg, n_agg).shape == (n_agg,) * 2
    assert _rho_estimate_h1_edges(
        mesh.edges, mesh.edge_data["wt"], mesh.vertex_data["l2wt"]
    ) > 1.0
    assert all(v == {"native": 0, "declined": 0}
               for v in tnative.CALLS.values())


# ---------------------------------------------------------------------------
# declines: the callers' numpy branches where the JAX package takes them
# ---------------------------------------------------------------------------


def _declines():
    return {k: dict(v) for k, v in tnative.CALLS.items()}


def test_spw_round_on_a_mesh_without_l2wt_takes_the_numpy_round():
    """``H1Energy.spw_round`` declines a mesh without ``l2wt`` (counted);
    the coarsener then takes the numpy matching round (soc, edge graph and
    the native ``handshake_match``), as the JAX package's does, and
    aggregates as a coarsener without a fused round."""
    from ngsamg_tpu.apps.h1 import H1Energy as JH1
    from ngsamg_tpu.coarsen import pairwise as jpw
    from ngsamg_tpu_torch.apps.h1 import H1Energy as TH1
    from ngsamg_tpu_torch.coarsen import pairwise as tpw

    def bare(mesh):
        return AlgebraicMesh(nv=mesh.nv, edges=mesh.edges,
                             edge_data=dict(mesh.edge_data))

    class BareT(TH1):
        def spw_round(self, mesh, theta, can_match):
            return super().spw_round(bare(mesh), theta, can_match)

    class BareJ(JH1):
        def spw_round(self, mesh, theta, can_match):
            return super().spw_round(bare(mesh), theta, can_match)

    class NoRound(TH1):
        spw_round = None

    q = tfem.unstructured_poisson(10, dim=3, refine=1)
    mesh = TH1().build_finest_mesh(q.A.tocsr())
    with switches(True):
        c0 = _declines()
        assert TH1().spw_round(bare(mesh), 0.08, None) is None
        assert tnative.CALLS["spw_round_h1"]["declined"] == (
            c0["spw_round_h1"]["declined"] + 1)
        c0 = _declines()
        vt, nt = tpw.spw_aggregate_energy(BareT(), mesh, rounds=3)
        c1 = _declines()
        vn, nn = tpw.spw_aggregate_energy(NoRound(), mesh, rounds=3)
        vj, nj = jpw.spw_aggregate_energy(BareJ(), mesh, rounds=3)
    rounds = c1["spw_round_h1"]["declined"] - c0["spw_round_h1"]["declined"]
    assert rounds >= 2
    assert c1["spw_round_h1"]["native"] == c0["spw_round_h1"]["native"]
    assert c1["handshake_match"]["native"] == (
        c0["handshake_match"]["native"] + rounds)
    assert nt == nn == nj < mesh.nv
    np.testing.assert_array_equal(vt, vn)
    np.testing.assert_array_equal(vt, vj)


@pytest.fixture(scope="module")
def scalar_level():
    """The finest level of a small scalar H1 hierarchy (native setup): the
    level, its energy and the next level's mesh."""
    from ngsamg_tpu_torch.apps.h1 import H1Energy as TH1
    from ngsamg_tpu_torch.factory.levels import setup_levels
    from ngsamg_tpu_torch.transfer.prolongation import piecewise_prol

    q = tfem.unstructured_poisson(10, dim=3, refine=1)
    en = TH1()
    with switches(True):
        levels, _log = setup_levels(q.A.tocsr(), en,
                                    _cheb(ngsamg_tpu_torch), q.coords)
    lev0, lev1 = levels[0], levels[1]
    Ppw = piecewise_prol(en, lev0.mesh, lev1.mesh, lev0.v2agg)
    return en, lev0, lev1.mesh, Ppw


def _same_prolongation(Pa, Pb):
    Pa, Pb = Pa.tocsr(), Pb.tocsr()
    Pa.sort_indices()
    Pb.sort_indices()
    assert np.array_equal(Pa.indptr, Pb.indptr)
    assert np.array_equal(Pa.indices, Pb.indices)
    assert abs(Pa - Pb).max() <= 1e-12 * abs(Pb).max()


@pytest.mark.parametrize("cause", ["no_level_matrix", "wrapper_none"])
def test_scalar_prolongation_declines_take_the_numpy_branch(
    scalar_level, cause
):
    """``_smoothed_prol_scalar_native`` declines a level without a scalar
    matrix (``A=None``: row blocks > 1), and a None from
    ``smoothed_prol_scalar``; each is counted, and ``smoothed_prol`` then
    computes P on its numpy branch: the P of the switch-off run (the
    structure equal, the values to 1e-12: the truncation stays native)
    and, for ``A=None``, the JAX package's own P on the same inputs."""
    from ngsamg_tpu.transfer.prolongation import smoothed_prol as jsp
    from ngsamg_tpu_torch.transfer.prolongation import smoothed_prol as tsp

    en, lev0, mesh1, Ppw = scalar_level
    A = None if cause == "no_level_matrix" else lev0.A

    def run(fn, energy):
        return fn(energy, lev0.mesh, mesh1, lev0.v2agg, Ppw, A=A, row_bs=1)

    with switches(True), pytest.MonkeyPatch.context() as mp:
        if cause == "wrapper_none":
            mp.setattr(tnative, "smoothed_prol_scalar",
                       lambda *a, **k: None)
        c0 = _declines()
        Pt = run(tsp, en)
        c1 = _declines()
        if cause == "no_level_matrix":
            from ngsamg_tpu.apps.h1 import H1Energy as JH1

            _same_prolongation(Pt, run(jsp, JH1()))
    assert c1["smoothed_prol_scalar"]["declined"] == (
        c0["smoothed_prol_scalar"]["declined"] + 1)
    assert c1["smoothed_prol_scalar"]["native"] == (
        c0["smoothed_prol_scalar"]["native"])
    assert c1["truncate_prol_blocks"]["native"] == (
        c0["truncate_prol_blocks"]["native"] + 1)
    with switches(False):
        Pn = run(tsp, en)
    _same_prolongation(Pt, Pn)


def test_bf16_staging_packs_the_same_with_the_switch_on_and_off():
    """A bfloat16 level is packed in f32 (numpy has no bfloat16) and cast
    once on the device: the native tile-ELL packers and their numpy
    branches give the same f32 arrays, hence the same bf16 tensors."""
    from ngsamg_tpu_torch.precond.amg import _cast_floats
    from ngsamg_tpu_torch.sparse import formats

    A = tfem.unstructured_poisson(12, dim=3, refine=1).A.tocsr()
    perm = formats.plan_reorder(A, 1)
    Ap = A[perm][:, perm].tocsr()
    packed = {}
    for on in (True, False):
        with switches(on):
            packed[on] = [
                _cast_floats(pack(Ap, np.float32), torch.bfloat16, {})
                for pack in (formats.tile_ell_stack_from_scipy,
                             formats.tile_ell_from_scipy)
            ]
    for a, b in zip(packed[True], packed[False]):
        pairs = list(zip(getattr(a, "blocks", (a,)), getattr(b, "blocks",
                                                             (b,))))
        assert pairs and len(pairs) == len(getattr(b, "blocks", (b,)))
        for ba, bb in pairs:
            assert ba.data.dtype == bb.data.dtype == torch.bfloat16
            assert ba.cols.dtype == bb.cols.dtype == torch.int64
            assert torch.equal(ba.data, bb.data)
            assert torch.equal(ba.cols, bb.cols)


def test_scalar_setup_wrappers_match_numpy_branches():
    """Every scalar-setup and staging wrapper against the numpy branch
    beside its call, on the finest and the first coarse level of a 3D
    unstructured Poisson hierarchy, at the tolerances chip_smoke.py's
    ``[native]`` phase holds on the card's host (``native/parity.py``):
    integers (edges, partners, aggregates, colours, cluster sets,
    permutations, tile columns) equal, values to at most 1e-10."""
    from ngsamg_tpu_torch.native import parity

    p = tfem.unstructured_poisson(16, dim=3, refine=1)
    rows = parity.scalar_setup_parity(p.A, p.coords)
    assert [r["wrapper"] for r in rows] == list(parity.SCALAR_TOLERANCES)
    assert len(rows) == 16
    assert set(parity.SCALAR_TOLERANCES) | set(parity.TOLERANCES) == set(
        tnative.WRAPPERS)
    assert max(parity.SCALAR_TOLERANCES.values()) <= 1e-10
    for r in rows:
        assert r["ok"], r


def test_mp_scalar_ranks_build_the_jax_native_hierarchy():
    """A scalar distributed setup on 2 MP ranks with the switch on: the
    hierarchy is bitwise the JAX package's native one (its single
    controller), and every rank reports the native calls of its level loop
    (the kernel-preserving truncation) and no decline."""
    from ngsamg_tpu.apps.h1 import H1Energy as JH1
    from ngsamg_tpu.parallel import dist_setup as jds
    from ngsamg_tpu_torch.apps.h1 import H1Energy as TH1
    from ngsamg_tpu_torch.parallel import mp_runtime

    q = tfem.unstructured_poisson(12, dim=3, refine=1)
    with switches(True):
        ref, ref_log = jds.dist_setup_levels(
            q.A, JH1(), _cheb(ngsamg_tpu), 2, coords=q.coords
        )
        got, log = mp_runtime.mp_dist_setup_levels(
            q.A, TH1(), _cheb(ngsamg_tpu_torch), 2, coords=q.coords
        )
    assert log.nvs == ref_log.nvs and log.nnzs == ref_log.nnzs
    assert len(got) == len(ref) >= 3
    for a, b in zip(ref, got):
        assert (a.A != b.A).nnz == 0
        if a.P is not None:
            assert (a.P.tocsr() != b.P.tocsr()).nnz == 0
    assert len(log.mp_rank_stats) == 2
    for st in log.mp_rank_stats:
        calls = st["native_calls"]
        assert calls.get("truncate_prol_blocks", {}).get("native"), calls
        assert not any(c["declined"] for c in calls.values()), calls


@pytest.mark.parametrize("on", [False, True], ids=["numpy", "native"])
def test_mp_ranks_take_the_parents_switch(on):
    """The MP ranks run with the parent's switch, not the module default:
    with it off every rank takes the numpy branches (no native call) and
    the hierarchy is the single controller's numpy one; with it on every
    rank calls the native kernels, and the hierarchy is the single
    controller's native one."""
    from ngsamg_tpu_torch.parallel import dist_setup as tds
    from ngsamg_tpu_torch.parallel import mp_runtime

    A = tfem.unstructured_elasticity(12, dim=2)
    opts = ngsamg_tpu_torch.AMGOptions(dtype="float64")
    opts.levels.max_coarse_size = 40
    with switches(on):
        ref, ref_log = tds.dist_setup_levels(
            A.A, TEl(dim=2), opts, 2, coords=A.coords
        )
        got, log = mp_runtime.mp_dist_setup_levels(
            A.A, TEl(dim=2), opts, 2, coords=A.coords
        )
    assert log.nvs == ref_log.nvs and log.nnzs == ref_log.nnzs
    for a, b in zip(ref, got):
        assert (a.A != b.A).nnz == 0
        if a.P is not None:
            assert (a.P.tocsr() != b.P.tocsr()).nnz == 0
    for st in log.mp_rank_stats:
        calls = st["native_calls"]
        if on:
            assert calls.get("truncate_prol_blocks", {}).get("native"), calls
        else:
            assert calls == {}, calls


def test_native_module_imports_no_torch_and_no_jax():
    code = (
        "import sys\n"
        "import ngsamg_tpu_torch.native as n\n"
        "n.extension()\n"
        "bad = [m for m in sys.modules if m in ('torch', 'jax', "
        "'ngsamg_tpu') or m.startswith(('torch.', 'jax.', 'ngsamg_tpu.'))]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, PYTHONPATH=ROOT),
    )
    assert res.returncode == 0, res.stderr
