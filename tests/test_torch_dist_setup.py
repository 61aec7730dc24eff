"""Port parity for the host-distributed setup (ROADMAP queue 1 item 8a).

Mirrors tests/test_dist_setup.py (its ``test_collective_transport_parity``
belongs to item 8b, the sharded solve). The same scipy matrices, made by
the port's `utils/fem.py` from its numpy seeds, go through the JAX
package's `parallel.dist_setup.dist_setup_levels` and the port's copy.
Both are the same numpy code; the JAX package runs on its numpy branches
(`ngsamg_tpu.native.HAVE_NATIVE = False`: its `truncate_prol` would
otherwise take the native kernel), so:
- `v2agg`, the sparsity and the values of every level's A and P, the
  level sizes and nnz, and the log's distributed fields
  (`peak_shard_bytes`, `finest_global_bytes`, `contract_decisions`,
  `shards_per_level`) are compared EXACTLY;
- against the port's own serial setup, as the JAX test does: the same
  aggregates and nnz, coarse values to 1e-10 relative (1e-9 for
  elasticity): the distributed RAP sums in another order.
The hierarchy solves through `AMGPreconditioner(..., dist_setup=4,
device="cpu")` within one iteration of the JAX package's run.
"""

import contextlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ngsamg_tpu
import ngsamg_tpu.native as jnative
import ngsamg_tpu_torch
from ngsamg_tpu.apps.elasticity import ElasticityEnergy as JEl
from ngsamg_tpu.apps.h1 import H1Energy as JH1
from ngsamg_tpu.parallel import dist_setup as jds
from ngsamg_tpu_torch.apps.elasticity import ElasticityEnergy as TEl
from ngsamg_tpu_torch.apps.h1 import H1Energy as TH1
from ngsamg_tpu_torch.factory.levels import setup_levels as t_setup_levels
from ngsamg_tpu_torch.parallel import dist_setup as tds
from ngsamg_tpu_torch.utils import fem as tfem

torch.set_num_threads(2)

LOG_FIELDS = (
    "nvs", "nnzs", "peak_shard_bytes", "finest_global_bytes",
    "contract_decisions", "shards_per_level",
)


@contextlib.contextmanager
def numpy_branches():
    """The JAX package on the numpy branches of its host setup."""
    old = jnative.HAVE_NATIVE
    jnative.HAVE_NATIVE = False
    try:
        yield
    finally:
        jnative.HAVE_NATIVE = old


def _opts(pkg, **levels):
    # f64 so the serial Galerkin products match the distributed f64 ones
    o = pkg.AMGOptions(dtype="float64")
    o.coarsen.algo = pkg.SpecOpt(pkg.CoarsenType.SPW)
    o.levels.max_coarse_size = 40
    for k, v in levels.items():
        setattr(o.levels, k, v)
    return o


def _csr_equal(a, b, what):
    a, b = a.tocsr(), b.tocsr()
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(a.indptr, b.indptr, err_msg=what)
    np.testing.assert_array_equal(a.indices, b.indices, err_msg=what)
    np.testing.assert_array_equal(a.data, b.data, err_msg=what)


def assert_same_hierarchy(jl, jlog, tl, tlog):
    """The port's levels and log equal the JAX package's bit for bit."""
    for f in LOG_FIELDS:
        assert getattr(tlog, f) == getattr(jlog, f), f
    assert len(tl) == len(jl)
    for i, (a, b) in enumerate(zip(jl, tl)):
        assert a.row_bs == b.row_bs and a.mesh.nv == b.mesh.nv, i
        _csr_equal(a.A, b.A, f"A{i}")
        assert (a.P is None) == (b.P is None), i
        if a.P is not None:
            assert a.P.blocksize == b.P.blocksize, i
            _csr_equal(a.P, b.P, f"P{i}")
            np.testing.assert_array_equal(a.v2agg, b.v2agg, err_msg=f"L{i}")
        assert (a.P_amg is None) == (b.P_amg is None), i
        if a.P_amg is not None:
            _csr_equal(a.P_amg, b.P_amg, f"P_amg{i}")
        for k, v in a.mesh.vertex_data.items():
            np.testing.assert_array_equal(v, b.mesh.vertex_data[k])


def assert_matches_serial(s_levels, s_log, d_levels, d_log, rtol):
    """tests/test_dist_setup.py's ``_check_equal``, on the port alone."""
    assert s_log.nvs == d_log.nvs
    for sl, dl in zip(s_levels[:-1], d_levels[:-1]):
        np.testing.assert_array_equal(sl.v2agg, dl.v2agg)
    for i, (sl, dl) in enumerate(zip(s_levels, d_levels)):
        if i == 0:
            continue
        assert sl.A.nnz == dl.A.nnz, f"level {i} nnz"
        diff = abs(sl.A - dl.A).max()
        assert diff < rtol * abs(sl.A).max(), f"level {i}: {diff:.2e}"


def _both(A, j_energy, t_energy, n_shards, coords=None, **levels):
    with numpy_branches():
        jl, jlog = jds.dist_setup_levels(
            A, j_energy, _opts(ngsamg_tpu, **levels), n_shards, coords=coords
        )
    tl, tlog = tds.dist_setup_levels(
        A, t_energy, _opts(ngsamg_tpu_torch, **levels), n_shards,
        coords=coords,
    )
    return jl, jlog, tl, tlog


@pytest.mark.parametrize("n_shards", [2, 4, 7])
def test_dist_equals_jax_unstructured(n_shards):
    A = tfem.unstructured_poisson(20, dim=2).A
    jl, jlog, tl, tlog = _both(A, JH1(bs=1), TH1(bs=1), n_shards)
    assert len(tl) >= 3
    assert_same_hierarchy(jl, jlog, tl, tlog)
    s_levels, s_log = t_setup_levels(
        A.tocsr(), TH1(bs=1), _opts(ngsamg_tpu_torch)
    )
    assert_matches_serial(s_levels, s_log, tl, tlog, 1e-10)


def test_dist_equals_jax_structured():
    # massively tied strengths: the hash tie-break must keep the
    # shard-local matching identical
    A = sp.csr_matrix(tfem.poisson_3d(8).A)
    jl, jlog, tl, tlog = _both(A, JH1(bs=1), TH1(bs=1), 4)
    assert_same_hierarchy(jl, jlog, tl, tlog)
    s_levels, s_log = t_setup_levels(A, TH1(bs=1), _opts(ngsamg_tpu_torch))
    assert_matches_serial(s_levels, s_log, tl, tlog, 1e-10)


def test_dist_vector_h1_equals_jax():
    """Vector (bs=2) H1: condensed trace graph, kron-expanded P; same
    aggregates and coarse nnz as the port's serial path."""
    prob = tfem.vector_poisson(tfem.poisson_2d(20), 2)
    jl, jlog, tl, tlog = _both(prob.A, JH1(bs=2), TH1(bs=2), 4)
    assert_same_hierarchy(jl, jlog, tl, tlog)
    s_levels, s_log = t_setup_levels(
        prob.A.tocsr(), TH1(bs=2), _opts(ngsamg_tpu_torch)
    )
    assert s_log.nvs == tlog.nvs
    for sl, dl in zip(s_levels[:-1], tl[:-1]):
        np.testing.assert_array_equal(sl.v2agg, dl.v2agg)
    for i, (sl, dl) in enumerate(zip(s_levels, tl)):
        if i:
            assert sl.A.nnz == dl.A.nnz, f"level {i}"


@pytest.mark.parametrize("n_shards", [2, 4])
def test_dist_elasticity_equals_jax(n_shards):
    """Robust per-round matching, transported coarse energies, block
    smoothed prolongation and the embedding fold (`dist_elast.py`)."""
    prob = tfem.unstructured_elasticity(10, dim=2)
    je, te = JEl(dim=2), TEl(dim=2)
    jl, jlog, tl, tlog = _both(prob.A, je, te, n_shards, coords=prob.coords)
    assert te._s == je._s  # rot_scale "auto": the same median
    assert_same_hierarchy(jl, jlog, tl, tlog)
    ts = TEl(dim=2)
    s_levels, s_log = t_setup_levels(
        prob.A.tocsr(), ts, _opts(ngsamg_tpu_torch), coords=prob.coords
    )
    assert ts._s == te._s
    assert_matches_serial(s_levels, s_log, tl, tlog, 1e-9)


def test_dist_setup_shard_residency():
    """Per-shard peak memory stays ~1/n of the global matrix, and the
    port's accounting is the JAX package's."""
    A = tfem.unstructured_poisson(24, dim=2).A
    # toy scale: pin the TryContractStep knobs off, as the JAX test does
    jl, jlog, tl, tlog = _both(
        A, JH1(bs=1), TH1(bs=1), 8, rd_min_rows=1, rd_slow_ratio=2.0
    )
    assert_same_hierarchy(jl, jlog, tl, tlog)
    assert tlog.finest_global_bytes > 0 and tlog.peak_shard_bytes > 0
    assert tlog.peak_shard_bytes < tlog.finest_global_bytes * 4.0 / 8


def test_try_contract_step_in_loop():
    """The level loop's own contraction decisions (TryContractStep analog)
    equal the JAX package's under each trigger, and contraction changes
    ownership, not values."""
    A = tfem.unstructured_poisson(40, dim=2).A.tocsr().astype(np.float64)

    def run(pkg, mod, energy, **lv):
        o = _opts(pkg, max_coarse_size=20, **lv)
        parts, starts = mod.split_rows(A, 4)
        return mod._scalar_levels_parts(parts, starts, o, energy)

    out = {}
    for name, lv in (
        ("none", dict(rd_min_rows=1, rd_slow_ratio=2.0)),
        ("min", dict(rd_min_rows=200, rd_slow_ratio=2.0)),
        ("slow", dict(rd_min_rows=1, rd_slow_ratio=0.2)),
    ):
        with numpy_branches():
            jr, jlog = run(ngsamg_tpu, jds, JH1(bs=1), **lv)
        tr, tlog = run(ngsamg_tpu_torch, tds, TH1(bs=1), **lv)
        for f in LOG_FIELDS:
            assert getattr(tlog, f) == getattr(jlog, f), (name, f)
        assert len(tr) == len(jr)
        for a, b in zip(jr, tr):
            for key in ("Ac_parts", "P_parts"):
                for pa, pb in zip(a[key], b[key]):
                    _csr_equal(pa, pb, f"{name} {key}")
            np.testing.assert_array_equal(a["coarse_starts"],
                                          b["coarse_starts"])
        out[name] = (tr, tlog)
    r_none, log_none = out["none"]
    assert log_none.contract_decisions == []
    assert all(k == 4 for k in log_none.shards_per_level)
    r_min, log_min = out["min"]
    assert any("min_rows" in d[3] for d in log_min.contract_decisions)
    assert log_min.shards_per_level[-1] < 4
    assert any(
        "slow_coarsening" in d[3] for d in out["slow"][1].contract_decisions
    )
    assert len(r_none) == len(r_min)
    for ra, rb in zip(r_none, r_min):
        Aa = sp.vstack(ra["Ac_parts"], format="csr")
        Ab = sp.vstack(rb["Ac_parts"], format="csr")
        assert Aa.nnz == Ab.nnz
        assert abs(Aa - Ab).max() < 1e-12 * abs(Aa).max()
    for t in range(log_min.shards_per_level[-1], 4):
        assert r_min[-1]["Ac_parts"][t].shape[0] == 0


def _cheb_opts(pkg, dist):
    o = _opts(pkg)
    o.smoother = pkg.config.SmootherOptions(
        type=pkg.config.SmootherType.CHEBYSHEV
    )
    o.dist_setup = dist
    return o


@pytest.mark.parametrize("case", ["h1", "elasticity"])
def test_dist_hierarchy_solves(case):
    """`AMGPreconditioner(..., dist_setup=4)` builds the distributed
    hierarchy and solves within one iteration of the JAX package
    (tests/test_dist_setup.py's ``test_dist_hierarchy_solves`` and
    ``test_dist_elasticity_hierarchy_solves``)."""
    if case == "h1":
        prob, kw, maxiter = tfem.unstructured_poisson(24, dim=2), {}, 60
    else:
        prob = tfem.unstructured_elasticity(9, dim=2)
        kw, maxiter = {"energy": "elasticity", "block_size": 2}, 80
    res = {}
    for name, pkg, extra in (
        ("jax", ngsamg_tpu, {}),
        ("torch", ngsamg_tpu_torch, {"device": "cpu"}),
    ):
        pc = pkg.AMGPreconditioner(
            prob.A, coords=prob.coords, options=_cheb_opts(pkg, 4),
            **kw, **extra,
        ).setup()
        assert pc.log_.shards_per_level[0] == 4  # the distributed branch
        x, info = pc.solve(prob.b, tol=1e-8, maxiter=maxiter)
        r = np.linalg.norm(prob.A @ x - prob.b) / np.linalg.norm(prob.b)
        assert info.converged and r < 1e-7, (name, info.iterations, r)
        res[name] = (pc.log_.nvs, info.iterations)
    assert res["torch"][0] == res["jax"][0]
    assert abs(res["torch"][1] - res["jax"][1]) <= 1, res
