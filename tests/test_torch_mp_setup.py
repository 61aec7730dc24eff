"""Port parity for the multi-process distributed setup (parallel/mp_runtime.py).

Mirrors tests/test_mp_setup.py's scalar, vector-H1, elasticity,
residency and solve tests. One spawned OS process per rank runs the
port's rank-local level loop over an ``MPTransport``; the hierarchy must
be BITWISE-equal to the port's single-controller ``dist_setup_levels``
and to the JAX package's (run on its numpy branches, as in
tests/test_torch_dist_setup.py). The ranks are numpy processes started
with ``CUDA_VISIBLE_DEVICES=""``. The two Stokes entry points (Stokes
dual mesh, scalar and vector facet dofs, and HDiv) are held bitwise to
the port's single-controller ``dist_stokes`` setups, as
tests/test_mp_setup.py holds the JAX package's.
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
from ngsamg_tpu.apps.elasticity import ElasticityEnergy as JEl
from ngsamg_tpu.apps.h1 import H1Energy as JH1
from ngsamg_tpu.parallel import dist_setup as jds
from ngsamg_tpu_torch.apps.elasticity import ElasticityEnergy as TEl
from ngsamg_tpu_torch.apps.h1 import H1Energy as TH1
from ngsamg_tpu_torch.parallel import dist_setup as tds
from ngsamg_tpu_torch.parallel import mp_runtime
from ngsamg_tpu_torch.utils import fem as tfem

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def port_numpy_branches():
    """The port on the numpy branches of its host setup for this whole
    file: its hierarchies are held to the JAX package's numpy branches
    (``numpy_branches``), and where a test compares with the JAX package's
    native run it holds the port's numpy hierarchy to it. The native
    branches are held to the JAX package's native run by
    tests/test_torch_native.py."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tnative, "HAVE_NATIVE", False)
        yield


@contextlib.contextmanager
def numpy_branches():
    old = jnative.HAVE_NATIVE
    jnative.HAVE_NATIVE = False
    try:
        yield
    finally:
        jnative.HAVE_NATIVE = old


def _opts(pkg, max_coarse_size=40):
    o = pkg.AMGOptions(dtype="float64")
    o.coarsen.algo = pkg.SpecOpt(pkg.CoarsenType.SPW)
    o.levels.max_coarse_size = max_coarse_size
    # the in-loop TryContractStep pinned off, as in the JAX test: at toy
    # scale every coarse level would concentrate onto rank 0
    o.levels.rd_min_rows = 1
    o.levels.rd_slow_ratio = 2.0
    return o


def _csr_equal(a, b, what):
    a, b = a.tocsr(), b.tocsr()
    np.testing.assert_array_equal(a.indptr, b.indptr, err_msg=what)
    np.testing.assert_array_equal(a.indices, b.indices, err_msg=what)
    np.testing.assert_array_equal(a.data, b.data, err_msg=what)


def assert_bitwise(ref, ref_log, m_levels, m_log):
    assert len(ref) == len(m_levels) >= 3, (ref_log.nvs, m_log.nvs)
    assert ref_log.nvs == m_log.nvs
    assert ref_log.nnzs == m_log.nnzs
    for i, (sl, ml) in enumerate(zip(ref, m_levels)):
        assert sl.row_bs == ml.row_bs
        _csr_equal(sl.A, ml.A, f"A{i}")
        assert (sl.P is None) == (ml.P is None)
        if sl.P is not None:
            _csr_equal(sl.P, ml.P, f"P{i}")
            np.testing.assert_array_equal(sl.v2agg, ml.v2agg)
        if sl.P_amg is not None or ml.P_amg is not None:
            _csr_equal(sl.P_amg, ml.P_amg, f"P_amg{i}")


def _three_ways(A, jen, ten, n_ranks, coords=None, **kw):
    """(JAX single controller, port single controller, port MP)."""
    with numpy_branches():
        jl = jds.dist_setup_levels(
            A, jen, _opts(ngsamg_tpu, **kw), n_ranks, coords=coords
        )
    tl = tds.dist_setup_levels(
        A, ten(), _opts(ngsamg_tpu_torch, **kw), n_ranks, coords=coords
    )
    ml = mp_runtime.mp_dist_setup_levels(
        A, ten(), _opts(ngsamg_tpu_torch, **kw), n_ranks, coords=coords
    )
    return jl, tl, ml


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_mp_setup_bitwise_equals_single_controller(n_ranks):
    A = tfem.unstructured_poisson(20, dim=2).A.tocsr()
    jl, tl, ml = _three_ways(A, JH1(bs=1), lambda: TH1(bs=1), n_ranks)
    assert_bitwise(*tl, *ml)
    assert_bitwise(*jl, *ml)
    stats = ml[1].mp_rank_stats
    assert len(stats) == n_ranks
    assert ml[1].peak_shard_bytes == max(s["peak_shard_bytes"] for s in stats)


def test_mp_setup_shard_residency_and_traffic():
    """Each rank holds a shard, not the global problem; doubling the
    ranks about halves what one rank holds."""
    A = tfem.unstructured_poisson(64, dim=2).A.tocsr()
    peaks = {}
    for n_ranks in (2, 4):
        m_levels, m_log = mp_runtime.mp_dist_setup_levels(
            A, TH1(bs=1), _opts(ngsamg_tpu_torch), n_ranks
        )
        stats = m_log.mp_rank_stats
        assert len(stats) == n_ranks
        glob = m_log.finest_global_bytes
        for st in stats:
            assert 0 < st["peak_shard_bytes"] < 3.0 * glob / n_ranks
            assert st["transport_calls"] > 0
            assert 0 < st["moved_bytes"] < 100 * glob
        assert all(st["nvs"] == stats[0]["nvs"] for st in stats)
        peaks[n_ranks] = max(st["peak_shard_bytes"] for st in stats)
    assert peaks[4] < 0.65 * peaks[2], peaks
    s_levels, _ = tds.dist_setup_levels(
        A, TH1(bs=1), _opts(ngsamg_tpu_torch), 4
    )
    for sl, ml in zip(s_levels, m_levels):
        assert abs(sl.A - ml.A).max() == 0.0


def test_mp_vector_h1_bitwise_equals_single_controller():
    A = sp.kron(tfem.unstructured_poisson(16, dim=2).A.tocsr(), sp.eye(2),
                format="csr")
    jl, tl, ml = _three_ways(
        A, JH1(bs=2), lambda: TH1(bs=2), 2, max_coarse_size=15
    )
    assert all(lev.row_bs == 2 for lev in ml[0])
    assert_bitwise(*tl, *ml)
    assert_bitwise(*jl, *ml)


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_mp_elasticity_bitwise_equals_single_controller(n_ranks):
    prob = tfem.unstructured_elasticity(12, dim=2)
    A = prob.A.tocsr()
    jl, tl, ml = _three_ways(
        A, JEl(dim=2), lambda: TEl(dim=2), n_ranks, coords=prob.coords,
        max_coarse_size=15,
    )
    assert_bitwise(*tl, *ml)
    assert_bitwise(*jl, *ml)


def test_mp_elasticity_shard_residency():
    prob = tfem.unstructured_elasticity(16, dim=2)
    A = prob.A.tocsr()
    peaks = {}
    for n_ranks in (2, 4):
        _levels, m_log = mp_runtime.mp_dist_setup_levels(
            A, TEl(dim=2), _opts(ngsamg_tpu_torch), n_ranks,
            coords=prob.coords,
        )
        stats = m_log.mp_rank_stats
        assert len(stats) == n_ranks
        glob = m_log.finest_global_bytes
        for st in stats:
            assert 0 < st["peak_shard_bytes"] < 5.0 * glob / n_ranks
            assert st["transport_calls"] > 0
        peaks[n_ranks] = max(st["peak_shard_bytes"] for st in stats)
    assert peaks[4] < 0.7 * peaks[2], peaks


def test_mp_setup_solves():
    """The MP-built hierarchy is Galerkin-consistent and solves through the
    port's staging on the CPU."""
    prob = tfem.unstructured_poisson(12, dim=2)
    A = prob.A.tocsr().astype(np.float64)
    levels, log = mp_runtime.mp_dist_setup_levels(
        A, TH1(bs=1), _opts(ngsamg_tpu_torch), 2
    )
    P = levels[0].P.tocsr()
    Ac = levels[1].A.tocsr()
    G = (P.T @ (A @ P)).tocsr()
    Gs = ((G + G.T) * 0.5).tocsr()
    assert abs(Gs - Ac).max() < 1e-12 * abs(Ac).max()
    opts = _opts(ngsamg_tpu_torch)
    opts.smoother = ngsamg_tpu_torch.SmootherOptions(
        type=ngsamg_tpu_torch.SmootherType.CHEBYSHEV
    )
    pc = ngsamg_tpu_torch.AMGPreconditioner(
        A, coords=prob.coords, options=opts, device="cpu"
    )
    pc.setup_levels_, pc.log_ = levels, log
    pc._compile_device()
    pc._is_setup = True
    x, info = pc.solve(prob.b, tol=1e-8, maxiter=60)
    r = np.linalg.norm(A @ x - prob.b) / np.linalg.norm(prob.b)
    assert info.converged and r < 1e-7, (info.iterations, r)


def _stokes_pc(p, opts):
    from ngsamg_tpu_torch.precond.stokes import StokesAMG

    return StokesAMG(
        p.A, cell_pos=p.cell_pos, cell_vol=p.cell_vol,
        facet_cells=p.facet_cells, facet_flow=p.facet_flow, options=opts,
        device="cpu",
    ).setup()


def _hdiv_pc(p, counts, V, opts):
    from ngsamg_tpu_torch.precond.stokes import StokesHDivAMG

    return StokesHDivAMG(
        p.A, cell_pos=p.cell_pos, cell_vol=p.cell_vol,
        facet_cells=p.facet_cells, facet_flow=p.facet_flow,
        facet_dof_counts=counts, preserved=V, options=opts, device="cpu",
    ).setup()


def _stokes_equal(s_levels, m_levels):
    assert len(s_levels) == len(m_levels) >= 2
    for i, (sl, ml) in enumerate(zip(s_levels, m_levels)):
        assert abs(sl.A - ml.A).max() == 0.0, f"L{i}"
        assert sl.mesh.nv == ml.mesh.nv and sl.mesh.ne == ml.mesh.ne
        np.testing.assert_array_equal(sl.mesh.edges, ml.mesh.edges)
        np.testing.assert_array_equal(
            sl.mesh.edge_data["flow"], ml.mesh.edge_data["flow"]
        )
        if sl.P is not None or ml.P is not None:
            assert abs(sl.P - ml.P).max() == 0.0, f"P L{i}"
            np.testing.assert_array_equal(sl.v2agg, ml.v2agg)
        if sl.C is not None or ml.C is not None:
            assert abs(sl.C - ml.C).max() == 0.0, f"C L{i}"


def _hdiv_equal(s_levels, m_levels):
    assert len(s_levels) == len(m_levels) >= 2
    for i, (sl, ml) in enumerate(zip(s_levels, m_levels)):
        np.testing.assert_array_equal(sl.dofs.offsets, ml.dofs.offsets)
        assert abs(sl.A - ml.A).max() == 0.0, f"L{i}"
        np.testing.assert_array_equal(sl.pres.vectors, ml.pres.vectors)
        if sl.P is not None or ml.P is not None:
            assert abs(sl.P - ml.P).max() == 0.0, f"P L{i}"
            np.testing.assert_array_equal(sl.v2agg, ml.v2agg)


def test_mp_stokes_entry_points_name_item_8c():
    """The two distributed Stokes entry points (ROADMAP item 8c) run on
    two ranks, the default smoothed prolongation included, and equal the
    single controller."""
    from ngsamg_tpu_torch.parallel import dist_stokes as tdst
    from ngsamg_tpu_torch.utils import stokes_fem as tsf

    p, _ = tsf.stokes_tri(6, dim=2, alpha=10.0)
    opts = ngsamg_tpu_torch.AMGOptions()
    opts.levels.max_coarse_size = 30
    pc = _stokes_pc(p, opts)
    s_levels = tdst.dist_stokes_levels(pc.A_host, pc.mesh0, 1, opts, 2)
    m_levels, m_log = mp_runtime.mp_dist_stokes_levels(
        pc.A_host, pc.mesh0, 1, opts, 2
    )
    _stokes_equal(s_levels, m_levels)
    assert len(m_log.mp_rank_stats) == 2
    p, counts, V = tsf.stokes_tri_hdiv(6, dim=2, alpha=10.0)
    o = ngsamg_tpu_torch.AMGOptions()
    o.levels.max_coarse_size = 60
    pc = _hdiv_pc(p, counts, V, o)
    s_levels = tdst.dist_stokes_hdiv_levels(
        pc.A_host, pc.mesh0, pc.dofs0, pc.pres0, o, 2
    )
    m_levels, _ = mp_runtime.mp_dist_stokes_hdiv_levels(
        pc.A_host, pc.mesh0, pc.dofs0, pc.pres0, o, 2
    )
    _hdiv_equal(s_levels, m_levels)


@pytest.mark.parametrize("bs", [1, 2])
def test_mp_stokes_equals_single_controller(bs):
    """tests/test_mp_setup.py's Stokes case: the dual-mesh level loop one
    process per rank, per-rank cell/facet slices only, equal to the single
    controller (operators, prolongations, loop basis)."""
    from ngsamg_tpu_torch.config import ProlType
    from ngsamg_tpu_torch.parallel import dist_stokes as tdst
    from ngsamg_tpu_torch.utils import stokes_fem as tsf

    if bs == 1:
        p, _ = tsf.stokes_tri(10, dim=2, alpha=10.0)
    else:
        p, _ = tsf.stokes_cr(8, alpha=10.0)
    opts = ngsamg_tpu_torch.AMGOptions()
    opts.levels.max_coarse_size = 60
    opts.prol.type = ngsamg_tpu_torch.SpecOpt(ProlType.PIECEWISE)
    pc = _stokes_pc(p, opts)
    s_levels = tdst.dist_stokes_levels(pc.A_host, pc.mesh0, bs, opts, 3)
    m_levels, m_log = mp_runtime.mp_dist_stokes_levels(
        pc.A_host, pc.mesh0, bs, opts, 3
    )
    assert m_log.peak_shard_bytes > 0
    assert len(m_log.mp_rank_stats) == 3
    _stokes_equal(s_levels, m_levels)


def test_mp_stokes_hdiv_equals_single_controller():
    """tests/test_mp_setup.py's HDiv case: the preserved-vector level loop
    one process per rank, equal to the single controller."""
    from ngsamg_tpu_torch.parallel import dist_stokes as tdst
    from ngsamg_tpu_torch.utils import stokes_fem as tsf

    p, counts, V = tsf.stokes_tri_hdiv(8, dim=2, alpha=10.0)
    o = ngsamg_tpu_torch.AMGOptions()
    o.levels.max_coarse_size = 120
    pc = _hdiv_pc(p, counts, V, o)
    s_levels = tdst.dist_stokes_hdiv_levels(
        pc.A_host, pc.mesh0, pc.dofs0, pc.pres0, o, 3
    )
    m_levels, m_log = mp_runtime.mp_dist_stokes_hdiv_levels(
        pc.A_host, pc.mesh0, pc.dofs0, pc.pres0, o, 3
    )
    assert m_log.peak_shard_bytes > 0
    _hdiv_equal(s_levels, m_levels)


def test_mp_ranks_take_host_data_only():
    """An energy that holds a tensor off the CPU is refused before any
    rank starts (the ranks hide the card); a device name is host data."""

    class _Meta(TH1):
        pass

    en = _Meta(bs=1)
    en.cache = {"x": torch.zeros(2, device="meta")}
    A = tfem.poisson_2d(6).A.tocsr()
    with pytest.raises(ValueError, match="host data only"):
        mp_runtime.mp_dist_setup_levels(A, en, _opts(ngsamg_tpu_torch), 2)
    el = TEl(dim=2, device=torch.device("cuda"))
    assert mp_runtime._device_tensors(el) == []


def test_rank_modules_import_without_torch():
    """What a rank imports (the level loops, the energies, the options,
    the scalar-setup modules that call the native wrappers, the native
    setup extension, loaded) loads no torch: a spawned rank starts in
    about the time numpy and scipy take."""
    code = (
        "import sys\n"
        "import ngsamg_tpu_torch.parallel.mp_runtime\n"
        "import ngsamg_tpu_torch.parallel.dist_elast\n"
        "import ngsamg_tpu_torch.apps.elasticity\n"
        "import ngsamg_tpu_torch.apps.h1\n"
        "import ngsamg_tpu_torch.mesh.topo\n"
        "import ngsamg_tpu_torch.coarsen.pairwise\n"
        "import ngsamg_tpu_torch.transfer.prolongation\n"
        "import ngsamg_tpu_torch.transfer.galerkin\n"
        "import ngsamg_tpu_torch.native\n"
        "ngsamg_tpu_torch.native.extension()\n"
        "assert 'torch' not in sys.modules\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert res.returncode == 0, res.stderr
