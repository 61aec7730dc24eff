"""The port's ``CollectiveTransport`` (parallel/transport.py).

Mirrors tests/test_dist_setup.py::test_collective_transport_parity and
tests/test_dist_stokes.py::test_dist_stokes_collective_transport_parity.
The JAX package runs its setup over single-controller ``shard_map``
programs; in the port a collective has one process per rank, so the
same setups run in a spawned world of gloo ranks on CPU tensors
(``mp_runtime`` with ``transport="collective"``), every exchange one
``all_to_all_single`` of uint32 words. The hierarchy must be BITWISE the
port's ``LocalTransport`` one, which tests/test_torch_dist_setup.py and
tests/test_torch_dist_stokes.py hold to the JAX package's.
"""


import numpy as np
import pytest

import ngsamg_tpu
import ngsamg_tpu.native as jnative
import ngsamg_tpu_torch
from ngsamg_tpu.apps.h1 import H1Energy as JH1
from ngsamg_tpu.parallel import dist_setup as jds
from ngsamg_tpu_torch.apps.h1 import H1Energy as TH1
from ngsamg_tpu_torch.parallel import dist_setup as tds
from ngsamg_tpu_torch.parallel import dist_stokes as tdst
from ngsamg_tpu_torch.parallel import mp_runtime
from ngsamg_tpu_torch.parallel import transport as ttr
from ngsamg_tpu_torch.precond.stokes import StokesAMG
from ngsamg_tpu_torch.utils import fem as tfem
from ngsamg_tpu_torch.utils import stokes_fem as tsf

N_SHARDS = 8  # the JAX tests' mesh (tests/conftest.py)


def _opts(pkg):
    # the JAX test's options: f64, the algebraic (SPW) path
    o = pkg.AMGOptions(dtype="float64")
    o.coarsen.algo = pkg.SpecOpt(pkg.CoarsenType.SPW)
    o.levels.max_coarse_size = 40
    return o


def _csr_equal(a, b, what):
    a, b = a.tocsr(), b.tocsr()
    np.testing.assert_array_equal(a.indptr, b.indptr, err_msg=what)
    np.testing.assert_array_equal(a.indices, b.indices, err_msg=what)
    np.testing.assert_array_equal(a.data, b.data, err_msg=what)


def test_collective_transport_parity():
    """The H1 setup over the collective transport reproduces the local
    transport's hierarchy exactly (payloads bit-cast)."""
    prob = tfem.unstructured_poisson(14, dim=2)
    l_levels, l_log = tds.dist_setup_levels(
        prob.A, TH1(bs=1), _opts(ngsamg_tpu_torch), N_SHARDS
    )
    c_levels, c_log = mp_runtime.mp_dist_setup_levels(
        prob.A, TH1(bs=1), _opts(ngsamg_tpu_torch), N_SHARDS,
        transport="collective", backend="gloo", device="cpu",
    )
    stats = c_log.mp_rank_stats
    assert len(stats) == N_SHARDS
    assert all(s["transport_calls"] > 0 for s in stats), (
        "collective transport never exercised"
    )
    assert l_log.nvs == c_log.nvs and l_log.nnzs == c_log.nnzs
    assert len(l_levels) == len(c_levels) >= 2
    for i, (ll, cl) in enumerate(zip(l_levels, c_levels)):
        _csr_equal(ll.A, cl.A, f"A{i}")
        if ll.P is not None:
            _csr_equal(ll.P, cl.P, f"P{i}")
            np.testing.assert_array_equal(ll.v2agg, cl.v2agg)
    # and the JAX package's local-transport hierarchy (numpy branches)
    old = jnative.HAVE_NATIVE
    jnative.HAVE_NATIVE = False
    try:
        j_levels, j_log = jds.dist_setup_levels(
            prob.A, JH1(bs=1), _opts(ngsamg_tpu), N_SHARDS
        )
    finally:
        jnative.HAVE_NATIVE = old
    assert j_log.nvs == c_log.nvs
    for i, (jl, cl) in enumerate(zip(j_levels, c_levels)):
        _csr_equal(jl.A, cl.A, f"JAX A{i}")


def test_dist_stokes_collective_transport_parity():
    """The Stokes dual-mesh setup over the collective transport, the
    typed ``route_rows`` routing included, reproduces the local
    transport's hierarchy (operators, flows, prolongations, loops)."""
    p, _ = tsf.stokes_tri(8, dim=2, alpha=10.0)
    opts = ngsamg_tpu_torch.AMGOptions()
    opts.levels.max_coarse_size = 60
    pc = StokesAMG(
        p.A, cell_pos=p.cell_pos, cell_vol=p.cell_vol,
        facet_cells=p.facet_cells, facet_flow=p.facet_flow, options=opts,
        device="cpu",
    )
    l_levels = tdst.dist_stokes_levels(pc.A_host, pc.mesh0, 1, opts,
                                       N_SHARDS)
    c_levels, c_log = mp_runtime.mp_dist_stokes_levels(
        pc.A_host, pc.mesh0, 1, opts, N_SHARDS,
        transport="collective", backend="gloo", device="cpu",
    )
    assert all(s["transport_calls"] > 0 for s in c_log.mp_rank_stats)
    assert len(l_levels) == len(c_levels) >= 2
    for i, (ll, cl) in enumerate(zip(l_levels, c_levels)):
        assert abs(ll.A - cl.A).max() == 0.0, f"L{i}"
        np.testing.assert_array_equal(
            ll.mesh.edge_data["flow"], cl.mesh.edge_data["flow"]
        )
        if ll.P is not None or cl.P is not None:
            assert abs(ll.P - cl.P).max() == 0.0, f"P L{i}"
        if ll.C is not None or cl.C is not None:
            assert abs(ll.C - cl.C).max() == 0.0, f"C L{i}"


def test_collective_transport_refuses_unset_backend():
    """Nothing chooses the backend for the caller."""
    A = tfem.poisson_2d(6).A.tocsr()
    with pytest.raises(ValueError, match="explicit backend"):
        mp_runtime.mp_dist_setup_levels(
            A, TH1(bs=1), _opts(ngsamg_tpu_torch), 2,
            transport="collective",
        )


def test_collective_transport_refuses_unset_device():
    """Nothing places the words on a device for the caller either."""
    A = tfem.poisson_2d(6).A.tocsr()
    with pytest.raises(ValueError, match="and device"):
        mp_runtime.mp_dist_setup_levels(
            A, TH1(bs=1), _opts(ngsamg_tpu_torch), 2,
            transport="collective", backend="gloo",
        )


@pytest.mark.parametrize("entry", ["spawn_world", "spawn_tasks"])
def test_world_entry_points_need_device(entry):
    """A spawned world has no default device: leaving it out is an error
    before any rank starts."""
    from ngsamg_tpu_torch.parallel import sharded_run, world

    with pytest.raises(TypeError, match="device"):
        if entry == "spawn_world":
            world.spawn_world(sharded_run.run_tasks, 2, backend="gloo")
        else:
            sharded_run.spawn_tasks([], 2, backend="gloo")


@pytest.mark.parametrize(
    "arr",
    [
        np.arange(5, dtype=np.float64) * 0.1,
        np.arange(6, dtype=np.int64).reshape(3, 2) - 2,
        np.array([True, False, True]),
        np.arange(4, dtype=np.int16),
        np.zeros((0, 3), dtype=np.float32),
    ],
    ids=["f64", "i64x2", "bool", "i16", "empty"],
)
def test_word_round_trip(arr):
    """Payloads cross as uint32 words and come back bit for bit."""
    w = ttr._to_u32(arr)
    assert w.dtype == np.uint32 and w.shape[0] == arr.shape[0]
    back = ttr._from_u32(w, arr.dtype, arr.shape[1:])
    assert back.dtype == arr.dtype
    np.testing.assert_array_equal(back, arr)
    assert ttr._bucket(5) == 8 and ttr._bucket(1) == 1
