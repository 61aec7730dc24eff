"""The f64 defect correction on the device (`precond/amg.py`
``_solve_device_refined``), on every scalar finest format with an f64 twin.

- On the same ``b`` its answer agrees with the host loop's
  (``_solve_host_refined``, scipy residuals) to 1e-10 relative, with the
  same iterations and passes, and it computes no residual on the host.
- A GS finest level is packed once in f64: the f32 operator and the GS
  smoother's split rows are bit for bit those of a direct f32 pack, and
  the f64 twin shares the operator's columns.
- A correction that stagnates still finishes with the mixed PCG, as the
  host loop's does.
CPU tensors throughout: each kernel's plain version.
"""

import numpy as np
import pytest
import torch

import ngsamg_tpu_torch
from ngsamg_tpu_torch.precond import amg as tamg
from ngsamg_tpu_torch.smoothers.build import build_smoother
from ngsamg_tpu_torch.solve.pcg import SolveResult
from ngsamg_tpu_torch.sparse import bell
from ngsamg_tpu_torch.utils import fem

torch.set_num_threads(2)


def _cheb(**kw):
    return ngsamg_tpu_torch.AMGOptions(
        smoother=ngsamg_tpu_torch.SmootherOptions(
            type=ngsamg_tpu_torch.SmootherType.CHEBYSHEV
        ),
        **kw,
    )


# (problem, options, the finest operator's format)
FORMATS = {
    "gs_block_ell": (lambda: fem.poisson_3d(12), ngsamg_tpu_torch.AMGOptions,
                     "BlockELL"),
    "stencil": (lambda: fem.poisson_3d(34), _cheb, "StencilDia"),
    "tile_ell_stack": (lambda: fem.unstructured_poisson(40, dim=2, refine=1),
                       _cheb, "TileELLStack"),
    "tile_ell": (lambda: fem.unstructured_poisson(40, dim=2, refine=1),
                 lambda: _cheb(shards=2), "TileELL"),
    "dia": (lambda: fem.unstructured_poisson(20, dim=3), _cheb, "DiaMatrix"),
    "dense": (lambda: fem.unstructured_poisson(8, dim=3), _cheb,
              "DenseMatrix"),
}


def _setup(p, opts):
    return ngsamg_tpu_torch.AMGPreconditioner(
        p.A, coords=p.coords, options=opts, device="cpu"
    ).setup()


def _host_loop(pc, b, tol=1e-8):
    b = np.asarray(b, dtype=np.float64)
    return pc._solve_host_refined(
        b, np.linalg.norm(b), tol, tamg._FLOORS[pc.dtype], 8, 300
    )


@pytest.mark.parametrize("name", list(FORMATS))
def test_device_loop_matches_host_loop(name):
    make, opts, kind = FORMATS[name]
    p = make()
    pc = _setup(p, opts())
    assert type(pc.A_dev).__name__ == kind
    x, info = pc.solve(p.b, tol=1e-8)
    assert type(pc._A64_mixed) is type(pc.A_dev)
    assert info.host_residuals == 0
    xh, ih = _host_loop(pc, p.b)
    assert info.converged and ih.converged
    assert info.iterations == ih.iterations
    assert info.outer_iterations == ih.outer_iterations
    assert len(info.history) == len(ih.history)
    assert np.linalg.norm(x - xh) <= 1e-10 * np.linalg.norm(xh)
    true = np.linalg.norm(p.b - p.A @ x) / np.linalg.norm(p.b)
    assert true <= 1e-8 and abs(info.relres - true) <= 1e-12


def test_gs_finest_pack_is_cast_from_f64():
    p = fem.poisson_3d(12)
    pc = _setup(p, ngsamg_tpu_torch.AMGOptions())
    A0 = pc._A0_perm
    data32, cols, _nb, nslots = bell.pack(A0, 1, 1, np.float32,
                                          pc._row_align)
    data64, _c, _n, _s = bell.pack(A0, 1, 1, np.float64, pc._row_align)
    Af, twin = pc.A_dev, pc._A64_dev
    assert Af.data.dtype == torch.float32
    np.testing.assert_array_equal(Af.data.numpy(), data32)
    np.testing.assert_array_equal(Af.cols.numpy(), cols)
    np.testing.assert_array_equal(Af.nslots.numpy(), nslots)
    assert twin.data.dtype == torch.float64
    np.testing.assert_array_equal(twin.data.numpy(), data64)
    assert twin.cols is Af.cols and twin.nslots is Af.nslots
    # the smoother's split rows: those a direct f32 pack gives
    sm = pc.op.levels[0].smoother
    ref = build_smoother(
        A0, 1, pc.options.smoother, 0, Af.nrows_pad, np.float32,
        color_bounds=sm.color_bounds, ell=(data32, cols),
    )
    assert len(sm.cdata) == len(ref.cdata) > 1
    for got, want in zip(sm.cdata, ref.cdata):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    for got, want in zip(sm.ccols, ref.ccols):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(sm.Dinv.numpy(), ref.Dinv)


def test_return_device_stays_on_the_device():
    """The GS finest level's loop hands back the f64 answer on the device,
    in the external order, without a read of x."""
    p = fem.poisson_3d(12)
    pc = _setup(p, ngsamg_tpu_torch.AMGOptions())
    x_host, info = pc.solve(p.b, tol=1e-8)
    x, info_d = pc.solve(p.b, tol=1e-8, return_device=True)
    assert isinstance(x, torch.Tensor) and x.dtype == torch.float64
    assert x.shape == (p.n,)
    np.testing.assert_array_equal(x.numpy(), x_host)
    assert info_d.host_syncs == info.host_syncs - 1


@pytest.mark.parametrize("name", ["gs_block_ell", "dia"])
def test_stagnation_reaches_the_mixed_fallback(name, monkeypatch):
    """Inner PCGs that return no correction: the second pass stagnates,
    and the mixed PCG finishes the solve, on the device loop as on the
    host loop."""
    make, opts, _kind = FORMATS[name]
    p = make()
    pc = _setup(p, opts())

    def no_correction(op, A, b, *, tol=1e-8, maxiter=200):
        return SolveResult(torch.zeros_like(b),
                           torch.ones((), dtype=torch.int32), b.new_ones(()))

    monkeypatch.setattr(tamg, "pcg", no_correction)
    x, info = pc.solve(p.b, tol=1e-8)
    xh, ih = _host_loop(pc, p.b)
    assert info.host_residuals == 0
    assert info.converged and ih.converged
    # two passes of one (empty) iteration, the repeated check, then the
    # mixed PCG's verified residuals
    assert info.history[:3] == pytest.approx([1.0, 1.0, 1.0])
    assert info.iterations == ih.iterations > 2
    assert info.outer_iterations == ih.outer_iterations > 2
    assert len(info.history) == len(ih.history)
    assert np.linalg.norm(x - xh) <= 1e-10 * np.linalg.norm(xh)
    xd, _ = pc.solve(p.b, tol=1e-8, return_device=True)
    assert isinstance(xd, torch.Tensor) and xd.dtype == torch.float64
    np.testing.assert_array_equal(xd.numpy(), x)
