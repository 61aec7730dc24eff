"""Port parity for the host setup and the device staging of a hierarchy.

`fem.poisson_3d(40)` with the Chebyshev smoother goes through both
packages' `AMGPreconditioner(...).setup()`. At this size the stencil
domain yields a uniform finest level (`StencilDia`), a clamp-compressed
level and a CSR tail, as the headline does. `_DIA_SYM_MIN_ROWS` is
lowered to 1,000 in both packages so that the symmetric half-storage
staging (K3's format) is covered here too.

Stencil-domain data is compared bitwise: both packages run the same
numpy code. CSR-tail matrices, lambda_max estimates and the coarse
inverse are compared in f64 to rtol 1e-10, and their f32-staged copies
to one f32 ulp: with both switches on (the default) both packages run the
native `rap_csr`/`rho_power` (tests/test_torch_native.py holds that run
bitwise); the bound also covers a run of either package on its numpy
branches.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ngsamg_tpu
import ngsamg_tpu.precond.amg as jamg
import ngsamg_tpu.smoothers.build as jbuild
import ngsamg_tpu.sparse.formats as jformats
import ngsamg_tpu_torch
import ngsamg_tpu_torch.precond.amg as tamg
import ngsamg_tpu_torch.smoothers.build as tbuild
import ngsamg_tpu_torch.sparse.formats as tformats
from ngsamg_tpu_torch.factory.levels import setup_levels
from ngsamg_tpu_torch.utils import fem as tfem

torch.set_num_threads(2)

F32_ULP = 2.0 ** -23


def _cheb(pkg):
    return pkg.AMGOptions(
        smoother=pkg.config.SmootherOptions(
            type=pkg.config.SmootherType.CHEBYSHEV
        )
    )


@pytest.fixture(scope="module")
def pair():
    p = tfem.poisson_3d(40)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jformats, "_DIA_SYM_MIN_ROWS", 1000)
        mp.setattr(tformats, "_DIA_SYM_MIN_ROWS", 1000)
        pj = ngsamg_tpu.AMGPreconditioner(
            p.A, coords=p.coords, options=_cheb(ngsamg_tpu)
        ).setup()
        pt = ngsamg_tpu_torch.AMGPreconditioner(
            p.A, coords=p.coords, options=_cheb(ngsamg_tpu_torch),
            device="cpu",
        ).setup()
    return p, pj, pt


def test_fem_matches_jax(pair):
    from ngsamg_tpu.utils import fem as jfem

    p, _, _ = pair
    q = jfem.poisson_3d(40)
    assert isinstance(p.A, sp.dia_matrix)
    np.testing.assert_array_equal(p.A.offsets, q.A.offsets)
    np.testing.assert_array_equal(p.A.data, q.A.data)
    np.testing.assert_array_equal(p.b, q.b)
    np.testing.assert_array_equal(p.coords, q.coords)


def test_level_log_matches(pair):
    _, pj, pt = pair
    assert pt.log_.nvs == pj.log_.nvs
    assert pt.log_.nnzs == pj.log_.nnzs
    assert pt.num_levels == pj.num_levels == 4
    assert pt.operator_complexity == pj.operator_complexity


def test_stencil_levels_bitwise(pair):
    from ngsamg_tpu.transfer import stencil as jst

    _, pj, pt = pair
    n_stencil = 0
    for lj, lt in zip(pj.setup_levels_, pt.setup_levels_):
        assert lt.lattice_transfer == lj.lattice_transfer
        assert type(lt.stencil).__name__ == type(lj.stencil).__name__
        if lj.stencil is None:
            continue
        n_stencil += 1
        sj, stc = lj.stencil, lt.stencil
        if isinstance(sj, jst.ClampedOp):
            assert stc.dims == sj.dims and stc.bands == sj.bands
            for mj, mt in zip(sj.maps, stc.maps):
                np.testing.assert_array_equal(mt, mj)
            sj, stc = sj.patch, stc.patch
        np.testing.assert_array_equal(stc.offs, sj.offs)
        np.testing.assert_array_equal(stc.data, sj.data)
    assert n_stencil == 2


def test_csr_tail_levels(pair):
    _, pj, pt = pair
    n_csr = 0
    for lj, lt in zip(pj.setup_levels_[1:], pt.setup_levels_[1:]):
        assert (lj.A is None) == (lt.A is None)
        if lj.A is None:
            continue
        n_csr += 1
        Aj, At = lj.A.tocsr(), lt.A.tocsr()
        assert At.shape == Aj.shape and At.nnz == Aj.nnz
        diff = abs(At - Aj).max()
        assert diff <= 1e-10 * abs(Aj).max()
    assert n_csr == 3


def test_staged_formats(pair):
    _, pj, pt = pair
    kinds = []
    for i, (dj, dt) in enumerate(zip(pj.op.levels, pt.op.levels)):
        Aj, At = dj.A, dt.A
        kinds.append(type(At).__name__)
        assert type(At).__name__ == type(Aj).__name__
        assert At.nrows == Aj.nrows
        tail = pj.setup_levels_[i].stencil is None
        if isinstance(At, tformats.StencilDia):
            assert At.offs == Aj.offs and At.dims == Aj.dims
            np.testing.assert_array_equal(At.vals.numpy(), np.asarray(Aj.vals))
            continue
        if isinstance(At, tformats.DiaMatrix):
            assert At.offsets == Aj.offsets
            assert At.sym_half == Aj.sym_half
            a, b = At.data.numpy()[:, : At.nrows], np.asarray(Aj.data)[
                :, : Aj.nrows
            ]
        else:
            n = At.nrows
            a, b = At.data.numpy()[:n, :n], np.asarray(Aj.data)[:n, :n]
        if tail:
            np.testing.assert_allclose(a, b, rtol=F32_ULP, atol=0)
        else:
            np.testing.assert_array_equal(a, b)
    assert kinds == ["StencilDia", "DiaMatrix", "DiaMatrix", "DenseMatrix"]
    # the clamp-compressed level is stored symmetric half at this threshold
    assert pt.op.levels[1].A.sym_half


def test_smoothers_and_transfers(pair):
    _, pj, pt = pair
    for i, (dj, dt) in enumerate(zip(pj.op.levels, pt.op.levels)):
        smj, smt = dj.smoother, dt.smoother
        assert (smj is None) == (smt is None)
        if smj is None:
            continue
        assert type(smt).__name__ == type(smj).__name__ == "ChebyshevSmoother"
        assert smt.order == smj.order == 3 and smt.steps == smj.steps
        assert smt.lam_max.dtype == np.float32
        for a, b in ((smt.lam_max, smj.lam_max), (smt.lam_min, smj.lam_min)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=F32_ULP)
        np.testing.assert_allclose(
            smt.Dinv.numpy(), np.asarray(smj.Dinv), rtol=F32_ULP, atol=0
        )
        for Tj, Tt in ((dj.P, dt.P), (dj.R, dt.R)):
            assert type(Tt).__name__ == type(Tj).__name__
            for f in ("dims_f", "dims_c", "omega", "nf", "nc"):
                assert getattr(Tt, f) == getattr(Tj, f)
            assert Tt.A is dt.A  # shared with the level, not a copy
            nf = Tt.nf if Tt.Dinv.shape[0] > 1 else 1
            np.testing.assert_allclose(
                Tt.Dinv.numpy()[:nf], np.asarray(Tj.Dinv)[:nf],
                rtol=F32_ULP, atol=0,
            )
    # the uniform finest level broadcasts one Dinv scalar
    assert tuple(pt.op.levels[0].smoother.Dinv.shape) == (1, 1, 1)


def test_lam_max_estimate_f64(pair):
    _, pj, pt = pair
    for lj, lt in zip(pj.setup_levels_, pt.setup_levels_):
        if lj.stencil is not None or lj is pj.setup_levels_[-1]:
            continue
        Dj = jbuild._pinv_blocks(lj.A.diagonal().reshape(-1, 1, 1))
        Dt = tbuild._pinv_blocks(lt.A.diagonal().reshape(-1, 1, 1))
        np.testing.assert_allclose(
            tbuild._lam_max_estimate(lt.A, 1, Dt),
            jbuild._lam_max_estimate(lj.A, 1, Dj),
            rtol=1e-10,
        )


def test_coarse_inverse(pair):
    _, pj, pt = pair
    inv_j = jamg._spd_inverse(pj.setup_levels_[-1].A.toarray())
    inv_t = tamg._spd_inverse(pt.setup_levels_[-1].A.toarray())
    np.testing.assert_allclose(
        inv_t, inv_j, rtol=1e-10, atol=1e-10 * np.abs(inv_j).max()
    )
    cj, ct = np.asarray(pj.op.coarse_inv), pt.op.coarse_inv.numpy()
    assert ct.shape == cj.shape and ct.dtype == cj.dtype == np.float32
    np.testing.assert_allclose(ct, cj, rtol=2 * F32_ULP, atol=1e-7 * np.abs(cj).max())


def test_f64_finest_stencil(pair):
    _, pj, pt = pair
    A64j, A64t = pj._A64_dev, pt._A64_dev
    assert A64t.vals.dtype == torch.float64
    assert A64t.offs == A64j.offs and A64t.dims == A64j.dims
    np.testing.assert_array_equal(A64t.vals.numpy(), np.asarray(A64j.vals))


def test_unported_paths_raise():
    """The plate test coarsener (which declines the structured fast path
    and reaches the generic loop) builds the JAX package's levels; the
    JAX package's default options (multicolor GS, V-cycle) and the W-cycle
    set up and solve; the Hiptmair smoother, which only the Stokes
    preconditioners build, raises the JAX package's ValueError instead of
    running another one."""
    import ngsamg_tpu.factory.levels as jlevels

    p = tfem.poisson_3d(12)
    opts = _cheb(ngsamg_tpu_torch)
    plates = []
    for pkg, run in ((ngsamg_tpu_torch, setup_levels),
                     (ngsamg_tpu, jlevels.setup_levels)):
        plate = _cheb(pkg).replace(coarsen=pkg.config.CoarsenOptions(
            algo=pkg.config.CoarsenType.PLATE
        ))
        plates.append(
            run(p.A, pkg.precond.amg.H1Energy(), plate, p.coords)
        )
    (lt, logt), (lj, logj) = plates
    assert logt.nvs == logj.nvs and logt.nnzs == logj.nnzs
    assert logt.nvs[1] == 11 * 11  # one aggregate per (x, y) column
    for a, b in zip(lt, lj):
        if b.v2agg is not None:
            np.testing.assert_array_equal(a.v2agg, b.v2agg)
        assert abs(a.A - b.A).max() <= 1e-12 * abs(b.A).max()
    for o in (ngsamg_tpu_torch.AMGOptions(),  # default smoother: GS
              opts.replace(cycle=ngsamg_tpu_torch.CycleType.W)):
        pc = ngsamg_tpu_torch.AMGPreconditioner(
            p.A, coords=p.coords, options=o, device="cpu"
        ).setup()
        x, info = pc.solve(p.b, tol=1e-8)
        rel = np.linalg.norm(p.b - p.A @ x) / np.linalg.norm(p.b)
        assert info.converged and rel <= 1e-8 and info.iterations <= 15
    hip = ngsamg_tpu_torch.AMGOptions(
        smoother=ngsamg_tpu_torch.SmootherOptions(
            type=ngsamg_tpu_torch.SmootherType.HIPTMAIR
        )
    )
    with pytest.raises(ValueError, match="unsupported smoother type"):
        ngsamg_tpu_torch.AMGPreconditioner(
            p.A, coords=p.coords, options=hip, device="cpu"
        ).setup()


@pytest.mark.parametrize("refine", [None, True, False])
@pytest.mark.parametrize("path", ["device", "host"])
def test_use_refinement_matches_jax(path, refine):
    """``solve(use_refinement=...)`` on both finest twins (the f64 stencil:
    Chebyshev on ``poisson_3d(40)``; the f64 pack of the GS block-ELL
    finest level of ``poisson_3d(12)``, the ``host`` case, which the JAX
    package refines on the host): the JAX package's iterations and passes;
    with refinement the port computes no residual on the host, without it
    one unverified pass on the host loop, whose true residual sits at the
    f32 inner tolerance in both packages."""
    p = tfem.poisson_3d(40 if path == "device" else 12)
    infos = []
    for pkg, kw in ((ngsamg_tpu, {}), (ngsamg_tpu_torch, {"device": "cpu"})):
        opts = _cheb(pkg) if path == "device" else pkg.AMGOptions()
        pc = pkg.AMGPreconditioner(p.A, coords=p.coords, options=opts, **kw)
        pc.setup()
        x, info = pc.solve(p.b, tol=1e-8, use_refinement=refine)
        infos.append((pc, np.asarray(x), info))
    (pj, xj, ij), (pt, xt, it) = infos
    assert pt._A64_dev is not None
    assert (it.host_residuals == 0) == (refine is not False)
    assert it.outer_iterations == ij.outer_iterations
    assert it.iterations == ij.iterations
    assert it.converged == ij.converged
    assert len(it.history) == len(ij.history)
    if refine is False:
        assert it.outer_iterations == 1
        assert it.relres == pytest.approx(ij.relres, rel=0.25)
        assert 1e-8 < it.relres < 1e-4
    else:
        assert it.converged and it.relres <= 1e-8
    assert np.linalg.norm(xt - xj) <= 1e-4 * np.linalg.norm(xj)


def test_missing_names():
    """``amg_preconditioner``, ``matvec_free`` and the staging times under
    the JAX package's stage names."""
    assert "amg_preconditioner" in ngsamg_tpu_torch.__all__
    p = tfem.poisson_3d(12)
    pcs = [
        pkg.amg_preconditioner(p.A, coords=p.coords, **kw)
        for pkg, kw in ((ngsamg_tpu, {}),
                        (ngsamg_tpu_torch, {"device": "cpu"}))
    ]
    pj, pt = pcs
    assert pt._is_setup
    assert list(pt._device_stage_times) == list(pj._device_stage_times)
    assert all(v >= 0 for v in pt._device_stage_times.values())
    v = np.random.default_rng(1).standard_normal(p.n)
    np.testing.assert_array_equal(pt.matvec_free(v), pj.matvec_free(v))


@pytest.mark.parametrize(
    "field, value, item",
    [("shards", 4, "item 8"), ("dist_setup", 4, "item 8")],
)
def test_unported_options_raise(field, value, item):
    """The options of ROADMAP item 8 run: ``shards`` (8b) stages the
    JAX package's padded hierarchy on one device (every level a multiple
    of 8 * shards rows, no bucketed tile-ELL), which the sharded solve
    places (tests/test_torch_parallel.py); the host-distributed setup
    (8a) builds the hierarchy on ``value`` shards
    (tests/test_torch_dist_setup.py holds it to the JAX package)."""
    p = tfem.poisson_3d(12)
    opts = _cheb(ngsamg_tpu_torch).replace(**{field: value})
    pc = ngsamg_tpu_torch.AMGPreconditioner(
        p.A, coords=p.coords, options=opts, device="cpu"
    ).setup()
    if field == "shards":
        pj = ngsamg_tpu.AMGPreconditioner(
            p.A, coords=p.coords,
            options=_cheb(ngsamg_tpu).replace(**{field: value}),
        ).setup()
        pads = [lev.A.nrows_pad for lev in pc.op.levels]
        assert pads == [lev.A.nrows_pad for lev in pj.op.levels], item
        assert all(n % (8 * value) == 0 for n in pads), pads
        assert [type(lev.A).__name__ for lev in pc.op.levels] == [
            type(lev.A).__name__ for lev in pj.op.levels
        ]
        x, info = pc.solve(p.b, tol=1e-8)
        assert info.converged
        return
    assert pc.log_.shards_per_level[0] == value
    assert pc.log_.peak_shard_bytes > 0


def test_energy_names():
    """The energies the port knows by name, and the one it does not."""
    from ngsamg_tpu_torch.apps.elasticity import ElasticityEnergy
    from ngsamg_tpu_torch.apps.h1 import H1Energy

    p = tfem.elasticity_2d(4, length=4)
    for name in ("elasticity", "elast"):
        pc = ngsamg_tpu_torch.AMGPreconditioner(
            p.A, energy=name, block_size=2, coords=p.coords,
            options=_cheb(ngsamg_tpu_torch), device="cpu",
        )
        assert isinstance(pc.energy, ElasticityEnergy) and pc.energy.dim == 2
    pc = ngsamg_tpu_torch.AMGPreconditioner(
        p.A, block_size=2, options=_cheb(ngsamg_tpu_torch), device="cpu"
    )
    assert isinstance(pc.energy, H1Energy) and pc.energy.dpv == 2
    with pytest.raises(ValueError, match="requires coords"):
        ngsamg_tpu_torch.AMGPreconditioner(
            p.A, energy="elasticity", block_size=2, device="cpu"
        )
    with pytest.raises(ValueError, match="unknown energy"):
        ngsamg_tpu_torch.AMGPreconditioner(p.A, energy="stokes", device="cpu")


def test_device_is_required():
    """No implicit CPU default: without ``device=`` the hierarchy goes to
    the card, so a machine without CUDA raises; the CPU is asked for."""
    p = tfem.poisson_3d(12)
    if torch.cuda.is_available():
        pc = ngsamg_tpu_torch.AMGPreconditioner(
            p.A, coords=p.coords, options=_cheb(ngsamg_tpu_torch)
        )
        assert pc.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ngsamg_tpu_torch.AMGPreconditioner(
                p.A, coords=p.coords, options=_cheb(ngsamg_tpu_torch)
            )
    pc = ngsamg_tpu_torch.AMGPreconditioner(
        p.A, coords=p.coords, options=_cheb(ngsamg_tpu_torch), device="cpu"
    )
    assert pc.device.type == "cpu"
