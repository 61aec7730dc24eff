"""Port parity for the Stokes device path: Hiptmair smoothing and solves.

- ``hiptmair_smooth`` forward and backward (from a zero guess and from a
  given one) and one ``amg_apply`` on the JAX package's own staged Stokes
  hierarchy, carried over by ``precond.convert.from_jax_operator``, at
  rtol 1e-5 in f32 (relative 2-norm: some 20 matvecs whose sums run in
  another order), on levels whose potential-space pads differ from the
  range pads; the pad rows stay zero.
- Whole solves on the CPU: ``StokesAMG`` on ``stokes_mac_2d(24)``,
  ``stokes_mac_3d(8)``, ``stokes_tri`` in 2D and in 3D with geometric
  loops and ``stokes_cr``; ``StokesHDivAMG`` on ``stokes_tri_hdiv(14)`` and
  ``stokes_mac_2d_hdiv(16)``; ``StokesHDGEmbeddedAMG`` on
  ``stokes_hdg_p1(12)``: the JAX package's level sizes, iterations within
  one of its count (its native run, each reference solved once per
  module), true relres <= 1e-8.
- The JAX package's convergence invariants on the port: alpha robustness
  of the curl-smoothed lattice path and of the geometric-loop path within
  the same budgets, the stiff penalty, Hiptmair on every level of a
  perturbed (off-lattice) mesh, the vector CR space at alpha 10 and 1000.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ngsamg_tpu
import ngsamg_tpu_torch
from ngsamg_tpu.precond import stokes as jpre
from ngsamg_tpu.smoothers import hiptmair as jhip
from ngsamg_tpu.solve import cycle as jcycle
from ngsamg_tpu.utils import stokes_fem as jsf
from ngsamg_tpu_torch.precond import stokes as tpre
from ngsamg_tpu_torch.precond.convert import from_jax_operator
from ngsamg_tpu_torch.smoothers import core as tcore
from ngsamg_tpu_torch.smoothers import hiptmair as thip
from ngsamg_tpu_torch.solve import cycle as tcycle
from ngsamg_tpu_torch.utils import stokes_fem as tsf

torch.set_num_threads(2)


def _opts(pkg, mcs):
    o = pkg.AMGOptions()
    o.levels.max_coarse_size = mcs
    return o


def _stokes(pkg, pre, p, mcs, geometric=False, pos=None, **kw):
    geo = {}
    if geometric:
        geo = dict(facet_verts=p.facet_verts, vert_pos=p.vert_pos,
                   bnd_facet_verts=p.bnd_facet_verts)
    return pre.StokesAMG(
        p.A, cell_pos=p.cell_pos if pos is None else pos,
        cell_vol=p.cell_vol, facet_cells=p.facet_cells,
        facet_flow=p.facet_flow, options=_opts(pkg, mcs), **geo, **kw,
    )


def _hdiv(pkg, pre, out, mcs, **kw):
    p, counts, V = out
    return pre.StokesHDivAMG(
        p.A, cell_pos=p.cell_pos, cell_vol=p.cell_vol,
        facet_cells=p.facet_cells, facet_flow=p.facet_flow,
        facet_dof_counts=counts, preserved=V, options=_opts(pkg, mcs), **kw,
    ), p.A, p.b


def _hdg(pkg, pre, out, mcs, **kw):
    S, b, E, geo = out
    return pre.StokesHDGEmbeddedAMG(
        S, E, **geo, options=_opts(pkg, mcs), **kw), S, b


# label: (generator call, maker, max_coarse_size); a maker takes
# (package, its precond.stokes, the generator's output, mcs, **kw) and
# returns (preconditioner, A, b)
SOLVES = {
    "mac_2d_24": (lambda m: m.stokes_mac_2d(24), "amg", 100),
    "mac_3d_8": (lambda m: m.stokes_mac_3d(8), "amg", 150),
    "tri_2d_16": (lambda m: m.stokes_tri(16, dim=2)[0], "amg", 80),
    "tri_3d_6_geo": (lambda m: m.stokes_tri(6, dim=3)[0], "amg_geo", 150),
    "cr_2d_10": (lambda m: m.stokes_cr(10, dim=2)[0], "amg", 150),
    "hdiv_tri_14": (lambda m: m.stokes_tri_hdiv(14), "hdiv", 120),
    "hdiv_mac_16": (lambda m: m.stokes_mac_2d_hdiv(16), "hdiv", 120),
    "hdg_12": (lambda m: m.stokes_hdg_p1(12), "hdg", 150),
}
MAKERS = {
    "amg": lambda pkg, pre, p, mcs, **kw: (
        _stokes(pkg, pre, p, mcs, **kw), p.A, p.b),
    "amg_geo": lambda pkg, pre, p, mcs, **kw: (
        _stokes(pkg, pre, p, mcs, geometric=True, **kw), p.A, p.b),
    "hdiv": _hdiv,
    "hdg": _hdg,
}


def _sizes(pc):
    levels = getattr(pc, "aux", pc).setup_levels_
    return [int(c.A.shape[0]) for c in levels]


def _relres(A, b, x):
    return float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))


@pytest.fixture(scope="module", params=sorted(SOLVES))
def reference(request):
    """The JAX package's solve of one problem (native run), once."""
    gen, kind, mcs = SOLVES[request.param]
    pc, A, b = MAKERS[kind](ngsamg_tpu, jpre, gen(jsf), mcs)
    pc.setup()
    x, info = pc.solve(b, tol=1e-8, maxiter=400)
    return request.param, dict(
        sizes=_sizes(pc), levels=pc.num_levels,
        iterations=int(info.iterations), relres=_relres(A, b, x),
    )


def test_solve_matches_jax(reference):
    name, ref = reference
    gen, kind, mcs = SOLVES[name]
    pc, A, b = MAKERS[kind](ngsamg_tpu_torch, tpre, gen(tsf), mcs,
                              device="cpu")
    pc.setup()
    assert pc.device.type == "cpu" and pc.A_dev.data.device.type == "cpu"
    x, info = pc.solve(b, tol=1e-8, maxiter=400)
    rel = _relres(A, b, x)
    assert _sizes(pc) == ref["sizes"] and pc.num_levels == ref["levels"]
    assert abs(info.iterations - ref["iterations"]) <= 1, (
        info.iterations, ref["iterations"])
    assert info.converged and rel <= 1e-8 and ref["relres"] <= 1e-8
    assert abs(info.relres - rel) <= 1e-12


# --- Hiptmair and the cycle on the JAX package's staged hierarchy ----------


@pytest.fixture(scope="module")
def staged():
    """The JAX package's staged hierarchy of stokes_mac_2d(32) (Hiptmair
    on DIA and dense potential spaces) and of stokes_tri(12) with
    geometric loops, and both carried over."""
    out = {}
    for name, p, geo in (("mac", jsf.stokes_mac_2d(32), False),
                         ("tri", jsf.stokes_tri(12, dim=2)[0], True)):
        pc = _stokes(ngsamg_tpu, jpre, p, 80, geometric=geo).setup()
        op_np = jax.tree_util.tree_map(np.asarray, pc.op)
        out[name] = (pc.op, from_jax_operator(op_np))
    return out


def _vec(n, n_pad, seed):
    x = np.zeros((n_pad, 1), dtype=np.float32)
    x[:n, 0] = np.random.default_rng(seed).standard_normal(n)
    return x


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _hiptmair_levels(op):
    return [i for i, lev in enumerate(op.levels)
            if type(lev.smoother).__name__ == "HiptmairSmoother"]


@pytest.mark.parametrize("name", ["mac", "tri"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("start", ["zero", "given"])
def test_hiptmair_smooth_matches_jax(staged, name, reverse, start):
    opj, opt = staged[name]
    levels = _hiptmair_levels(opt)
    assert levels and levels == _hiptmair_levels(opj)
    pads_differ = False
    for i in levels:
        lj, lt = opj.levels[i], opt.levels[i]
        sm = lt.smoother
        assert isinstance(sm, thip.HiptmairSmoother)
        n, n_pad = lt.A.nrows, lt.A.nrows_pad
        pads_differ |= sm.A_pot.nrows_pad != n_pad
        b = _vec(n, n_pad, 10 + i)
        x = None if start == "zero" else _vec(n, n_pad, 20 + i)
        yj = np.asarray(jhip.hiptmair_smooth(
            lj.smoother, lj.A, None if x is None else jnp.asarray(x),
            jnp.asarray(b), reverse=reverse))
        yt = thip.hiptmair_smooth(
            sm, lt.A, None if x is None else torch.from_numpy(x),
            torch.from_numpy(b), reverse=reverse).numpy()
        assert _rel(yt, yj) <= 1e-5, (i, _rel(yt, yj))
        assert not yt[n:].any()
        # the smoother dispatch reaches the same sweep
        sweep = tcore.smooth_back if reverse else tcore.smooth
        ys = sweep(sm, lt.A, None if x is None else torch.from_numpy(x),
                   torch.from_numpy(b)).numpy()
        np.testing.assert_array_equal(ys, yt)
    assert pads_differ


@pytest.mark.parametrize("name", ["mac", "tri"])
def test_cycle_matches_jax(staged, name):
    opj, opt = staged[name]
    n, n_pad = opt.levels[0].A.nrows, opt.levels[0].A.nrows_pad
    b = _vec(n, n_pad, 3)
    yj = np.asarray(jcycle.amg_apply(opj, jnp.asarray(b)))
    yt = tcycle.amg_apply(opt, torch.from_numpy(b)).numpy()
    assert _rel(yt, yj) <= 1e-5
    assert not yt[n:].any()


def test_dia_potential_space_matches_jax(staged):
    """stokes_mac_2d(32) stages DIA potential-space operators, the path
    that takes the DIA kernel on the card."""
    opj, opt = staged["mac"]
    dia = [i for i in _hiptmair_levels(opt)
           if type(opt.levels[i].smoother.A_pot).__name__ == "DiaMatrix"]
    assert dia
    from ngsamg_tpu.sparse import formats as jformats
    from ngsamg_tpu_torch.sparse import formats as tformats

    for i in dia:
        Aj, At = opj.levels[i].smoother.A_pot, opt.levels[i].smoother.A_pot
        x = _vec(At.nrows, At.nrows_pad, 40 + i)
        yj = np.asarray(jformats.matvec(Aj, jnp.asarray(x)))
        yt = tformats.matvec(At, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(yt, yj, rtol=1e-5,
                                   atol=1e-5 * np.abs(yj).max())


def test_own_staging_matches_jax_cycle():
    """The port's own staging (its tile-ELL packer, no reordering) gives
    the JAX package's cycle on the same problem."""
    pj, pt = jsf.stokes_mac_2d(12), tsf.stokes_mac_2d(12)
    cj = _stokes(ngsamg_tpu, jpre, pj, 40).setup()
    ct = _stokes(ngsamg_tpu_torch, tpre, pt, 40, device="cpu").setup()
    assert [type(lev.A).__name__ for lev in ct.op.levels][-1] == \
        "DenseMatrix"
    b = pt.b
    yj = np.asarray(jcycle.amg_apply(cj.op, cj._to_dev(b)))[: pt.n, 0]
    yt = tcycle.amg_apply(ct.op, ct._to_dev(b)).numpy()[: pt.n, 0]
    assert _rel(yt, yj) <= 1e-5


# --- the JAX package's convergence invariants on the port ------------------


def _port_solve(p, mcs, maxiter, **kw):
    pc = _stokes(ngsamg_tpu_torch, tpre, p, mcs, device="cpu", **kw).setup()
    x, info = pc.solve(p.b, tol=1e-8, maxiter=maxiter)
    assert info.converged and _relres(p.A, p.b, x) <= 1e-8
    return pc, info.iterations


def test_alpha_robustness():
    """Curl-smoothed prolongations keep the lattice path alpha-robust
    (the JAX package's test_stokes_alpha_robustness budgets)."""
    iters = {a: _port_solve(tsf.stokes_mac_2d(24, alpha=a), 100, 120)[1]
             for a in (1.0, 1000.0)}
    assert iters[1000.0] < 45 and iters[1000.0] <= 2 * iters[1.0], iters
    _port_solve(tsf.stokes_mac_2d(16, alpha=1000.0), 60, 200)


@pytest.mark.parametrize("dim,n,budget", [(2, 20, 20), (3, 9, 30)])
def test_geo_loops_alpha_robust(dim, n, budget):
    p, _ = tsf.stokes_tri(n, dim=dim, alpha=1000.0)
    _pc, it = _port_solve(p, 80, 150, geometric=True)
    assert it <= budget, it


def test_off_lattice_hiptmair_every_level():
    p = tsf.stokes_mac_2d(16, alpha=10.0)
    rng = np.random.default_rng(7)
    pos = p.cell_pos + rng.uniform(-0.25, 0.25, p.cell_pos.shape) / 16
    pc = _stokes(ngsamg_tpu_torch, tpre, p, 60, pos=pos,
                 device="cpu").setup()
    assert pc.num_levels >= 3
    for lev in pc.op.levels[:-1]:
        assert isinstance(lev.smoother, thip.HiptmairSmoother)
    x, info = pc.solve(p.b, tol=1e-8, maxiter=200)
    assert info.converged and _relres(p.A, p.b, x) <= 1e-8


def test_cr_vector_alpha():
    iters = {}
    for alpha in (10.0, 1000.0):
        p, _ = tsf.stokes_cr(16, dim=2, alpha=alpha)
        pc, iters[alpha] = _port_solve(p, 150, 250)
        assert pc.num_levels >= 3
    assert iters[10.0] < 40 and iters[1000.0] < 100, iters
    p, _ = tsf.stokes_cr(10, dim=2, alpha=100.0)
    pc, _it = _port_solve(p, 120, 150, geometric=True)
    assert pc._loops0 is not None
