"""Each block-setup wrapper against its numpy branch, on one problem.

The elasticity setup (ROADMAP item 10b) reaches fifteen wrappers of
``ngsamg_tpu_torch.native``. :func:`block_setup_parity` sets up the host
hierarchy of an elasticity problem with the native branches, takes its
finest level (matrix, mesh, aggregation, prolongation) and the next
level's mesh, and runs every one of those wrappers' callers twice on the
same inputs: with ``native.HAVE_NATIVE`` on, and off (the numpy branch
beside the call). Integer outputs (indptr, indices) must be equal; float
outputs agree within ``TOLERANCES[wrapper]`` (max |native - numpy| over
max |numpy|). The native robust SOC and pencil eigenvalues come from a
Jacobi eigensolver, numpy's from LAPACK, and the power iteration and the
products sum in another order, hence the tolerances.

tests/test_torch_native.py runs it on a small problem; chip_smoke.py's
``[native]`` phase on ``unstructured_elasticity(12, dim=3, refine=1)``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import scipy.sparse as sp

# per wrapper: the bound on max |native - numpy| / max |numpy|
TOLERANCES = {
    "frob2_sym": 0.0,
    "elast_ahat_bsr": 1e-12,
    "rigid_edge_blocks": 1e-12,
    "bsr_from_edge_blocks": 1e-12,
    "elast_rm_diag": 1e-12,
    "harmonic_mean_sym": 1e-10,
    "elast_soc_robust": 1e-9,
    "pencil_extreme_eig": 1e-9,
    "elast_map_edge_mats": 1e-12,
    "rho_power": 1e-10,
    "bsr_mm": 1e-12,
    "rap_bsr": 1e-12,
    "bsr_smooth_update": 1e-10,
    "truncate_prol_blocks": 1e-10,
    "bsr_sym_scale": 1e-15,
}


@contextlib.contextmanager
def _switch(on: bool):
    from .. import native

    old = native.HAVE_NATIVE
    native.HAVE_NATIVE = on
    try:
        yield
    finally:
        native.HAVE_NATIVE = old


def _parts(x):
    """(integer arrays, float arrays) of a result: the index arrays of a
    sparse matrix (sorted), or the arrays of a tuple."""
    if sp.issparse(x):
        if x.format == "bsr":
            x = x.copy()
            x.sort_indices()
            return [x.indptr, x.indices], [x.data]
        x = x.tocsr()
        x.sort_indices()
        return [x.indptr, x.indices], [x.data]
    if isinstance(x, (tuple, list)):
        ints, floats = [], []
        for y in x:
            i, f = _parts(y)
            ints += i
            floats += f
        return ints, floats
    x = np.asarray(x, dtype=np.float64)
    return [], [x]


def _compare(name, native_out, numpy_out) -> dict:
    ia, fa = _parts(native_out)
    ib, fb = _parts(numpy_out)
    ints_equal = len(ia) == len(ib) and all(
        a.shape == b.shape and np.array_equal(a, b) for a, b in zip(ia, ib)
    )
    rel = 0.0
    for a, b in zip(fa, fb):
        if a.shape != b.shape:
            rel = float("inf")
            break
        scale = np.abs(b).max(initial=0.0)
        d = np.abs(a - b).max(initial=0.0)
        rel = max(rel, d / scale if scale > 0 else d)
    tol = TOLERANCES[name]
    return {
        "wrapper": name,
        "ints_equal": bool(ints_equal),
        "max_rel_diff": rel,
        "tol": tol,
        "ok": bool(ints_equal and len(fa) == len(fb) and rel <= tol),
    }


def block_setup_parity(A, coords, dim: int) -> list[dict]:
    """One row per block-setup wrapper: its callers with the switch on and
    off on the finest level of ``A``'s elasticity hierarchy, the integer
    outputs compared exactly, the float ones against ``TOLERANCES``, and
    the native calls the switch-on run made (``native_calls``, > 0)."""
    from .. import native
    from ..apps.elasticity import (
        ElasticityEnergy,
        _frob2T,
        _pencil_extreme_eig,
    )
    from ..config import AMGOptions, SmootherOptions, SmootherType
    from ..factory.levels import setup_levels
    from ..mesh.topo import map_edges
    from ..precond.amg import _sym_scale
    from ..smoothers.build import _lam_max_estimate
    from ..sparse.host import block_diagonal_fast, to_bsr
    from ..transfer.galerkin import rap
    from ..transfer.prolongation import (
        _smoothed_block,
        piecewise_prol,
        truncate_prol,
    )

    en = ElasticityEnergy(dim)
    opts = AMGOptions(
        smoother=SmootherOptions(type=SmootherType.CHEBYSHEV)
    )
    with _switch(True):
        levels, _log = setup_levels(A.tocsr(), en, opts, coords)
    if len(levels) < 2:
        raise ValueError("the problem must coarsen at least once")
    lev0, lev1 = levels[0], levels[1]
    mesh0, mesh1 = lev0.mesh, lev1.mesh
    A0, P0, v2agg = lev0.A, lev0.P, lev0.v2agg
    bs, dpv = lev0.row_bs, en.dpv
    edges, E = mesh0.edges, mesh0.edge_data["mat"]
    cedges, e2ce = map_edges(mesh0, v2agg, mesh1.nv)
    Ppw = piecewise_prol(en, mesh0, mesh1, v2agg)
    with _switch(True):
        Ahat = en.replacement_matrix(mesh0)
        D = en.aux_diagonal(mesh0)
        P_smooth = _smoothed_block(
            en, mesh0, v2agg, Ppw, omega=4.0 / 3.0, A=A0, row_bs=bs,
            max_classic=5,
        )
    with _switch(False):
        blocks = en._edge_rm_blocks(mesh0)
    Dv = np.zeros((mesh0.nv, dpv, dpv))
    idx = np.arange(dim)
    Dv[:, idx, idx] = mesh0.vertex_data["l2wt"][:, None]
    # the pencil pairs of the robust SOC: the aux diagonals transported to
    # each edge's midpoint, and their series energy
    pos = mesh0.vertex_data["pos"]
    mid = 0.5 * (pos[edges[:, 0]] + pos[edges[:, 1]])
    Qmi = en.transport(mid, pos[edges[:, 0]])
    Qmj = en.transport(mid, pos[edges[:, 1]])
    di = np.swapaxes(Qmi, -1, -2) @ (D[edges[:, 0]] @ Qmi)
    dj = np.swapaxes(Qmj, -1, -2) @ (D[edges[:, 1]] @ Qmj)
    with _switch(True):
        C = native.harmonic_mean_sym(di, dj, rcond=1e-12)
    Dinv0 = np.linalg.pinv(block_diagonal_fast(to_bsr(A0, bs), bs))
    A0_bsr = to_bsr(A0, bs).copy()
    A0_bsr.sort_indices()
    Ppw_b = Ppw.tobsr(blocksize=(dpv, dpv))

    def sorted_product():
        C = (Ahat @ Ppw_b).tobsr(blocksize=(dpv, dpv))
        C.sort_indices()
        return C

    def series_energy():
        # the numpy branch of ElasticityEnergy.soc_robust
        T = di @ np.linalg.pinv(di + dj, rcond=1e-12, hermitian=True) @ dj
        return 0.5 * (T + np.transpose(T, (0, 2, 1)))

    def block_rap():
        Ac_b = native.rap_bsr(to_bsr(A0, bs), P0)
        Ac = Ac_b.tocsr()
        Ac.eliminate_zeros()
        return Ac

    # wrapper: (the native side, the numpy side); each runs with the
    # switch on and off respectively
    cases = {
        "frob2_sym": (lambda: _frob2T(E),) * 2,
        "elast_ahat_bsr": (lambda: en.replacement_matrix(mesh0),) * 2,
        "rigid_edge_blocks": (lambda: en._edge_rm_blocks(mesh0),) * 2,
        "bsr_from_edge_blocks": (
            lambda: native.bsr_from_edge_blocks(edges, *blocks, Dv),
            lambda: en.replacement_matrix(mesh0),
        ),
        "elast_rm_diag": (lambda: en.aux_diagonal(mesh0),) * 2,
        "harmonic_mean_sym": (
            lambda: native.harmonic_mean_sym(di, dj, rcond=1e-12),
            series_energy,
        ),
        "elast_soc_robust": (lambda: en.soc_robust(mesh0),) * 2,
        "pencil_extreme_eig": (lambda: _pencil_extreme_eig(E, C),) * 2,
        "elast_map_edge_mats": (
            lambda: en.map_data(mesh0, v2agg, mesh1.nv, cedges,
                                e2ce).edge_data["mat"],) * 2,
        "rho_power": (lambda: _lam_max_estimate(A0, bs, Dinv0),) * 2,
        "bsr_mm": (lambda: native.bsr_mm(Ahat, Ppw_b), sorted_product),
        "rap_bsr": (
            block_rap,
            lambda: rap(A0, P0, dtype=np.float64, bs_r=bs, bs_c=dpv),
        ),
        "bsr_smooth_update": (
            lambda: _smoothed_block(
                en, mesh0, v2agg, Ppw, omega=4.0 / 3.0, A=A0, row_bs=bs,
                max_classic=5,
            ),) * 2,
        "truncate_prol_blocks": (
            lambda: truncate_prol(en, mesh1, P_smooth.copy(),
                                  max_per_row=4, min_frac=0.1),) * 2,
        "bsr_sym_scale": (lambda: _sym_scale(A0_bsr)[0],) * 2,
    }
    rows = []
    for name, (fn_native, fn_numpy) in cases.items():
        before = native.CALLS[name]["native"]
        with _switch(True):
            a = fn_native()
        calls = native.CALLS[name]["native"] - before
        with _switch(False):
            b = fn_numpy()
        row = _compare(name, a, b)
        row["native_calls"] = calls
        row["ok"] = row["ok"] and calls > 0
        rows.append(row)
    return rows
