"""The unstructured deployment's operators held to their definitions.

``unstructured_poisson(16, dim=3, refine=1)`` (32,720 DoF) under the
configuration ``unstructured_poisson_55``'s flags (Chebyshev) stages
``TileELLStack`` levels 0-1 over dense levels 2-3, ``TileELL`` transfers on
levels 0-2, and a cluster correction of 189 clusters up to 12 rows wide.
Against the plain float64 definitions of ``benchmark/reference``
(``residual.Operator`` through ``cluster_corr.operator``, and
``cluster_corr.detect``/``apply``/``wrapped``), on the program's own host
matrices as staged (``pc.staged_host_matrices()``, permuted and scaled):

- every tile-ELL level and transfer, its padding rows zero, and the
  tile-ELL f64 twin of the finest level; a bfloat16 copy of a level
  misses the float32 tolerance;
- the cluster sets, as sets of rows, and the correction's product;
- one wrapped cycle (``amg_apply``), with the program's own bare cycle as
  the reference's ``cycle``;
- a solve, to a true relative residual of 1e-8.
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.reference import cluster_corr as ref
from benchmark.reference import residual
from ngsamg_tpu_torch import AMGPreconditioner
from ngsamg_tpu_torch.config import options_from_flags
from ngsamg_tpu_torch.smoothers.cluster_corr import (cluster_apply,
                                                     detect_clusters)
from ngsamg_tpu_torch.solve import cycle
from ngsamg_tpu_torch.sparse import formats
from ngsamg_tpu_torch.utils import fem

torch.set_num_threads(2)

FLAGS = {"sm_type": "chebyshev"}  # configs/unstructured_poisson_55.json
# float32: one rounding a partial sum of at most ~60 terms a row, about
# 60 * 6e-8 = 4e-6 of max |y| at worst; a TF32 or bfloat16 product errs by
# 5e-4 or more
F32_TOL = 1e-5
# float64: the same sums at 1.1e-16 a term
F64_TOL = 1e-12
# one wrapped cycle in float32 against the float64 wrap of the same float32
# cycle: the two cluster solves and the two finest residuals round in f32
CYCLE_TOL = 1e-6
OPERATORS = [(0, "A"), (0, "P"), (0, "R"), (1, "A"), (1, "P"), (1, "R"),
             (2, "P"), (2, "R")]


@pytest.fixture(scope="module")
def staged():
    p = fem.unstructured_poisson(16, dim=3, refine=1)
    pc = AMGPreconditioner(p.A, coords=p.coords,
                           options=options_from_flags(FLAGS),
                           device="cpu").setup()
    return p, pc, pc.staged_host_matrices()


def _rel(y, ref_y):
    return float((y - ref_y).abs().max() / ref_y.abs().max())


def _x(n, n_pad, dtype, seed):
    x = torch.zeros((n_pad, 1), dtype=dtype)
    x[:n, 0] = torch.as_tensor(np.random.default_rng(seed).standard_normal(n))
    return x


def test_the_hierarchy_is_tile_ell_and_dense(staged):
    p, pc, _ = staged
    assert p.n == 32720
    levels = pc.op.levels
    assert [type(lev.A).__name__ for lev in levels] == [
        "TileELLStack", "TileELLStack", "DenseMatrix", "DenseMatrix"]
    assert all(isinstance(lev.P, formats.TileELL)
               and isinstance(lev.R, formats.TileELL) for lev in levels[:-1])
    assert pc.op.cluster_corr.shape == (189, 12)


@pytest.mark.parametrize("level,what", OPERATORS,
                         ids=[f"{w}{lv}" for lv, w in OPERATORS])
def test_tile_ell_operators_are_their_host_matrices(staged, level, what):
    _, pc, host = staged
    T = getattr(pc.op.levels[level], what)
    M = host[level][what]
    m, k = M.shape
    assert T.nrows == m and T.ncols_pad >= k
    x = _x(k, T.ncols_pad, torch.float32, 10 * level + len(what))
    y = T.matvec(x)
    want = ref.operator(M, "cpu")(x[:, 0].double())
    assert _rel(y[:m, 0].double(), want) <= F32_TOL
    assert not y[m:].any()


def test_f64_twin_is_the_finest_host_matrix(staged):
    p, pc, host = staged
    A64 = pc._ensure_A64_mixed()
    assert isinstance(A64, formats.TileELLStack)
    assert A64.blocks[0].data.dtype == torch.float64
    x = _x(p.n, A64.ncols_pad, torch.float64, 3)
    want = residual.Operator(host[0]["A"], "cpu")(x[: p.n, 0])
    assert _rel(A64.matvec(x)[: p.n, 0], want) <= F64_TOL


def test_a_bfloat16_level_misses_the_tolerance(staged):
    """The float32 tolerance tells a float32 product from a lower one."""
    p, pc, host = staged
    T = pc.op.levels[0].A
    low = dataclasses.replace(T, blocks=tuple(
        dataclasses.replace(b, data=b.data.bfloat16()) for b in T.blocks))
    x = _x(p.n, T.ncols_pad, torch.float32, 4)
    want = ref.operator(host[0]["A"], "cpu")(x[:, 0].double())
    y = low.matvec(x.bfloat16())[: p.n, 0].double()
    assert _rel(y, want) > F32_TOL


def _members(cc):
    """The program's clusters as sets of rows: a padding slot points at
    row 0 with a zero row and column of the inverse."""
    idx, inv = cc.idx.numpy(), cc.inv.double().numpy()
    real = np.diagonal(inv, axis1=1, axis2=2) != 0
    return {frozenset(r[m].tolist()) for r, m in zip(idx, real)}


def test_cluster_sets_are_the_definition(staged):
    _, pc, host = staged
    want = ref.detect(host[0]["A"], 0.35, 0.3, 16)
    assert len(want) == 189 and max(len(c) for c in want) == 12
    assert _members(pc.op.cluster_corr) == {frozenset(c.tolist())
                                             for c in want}


@pytest.mark.parametrize("dtype,tol", [(np.float32, F32_TOL),
                                       (np.float64, F64_TOL)],
                         ids=["f32", "f64"])
def test_cluster_apply_is_the_definition(staged, dtype, tol):
    p, pc, host = staged
    A0 = host[0]["A"]
    cc = pc.op.cluster_corr if dtype == np.float32 else detect_clusters(
        A0, dtype=np.float64)
    r = _x(p.n, pc.op.levels[0].A.nrows_pad, cc.inv.dtype, 5)
    z = cluster_apply(cc, r)
    want = ref.apply(ref.detect(A0), A0, r[: p.n, 0].double())
    assert _rel(z[: p.n, 0].double(), want) <= tol
    assert not z[p.n:].any()


def test_amg_apply_is_the_wrapped_cycle(staged):
    p, pc, host = staged
    op, n = pc.op, p.n
    n_pad = op.levels[0].A.nrows_pad
    bare = dataclasses.replace(op, cluster_corr=None)

    def bare_cycle(v):
        x = torch.zeros((n_pad, 1))
        x[:n, 0] = v.float()
        return cycle.amg_apply(bare, x)[:n, 0].double()

    b = _x(n, n_pad, torch.float32, 6)
    z = cycle.amg_apply(op, b)[:n, 0].double()
    A0 = host[0]["A"]
    want = ref.wrapped(bare_cycle, ref.detect(A0), A0, b[:n, 0].double())
    assert _rel(z, want) <= CYCLE_TOL


def test_solve_reaches_1e8_by_the_plain_residual(staged):
    p, pc, _ = staged
    b = np.random.default_rng(7).standard_normal(p.n)
    x, info = pc.solve(b, tol=1e-8)
    assert info.converged
    relres = residual.relres(residual.Operator(p.A, "cpu"), b,
                             torch.as_tensor(x))
    assert relres <= 1e-8


def test_staged_host_matrices_leave_out_implicit_transfers():
    """On a lattice the transfers are implicit (no host P is staged) and
    the levels stay unpermuted and unscaled; block levels are refused."""
    p = fem.poisson_3d(20)
    pc = AMGPreconditioner(p.A, coords=p.coords,
                           options=options_from_flags(FLAGS),
                           device="cpu").setup()
    host = pc.staged_host_matrices()
    assert [sorted(h) for h in host] == [["A"]] * pc.num_levels
    assert (host[0]["A"] != p.A.tocsr()).nnz == 0
    q = fem.elasticity_3d(4)
    pq = AMGPreconditioner(q.A, coords=q.coords, energy="elasticity",
                           block_size=3, device="cpu").setup()
    with pytest.raises(ValueError):
        pq.staged_host_matrices()
