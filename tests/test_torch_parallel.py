"""The sharded solve of ngsamg_tpu_torch against the JAX package's.

Mirrors the nine tests of tests/test_parallel.py. The JAX package runs on
the 8 virtual CPU devices of tests/conftest.py in this process; the port
runs in one spawned world of 8 gloo ranks on CPU tensors
(``parallel.sharded_run.spawn_tasks``), on the JAX package's own padded
``shards=8`` hierarchies carried over with ``precond.convert`` — so both
packages shard the same operator. Every task of the file runs in that one
world (a module fixture), each test reads its part:

* halo and sharded matvecs are held to the JAX package's on the same
  vector: rtol 1e-5 in f32, 1e-12 in f64;
* a sharded solve takes the port's replicated iteration count, within one
  of the JAX package's sharded count, to a true relres below tol;
* ``level_shard_counts`` equals the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ngsamg_tpu import AMGOptions, AMGPreconditioner
from ngsamg_tpu.config import SmootherOptions, SmootherType
from ngsamg_tpu.parallel import halo as jhalo
from ngsamg_tpu.parallel.shard import (
    level_shard_counts as j_counts,
    make_mesh,
    shard_operator as j_shard,
)
from ngsamg_tpu.solve.cycle import amg_apply as j_apply
from ngsamg_tpu.solve.pcg import _pcg_chunk, _pcg_init, pcg as j_pcg
from ngsamg_tpu.sparse import formats as jformats
from ngsamg_tpu.utils import fem

from ngsamg_tpu_torch.parallel.sharded_run import spawn_tasks
from ngsamg_tpu_torch.precond.convert import from_jax_operator
from ngsamg_tpu_torch.solve.cycle import amg_apply as t_apply
from ngsamg_tpu_torch.solve.pcg import (
    _pcg_init as t_init,
    _pcg_step as t_step,
    pcg as t_pcg,
)
from ngsamg_tpu_torch.sparse import formats as tformats

NSH = 8


def _jpc(prob, *, smoother=None, mcs=None, dtype="float32", **kw):
    o = AMGOptions(shards=NSH, dtype=dtype)
    if smoother is not None:
        o.smoother = SmootherOptions(type=smoother)
    if mcs is not None:
        o.levels.max_coarse_size = mcs
    return AMGPreconditioner(
        prob.A, coords=prob.coords, options=o, **kw
    ).setup()


def _port_op(pc):
    return from_jax_operator(jax.tree_util.tree_map(np.asarray, pc.op))


def _steps_jax(op, A, b, n):
    st = _pcg_init(b)
    tol2 = np.float32(1e-30)
    for _ in range(n // 4):
        st = _pcg_chunk(op, A, st, tol2, chunk=4)
    return np.asarray(st[0])


def _steps_port(op, b, n):
    A = op.levels[0].A
    st = t_init(b)
    tol2 = torch.tensor(1e-30, dtype=b.dtype)
    for _ in range(n):
        st = t_step(op, A, st, tol2)
    return st[0].numpy()


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _level_vectors(op_np, seed, dtype):
    """One random vector per level, zero on the padding rows."""
    rng = np.random.default_rng(seed)
    out = []
    for lev in op_np.levels:
        A = lev.A
        kind = type(A).__name__
        bs = (A.data.shape[3] if kind == "BlockELL"
              else A.bs if kind == "DenseMatrix" else 1)
        v = np.zeros((A.nrows_pad, bs), dtype)
        v[: A.nrows] = rng.standard_normal((A.nrows, bs))
        out.append(v)
    return out


@pytest.fixture(scope="module")
def world():
    mesh = make_mesh(NSH)
    C = {}
    tasks = []

    def add(name, **t):
        C.setdefault(name, {})["task" + str(len(
            [k for k in C[name] if k.startswith("task")]))] = len(tasks)
        tasks.append(t)

    # halo DIA matvec (test_halo_exchange_dia_spmv)
    p = fem.poisson_3d(20)
    Aj = jformats.dia_from_scipy(
        p.A, jnp.float32, row_align=8 * NSH, use_pallas=False
    )
    x = np.random.default_rng(0).standard_normal(Aj.nrows_pad)
    xs = jax.device_put(jnp.asarray(x[:, None], jnp.float32),
                        NamedSharding(mesh, P("rows", None)))
    ds = jax.device_put(Aj.data, NamedSharding(mesh, P(None, "rows")))
    yj = np.asarray(jax.jit(jhalo.dia_halo_matvec(Aj, mesh))(ds, xs))
    At = tformats.dia_from_scipy(p.A, np.float32, row_align=8 * NSH)
    C["dia"] = {"yj": yj[:, 0], "x": x, "p": p,
                "err_j": jhalo.demo_sharded_solve(NSH, 20)}
    add("dia", kind="dia_halo", A=At, x=x[:, None])
    add("dia", kind="demo", n=20)

    # fixed PCG steps (test_shard_operator_solve)
    prob = fem.poisson_3d(10)
    pc = _jpc(prob, smoother=SmootherType.CHEBYSHEV, mcs=60)
    op_s, A_s = j_shard(pc.op, pc.A_dev, mesh, replicate_below=100)
    b = pc._to_dev(prob.b)
    op_t = _port_op(pc)
    bt = torch.from_numpy(np.array(b))
    C["steps"] = {
        "xj": _steps_jax(op_s, A_s, b, 16),
        "xr": _steps_port(op_t, bt, 16),
        "counts_j": j_counts(op_s),
    }
    add("steps", kind="pcg", op=op_t, b=np.asarray(b), steps=16,
        tol2=1e-30, shard={"replicate_below": 100})

    # to tolerance (test_sharded_solve_to_tolerance)
    prob = fem.poisson_3d(12)
    pc = _jpc(prob, smoother=SmootherType.CHEBYSHEV, mcs=60,
              dtype="float64")
    op_s, A_s = j_shard(pc.op, pc.A_dev, mesh, replicate_below=100)
    b = pc._to_dev(prob.b)
    op_t = _port_op(pc)
    bt = torch.from_numpy(np.array(b))
    res_t = t_pcg(op_t, op_t.levels[0].A, bt, tol=1e-8, maxiter=60)
    C["tol"] = {
        "it_j": int(j_pcg(op_s, A_s, b, tol=1e-8, maxiter=60).iterations),
        "it_r": int(res_t.iterations),
        "pc": pc, "prob": prob, "counts_j": j_counts(op_s),
    }
    add("tol", kind="pcg", op=op_t, b=np.asarray(b), tol=1e-8, maxiter=60,
        shard={"replicate_below": 100})

    # multicolor GS (test_sharded_gs_matches_replicated)
    prob = fem.unstructured_poisson(16, dim=2)
    pc = _jpc(prob, smoother=SmootherType.GS, mcs=40)
    op_s, A_s = j_shard(pc.op, pc.A_dev, mesh, replicate_below=50)
    b = pc._to_dev(prob.b)
    op_t = _port_op(pc)
    bt = torch.from_numpy(np.array(b))
    C["gs"] = {
        "xj": _steps_jax(op_s, A_s, b, 12),
        "xr": _steps_port(op_t, bt, 12),
        "counts_j": j_counts(op_s),
    }
    add("gs", kind="pcg", op=op_t, b=np.asarray(b), steps=12,
        tol2=1e-30, shard={"replicate_below": 50})

    # one-shot interface halo (test_tile_halo_matvec_matches_replicated)
    p = fem.unstructured_poisson(160, dim=2)
    n = p.A.shape[0]
    pad = -(-n // (8 * NSH)) * (8 * NSH)
    Aj = jformats.tile_ell_from_scipy(
        p.A.tocsr(), np.float32, tile_m=8, nr_pad=pad, nc_pad=pad
    )
    fn, d_s, c_s, s_s, comm_j = jhalo.tile_halo_matvec(Aj, mesh)
    xv = np.zeros((pad, 1), np.float32)
    xv[:n, 0] = np.random.default_rng(0).standard_normal(n)
    x_s = jax.device_put(jnp.asarray(xv),
                         NamedSharding(mesh, P("rows", None)))
    C["tile"] = {
        "yj": np.asarray(fn(d_s, c_s, s_s, x_s))[:n, 0],
        "comm_j": comm_j, "x": xv, "p": p, "n": n,
    }
    At = tformats.tile_ell_from_scipy(
        p.A.tocsr(), np.float32, nr_pad=pad, nc_pad=pad
    )
    add("tile", kind="tile_halo", A=At, x=xv)

    # production interface-halo cycle (test_halo_tile_ell_in_production_cycle)
    prob = fem.unstructured_poisson(100, dim=2, refine=1)
    pc = _jpc(prob, smoother=SmootherType.CHEBYSHEV, mcs=60)
    op_s, A_s = j_shard(pc.op, pc.A_dev, mesh, replicate_below=100)
    b = pc._to_dev(prob.b)
    op_t = _port_op(pc)
    bt = torch.from_numpy(np.array(b))
    op_np = jax.tree_util.tree_map(np.asarray, pc.op)
    vs = _level_vectors(op_np, 1, np.float32)
    C["htile"] = {
        "xj": _steps_jax(op_s, A_s, b, 16),
        "xr": _steps_port(op_t, bt, 16),
        "counts_j": j_counts(op_s),
        "comm_j": [getattr(lev.A, "comm_per_apply", None)
                   for lev in op_s.levels],
        "mv_j": [np.asarray(jformats.matvec(lev.A, jnp.asarray(v)))
                 for lev, v in zip(pc.op.levels, vs)],
    }
    add("htile", kind="pcg", op=op_t, b=np.asarray(b), steps=16,
        tol2=1e-30, shard={"replicate_below": 100})
    add("htile", kind="apply", op=op_t, b=np.asarray(b), matvecs=vs,
        shard={"replicate_below": 100})

    # sub-group placement and the replicated P (test_intermediate_
    # contraction_sub_meshes, test_contraction_level_replicated_P_bound)
    p = fem.poisson_3d(20)
    pc = AMGPreconditioner(
        p.A, coords=p.coords,
        options=AMGOptions(dtype="float64", shards=NSH),
    ).setup()
    kw = {"replicate_below": 4096, "min_local_rows": 128}
    op_s, _ = j_shard(pc.op, pc.A_dev, mesh, **kw)
    rng = np.random.default_rng(0)
    bb = np.zeros((pc.A_dev.nrows_pad, 1))
    bb[: p.n, 0] = rng.standard_normal(p.n)
    op_np = jax.tree_util.tree_map(np.asarray, pc.op)
    vs = _level_vectors(op_np, 2, np.float64)
    C["sub"] = {
        "yj": np.asarray(j_apply(pc.op, jnp.asarray(bb))),
        "yr": t_apply(_port_op(pc), torch.from_numpy(bb)).numpy(),
        "counts_j": j_counts(op_s),
        "mv_j": [np.asarray(jformats.matvec(lev.A, jnp.asarray(v)))
                 for lev, v in zip(pc.op.levels, vs)],
    }
    add("sub", kind="apply", op=_port_op(pc), b=bb, matvecs=vs, shard=kw)

    # block interface halo (test_halo_block_ell_in_production_cycle)
    p = fem.elasticity_3d(11)
    o = AMGOptions(shards=NSH, dtype="float64")
    o.smoother = SmootherOptions(type=SmootherType.CHEBYSHEV)
    pc = AMGPreconditioner(
        p.A, energy="elasticity", block_size=3, coords=p.coords, options=o,
    ).setup()
    op_s, _ = j_shard(pc.op, pc.A_dev, mesh, replicate_below=200)
    npad, bs = pc.A_dev.nrows_pad, pc.setup_levels_[0].row_bs
    bb = np.zeros((npad, bs))
    nb = p.A.shape[0] // bs
    bb[:nb] = np.random.default_rng(0).standard_normal((nb, bs))
    op_np = jax.tree_util.tree_map(np.asarray, pc.op)
    vs = _level_vectors(op_np, 3, np.float64)
    C["hblock"] = {
        "yj": np.asarray(j_apply(pc.op, jnp.asarray(bb))),
        "counts_j": j_counts(op_s),
        "comm_j": [getattr(lev.A, "comm_per_apply", None)
                   for lev in op_s.levels],
        "mv_j": [np.asarray(jformats.matvec(lev.A, jnp.asarray(v)))
                 for lev, v in zip(pc.op.levels, vs)],
    }
    add("hblock", kind="apply", op=_port_op(pc), b=bb, matvecs=vs,
        shard={"replicate_below": 200})

    # a sharded StencilDia level 0 (replicated values; K1 on the gathered
    # x) and lattice transfers, as the port places them
    p = fem.poisson_3d(40)
    pc = _jpc(p, smoother=SmootherType.CHEBYSHEV)
    rng = np.random.default_rng(4)
    bb = np.zeros((pc.A_dev.nrows_pad, 1), np.float32)
    bb[: p.n, 0] = rng.standard_normal(p.n)
    op_np = jax.tree_util.tree_map(np.asarray, pc.op)
    vs = _level_vectors(op_np, 5, np.float32)
    op_s, _ = j_shard(pc.op, pc.A_dev, mesh, replicate_below=100)
    C["stencil"] = {
        "yj": np.asarray(j_apply(pc.op, jnp.asarray(bb))),
        "counts_j": j_counts(op_s),
        "kinds": [type(lev.A).__name__ for lev in op_np.levels],
        "mv_j": [np.asarray(jformats.matvec(lev.A, jnp.asarray(v)))
                 for lev, v in zip(pc.op.levels, vs)],
    }
    add("stencil", kind="apply", op=_port_op(pc), b=bb, matvecs=vs,
        shard={"replicate_below": 100})

    res = spawn_tasks(tasks, NSH, backend="gloo", device="cpu",
                      timeout=600)
    for name, d in C.items():
        for k in [k for k in d if k.startswith("task")]:
            d["res" + k[4:]] = res[d.pop(k)]
    return C


def _check_matvecs(mv_j, mv_t, f64):
    rtol = 1e-12 if f64 else 1e-5
    for yj, yt in zip(mv_j, mv_t):
        assert yt.shape == yj.shape
        err = np.abs(yt - yj).max() / max(np.abs(yj).max(), 1e-300)
        assert err < rtol, err


def test_halo_exchange_dia_spmv(world):
    d = world["dia"]
    assert d["err_j"] < 1e-5 and d["res1"] < 1e-5, (d["err_j"], d["res1"])
    y = d["res0"]["y"][:, 0]
    assert np.abs(y - d["yj"]).max() < 1e-5 * np.abs(d["yj"]).max()
    p = d["p"]
    ref = p.A @ d["x"][: p.n]
    assert np.abs(y[: p.n] - ref).max() < 1e-5 * np.abs(ref).max()


def test_shard_operator_solve(world):
    d = world["steps"]
    xs = d["res0"]["x"]
    assert d["res0"]["counts"] == d["counts_j"]
    assert np.isfinite(xs).all()
    # the JAX test's bound, against the port's replicated steps and the
    # JAX package's sharded ones
    assert _rel(xs, d["xr"]) < 1e-3
    assert _rel(xs, d["xj"]) < 1e-3


def test_sharded_solve_to_tolerance(world):
    d = world["tol"]
    r = d["res0"]
    assert r["counts"] == d["counts_j"]
    assert r["relres"] < 1e-8
    assert r["iterations"] == d["it_r"]
    assert abs(r["iterations"] - d["it_j"]) <= 1, (r["iterations"],
                                                   d["it_j"])
    pc, prob = d["pc"], d["prob"]
    xs = pc._from_dev(jnp.asarray(r["x"]))
    rr = np.linalg.norm(prob.A @ xs - prob.b) / np.linalg.norm(prob.b)
    assert rr < 1e-7, rr


def test_sharded_gs_matches_replicated(world):
    d = world["gs"]
    r = d["res0"]
    assert r["counts"] == d["counts_j"]
    assert r["counts"][0] > 1, "GS level still replicated"
    assert r["levels"][0]["smoother"] == "ShardedGS"
    assert r["collectives"]["gs_rounds"] > 0
    assert _rel(r["x"], d["xr"]) < 1e-4
    assert _rel(r["x"], d["xj"]) < 1e-4


def test_tile_halo_matvec_matches_replicated(world):
    d = world["tile"]
    r = d["res0"]
    n, p = d["n"], d["p"]
    y = r["y"][:n, 0]
    assert r["comm"] == d["comm_j"]
    assert np.abs(y - d["yj"]).max() < 1e-5 * np.abs(d["yj"]).max()
    y_ref = p.A @ d["x"][:n, 0].astype(np.float64)
    assert np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref) < 1e-5
    assert r["comm"] < 0.35 * n, (r["comm"], n)


def test_halo_tile_ell_in_production_cycle(world):
    d = world["htile"]
    r, a = d["res0"], d["res1"]
    assert r["counts"] == d["counts_j"]
    halo = [lev for lev in r["levels"] if lev["A"] == "HaloTileELL"]
    assert halo, "no level went through the interface-halo path"
    lev0 = halo[0]
    assert lev0["nrows"] > 20_000 and (
        lev0["comm_per_apply"] < 0.25 * lev0["nrows"]
    ), lev0
    assert [lev["comm_per_apply"] for lev in r["levels"]] == d["comm_j"]
    _check_matvecs(d["mv_j"], a["matvecs"], f64=False)
    assert _rel(r["x"], d["xr"]) < 1e-3
    assert _rel(r["x"], d["xj"]) < 1e-3


def test_intermediate_contraction_sub_meshes(world):
    d = world["sub"]
    r = d["res0"]
    counts = r["counts"]
    assert counts == d["counts_j"]
    assert counts[0] == 8 and any(1 < c < 8 for c in counts), counts
    _check_matvecs(d["mv_j"], r["matvecs"], f64=True)
    for ref in (d["yj"], d["yr"]):
        err = np.linalg.norm(r["y"] - ref) / np.linalg.norm(ref)
        assert err < 1e-10, err


def test_halo_block_ell_in_production_cycle(world):
    d = world["hblock"]
    r = d["res0"]
    assert r["counts"] == d["counts_j"]
    halo = [lev for lev in r["levels"] if lev["A"] == "HaloBlockELL"]
    assert halo, "no BLOCK level went through the halo path"
    assert [lev["comm_per_apply"] for lev in r["levels"]] == d["comm_j"]
    lev0 = halo[0]
    assert lev0["comm_per_apply"] < 0.7 * lev0["nrows"] * 3
    _check_matvecs(d["mv_j"], r["matvecs"], f64=True)
    err = np.linalg.norm(r["y"] - d["yj"]) / np.linalg.norm(d["yj"])
    assert err < 1e-10, err


def test_contraction_level_replicated_P_bound(world):
    r = world["sub"]["res0"]
    repl_P_bytes = 0
    for lev, c in zip(r["levels"], r["counts"]):
        if not (1 < c < 8) or lev["P"] is None:
            continue
        # the P of a partially-replicated level is the whole P
        assert lev["P_local_rows"] is False, lev
        repl_P_bytes += lev["P_bytes"]
    assert 0 < repl_P_bytes < 8 * 1024 * 1024, repl_P_bytes


def test_sharded_stencil_level_and_lattice_transfers(world):
    """A lattice hierarchy: the row-sharded StencilDia level 0 (each rank
    applies the stencil to the gathered x and keeps its rows), the DIA
    levels' windows and the lattice transfers between placements, held to
    the JAX package's replicated matvecs and cycle on the same vectors."""
    d = world["stencil"]
    r = d["res0"]
    assert d["kinds"][0] == "StencilDia"
    assert r["counts"] == d["counts_j"]
    assert r["levels"][0]["A"] == "StencilDia" and r["levels"][0]["j"] == NSH
    assert r["levels"][0]["P"] == "ShardedLatticeProlongation"
    _check_matvecs(d["mv_j"], r["matvecs"], f64=False)
    err = np.linalg.norm(r["y"] - d["yj"]) / np.linalg.norm(d["yj"])
    assert err < 1e-5, err


@pytest.mark.parametrize("r0, r1", [(0, 16), (16, 48), (48, 64)])
def test_sym_half_rows_expand_mirrored_diagonals(r0, r1):
    """A row block of a symmetric-half DIA level: placed as a full-storage
    window whose minus diagonals are the mirrored data[o][i - o] of the
    rows left of the block; its K2 windowed product equals those rows of
    the JAX package's symmetric-half matvec and of the exact product."""
    from ngsamg_tpu_torch.parallel.shard import _dia_rows

    n, offs = 64, (0, 1, 9)
    rng = np.random.default_rng(7)
    data = rng.standard_normal((len(offs), n))
    for d, o in enumerate(offs):
        data[d, n - o:] = 0.0  # A[i, i + o] only inside the matrix
    At = tformats.DiaMatrix(data=torch.from_numpy(data), offsets=offs,
                            nrows=n, nrows_pad=n, sym_half=True)
    x = rng.standard_normal((n, 1))
    with jax.enable_x64(True):  # f64 whatever ran before in this process
        Aj = jformats.DiaMatrix(data=jnp.asarray(data), offsets=offs,
                                nrows=n, nrows_pad=n, use_pallas=False,
                                sym_half=True)
        yj = np.asarray(jformats.matvec(Aj, jnp.asarray(x)))[r0:r1]
    W = _dia_rows(At, r0, r1, "cpu")
    assert W.offsets == (-9, -1, 0, 1, 9) and W.x_base == r0
    y = tformats.matvec(W, torch.from_numpy(x)).numpy()
    dense = np.zeros((n, n))
    for d, o in enumerate(offs):
        for i in range(n - o):
            dense[i, i + o] = dense[i + o, i] = data[d, i]
    np.testing.assert_allclose(y, (dense @ x)[r0:r1], rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(y, yj, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("r0, r1", [(0, 24), (24, 40), (40, 64), (0, 64)])
def test_full_dia_rows_as_windows(dtype, r0, r1):
    """A row block of a full-storage DIA level is a window of the one K2
    entry (x read from ``x_base``, zero outside [0, x_len)); a whole level
    is the window (n_pad, n_pad, 0). Both equal those rows of the JAX
    package's DIA matvec (rtol 1e-5 in f32, 1e-12 in f64)."""
    from ngsamg_tpu_torch.parallel.shard import _dia_rows

    n, offs = 64, (-13, -1, 0, 2, 13)
    rng = np.random.default_rng(11)
    data = rng.standard_normal((len(offs), n)).astype(dtype)
    x = rng.standard_normal((n, 1)).astype(dtype)
    At = tformats.DiaMatrix(data=torch.from_numpy(data), offsets=offs,
                            nrows=n, nrows_pad=n)
    with jax.enable_x64(True):
        Aj = jformats.DiaMatrix(data=jnp.asarray(data), offsets=offs,
                                nrows=n, nrows_pad=n, use_pallas=False)
        yj = np.asarray(jformats.matvec(Aj, jnp.asarray(x)))
    W = _dia_rows(At, r0, r1, "cpu")
    assert (W.nrows, W.x_len, W.x_base) == (r1 - r0, n, r0)
    y = tformats.matvec(W, torch.from_numpy(x)).numpy()
    yw = tformats.matvec(At, torch.from_numpy(x)).numpy()
    tol = 1e-5 if dtype == "float32" else 1e-12
    np.testing.assert_allclose(y, yj[r0:r1], rtol=tol, atol=tol)
    np.testing.assert_allclose(yw, yj, rtol=tol, atol=tol)
    np.testing.assert_array_equal(y, yw[r0:r1])
