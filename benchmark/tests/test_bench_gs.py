"""The multicolour Gauss-Seidel configuration ``poisson3d_101_gs``: its file,
the work count of its sweep (``benchmark/gs_work.py``), its two readers on
a tiny GS cell on the CPU, and, on a card, the program's staged level-0
sweeps at full size against the plain ``blocked_sweep``."""

import dataclasses
import json
import shutil
import types

import pytest
import scipy.sparse as sp
import torch

from benchmark import gs_work, roofline, run, spec
from benchmark.problems import lattice_poisson
from benchmark.reference import gs_sweep
from benchmark.tests.conftest import DATA, ROOT, make_tree

SEED = 2**31 + 101
# a float32 sweep over at most 27 terms a row rounds to about 1e-6; a
# bfloat16 one to about 4e-3
SWEEP_TOL = 2e-5


def test_config_parses_and_the_benchmark_validates():
    cfg = spec.config(ROOT, "poisson3d_101_gs")
    n = cfg["problem"]["params"]["n"]
    assert cfg["problem"]["generator"] == "lattice_poisson"
    assert cfg["dofs"] == (n - 1) ** 3 == 1_000_000
    assert cfg["setup"] == {"energy": "h1", "block_size": 1, "coords": True,
                            "flags": {"sm_type": "gs"}}
    assert cfg["solve"] == {"tol": 1e-8}
    assert cfg["control"] == {"use_refinement": False}
    assert cfg["reduced"] == []
    bench = spec.load(ROOT)
    assert spec.validate(bench, ROOT) == []
    cell = spec.workload(bench, "poisson3d_101_gs.solve")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "poisson3d_101_gs", "solve", 1)
    for m in bench["per_layer"]:
        assert spec.applies(m, "poisson3d_101_gs.solve"), m["name"]


def test_gs_work_counts_a_small_lattice_level():
    # n = 5: 4^3 rows; the Kuhn stencil stores 15 diagonals, 7 of them
    # nonzero taps, on a uniform diagonal
    m = 4
    A, _ = lattice_poisson.generate(m + 1)
    rows = m**3
    nnz = rows + 3 * 2 * (m - 1) * m * m
    assert A.nnz > nnz  # the DIA's stored zeros are not counted
    ops, nbytes = gs_work.sweep_work(A)
    assert ops == 2 * nnz + 2 * rows
    # 7 taps and one inverse diagonal; b read, x read and written
    assert nbytes == 4 * 7 + 4 + 4 * rows + 8 * rows
    # roofline.py's matvec count of the same stencil, and b and Dinv more
    m_ops, m_bytes = roofline.lattice_matvec_work(A)
    assert (ops, nbytes) == (m_ops + 2 * rows, m_bytes + 4 * rows + 4)
    # a diagonal that is not uniform: one inverse diagonal a row
    A2 = A.copy()
    A2.data[list(A2.offsets).index(0), 0] *= 2.0
    assert gs_work.sweep_work(A2) == (ops, nbytes - 4 + 4 * rows)
    # the same operator as CSR has no stencil: every nonzero is read
    assert gs_work.sweep_work(A.tocsr()) == (
        ops, 8 * nnz + 4 * (rows + 1) + 4 * rows + 8 * rows + 4 * rows)


def test_gs_work_leaves_out_an_explicit_zero():
    rows, cols = [0, 0, 1, 1, 2, 2], [0, 2, 1, 0, 2, 1]
    A = sp.csr_matrix(([4.0, -1.0, 4.0, 0.0, 4.0, 0.0], (rows, cols)),
                      shape=(3, 3))
    assert A.nnz == 6
    assert gs_work.sweep_work(A) == (2 * 4 + 2 * 3,
                                     8 * 4 + 4 * 4 + 16 * 3)


def test_gs_work_refuses_a_rectangle():
    with pytest.raises(ValueError):
        gs_work.sweep_work(sp.random(4, 5, density=0.5, format="csr"))


@pytest.fixture(scope="module")
def gs_tree(tmp_path_factory):
    """The tiny tree of ``conftest.make_tree`` with a tiny GS cell."""
    tree = make_tree(tmp_path_factory.mktemp("gs_tree"))
    shutil.copy(DATA / "gs_tiny.json", tree / "benchmark" / "configs")
    bench = spec.load(tree)
    bench["configs"].append(
        {"name": "gs_tiny", "source": "test-only",
         "file": "benchmark/configs/gs_tiny.json", "reduced": [],
         "why": "a CPU test's size"})
    bench["workloads"].append(
        {"name": "gs_tiny.solve", "config": "gs_tiny",
         "traffic": "solve_tiny", "chips": 1, "why": "a CPU test's size"})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tree


def test_gs_readers_on_a_tiny_gs_cell(gs_tree):
    assert spec.validate(spec.load(gs_tree), gs_tree) == []
    res = run.run_cell(gs_tree, "gs_tiny.solve", SEED, 0.3, True,
                       device="cpu")
    assert res["correct"]
    steps = res["metrics"]["gs_colour_steps_per_solve"]
    assert steps["unit"] == "steps/solve" and steps["value"] > 0
    # the roofline is read on a card only
    assert "gs_sweep_roofline" not in res["metrics"]


def test_colour_steps_reader_is_the_windows_mean(gs_tree):
    read = spec.reader(gs_tree, "gs_colour_steps_per_solve")
    infos = [types.SimpleNamespace(colour_steps=v) for v in (40, 60, 80)]
    assert read(types.SimpleNamespace(
        window=types.SimpleNamespace(infos=infos))) == 60.0
    # a program whose SolveInfo has no such counter
    old = [types.SimpleNamespace(iterations=3)]
    assert read(types.SimpleNamespace(
        window=types.SimpleNamespace(infos=old))) is None


def test_sweep_device_time_is_the_kernels_around_each_record(gs_tree):
    """A record's device time is the union of the device events within
    ``margin_us`` of it, which takes in kernels that the profiler's clock
    offset puts just outside and leaves out the L2 sweep before it."""
    read = spec.reader(gs_tree, "gs_sweep_roofline")
    rec = read.__globals__["RECORD"]
    events = [
        ("fill", True, -20.0, -8.0),  # the L2 sweep, idle after it
        (rec, False, 0.0, 10.0), (rec, True, 1.0, 9.0),  # its mirror
        ("k", True, -2.0, 4.0), ("k", True, 3.0, 5.0),  # overlap once
        ("Memcpy DtoD", True, 6.0, 7.0),
        ("k", True, 11.0, 12.0),  # past the end by less than the margin
        ("fill", True, 17.0, 19.0),
        (rec, False, 30.0, 37.0), ("aten::add", False, 31.0, 32.0),
        ("k", True, 35.0, 36.0), ("k", True, 36.5, 42.0),  # cut at 40
    ]
    got = read.__globals__["sweep_device_s"](events, margin_us=3.0)
    assert got == pytest.approx([9e-6, 4.5e-6])


def test_gs_readers_on_a_chebyshev_cell(gs_tree):
    res = run.run_cell(gs_tree, "lattice_tiny.solve", SEED, 0.2, True,
                       device="cpu")
    assert res["correct"]
    assert res["metrics"]["gs_colour_steps_per_solve"]["value"] == 0.0
    assert "gs_sweep_roofline" not in res["metrics"]


@pytest.mark.cuda
def test_staged_level0_sweeps_match_the_reference_on_the_card():
    """Full size: ``poisson3d_101_gs``'s staged float32 level-0 forward and
    backward sweeps against ``blocked_sweep`` in float64 on the same
    permuted, scaled level-0 matrix, ``x`` and ``b``; a bfloat16 copy of
    the smoother fails the same limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from ngsamg_tpu_torch.smoothers.core import smooth, smooth_back
    from ngsamg_tpu_torch.sparse import bell

    c = run.set_up(ROOT, "poisson3d_101_gs.solve", "cuda")
    lev = c.pc.op.levels[0]
    sm, A = lev.smoother, lev.A
    n = A.nrows
    assert n == c.A.shape[0]
    ref_A = gs_sweep.Csr(bell.to_scipy(A), "cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.zeros((A.nrows_pad, 1), device="cuda")
    b = torch.zeros_like(x)
    x[:n, 0] = torch.randn(n, device="cuda", generator=g)
    b[:n, 0] = torch.randn(n, device="cuda", generator=g)
    x64, b64 = x[:n, 0].double(), b[:n, 0].double()
    out = {"rows": n, "colours": len(sm.color_bounds) - 1}
    for name, fn, reverse in (("forward", smooth, False),
                              ("backward", smooth_back, True)):
        ref = gs_sweep.blocked_sweep(ref_A, sm.color_bounds, x64, b64,
                                     reverse)
        y = fn(sm, A, x, b)[:n, 0].double()
        out[name] = float((y - ref).abs().max() / ref.abs().max())
        low = dataclasses.replace(
            sm, Dinv=sm.Dinv.bfloat16(),
            cdata=tuple(t.bfloat16() for t in sm.cdata),
            cdinv=tuple(t.bfloat16() for t in sm.cdinv))
        y16 = fn(low, A, x.bfloat16(), b.bfloat16())[:n, 0].double()
        out[name + "_bf16"] = float((y16 - ref).abs().max()
                                    / ref.abs().max())
    print("[gs-sweep] " + json.dumps(out), flush=True)
    assert out["forward"] <= SWEEP_TOL and out["backward"] <= SWEEP_TOL
    assert out["forward_bf16"] > SWEEP_TOL
    assert out["backward_bf16"] > SWEEP_TOL
