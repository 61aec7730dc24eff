"""The traffic generator and the trace reduction."""

import json

import numpy as np
import pytest

from benchmark import devtrace, drive
from benchmark.tests.conftest import BENCH


def test_each_solve_draws_its_own_right_hand_side():
    a = drive.Rhs(50, 2**31 + 5, "cpu", "pinned")
    b = drive.Rhs(50, 2**31 + 5, "cpu", "pinned")
    c = drive.Rhs(50, 2**31 + 6, "cpu", "pageable")
    a0 = a.draw(0).copy()
    assert a0.dtype == np.float64 and a0.shape == (50,)
    assert np.array_equal(a0, b.draw(0))
    assert not np.array_equal(a0, c.draw(0))
    a1 = a.draw(1).copy()
    assert not np.array_equal(a0, a1)
    # drawn again, the same vector: the check reads what the solve got
    assert np.array_equal(a.draw(0), a0)
    assert drive.stream_seed(2**64 + 3, 0) == drive.stream_seed(3, 0)
    assert 0 <= drive.stream_seed(2**40, 7) < 2**63


def test_closed_loop_keeps_a_sample_of_fixed_size():
    seen = []

    def solve(b):
        seen.append(b.copy())
        return b * 2.0, {"k": len(seen)}

    rhs = drive.Rhs(4, 7, "cpu", "pinned")
    w = drive.closed_loop(solve, rhs, 3, 0.05, "cpu", 5,
                          np.random.default_rng([7, 1]))
    n = len(w.latencies)
    assert n == len(seen) == len(w.infos) and n > 5
    # no right-hand side comes back within a run
    assert len({b.tobytes() for b in seen}) == n
    assert len(w.kept) == 5
    ks = [k for k, _ in w.kept]
    assert len(set(ks)) == 5 and 3 <= min(ks) and max(ks) < n + 3
    for k, x in w.kept:
        assert np.array_equal(x, seen[k - 3] * 2.0)
        assert np.array_equal(x, rhs.draw(k) * 2.0)
    assert w.wall_s >= 0.05
    assert w.solve_s == pytest.approx(sum(w.latencies) / n)
    assert w.solve_s <= w.wall_s


def test_kept_answers_leave_the_device():
    import torch

    x = drive.to_host(torch.arange(3.0))
    assert isinstance(x, np.ndarray) and x.tolist() == [0.0, 1.0, 2.0]


def test_mixes_are_checked():
    mix = json.loads((BENCH / "traffic" / "solve.json").read_text())
    drive.check_mix(mix)
    with pytest.raises(ValueError):
        drive.check_mix({**mix, "clients": 2})
    with pytest.raises(ValueError):
        drive.check_mix({**mix, "extra": 1})
    with pytest.raises(ValueError):
        drive.check_mix({**mix, "rhs_memory": "shared"})


def test_trace_reduction():
    S = devtrace.SPAN
    ev = [
        (S, False, 0.0, 100.0),
        (S, True, 0.0, 100.0),  # the span's mirror on the device timeline
        ("k1", True, 10.0, 30.0),
        ("k2", True, 20.0, 40.0),
        ("Memcpy HtoD", True, 60.0, 70.0),
        ("aten::item", False, 40.0, 60.0),
        ("cudaLaunchKernel", False, 5.0, 9.0),
    ]
    tr = devtrace.reduce(ev)
    assert tr.solves == 1 and tr.launches == 2 and tr.device_events == 3
    assert tr.busy_s == pytest.approx(40e-6)
    assert tr.span_s == pytest.approx(100e-6)
    assert tr.device_ops[0] == ["k1", pytest.approx(20e-6)]
    gaps = dict(tr.idle_gaps)
    assert gaps["aten::item"] == pytest.approx(20e-6)
    assert gaps["cudaLaunchKernel"] == pytest.approx(10e-6)
    assert gaps[devtrace.PYTHON] == pytest.approx(30e-6)


def test_only_what_lies_inside_the_solves_counts():
    S = devtrace.SPAN
    ev = [
        (S, False, 0.0, 100.0),
        (S, False, 200.0, 260.0),
        ("k1", True, 10.0, 30.0),
        ("k1", True, 210.0, 250.0),
        # the harness's draw and copy between the two solves
        ("randn", True, 120.0, 150.0),
        ("Memcpy DtoH", True, 150.0, 190.0),
        ("aten::randn", False, 110.0, 160.0),
    ]
    tr = devtrace.reduce(ev)
    assert tr.solves == 2 and tr.launches == 2 and tr.device_events == 2
    assert tr.span_s == pytest.approx(160e-6)
    assert tr.busy_s == pytest.approx(60e-6)
    assert tr.device_ops == [["k1", pytest.approx(60e-6)]]
    assert "aten::randn" not in dict(tr.idle_gaps)
    assert sum(v for _, v in tr.idle_gaps) == pytest.approx(100e-6)

