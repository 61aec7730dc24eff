"""``correct`` at a size a test run holds: the program's answers pass, the
control (its float32 path without the float64 correction) fails, and so
does a run whose timed path is broken underneath.

The harness's look for a card is skipped (``device="cpu"``); the rest of
a run is driven as on the card.
"""

import json

import numpy as np
import pytest

from benchmark import control, run
from ngsamg_tpu_torch.precond.amg import AMGPreconditioner

CELLS = ["lattice_tiny.solve", "elasticity_tiny.solve"]
SEED = 2**31 + 11


def _run(tree, cell, control=False, trace=False, seconds=0.3):
    return run.run_cell(tree, cell, SEED, seconds, trace, device="cpu",
                        control=control)


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails(tiny_tree, cell):
    ok = _run(tiny_tree, cell)
    assert ok["correct"] and ok["failed"] == 0
    assert ok["checks"]["relres_max"]["value"] <= 1e-8
    ctl = _run(tiny_tree, cell, control=True)
    assert not ctl["correct"]
    assert ctl["failed"] == ctl["checks"]["answers_checked"]["value"] > 0
    assert ctl["checks"]["relres_max"]["value"] > 3e-8
    assert list(ok)[-1] == "checks"


def _unchanged(solve):
    """A solve that hands back its starting state, x = 0."""
    def wrapped(self, b, **kw):
        x, info = solve(self, b, **kw)
        return x * 0, info
    return wrapped


def _altered(solve):
    """One entry of each answer changed where the answer is made."""
    def wrapped(self, b, **kw):
        x, info = solve(self, b, **kw)
        x = x.clone() if hasattr(x, "clone") else x.copy()
        x[len(x) // 2] += 1e-3 * float(abs(x).max())
        return x, info
    return wrapped


def _half_left_out(solve):
    """Every other right-hand side is not solved: the previous answer comes
    back in its place."""
    state = {"n": 0, "last": None}

    def wrapped(self, b, **kw):
        state["n"] += 1
        if state["n"] % 2 == 0 and state["last"] is not None:
            return state["last"]
        state["last"] = solve(self, b, **kw)
        return state["last"]
    return wrapped


@pytest.mark.parametrize("fault", [_unchanged, _altered, _half_left_out])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny_tree, cell, fault,
                                            monkeypatch):
    monkeypatch.setattr(AMGPreconditioner, "solve",
                        fault(AMGPreconditioner.solve))
    # a window of several solves, so that a stale answer meets another
    # right-hand side than its own
    res = _run(tiny_tree, cell, seconds=2.5)
    assert res["attempted"] >= 3
    assert not res["correct"] and res["failed"] > 0


def _memoised(solve, hits):
    """A solve that answers a right-hand side it has seen before from its
    memory: it gains only where the traffic repeats one."""
    memo = {}

    def wrapped(self, b, **kw):
        key = np.asarray(b).tobytes()
        if key in memo:
            hits.append(key)
            return memo[key]
        memo[key] = solve(self, b, **kw)
        return memo[key]
    return wrapped


def test_no_right_hand_side_comes_back(tiny_tree, monkeypatch):
    hits = []
    monkeypatch.setattr(AMGPreconditioner, "solve",
                        _memoised(AMGPreconditioner.solve, hits))
    res = _run(tiny_tree, "lattice_tiny.solve", seconds=2.5)
    assert res["attempted"] >= 3 and res["correct"]
    assert hits == []


def test_control_readings_go_through_the_runs_check(tiny_tree):
    cell = run.set_up(tiny_tree, "lattice_tiny.solve", "cpu")
    recs = (control.readings(cell, [SEED], False, 0.3)
            + control.readings(cell, [SEED + 1], True, 0.3))
    ok, ctl = recs
    assert ok["correct"] and ok["relres_max"] <= 1e-8
    assert not ctl["correct"] and ctl["relres_min"] > 3e-8
    assert ok["checked"] >= 1 and ctl["checked"] >= 1


def test_traced_run_reads_per_layer_metrics(tiny_tree):
    res = _run(tiny_tree, "lattice_tiny.solve", trace=True)
    assert res["correct"]
    m = res["metrics"]
    # on the CPU the device readers find nothing to read and stay out
    assert {"setup_host_s", "staging_s", "pcg_iterations",
            "solves_seen"} <= set(m)
    assert "l0_matvec_roofline" not in m and "solve_ms" not in m
    assert m["solves_seen"]["value"] == res["attempted"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(res)


def test_main_refuses_without_a_card(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "poisson3d_216.solve", "--seed", str(SEED),
                   "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


def test_no_result_when_a_forbidden_module_loaded(monkeypatch):
    import sys
    import types

    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client",
                        types.ModuleType("jaxlib.xla_client"))
    assert run.forbidden_modules() == ["jaxlib"]
    monkeypatch.setitem(sys.modules, "jax_like", types.ModuleType("x"))
    assert run.forbidden_modules() == ["jaxlib"]
