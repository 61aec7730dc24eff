"""The port's recorder of spans and counters (`utils/timers.py`).

A solve with tracing on records a tree of spans under one solve id; the
set-up's phases are recorded always and lie inside ``setup_time_host``;
spans sit on the torch profiler's clock through the recorder's anchor and
join its Chrome trace on a host track; tracing off records no solve-side
span and leaves the answers bit for bit as they were; every blocking read
of a solve is counted, and so are the multicolour GS sweeps' colour
steps (``SolveInfo.colour_steps``), each sweep a ``gs.sweep`` span inside
its ``cycle.level`` with tracing on. CPU only: the card's trace (K1 beside
the ``cycle.level`` spans) is checked by ``chip_smoke.py`` ``[timers]``.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

import ngsamg_tpu_torch
import ngsamg_tpu_torch.utils.timers as timers
from ngsamg_tpu_torch.config import options_from_flags
from ngsamg_tpu_torch.solve import pcg as tpcg
from ngsamg_tpu_torch.utils import fem as tfem
from ngsamg_tpu_torch.utils.trace_solve import NO_SPAN, _span_key, idle_by_span

torch.set_num_threads(2)

CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]
PHASES = ("setup.mesh", "setup.coarsen", "setup.prol", "setup.rap")
SOLVE_SPANS = {"solve", "solve.pass", "pcg.iter", "cycle.level",
               "cycle.coarse", "gs.sweep", "sync"}


def _cheb():
    return ngsamg_tpu_torch.AMGOptions(
        smoother=ngsamg_tpu_torch.SmootherOptions(
            type=ngsamg_tpu_torch.SmootherType.CHEBYSHEV
        )
    )


# the three residual paths of ``solve``: the host refinement loop (the GS
# block-ELL finest level of a small lattice), the device one (the f64
# stencil of a compressed lattice) and the mixed PCG (elasticity)
CASES = {
    "host": (lambda: tfem.poisson_3d(12), dict(options=None), {}),
    "device": (lambda: tfem.poisson_3d(40), dict(options="cheb"), {}),
    "mixed": (lambda: tfem.elasticity_3d(6),
              dict(options="cheb", energy="elasticity", block_size=3),
              dict(mixed=True)),
}


@pytest.fixture(scope="module")
def setups():
    out = {}
    for name, (make, kw, solve_kw) in CASES.items():
        p = make()
        kw = dict(kw)
        kw["options"] = _cheb() if kw["options"] == "cheb" else None
        pc = ngsamg_tpu_torch.AMGPreconditioner(
            p.A, coords=p.coords, device="cpu", **kw
        ).setup()
        out[name] = (p, pc, solve_kw)
    return out


def _solve_spans(pc, n0):
    return [s for s in pc.trace_.spans[n0:]]


def test_solve_span_tree(setups):
    p, pc, _ = setups["host"]
    rec = pc.trace_
    n0 = len(rec.spans)
    with timers.tracing(True):
        _x, info = pc.solve(p.b, tol=1e-8)
    spans = _solve_spans(pc, n0)
    assert {s.name for s in spans} == SOLVE_SPANS
    assert all(s.end >= s.start > 0 for s in spans)
    root = spans[0]
    assert root.name == "solve" and root.parent == 0
    assert [s for s in spans if s.name == "solve"] == [root]
    # one solve id, new to this solve
    assert {s.solve for s in spans} == {root.solve} and root.solve > 0
    assert all(s.solve == 0 for s in rec.spans[:n0] if s.name != "solve")
    by_id = {s.id: s for s in rec.spans}
    for s in spans[1:]:
        par = by_id[s.parent]
        assert par.solve == root.solve
        assert par.start <= s.start and s.end <= par.end
    assert len([s for s in spans if s.name == "pcg.iter"]) == info.iterations
    assert len([s for s in spans if s.name == "solve.pass"]) == \
        info.outer_iterations
    # self times: none negative, and over the solve they add up to the
    # root's duration
    own = rec.self_ns()
    assert all(own[s.id] >= 0 for s in spans)
    assert sum(own[s.id] for s in spans) == root.ns
    for s in spans:
        kids = [k for k in spans if k.parent == s.id]
        assert own[s.id] + sum(k.ns for k in kids) == s.ns
    assert {s.attrs["level"] for s in spans if s.name == "cycle.level"} == \
        set(range(pc.num_levels - 1))


@pytest.mark.parametrize("case", ["stencil", "generic", "elasticity"])
def test_setup_phases(case):
    """With tracing off (the default): one ``setup.level`` a level, phases
    inside their level and disjoint, their sum within the host setup."""
    assert not timers.ON
    if case == "elasticity":
        p = tfem.elasticity_3d(5)
        kw = dict(energy="elasticity", block_size=3, options=_cheb())
    else:
        p = tfem.poisson_3d(40 if case == "stencil" else 16)
        kw = dict(options=_cheb() if case == "stencil" else None)
    pc = ngsamg_tpu_torch.AMGPreconditioner(
        p.A, coords=p.coords, device="cpu", **kw
    ).setup()
    rec = pc.trace_
    (host,) = rec.named("setup.host")
    (staging,) = rec.named("setup.staging")
    assert pc.setup_time_host == host.seconds
    assert pc.setup_time_device == staging.seconds
    levels = rec.named("setup.level")
    assert [s.attrs["level"] for s in levels] == list(range(pc.num_levels))
    assert all(s.parent == host.id for s in levels)
    lev_ids = {s.id for s in levels}
    phases = sorted((s for s in rec.spans if s.name in PHASES),
                    key=lambda s: s.start)
    assert all(s.parent in lev_ids for s in phases)
    assert {s.name for s in phases} >= {"setup.mesh", "setup.prol",
                                        "setup.rap"}
    # the stencil path's coarse map is implicit (index blocking)
    first = {s.name for s in phases if s.parent == levels[0].id}
    assert ("setup.coarsen" in first) == (case != "stencil")
    for a, b in zip(phases, phases[1:]):
        assert a.end <= b.start
    total = sum(s.ns for s in phases)
    assert 0 < total <= host.ns
    # phases have no children: their self time is their duration
    own = rec.self_ns()
    assert all(own[s.id] == s.ns for s in phases)


def test_staging_stage_times_are_span_sums(setups):
    _p, pc, _ = setups["mixed"]
    rec = pc.trace_
    stages = pc._device_stage_times
    assert list(stages) == ["row_order", "permute", "pack_A", "smoothers",
                            "pack_PR", "coarse_inv", "cluster_corr",
                            "device_put"]
    for name, sec in stages.items():
        assert sec == rec.seconds("staging." + name)
    (staging,) = rec.named("setup.staging")
    assert sum(stages.values()) <= staging.seconds
    assert len(rec.named("staging.permute")) == pc.num_levels


def test_span_clock_matches_the_profiler():
    """A span around a profiled CPU op, placed through the recorder's
    anchor, encloses the op's interval in the profiler's own results; the
    ``perf_counter_ns`` readings just before and after the op, placed the
    same way, bound it to within the clocks' disagreement (50 us)."""
    from torch.profiler import profile

    rec = timers.Recorder()
    a = torch.randn(300, 300)
    with timers.recording(rec), profile(activities=CPU_ONLY) as prof:
        with timers.span("around"):
            time.sleep(2e-3)
            t_a = time.perf_counter_ns()
            _b = a @ a
            t_b = time.perf_counter_ns()
            time.sleep(2e-3)
    (sp,) = rec.named("around")
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mm"]
    assert len(ops) == 1
    op_lo = ops[0].start_ns()
    op_hi = op_lo + ops[0].duration_ns()
    assert rec.epoch_ns(sp.start) < op_lo <= op_hi < rec.epoch_ns(sp.end)
    tol = 50_000
    assert rec.epoch_ns(t_a) - tol <= op_lo
    assert op_hi <= rec.epoch_ns(t_b) + tol


@pytest.mark.parametrize("case", sorted(CASES))
def test_tracing_off_records_no_solve_span_and_answers_alike(setups, case):
    p, pc, kw = setups[case]
    rec = pc.trace_
    n0 = len(rec.spans)
    x_off, info_off = pc.solve(p.b, tol=1e-8, **kw)
    assert len(rec.spans) == n0
    with timers.tracing(True):
        x_on, info_on = pc.solve(p.b, tol=1e-8, **kw)
    assert not timers.ON
    spans = _solve_spans(pc, n0)
    assert spans and {s.name for s in spans} <= SOLVE_SPANS
    np.testing.assert_array_equal(np.asarray(x_on), np.asarray(x_off))
    assert info_on.iterations == info_off.iterations
    assert info_on.history == info_off.history
    assert info_on.host_syncs == info_off.host_syncs
    n1 = len(rec.spans)
    pc.solve(p.b, tol=1e-8, **kw)
    assert len(rec.spans) == n1


def _expected_syncs(case, info, pc, return_device):
    it, outer = info.iterations, info.outer_iterations
    # a PCG call reads bnorm, an iteration's residual and, through its
    # caller, the count; its threshold is rounded on the host, not read
    if case == "host":
        # each pass: b in, bnorm, an iteration's residual, x out, the
        # iteration count
        return it + 4 * (outer - 1)
    if case == "device":
        # b in; a pass's residual norm, then bnorm, the iterations'
        # residuals and the count; the last check and the final
        # residual; x out unless it stays on the device
        return it + 3 * outer + (not return_device)
    # b in, the scale's inverse in, each pass's bnorm, iterations and
    # count, each restart's check, x out
    return it + 3 * outer + 2 + (pc._scale0 is not None)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64,
                                torch.bfloat16], ids=str)
def test_threshold_is_rounded_on_the_host(dt):
    """A PCG call's threshold tol^2 ||b||^2 is rounded in its dtype on the
    host to the device tensor's bits, so the loop need not read it back."""
    rng = np.random.default_rng(7)
    cases = [(1e-8, 1.0), (1e-8, 0.1 + 0.2), (0.5e-8 / 3e-3, 12.345),
             (1e-6, 1e-30), (0.3, 7.1e12)]
    cases += [(float(t), float(b)) for t, b in zip(
        10.0 ** rng.uniform(-9, 0, 200), 10.0 ** rng.uniform(-20, 20, 200))]
    for tol, bnorm2 in cases:
        want = float(torch.tensor(tol * tol * bnorm2, dtype=dt))
        dev, host = tpcg._threshold(tol, bnorm2, dt, "cpu")
        assert host.hex() == want.hex(), (tol, bnorm2)
        assert dev.dtype == dt and float(dev).hex() == want.hex()


@pytest.mark.parametrize("case,return_device", [
    ("host", False), ("device", False), ("device", True), ("mixed", False),
])
def test_host_syncs_follow_iterations_and_passes(setups, case,
                                                 return_device):
    p, pc, kw = setups[case]
    rec = pc.trace_
    n0 = len(rec.spans)
    with timers.tracing(True):
        x, info = pc.solve(p.b, tol=1e-8, return_device=return_device, **kw)
    assert info.converged
    assert isinstance(x, torch.Tensor) == (return_device and case == "device")
    assert info.host_syncs == _expected_syncs(case, info, pc, return_device)
    syncs = [s for s in _solve_spans(pc, n0) if s.name == "sync"]
    assert len(syncs) == info.host_syncs
    assert info.sync_wait_s == pytest.approx(
        sum(s.ns for s in syncs) / 1e9, abs=1e-12)
    (root,) = [s for s in _solve_spans(pc, n0) if s.name == "solve"]
    # the host time is taken inside the root span
    assert 0 < info.dispatch_s
    assert 0.9 * root.seconds < info.dispatch_s + info.sync_wait_s \
        <= root.seconds


def test_export_chrome_merges_into_the_profile(setups, tmp_path):
    """The spans join the profile's own Chrome trace on a host track of
    their own, on its clock: every other event is the profile's, none is
    added on a device, and the root span covers the solve's operators."""
    from torch.profiler import profile

    p, pc, _ = setups["host"]
    rec = pc.trace_
    with timers.tracing(True), profile(activities=CPU_ONLY) as prof:
        pc.solve(p.b, tol=1e-8)
    n_ops = len(prof.profiler.kineto_results.events())
    path = rec.export_chrome(str(tmp_path / "merged.json"), prof)
    assert os.listdir(tmp_path) == ["merged.json"]
    with open(path) as fh:
        merged = json.load(fh)
    assert merged["baseTimeNanoseconds"] > 0
    ours = [e for e in merged["traceEvents"]
            if e.get("tid") == timers._SPAN_TID]
    theirs = [e for e in merged["traceEvents"]
              if e.get("tid") != timers._SPAN_TID]
    # the profile's own operator events, each once
    assert len([e for e in theirs if e.get("cat") == "cpu_op"]) == n_ops
    spans = [e for e in ours if e["ph"] == "X"]
    assert len(spans) == sum(1 for s in rec.spans if s.end)
    assert {e["pid"] for e in ours} == {os.getpid()}
    assert {e["cat"] for e in spans} == {timers._SPAN_CAT}
    (root,) = [e for e in spans if e["name"] == "solve"
               and e["args"]["solve"] == rec.solves]
    ops = [e for e in theirs if e.get("cat") == "cpu_op"
           and e["name"] in ("aten::add", "aten::mul")]
    assert ops
    for e in ops:
        assert root["ts"] <= e["ts"] and \
            e["ts"] + e["dur"] <= root["ts"] + root["dur"]
    # without a profile: the spans alone
    alone = rec.export_chrome(str(tmp_path / "alone.json"))
    with open(alone) as fh:
        doc = json.load(fh)
    assert len([e for e in doc["traceEvents"] if e["ph"] == "X"]) == \
        len(spans)


def test_recorder_bound_and_closing():
    rec = timers.Recorder(max_spans=3)
    with timers.recording(rec):
        outer = timers.span("a")
        inner = timers.span("b", level=1)
        outer.close()  # closes the open child too
        assert inner.end == outer.end > 0
        outer.close()  # a closed span stays as it was
        assert outer.end == inner.end
        with timers.span("c"):
            assert timers.span("d") is timers.NULL
            assert timers.span("e") is timers.NULL
    assert [s.name for s in rec.spans] == ["a", "b", "c"]
    assert rec.dropped == 2
    assert rec.spans[1].parent == rec.spans[0].id
    assert rec.spans[2].parent == 0
    assert timers.span("outside") is timers.NULL


def test_tracing_switch_restores():
    assert not timers.ON
    with timers.tracing(True):
        assert timers.ON
        with timers.tracing(False):
            assert not timers.ON
        assert timers.ON
    assert not timers.ON
    t = timers.tracing(True)
    try:
        assert timers.ON
    finally:
        t.__exit__(None, None, None)
    assert not timers.ON


def test_blocking_counts_only_inside_a_recorder():
    rec = timers.Recorder()
    v = torch.tensor(2.5)
    assert timers.blocking(float, v) == 2.5
    assert rec.syncs == 0
    with timers.recording(rec):
        assert timers.blocking(int, torch.tensor(3)) == 3
        with timers.tracing(True):
            timers.blocking(float, v)
    assert rec.syncs == 2 and rec.sync_ns > 0
    assert [(s.name, s.attrs) for s in rec.spans] == [
        ("sync", {"op": "float"})]


def test_idle_by_span_takes_the_innermost_span():
    """Device gaps go to the innermost span at their midpoints; a gap in
    no child falls in the root's self time."""
    rec = timers.Recorder()
    root = timers.Span(rec, "solve", 1, 0, 1, 0, 100, None)
    lvl = timers.Span(rec, "cycle.level", 2, 1, 1, 10, 50, {"level": 0})
    crs = timers.Span(rec, "cycle.coarse", 3, 2, 1, 20, 30, None)
    sync = timers.Span(rec, "sync", 4, 1, 1, 60, 90, {"op": "float"})
    busy = [(0, 12), (18, 24), (28, 62), (80, 120)]
    idle, root_self, total = idle_by_span(
        busy, [root, lvl, crs, sync], lambda t: t)
    # gaps (12, 18) in the level, (24, 28) in the coarse solve, (62, 80) in
    # the read; the window ends with the last busy interval
    assert idle == {"cycle.level[0]": 6e-9, "cycle.coarse": 4e-9,
                    "sync[float]": 18e-9}
    assert root_self == 0 and total == pytest.approx(28e-9)
    # one gap, (5, 100), whose midpoint lies in no child
    idle, root_self, total = idle_by_span(
        [(0, 5)], [root, lvl], lambda t: t, hi=100)
    assert idle == {"solve": pytest.approx(95e-9)}
    assert root_self == total == pytest.approx(95e-9)
    # a gap whose midpoint lies after the root span's end is in no span
    idle, root_self, _total = idle_by_span(
        [], [root], lambda t: t + 10, hi=300)
    assert idle == {NO_SPAN: pytest.approx(290e-9)} and root_self == 0


def _gs_setup(steps):
    """A small GS hierarchy of several levels (``sm_steps`` sweeps a
    visit)."""
    p = tfem.poisson_3d(13)
    opts = options_from_flags({"sm_type": "gs", "sm_steps": steps,
                               "max_coarse_size": 40})
    pc = ngsamg_tpu_torch.AMGPreconditioner(
        p.A, coords=p.coords, options=opts, device="cpu").setup()
    return p, pc


def _nonempty_colours(sm):
    cb = sm.color_bounds
    return sum(1 for a, b in zip(cb[:-1], cb[1:]) if b > a)


@pytest.mark.parametrize("steps", [1, 2])
def test_colour_steps_count_every_sweep(steps):
    """``SolveInfo.colour_steps`` is the sum over level visits of
    (non-empty colours x steps) for the forward and the backward sweep;
    the same with tracing off, where no ``gs.sweep`` span is recorded;
    the counter adds no blocking read."""
    p, pc = _gs_setup(steps)
    levels = pc.op.levels
    assert len(levels) >= 3
    assert all(lev.smoother.steps == steps for lev in levels[:-1])
    rec = pc.trace_
    n0 = len(rec.spans)
    x_off, off = pc.solve(p.b, tol=1e-8)
    assert len(rec.spans) == n0
    with timers.tracing(True):
        x_on, on = pc.solve(p.b, tol=1e-8)
    spans = _solve_spans(pc, n0)
    visits = [s.attrs["level"] for s in spans if s.name == "cycle.level"]
    want = sum(2 * steps * _nonempty_colours(levels[lv].smoother)
               for lv in visits)
    assert on.colour_steps == off.colour_steps == want > 0
    np.testing.assert_array_equal(x_on, x_off)
    assert on.host_syncs == off.host_syncs == _expected_syncs(
        "host", off, pc, False)
    # the recorder's own count: the two solves'
    assert rec.colour_steps == 2 * want


def test_gs_sweep_spans_nest_in_their_level():
    p, pc = _gs_setup(1)
    levels = pc.op.levels
    rec = pc.trace_
    n0 = len(rec.spans)
    with timers.tracing(True):
        _x, info = pc.solve(p.b, tol=1e-8)
    spans = _solve_spans(pc, n0)
    by_id = {s.id: s for s in spans}
    sweeps = [s for s in spans if s.name == "gs.sweep"]
    assert sweeps
    for s in sweeps:
        par = by_id[s.parent]
        assert par.name == "cycle.level"
        level = par.attrs["level"]
        assert s.attrs["colours"] == _nonempty_colours(
            levels[level].smoother)
        assert par.start <= s.start and s.end <= par.end
        # the idle report names a sweep by its visit's level
        assert _span_key(s, by_id) == f"gs.sweep[{level}]"
    # each visit: a forward sweep, then (after the coarser levels) a
    # backward one
    for lvl in (s for s in spans if s.name == "cycle.level"):
        kids = [s for s in sweeps if s.parent == lvl.id]
        assert [k.attrs["reverse"] for k in kids] == [False, True]
    assert sum(s.attrs["colours"] for s in sweeps) == info.colour_steps


@pytest.mark.parametrize("case", ["device", "mixed"])
def test_chebyshev_runs_no_colour_step(setups, case):
    p, pc, kw = setups[case]
    with timers.tracing(True):
        _x, info = pc.solve(p.b, tol=1e-8, **kw)
    assert info.colour_steps == 0
    assert not pc.trace_.named("gs.sweep")
