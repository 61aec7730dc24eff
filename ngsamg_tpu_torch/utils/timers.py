"""Spans and counters: the port's one recorder.

The reference instruments every significant function with NGSolve Timers
and RegionTimers (base_factory.cpp:223; amg_matrix.cpp:168-178 per-level
cycle timers). Here a :class:`Recorder` (``pc.trace_``, one a
preconditioner, made anew by each ``setup()``) keeps spans in memory:
name, span id, parent id, solve id, start, end and a few attributes.
Durations come from ``time.perf_counter_ns``; each recorder also stores
one anchor pair (``time.time_ns()``, ``perf_counter_ns()``), so a span can
be placed on the clock of ``torch.profiler``, whose events are in
nanoseconds of the Unix epoch (:meth:`Recorder.epoch_ns`,
:meth:`Recorder.export_chrome`). Spans never go through
``torch.profiler.record_function``: they put no event on the device's
timeline.

Always recorded, while a recorder is current (``recording``, ``solving``):

- ``setup`` > ``setup.host`` > ``setup.level`` (one a level, attribute
  ``level``) > ``setup.mesh``, ``setup.coarsen``, ``setup.prol``,
  ``setup.rap`` (factory/levels.py); ``setup`` > ``setup.staging`` >
  ``staging.<stage>`` under the JAX package's stage names, each ending in
  a synchronise on CUDA (precond/amg.py);
- per solve, the counters :func:`solving` hands to ``SolveInfo``: blocking
  reads and copies (every one goes through :func:`blocking`), the host's
  time blocked in them, the solve's host time, and the colour steps of the
  multicolour GS sweeps (:func:`count_colour_steps`, a host integer the
  sweep adds as it runs) and of those the hand-written sweep kernel ran
  (:func:`count_gs_kernel_steps`, the same way), the f64 residuals
  computed on the host (:func:`count_host_residuals`, the same way), and
  the applications of tile-ELL operators (:func:`count_tile_ell_matvecs`,
  the same way: one a ``TileELL`` or ``TileELLStack`` matvec, a stack once
  whatever its buckets, f32 cycle and f64 twin alike) and of those the
  hand-written tile-ELL kernel ran (:func:`count_tile_ell_kernel_matvecs`,
  the same way: one a launch, a stack's one launch once).

Only with tracing on (:class:`tracing`; off by default), where each site
costs one check of the module flag ``ON`` and allocates nothing when it is
off: ``solve`` > ``solve.pass`` (one f64 defect-correction pass or mixed
restart) > ``pcg.iter`` > ``cycle.level`` (attribute ``level``; its self
time is that level's smoothing, residual and transfers) and
``cycle.coarse``, ``gs.sweep`` (one multicolour GS sweep, a child of the
``cycle.level`` or ``cycle.coarse`` it smooths; attributes ``reverse`` and
``colours``, the non-empty colours it ran), ``cluster.apply`` (one
application of the local cluster correction, two a cycle, a child of the
``pcg.iter`` whose cycle it wraps; attributes ``clusters``, the number of
clusters, and ``width``, the padded cluster size) and ``sync`` around each
blocking read.

This module imports no torch: the host setup's modules import it, and the
multi-process setup's ranks must start without torch.
"""

from __future__ import annotations

import contextvars
import json
import os
import time

ON = False  # tracing: the solve's spans are recorded
MAX_SPANS = 1 << 18
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "ngsamg_tpu_torch_recorder", default=None)
_SPAN_CAT = "ngsamg_span"  # the category of the spans in a Chrome trace
_SPAN_TRACK = "ngsamg_tpu_torch spans"  # their host track's name
_SPAN_TID = 0x6E67  # and its thread id, beside the profiler's own


class tracing:
    """Turns the solve's spans on (or off) for the process. As a context
    manager it restores the previous setting at the block's end:

        timers.tracing(True)             # on from here
        with timers.tracing(True): ...   # on inside the block
    """

    def __init__(self, on: bool = True):
        global ON
        self._prev = ON
        ON = bool(on)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        global ON
        ON = self._prev


class Span:
    """One recorded interval; ``end`` is 0 while it is open. As a context
    manager it closes at the block's end (it opened when it was made)."""

    __slots__ = ("name", "id", "parent", "solve", "start", "end", "attrs",
                 "_rec")

    def __init__(self, rec, name, sid, parent, solve, start, end, attrs):
        self._rec = rec
        self.name, self.id, self.parent, self.solve = name, sid, parent, solve
        self.start, self.end, self.attrs = start, end, attrs

    @property
    def ns(self) -> int:
        return self.end - self.start

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def close(self) -> None:
        self._rec.close(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._rec.close(self)


class _NullSpan:
    """What :func:`span` gives where nothing is recorded."""

    __slots__ = ()
    seconds = 0.0

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


NULL = _NullSpan()


class Recorder:
    """Spans and counters of one preconditioner. At most ``max_spans``
    spans are kept (the first ones); ``dropped`` counts the others."""

    def __init__(self, max_spans: int = MAX_SPANS):
        self.max_spans = int(max_spans)
        self.spans: list[Span] = []
        self.dropped = 0
        self.solves = 0  # solve ids handed out; spans outside a solve get 0
        self.syncs = 0  # blocking reads while this recorder was current
        self.sync_ns = 0  # the host's time blocked in them
        self.colour_steps = 0  # GS colour steps while this was current
        self.gs_kernel_steps = 0  # of them, run by the sweep kernel
        self.host_residuals = 0  # f64 residuals computed on the host
        self.tile_ell_matvecs = 0  # tile-ELL operator applications
        self.tile_ell_kernel_matvecs = 0  # of them, run by the kernel
        self._solve = 0
        self._stack: list[Span] = []
        self.anchor = (time.time_ns(), time.perf_counter_ns())

    def _span(self, name, start, end, attrs):
        if len(self.spans) >= self.max_spans:
            self.dropped += 1
            return None
        parent = self._stack[-1].id if self._stack else 0
        sp = Span(self, name, len(self.spans) + 1, parent, self._solve,
                  start, end, attrs)
        self.spans.append(sp)
        return sp

    def open(self, name: str, attrs: dict | None = None):
        """A span that starts now, a child of the innermost open one;
        :data:`NULL` once ``max_spans`` are kept."""
        sp = self._span(name, time.perf_counter_ns(), 0, attrs)
        if sp is None:
            return NULL
        self._stack.append(sp)
        return sp

    def close(self, sp: Span) -> None:
        """Ends ``sp`` now, and any span still open inside it; a closed
        span stays as it was."""
        if sp.end or sp not in self._stack:
            return
        t = time.perf_counter_ns()
        while self._stack:
            top = self._stack.pop()
            top.end = t
            if top is sp:
                break

    def add(self, name: str, start: int, end: int,
            attrs: dict | None = None) -> None:
        """A closed span, a child of the innermost open one."""
        self._span(name, start, end, attrs)

    # ---- reading -------------------------------------------------------
    def named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name and s.end]

    def self_ns(self) -> dict[int, int]:
        """Self time of every closed span, by span id: its duration less
        the time its children cover (children of one span never
        overlap)."""
        out = {s.id: s.ns for s in self.spans if s.end}
        for s in self.spans:
            if s.end and s.parent in out:
                out[s.parent] -= s.ns
        return out

    def seconds(self, name: str) -> float:
        """Summed duration of the spans named ``name``."""
        return sum(s.ns for s in self.named(name)) / 1e9

    def self_seconds(self, name: str) -> float:
        """Summed self time of the spans named ``name``."""
        own = self.self_ns()
        return sum(own[s.id] for s in self.named(name)) / 1e9

    def by_name(self, prefix: str = "") -> dict[str, float]:
        """Summed duration of the closed spans whose name starts with
        ``prefix``, by the name less the prefix, in the order each name
        first opened."""
        ns: dict[str, int] = {}
        for s in self.spans:
            if s.end and s.name.startswith(prefix):
                k = s.name[len(prefix):]
                ns[k] = ns.get(k, 0) + s.ns
        return {k: v / 1e9 for k, v in ns.items()}

    def epoch_ns(self, t: int) -> int:
        """``perf_counter_ns`` reading ``t`` in nanoseconds of the Unix
        epoch, the clock of ``torch.profiler``'s events."""
        wall, perf = self.anchor
        return wall + (t - perf)

    def export_chrome(self, path: str, prof=None) -> str:
        """Writes the spans to ``path`` as a Chrome trace. Given a finished
        ``torch.profiler.profile``, the spans join that profile's own trace
        on a host track of their own, on its clock; no device event is
        added. A profile's trace is written once: this writes it."""
        doc = {"traceEvents": []}
        if prof is not None:
            tmp = f"{path}.profile.json"
            prof.export_chrome_trace(tmp)
            try:
                with open(tmp) as fh:
                    doc = json.load(fh)
            finally:
                os.remove(tmp)
        # the profile's trace counts microseconds from its base time
        base = int(doc.get("baseTimeNanoseconds", 0))
        pid = os.getpid()
        events = doc.setdefault("traceEvents", [])
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": _SPAN_TID, "args": {"name": _SPAN_TRACK}})
        for s in self.spans:
            if s.end:
                events.append({
                    "ph": "X", "cat": _SPAN_CAT, "name": s.name,
                    "pid": pid, "tid": _SPAN_TID,
                    "ts": (self.epoch_ns(s.start) - base) / 1e3,
                    "dur": s.ns / 1e3,
                    "args": {"id": s.id, "parent": s.parent,
                             "solve": s.solve, **(s.attrs or {})},
                })
        with open(path, "w") as fh:
            json.dump(doc, fh)
        return path


def span(name: str, **attrs):
    """A span that starts now in the current recorder (:data:`NULL` where
    none is current); it ends at the ``with`` block's end or at its
    ``close()``."""
    rec = _CURRENT.get()
    if rec is None:
        return NULL
    return rec.open(name, attrs or None)


class recording:
    """Makes ``rec`` the current recorder inside the block."""

    def __init__(self, rec: Recorder):
        self.rec = rec

    def __enter__(self):
        self._token = _CURRENT.set(self.rec)
        return self.rec

    def __exit__(self, *exc):
        _CURRENT.reset(self._token)


class solving:
    """The scope of one solve: makes ``rec`` current under a new solve id,
    counts the blocking reads and the GS colour steps inside and times the
    host; with tracing on, also the root ``solve`` span. After the block:
    ``host_syncs``, ``sync_wait_s``, ``host_s``, ``dispatch_s`` (the host's
    time less its time blocked in reads), ``colour_steps``,
    ``gs_kernel_steps``, ``host_residuals``, ``tile_ell_matvecs`` and
    ``tile_ell_kernel_matvecs``."""

    host_syncs = colour_steps = gs_kernel_steps = host_residuals = 0
    tile_ell_matvecs = tile_ell_kernel_matvecs = 0
    sync_wait_s = host_s = dispatch_s = 0.0

    def __init__(self, rec: Recorder):
        self.rec = rec

    def __enter__(self):
        rec = self.rec
        self._token = _CURRENT.set(rec)
        self._outer = rec._solve
        rec.solves += 1
        rec._solve = rec.solves
        self._syncs, self._wait = rec.syncs, rec.sync_ns
        self._steps = rec.colour_steps
        self._kernel_steps = rec.gs_kernel_steps
        self._residuals = rec.host_residuals
        self._tile_ell = rec.tile_ell_matvecs
        self._tile_ell_kernel = rec.tile_ell_kernel_matvecs
        self._span = rec.open("solve") if ON else NULL
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec = self.rec
        self._span.close()
        rec._solve = self._outer
        _CURRENT.reset(self._token)
        self.host_syncs = rec.syncs - self._syncs
        self.sync_wait_s = (rec.sync_ns - self._wait) / 1e9
        self.colour_steps = rec.colour_steps - self._steps
        self.gs_kernel_steps = rec.gs_kernel_steps - self._kernel_steps
        self.host_residuals = rec.host_residuals - self._residuals
        self.tile_ell_matvecs = rec.tile_ell_matvecs - self._tile_ell
        self.tile_ell_kernel_matvecs = (rec.tile_ell_kernel_matvecs
                                        - self._tile_ell_kernel)
        self.host_s = (t1 - self._t0) / 1e9
        self.dispatch_s = self.host_s - self.sync_wait_s


def count_colour_steps(n: int) -> None:
    """Adds ``n`` colour steps of a multicolour GS sweep to the current
    recorder (nothing where none is current)."""
    rec = _CURRENT.get()
    if rec is not None:
        rec.colour_steps += n


def count_gs_kernel_steps(n: int) -> None:
    """Adds ``n`` colour steps that the hand-written GS sweep kernel ran
    to the current recorder (nothing where none is current)."""
    rec = _CURRENT.get()
    if rec is not None:
        rec.gs_kernel_steps += n


def count_host_residuals(n: int) -> None:
    """Adds ``n`` f64 residuals computed on the host to the current
    recorder (nothing where none is current)."""
    rec = _CURRENT.get()
    if rec is not None:
        rec.host_residuals += n


def count_tile_ell_matvecs(n: int) -> None:
    """Adds ``n`` applications of tile-ELL operators to the current
    recorder (nothing where none is current)."""
    rec = _CURRENT.get()
    if rec is not None:
        rec.tile_ell_matvecs += n


def count_tile_ell_kernel_matvecs(n: int) -> None:
    """Adds ``n`` tile-ELL applications that the hand-written kernel ran
    to the current recorder (nothing where none is current)."""
    rec = _CURRENT.get()
    if rec is not None:
        rec.tile_ell_kernel_matvecs += n


def blocking(fn, *args, **kw):
    """``fn(*args, **kw)``: a read or copy that holds the host until the
    device has caught up (``float``/``int`` of a device tensor, ``.cpu()``,
    a host-to-device ``.to()`` or ``as_tensor``). Every such call of the
    solve path goes through here, so that it is counted and timed in the
    current recorder, and is a ``sync`` span with tracing on."""
    t0 = time.perf_counter_ns()
    out = fn(*args, **kw)
    t1 = time.perf_counter_ns()
    rec = _CURRENT.get()
    if rec is not None:
        rec.syncs += 1
        rec.sync_ns += t1 - t0
        if ON:
            rec.add("sync", t0, t1, {"op": getattr(fn, "__name__", "?")})
    return out
