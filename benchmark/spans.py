"""Readers of the program's own record of a run: the spans in
``pc.trace_`` and the counters on each solve's ``SolveInfo``.

The arithmetic is the benchmark's: a span's self time is its duration less
its children's, from each span's ``name``, ``id``, ``parent``, ``start``
and ``end`` (nanoseconds, ``end`` 0 while open). Where the program keeps no
such record, or not the one asked for, a reader gives None.
"""

from __future__ import annotations


def setup_self_s(pc, name: str) -> float | None:
    """Summed self time, in seconds, of the spans named ``name`` that the
    program's one set-up recorded (spans outside any solve)."""
    spans = getattr(getattr(pc, "trace_", None), "spans", None)
    if not spans:
        return None
    closed = [s for s in spans if s.end and s.solve == 0]
    own = {s.id: s.end - s.start for s in closed}
    for s in closed:
        if s.parent in own:
            own[s.parent] -= s.end - s.start
    hits = [own[s.id] for s in closed if s.name == name]
    return sum(hits) / 1e9 if hits else None


def mean_info(infos, field: str) -> float | None:
    """The mean of a ``SolveInfo`` counter over ``infos``; None where a
    solve does not report it."""
    vals = [getattr(i, field, None) for i in infos]
    if not vals or any(v is None for v in vals):
        return None
    return float(sum(vals)) / len(vals)
