"""Trace validation: the invariants that make a trace a load-bearing
test artifact (the reference's ``obs/validate.py``, on the port's spans).

:func:`check_trace` takes spans (a :class:`~repro_torch.obs.trace.Tracer`, a
span list, or a trace-file path) and optionally the run's completions
(``{rid: Completion}``) and asserts:

1. **well-formed** — every span has finite, ordered times (``t1 >= t0``)
   and a non-empty name/track; ``stage.exec`` spans carry their ``stage``
   attribute.
2. **nesting** — duration spans on one track either nest properly or are
   disjoint; partial overlap means two records claim the same executor
   for incompatible intervals.
3. **replica serialism** — ``stage.exec`` spans on one replica/executor
   track never overlap: a replica runs one batch at a time, including
   killed flights (which end at the kill, before the replacement runs).
4. **latency extent** (with completions) — a completion's span tree spans
   exactly its latency: its first ``request.queue`` span starts at
   ``t_arrival``, its last ends at ``t_start`` (so queue-wait equals the
   gap between arrival and first segment-0 ``stage.exec``), and — for
   non-degraded completions — the last ``stage.exec`` containing the rid
   ends at ``t_done`` while a segment-0 ``stage.exec`` starts at
   ``t_start``.  Degraded completions are resolved by the SLO sweep
   between batches, so only their queue invariants apply.

Returns a list of violation strings (empty = clean); ``strict=True``
raises :class:`TraceInvariantError` instead.  Requests that were
rejected (or whose only dispatch was killed) legitimately leave queue
spans with no completion; those are not flagged.
"""
from __future__ import annotations

import math

from repro_torch.obs.trace import ASYNC, SPAN, Span, Tracer, load_chrome_trace

_EPS = 1e-9
_EXEC_TRACKS = ('replica', 'executor', 'device')


class TraceInvariantError(AssertionError):
    """Raised by ``check_trace(..., strict=True)`` on any violation."""

    def __init__(self, violations):
        self.violations = list(violations)
        super().__init__('trace invariants violated:\n  ' +
                         '\n  '.join(self.violations))


def _coerce(spans_or_tracer) -> list[Span]:
    if isinstance(spans_or_tracer, Tracer):
        return list(spans_or_tracer.spans)
    if isinstance(spans_or_tracer, (str, bytes)) or hasattr(
            spans_or_tracer, '__fspath__'):
        return load_chrome_trace(spans_or_tracer)
    return list(spans_or_tracer)


def _near(a, b, tol=_EPS) -> bool:
    return abs(a - b) <= tol * max(1.0, abs(a), abs(b))


def check_trace(spans_or_tracer, completions=None, *,
                strict: bool = False) -> list[str]:
    """Validate span invariants; see the module docstring."""
    spans = _coerce(spans_or_tracer)
    v: list[str] = []

    # 1. well-formed
    for s in spans:
        if not (math.isfinite(s.t0) and math.isfinite(s.t1)):
            v.append(f'{s.name}@{s.track}: non-finite time '
                     f'[{s.t0}, {s.t1}]')
        elif s.t1 < s.t0 - _EPS:
            v.append(f'{s.name}@{s.track}: torn span (t1 {s.t1:.9f} < '
                     f't0 {s.t0:.9f})')
        if not s.name or not s.track:
            v.append(f'span with empty name/track at t={s.t0}')
        if s.name == 'stage.exec' and 'stage' not in s.args:
            v.append(f'stage.exec@{s.track} t={s.t0:.6f}: missing '
                     f'"stage" attribute')

    by_track: dict[str, list[Span]] = {}
    for s in spans:
        if s.kind == SPAN and s.t1 >= s.t0 - _EPS:
            by_track.setdefault(s.track, []).append(s)

    # 2. nesting: sorted by (t0, -t1) a child always follows its parent
    for track, ts in by_track.items():
        ts.sort(key=lambda s: (s.t0, -s.t1))
        stack: list[Span] = []
        for s in ts:
            while stack and stack[-1].t1 <= s.t0 + _EPS:
                stack.pop()
            if stack and s.t1 > stack[-1].t1 + _EPS:
                v.append(f'{track}: {s.name} [{s.t0:.6f}, {s.t1:.6f}] '
                         f'partially overlaps {stack[-1].name} '
                         f'[{stack[-1].t0:.6f}, {stack[-1].t1:.6f}]')
            else:
                stack.append(s)

    # 3. per-replica serial execution
    for track, ts in by_track.items():
        if not track.startswith(_EXEC_TRACKS):
            continue
        execs = sorted((s for s in ts if s.name == 'stage.exec'),
                       key=lambda s: s.t0)
        for a, b in zip(execs, execs[1:]):
            if b.t0 < a.t1 - _EPS:
                v.append(f'{track}: concurrent stage.exec spans '
                         f'[{a.t0:.6f}, {a.t1:.6f}] and '
                         f'[{b.t0:.6f}, {b.t1:.6f}]')

    # 4. completion extents
    if completions:
        queue_by_rid: dict[int, list[Span]] = {}
        exec_by_rid: dict[int, list[Span]] = {}
        for s in spans:
            if s.kind == ASYNC and s.name == 'request.queue':
                queue_by_rid.setdefault(s.cid, []).append(s)
            elif s.name == 'stage.exec' and not s.args.get('killed'):
                for rid in s.args.get('rids', ()):
                    exec_by_rid.setdefault(int(rid), []).append(s)
        for rid, c in completions.items():
            qs = sorted(queue_by_rid.get(rid, []), key=lambda s: s.t0)
            if not qs:
                v.append(f'rid {rid}: completion with no request.queue '
                         f'span')
                continue
            if not _near(qs[0].t0, c.t_arrival):
                v.append(f'rid {rid}: first queue span starts at '
                         f'{qs[0].t0:.9f}, arrival was '
                         f'{c.t_arrival:.9f}')
            if c.t_start is not None and not _near(qs[-1].t1, c.t_start):
                v.append(f'rid {rid}: queue-wait mismatch — last queue '
                         f'span ends at {qs[-1].t1:.9f}, service started '
                         f'at {c.t_start:.9f}')
            if c.degraded:
                continue            # resolved by the SLO sweep, not a batch
            es = exec_by_rid.get(rid, [])
            if not es:
                v.append(f'rid {rid}: completion with no stage.exec span')
                continue
            t_done = max(s.t1 for s in es)
            if not _near(t_done, c.t_done):
                v.append(f'rid {rid}: latency extent mismatch — last '
                         f'stage.exec ends at {t_done:.9f}, completion at '
                         f'{c.t_done:.9f}')
            if c.t_start is not None and not any(
                    s.args.get('stage') == 0 and _near(s.t0, c.t_start)
                    for s in es):
                v.append(f'rid {rid}: no segment-0 stage.exec starting at '
                         f't_start={c.t_start:.9f}')

    if strict and v:
        raise TraceInvariantError(v)
    return v
