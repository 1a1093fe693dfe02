"""Span tracing for the serving stack, with a Chrome-trace exporter (a copy
of the reference's jax-free ``obs/trace.py``; the port imports nothing
from the JAX package).

A :class:`Tracer` collects :class:`Span` records from a scheduler run
(simulated clock) or an export (wall clock) — the span taxonomy is fixed
(see the reference's ``serving/README.md``):

=====================  ========================================================
``request.queue``      async span per request: arrival (or requeue after a
                       kill) -> service start; lives on the request's cohort
                       track, correlated by rid.
``request.admit``      instant at an SLO admission decision (rejections).
``stage.exec``         one executed segment batch on a replica/executor
                       track, with ``stage``/``live``/``slots``/``rids``
                       attributes (``killed=True`` when a chaos kill
                       truncated it).
``compaction``         instant after a non-final segment lands: how many
                       slots exited vs survived.
``failover.restore``   checkpoint restore of a replacement replica, on the
                       NEW replica's track.
``export.calibrate``   wall-clock span around the layer-plan compile.
``kernel.launch``      one timed kernel execution during measure-mode
                       selection (these spans ARE the measurement).
=====================  ========================================================

Timestamps are float seconds on whichever clock produced them; serving
spans (simulated clock) and export spans (wall clock) land in different
trace *processes*, so the two timelines never mix on one track.

:data:`NULL_TRACER` (a :class:`NullTracer`) is the default everywhere: its
methods are no-ops that allocate nothing, so the uninstrumented hot path
pays one attribute check (``tracer.enabled``) and no span bookkeeping.

``to_chrome()`` emits the Chrome trace-event JSON format (the ``'X'`` /
``'b'``/``'e'`` / ``'i'`` / ``'C'`` phases) that https://ui.perfetto.dev
and chrome://tracing load directly: one thread per replica, one per
request cohort, grouped into ``serving`` / ``requests`` / ``export``
processes.  :func:`load_chrome_trace` parses that JSON back into spans so
a written trace file is a checkable artifact
(:func:`repro_torch.obs.validate.check_trace`), not just a picture.
"""
from __future__ import annotations

import json
import re
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

SPAN = 'span'          # nested duration on one track
ASYNC = 'async'        # request-lifetime span, correlated by cid (rid)
INSTANT = 'instant'    # point event
COUNTER = 'counter'    # sampled value (rendered as a counter track)

# track-name prefix -> (pid, process name); unknown prefixes go to 'misc'
_PID_GROUPS = (('replica', 1, 'serving'), ('executor', 1, 'serving'),
               ('device', 1, 'serving'), ('scheduler', 1, 'serving'),
               ('cohort', 2, 'requests'), ('export', 3, 'export'))


@dataclass(frozen=True)
class Span:
    """One trace event: a duration (``kind='span'``/``'async'``), an
    instant (``t1 == t0``), or a counter sample (``args={'value': v}``)."""
    name: str
    t0: float
    t1: float
    track: str
    kind: str = SPAN
    cid: int | None = None        # async correlation id (the rid)
    args: dict = field(default_factory=dict)

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


class Tracer:
    """Collects spans; ``enabled`` lets call sites skip building args."""

    enabled = True

    def __init__(self):
        self.spans: list[Span] = []
        self._wall0 = time.perf_counter()

    def now(self) -> float:
        """Wall-clock seconds since this tracer was created (the export
        timeline; scheduler spans carry their own simulated times)."""
        return time.perf_counter() - self._wall0

    def add(self, name, t0, t1, *, track, **args) -> None:
        self.spans.append(Span(name, float(t0), float(t1), track,
                               kind=SPAN, args=args))

    def async_span(self, name, t0, t1, *, track, cid, **args) -> None:
        self.spans.append(Span(name, float(t0), float(t1), track,
                               kind=ASYNC, cid=int(cid), args=args))

    def instant(self, name, t, *, track, **args) -> None:
        self.spans.append(Span(name, float(t), float(t), track,
                               kind=INSTANT, args=args))

    def counter(self, name, t, value, *, track='counters') -> None:
        self.spans.append(Span(name, float(t), float(t), track,
                               kind=COUNTER, args={'value': float(value)}))

    @contextmanager
    def span(self, name, *, track, **args):
        """Wall-clock duration span around a ``with`` body."""
        t0 = self.now()
        try:
            yield
        finally:
            self.add(name, t0, self.now(), track=track, **args)

    # ------------------------------------------------------- chrome export

    def to_chrome(self) -> dict:
        return spans_to_chrome(self.spans)

    def write(self, path) -> None:
        with open(path, 'w') as f:
            json.dump(self.to_chrome(), f)


class NullTracer(Tracer):
    """The default: every method is an allocation-free no-op."""

    enabled = False

    def __init__(self):                      # no span list, no clock
        pass

    def now(self):
        return 0.0

    def add(self, name, t0, t1, *, track, **args):
        pass

    def async_span(self, name, t0, t1, *, track, cid, **args):
        pass

    def instant(self, name, t, *, track, **args):
        pass

    def counter(self, name, t, value, *, track='counters'):
        pass

    @contextmanager
    def span(self, name, *, track, **args):
        yield

    def to_chrome(self):
        return spans_to_chrome(())

    @property
    def spans(self):
        return []


NULL_TRACER = NullTracer()


def as_tracer(tracer) -> Tracer:
    """None -> the shared :data:`NULL_TRACER`; anything else passes."""
    return NULL_TRACER if tracer is None else tracer


def _pid_for(track: str) -> tuple[int, str]:
    for prefix, pid, pname in _PID_GROUPS:
        if track.startswith(prefix):
            return pid, pname
    return 9, 'misc'


def _track_sort_key(track: str):
    """Natural sort so replica10 follows replica9, not replica1."""
    m = re.match(r'^(.*?)(\d+)$', track)
    return (m.group(1), int(m.group(2))) if m else (track, -1)


def spans_to_chrome(spans) -> dict:
    """Chrome trace-event JSON: ``ts``/``dur`` in microseconds, integer
    pid/tid, metadata events naming the processes and tracks."""
    tracks = sorted({s.track for s in spans}, key=_track_sort_key)
    tids, events = {}, []
    per_pid_next = {}
    for track in tracks:
        pid, pname = _pid_for(track)
        tid = per_pid_next.get(pid, 1)
        per_pid_next[pid] = tid + 1
        tids[track] = (pid, tid)
        if tid == 1:
            events.append({'ph': 'M', 'name': 'process_name', 'pid': pid,
                           'tid': 0, 'args': {'name': pname}})
        events.append({'ph': 'M', 'name': 'thread_name', 'pid': pid,
                       'tid': tid, 'args': {'name': track}})
        events.append({'ph': 'M', 'name': 'thread_sort_index', 'pid': pid,
                       'tid': tid, 'args': {'sort_index': tid}})
    for s in spans:
        pid, tid = tids[s.track]
        base = {'name': s.name, 'pid': pid, 'tid': tid,
                'ts': s.t0 * 1e6, 'args': dict(s.args)}
        if s.kind == SPAN:
            events.append({**base, 'ph': 'X', 'cat': 'serving',
                           'dur': s.dur * 1e6})
        elif s.kind == ASYNC:
            cid = f'0x{s.cid:x}'
            events.append({**base, 'ph': 'b', 'cat': s.name, 'id': cid})
            events.append({'name': s.name, 'pid': pid, 'tid': tid,
                           'ts': s.t1 * 1e6, 'ph': 'e', 'cat': s.name,
                           'id': cid, 'args': {}})
        elif s.kind == INSTANT:
            events.append({**base, 'ph': 'i', 's': 't'})
        elif s.kind == COUNTER:
            events.append({'name': s.name, 'pid': pid, 'tid': tid,
                           'ts': s.t0 * 1e6, 'ph': 'C',
                           'args': {s.name: s.args.get('value', 0.0)}})
    return {'traceEvents': events, 'displayTimeUnit': 'ms'}


def load_chrome_trace(path_or_dict) -> list[Span]:
    """Parse a Chrome trace (path or already-loaded dict) back into
    :class:`Span` records.  Raises ``ValueError`` on a torn async pair
    (a ``'b'`` with no matching ``'e'`` or vice versa) — a trace that
    cannot round-trip is itself a bug."""
    if isinstance(path_or_dict, dict):
        doc = path_or_dict
    else:
        with open(path_or_dict) as f:
            doc = json.load(f)
    events = doc.get('traceEvents', doc if isinstance(doc, list) else [])
    names = {}                             # (pid, tid) -> track name
    for e in events:
        if e.get('ph') == 'M' and e.get('name') == 'thread_name':
            names[(e['pid'], e['tid'])] = e['args']['name']
    def track(e):
        return names.get((e.get('pid', 0), e.get('tid', 0)),
                         f"pid{e.get('pid', 0)}.tid{e.get('tid', 0)}")
    spans, open_async = [], {}
    for e in events:
        ph = e.get('ph')
        t = e.get('ts', 0.0) / 1e6
        if ph == 'X':
            spans.append(Span(e['name'], t, t + e.get('dur', 0.0) / 1e6,
                              track(e), kind=SPAN,
                              args=dict(e.get('args', {}))))
        elif ph == 'b':
            key = (e.get('cat'), e.get('id'), e['name'])
            open_async.setdefault(key, []).append((t, track(e),
                                                   dict(e.get('args', {}))))
        elif ph == 'e':
            key = (e.get('cat'), e.get('id'), e['name'])
            pend = open_async.get(key)
            if not pend:
                raise ValueError(f'torn async span: end with no begin '
                                 f'for {key}')
            t0, trk, args = pend.pop(0)
            if not pend:
                del open_async[key]
            cid = e.get('id')
            cid = int(cid, 16) if isinstance(cid, str) else int(cid)
            spans.append(Span(e['name'], t0, t, trk, kind=ASYNC,
                              cid=cid, args=args))
        elif ph == 'i':
            spans.append(Span(e['name'], t, t, track(e), kind=INSTANT,
                              args=dict(e.get('args', {}))))
        elif ph == 'C':
            args = dict(e.get('args', {}))
            v = args.get(e['name'], next(iter(args.values()), 0.0))
            spans.append(Span(e['name'], t, t, track(e), kind=COUNTER,
                              args={'value': float(v)}))
    if open_async:
        raise ValueError(f'torn async span(s): begin with no end for '
                         f'{sorted(open_async)}')
    return spans
