"""Requests, completions, and the arrival queue for the serving runtime (a
copy of the reference's jax-free ``serving/request.py``; the port imports
nothing from the JAX package).

A :class:`Request` is one sample (one image) with an arrival timestamp and
an optional absolute ``deadline`` (the SLO layer, serving/slo.py); a
:class:`Completion` is the scheduler's answer — the request's logits (the
exit head's when it exited early, the final head's otherwise), the argmax
prediction, which stage it exited at, and the latency split.  Timestamps
are plain float seconds on whatever clock drives the scheduler (wall clock
or the benchmark's simulated cost-model clock).

:class:`RequestQueue` is the arrival buffer: FIFO, time-aware — the
scheduler only admits requests whose arrival time has passed on its clock,
so a recorded Poisson trace replays faithfully.  ``push`` validates that a
*fresh* trace arrives in order; ``requeue`` is the failover-replay path —
a request whose replica died mid-batch re-enters at its FIFO position by
original arrival time, which an in-order ``push`` would forbid.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any


@dataclass
class Request:
    """One inference request: ``x`` is a single unbatched sample (H, W, C).

    ``deadline`` is absolute (same clock as ``t_arrival``); None = no SLO.
    ``t_start`` is written by the scheduler when the request first enters
    an executed segment-0 batch (service start; queue-wait ends here).
    ``t_enqueued`` is the last time the request (re-)entered the queue —
    ``None`` until a failover requeue stamps the kill time, so a traced
    request's second ``request.queue`` span starts where its killed
    dispatch ended instead of double-counting the original wait.
    """
    rid: int
    x: Any
    t_arrival: float = 0.0
    deadline: float | None = None
    t_start: float | None = None
    t_enqueued: float | None = None


@dataclass
class Completion:
    """The served answer for one request."""
    rid: int
    logits: Any                # the head that answered (exit or final), fp32
    pred: int
    exit_stage: int            # stage index of the exit taken; -1 = final head
    t_arrival: float
    t_done: float
    t_start: float | None = None   # first segment-0 execution start
    deadline: float | None = None  # absolute SLO deadline (None = no SLO)
    degraded: bool = False         # forced to an earlier head by the SLO

    @property
    def latency(self) -> float:
        return self.t_done - self.t_arrival

    @property
    def queue_wait(self) -> float | None:
        """Arrival -> service start (None if never dispatched)."""
        return None if self.t_start is None else self.t_start - self.t_arrival

    @property
    def execute(self) -> float | None:
        """Service start -> completion (includes inter-segment waits)."""
        return None if self.t_start is None else self.t_done - self.t_start

    @property
    def on_time(self) -> bool | None:
        """Deadline met?  None when the request carried no deadline."""
        if self.deadline is None:
            return None
        return self.t_done <= self.deadline + 1e-12


class RequestQueue:
    """FIFO arrival queue with time-gated admission."""

    def __init__(self, requests=()):
        self._q = deque(sorted(requests, key=lambda r: r.t_arrival))

    def push(self, req: Request) -> None:
        """Append a FRESH request; raises unless pushed in arrival order
        (trace validation — an out-of-order fresh push is a bug, while a
        failover replay must go through :meth:`requeue`)."""
        if self._q and req.t_arrival < self._q[-1].t_arrival:
            raise ValueError(
                f'request {req.rid} arrives at {req.t_arrival} before the '
                f'queue tail ({self._q[-1].t_arrival}); push in arrival '
                f'order (failover replay goes through requeue())')
        self._q.append(req)

    def requeue(self, req: Request) -> None:
        """Re-admit a request (failover replay: its executor died before
        its batch landed).  Inserts at the FIFO position of its ORIGINAL
        arrival time, so replayed requests keep their place relative to
        requests still waiting — the order a fresh in-order trace would
        have produced."""
        for i, r in enumerate(self._q):
            if r.t_arrival > req.t_arrival:
                self._q.insert(i, req)
                return
        self._q.append(req)

    def pop_ready(self, now: float, limit: int) -> list:
        """Up to ``limit`` requests that have arrived by ``now``, FIFO."""
        out = []
        while self._q and len(out) < limit and self._q[0].t_arrival <= now:
            out.append(self._q.popleft())
        return out

    def next_arrival(self) -> float | None:
        """Arrival time of the head request (None when empty)."""
        return self._q[0].t_arrival if self._q else None

    def n_ready(self, now: float) -> int:
        """How many queued requests have arrived by ``now`` (the replica
        pool's scaling signal; FIFO order means they are a prefix)."""
        n = 0
        for r in self._q:
            if r.t_arrival > now:
                break
            n += 1
        return n

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)
