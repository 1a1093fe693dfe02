"""Requests, completions, and the arrival queue for the serving runtime.

A copy of the part of the reference's jax-free module that this slice
uses (the port imports nothing from the JAX package); deadlines and the
failover requeue come with the SLO and replica slices.

A :class:`Request` is one sample (one image) with an arrival timestamp; a
:class:`Completion` is the scheduler's answer — the request's logits (the
exit head's when it exited early, the final head's otherwise), the argmax
prediction, which stage it exited at, and the latency split.  Timestamps
are plain float seconds on the scheduler's clock.

:class:`RequestQueue` is the arrival buffer: FIFO and time-aware — the
scheduler only admits requests whose arrival time has passed on its clock,
so a recorded Poisson trace replays faithfully.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any


@dataclass
class Request:
    """One inference request: ``x`` is a single unbatched sample (H, W, C).
    ``t_start`` is written by the scheduler when the request first enters
    an executed segment-0 batch (service start; queue-wait ends here)."""
    rid: int
    x: Any
    t_arrival: float = 0.0
    t_start: float | None = None


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


class RequestQueue:
    """FIFO arrival queue with time-gated admission."""

    def __init__(self, requests=()):
        self._q = deque(sorted(requests, key=lambda r: r.t_arrival))

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
        """How many queued requests have arrived by ``now`` (FIFO order
        means they are a prefix)."""
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
