"""SLO policy: deadline-aware admission and graceful degradation (a copy of
the reference's jax-free ``serving/slo.py``; the port imports nothing from
the JAX package).

A :class:`~repro_torch.serving.request.Request` may carry an absolute
``deadline`` (same clock as its ``t_arrival``).  The scheduler threads an
:class:`SLOPolicy` through three decision points, all made BEFORE the
clock advances so a decision can never itself be late:

* **admission** — a request is rejected at pop time when its remaining
  budget cannot cover the segment-0 batches already queued ahead of it
  plus one head-of-line blocking execution (``admit``).  A rejected
  request is counted (``ServingMetrics.record_rejection``), never served
  late.
* **urgency override** — the wait-to-fill policy is overridden when any
  pending request's latest safe start (``deadline - cost(segment)``)
  would pass while the scheduler waits or runs another batch; the urgent
  segment runs as a partial batch instead (``urgent_segment``).
* **graceful degradation** — survivors of segment ``k`` hold their exit
  head's logits (the scheduler keeps the head row alongside the carry).
  Before an execution of cost ``c`` is charged, any pending request whose
  budget no longer covers ``c`` plus its own segment is force-completed
  NOW with those stored logits — a *degraded* completion at exit head
  ``k``, on time by construction (the check runs at ``now``, which is
  still within budget).  The E pass's exit heads thereby become a
  latency/accuracy dial: a late-budget request answers from the deepest
  head it could afford instead of blowing p99.

Per-segment batch costs come from the scheduler's simulated-clock
``stage_costs`` or are learned online (EWMA over observed wall-clock
batch costs) — on the simulated clock the estimates are exact and the
never-late guarantee is provable; on the wall clock it is best-effort
(the EWMA lags genuine cost shifts by a few batches).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class SLOPolicy:
    """Deadline admission + degradation decisions over per-segment costs.

    ``stage_costs`` is the current per-segment batch-cost estimate in
    clock seconds (simulated or wall).  ``None`` entries mean "not yet
    observed" and are treated as 0 — the policy admits everything until
    it has measurements, then tightens.  ``slack`` multiplies every cost
    estimate (>1 = conservative admission/degradation headroom).
    """
    stage_costs: list | None = None
    alpha: float = 0.25               # EWMA blend for observed batch costs
    slack: float = 1.0                # cost-estimate safety multiplier
    n_rejected: int = field(default=0, init=False)
    n_degraded: int = field(default=0, init=False)

    def _cost(self, k: int) -> float:
        if not self.stage_costs or self.stage_costs[k] is None:
            return 0.0
        return float(self.stage_costs[k]) * self.slack

    @property
    def max_cost(self) -> float:
        if not self.stage_costs:
            return 0.0
        return max(self._cost(k) for k in range(len(self.stage_costs)))

    def seed(self, stage_costs) -> None:
        """Install initial per-segment cost estimates (the scheduler's
        simulated ``stage_costs``, or a measured median)."""
        self.stage_costs = [float(c) for c in stage_costs]

    def observe(self, k: int, cost: float) -> None:
        """Fold an observed segment-``k`` batch cost into the estimate
        (EWMA; the wall-clock path's online calibration).  On the
        simulated clock the observation equals the estimate — a no-op."""
        if self.stage_costs is None:
            return
        old = self.stage_costs[k]
        self.stage_costs[k] = (cost if old is None
                               else (1 - self.alpha) * old + self.alpha * cost)

    # ------------------------------------------------------------ decisions

    def admit(self, deadline: float, now: float, backlog: int,
              slots: int) -> bool:
        """Can a request joining ``backlog`` queued segment-0 requests
        still reach the first exit head by ``deadline``?  Budgets the
        segment-0 batches ahead of it plus one head-of-line blocking
        execution of any other segment."""
        return self.admit_explain(deadline, now, backlog, slots)[0]

    def admit_explain(self, deadline: float, now: float, backlog: int,
                      slots: int) -> tuple[bool, float, float]:
        """:meth:`admit` plus its evidence: ``(admitted, budget, need)``
        — what the request had vs what the queue ahead of it costs.  The
        observability layer records these on rejection instants so a
        trace explains WHY a request was turned away."""
        batches = math.ceil((backlog + 1) / max(slots, 1))
        need = batches * self._cost(0) + self.max_cost
        budget = deadline - now
        return budget >= need, budget, need

    def latest_start(self, k: int, deadline: float) -> float:
        """Latest time segment ``k`` may start and still answer by
        ``deadline`` (at its end head, or the final head for the last
        segment)."""
        return deadline - self._cost(k)

    def urgent_segment(self, pend, now: float) -> int | None:
        """The segment that must run NOW (partial batch allowed) because
        some pending deadline's latest safe start falls within one
        worst-case blocking execution of ``now``; None when no deadline
        is at risk.  Ties break toward the tightest latest start.  The
        test is written as ``ls - max_cost <= now``, the same float
        difference :meth:`wake` returns: ``ls <= now + max_cost`` can round
        the other way at that horizon, and the scheduler, woken there with
        nothing urgent, would wait at it forever."""
        best = None
        for j, buf in enumerate(pend):
            for item in buf:
                d = item[0].deadline
                if d is None:
                    continue
                ls = self.latest_start(j, d)
                if ls - self.max_cost <= now and \
                        (best is None or ls < best[0]):
                    best = (ls, j)
        return None if best is None else best[1]

    def wake(self, pend, now: float) -> float | None:
        """Earliest time any pending deadline becomes urgent — the
        scheduler must not sleep past it (None when no deadlines pend)."""
        ls = [self.latest_start(j, item[0].deadline)
              for j, buf in enumerate(pend) for item in buf
              if item[0].deadline is not None]
        if not ls:
            return None
        return max(now, min(ls) - self.max_cost)

    def affordable(self, deadline: float, now: float, k: int,
                   charge: float, in_batch: bool) -> bool:
        """Will a pending segment-``k`` request still meet ``deadline``
        after an execution of cost ``charge``?  ``in_batch`` means the
        request is IN that execution (it answers at ``now + charge``);
        otherwise it must additionally fit its own segment afterwards."""
        need = charge if in_batch else charge + self._cost(k)
        return deadline >= now + need - 1e-12
