"""Request-level schedulers over torch tensors: continuous batching with
early-exit compaction and (optionally) SLO-aware admission/degradation.

Two schedulers share one contract (``run_trace(requests) -> (completions,
metrics)``) so they can be A/B-ed on the same arrival trace:

* :class:`StaticBatchScheduler` — the baseline: fill a batch from the
  queue, run the monolithic ``fn_exits`` to FULL depth, apply the
  early-exit rule afterwards.  Exits change which head answers but save
  no compute.

* :class:`ContinuousBatchScheduler` — the model's layer plan is split at
  the exit boundaries (``ServingModel.stage_fns``).  Each round runs ONE
  segment on a batch padded to the fixed slot geometry
  (``kernels/tiling.batch_slots``); samples whose exit confidence clears
  the threshold complete at once, surviving slots are compacted
  (gathered dense) into the next segment's pending buffer as int8
  :class:`~repro_torch.core.export.QAct` rows, and the freed slots are
  backfilled from the queue.

The replica-pool scheduler (serving/replica.py) subclasses the continuous
scheduler: same pending buffers and landing logic, event-driven over N
elastic replicas with straggler de-prioritization and chaos-tested
failover.

SLO mode (``slo=SLOPolicy(...)``, serving/slo.py): requests with a
``deadline`` are rejected at admission when their budget cannot cover the
queue ahead of them, urgent partial batches override wait-to-fill, and a
survivor whose budget can no longer cover its next segment is
force-completed NOW from its stored exit-head logits (a *degraded*
completion) — every SLO decision is made before the clock advances, so an
admitted request is degraded or completes on time, never silently late.

Bit-exactness contract: slots are independent at fixed batch geometry
(convs, matmuls, GroupNorm and softmax are all per-sample at fixed B), so
on a resident export every request's answer is bit-exact against the
monolithic ``fn_exits`` run on that request alone at the same slot
geometry, whichever requests shared its batches.  A degraded completion's
logits are bit-exact too: they are the head's own row from a normally
executed segment; only the exit DECISION was forced.

Time: the scheduler advances a single-executor clock.  ``stage_costs``
injects measured per-segment batch costs (the simulated clock: medians,
so a noisy host cannot corrupt an A/B); ``stage_costs=None`` uses the
wall time of each executed batch.  Either way every batch runs, and it
is synchronized (``torch.cuda.synchronize()``) before it lands, so a
wall-clock cost covers the device work.  Arrival timestamps gate
admission either way, so a Poisson trace replays faithfully.
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from repro_torch.core.export import QAct, exit_confidence
from repro_torch.kernels.tiling import batch_slots
from repro_torch.obs.trace import as_tracer
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.request import Completion, RequestQueue


def exit_decisions(logits, exits, threshold):
    """Per-sample ``(exit_stage, answer_logits)`` numpy arrays: the earliest
    exit whose ``exit_confidence`` strictly clears ``threshold`` wins; -1
    means the final head answers."""
    stage = np.full(logits.shape[0], -1, np.int64)
    ans = logits.to(torch.float32).cpu().numpy().copy()
    taken = np.zeros(logits.shape[0], bool)
    for s in sorted(exits):
        take = (exit_confidence(exits[s]).cpu().numpy() > threshold) & ~taken
        ans[take] = exits[s].to(torch.float32).cpu().numpy()[take]
        stage[take] = s
        taken |= take
    return stage, ans


def _take(src, idx):
    """Rows ``idx`` (None: ``src`` is one sample) of a tensor or QAct."""
    if isinstance(src, QAct):
        return QAct(_take(src.q, idx), src.scale)
    if idx is None:
        return src[None]
    return src[torch.as_tensor(idx, device=src.device)]


def _cat(parts):
    if isinstance(parts[0], QAct):
        scales = {p.scale for p in parts}
        if len(scales) != 1:
            raise ValueError(f'cannot batch carries on scales {scales}')
        return QAct(torch.cat([p.q for p in parts]), parts[0].scale)
    return torch.cat(parts)


def _pad(batch, slots):
    if isinstance(batch, QAct):
        return QAct(_pad(batch.q, slots), batch.scale)
    if batch.shape[0] >= slots:
        return batch
    return torch.cat([batch, batch.new_zeros(
        (slots - batch.shape[0],) + tuple(batch.shape[1:]))])


def _gather_rows(sources, slots):
    """Assemble a batch padded to exactly ``slots`` from per-sample
    ``(src, idx)`` references: ``idx=None`` means ``src`` IS the sample
    (a fresh request's x), otherwise ``src`` is a batch (tensor or QAct)
    and ``idx`` a row in it.  Consecutive rows of one source batch gather
    with ONE indexed take."""
    groups = []                          # (src, [idx...]) runs, or (x, None)
    for src, idx in sources:
        if idx is None:
            groups.append((src, None))
        elif groups and groups[-1][1] is not None and groups[-1][0] is src:
            groups[-1][1].append(idx)
        else:
            groups.append((src, [idx]))
    parts = [_take(src, idxs) for src, idxs in groups]
    return _pad(parts[0] if len(parts) == 1 else _cat(parts), slots)


def _synchronize(out):
    """Wait for the device work behind ``out`` (the reference's
    ``block_until_ready``)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return out


class _Clock:
    """Single-executor clock: simulated per-stage costs, or wall time."""

    def __init__(self, stage_costs=None):
        self.costs = stage_costs

    def charge(self, stage_idx, fn):
        """Run ``fn`` (returns synchronized outputs), return its cost."""
        if self.costs is not None:
            fn()
            return float(self.costs[stage_idx])
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0


class ContinuousBatchScheduler:
    """Continuous-batching scheduler with early-exit slot compaction.

    ``model`` must be exported with exit heads (``stage_fns`` present);
    see the module docstring for the bit-exactness contract.  ``slots`` is
    padded up to the tile geometry and stays fixed for the scheduler's
    lifetime.  ``threshold=None`` uses the model's operating point.
    ``slo`` (an :class:`~repro_torch.serving.slo.SLOPolicy`) enables
    deadline admission and graceful degradation; its cost estimates are
    seeded from ``stage_costs`` when given, else learned online from wall
    time.

    Pending-buffer entries are ``(req, src, idx, head_stage, head_row)``:
    ``(src, idx)`` reference the request's input or its carry row in its
    last segment's output batch, ``(head_stage, head_row)`` hold the exit
    head it last declined — the logits the SLO layer force-completes from
    when the budget runs out (None for segment 0, which has no head yet).
    """

    def __init__(self, model, *, slots=32, threshold=None, stage_costs=None,
                 max_wait=None, slo=None, tracer=None):
        if not model.stage_fns:
            raise ValueError(
                'model has no stage-split plan (exported without exit '
                'heads); the continuous scheduler needs exit boundaries '
                'to compact at')
        self.model = model
        self.slots = batch_slots(slots)
        self.threshold = (model.exit_threshold if threshold is None
                          else threshold)
        self.max_wait = max_wait
        self.n_segs = model.n_stages
        if stage_costs is not None and len(stage_costs) != self.n_segs:
            raise ValueError(f'stage_costs must have {self.n_segs} entries')
        self.slo = slo
        if slo is not None and slo.stage_costs is None:
            if stage_costs is not None:
                slo.seed(stage_costs)
            else:
                slo.stage_costs = [None] * self.n_segs   # learn online
        self._clock = _Clock(stage_costs)
        self.tracer = as_tracer(tracer)
        self._track = 'executor0'          # the single-executor track

    # ---- scheduling policy: deepest full batch first, wait to fill while
    # arrivals are still coming, drain partial batches once they are not.
    # ``max_wait`` bounds request aging: a partial batch runs once its
    # oldest request has waited that long.  The test is written as
    # ``t_arrival + max_wait <= now``, the same float sum run_trace sleeps
    # until: ``now - t_arrival >= max_wait`` can round the other way and
    # leave the loop waiting forever at that horizon.
    def _pick(self, pend, more_arrivals, now):
        for k in reversed(range(self.n_segs)):
            if len(pend[k]) >= self.slots:
                return k
        if more_arrivals:
            if self.max_wait is not None:
                for k in reversed(range(self.n_segs)):
                    if pend[k] and \
                            pend[k][0][0].t_arrival + self.max_wait <= now:
                        return k
            return None
        for k in reversed(range(self.n_segs)):
            if pend[k]:
                return k
        return None

    # --------------------------------------------------------- completions

    def _complete(self, req, logits_row, stage, now, completions, metrics,
                  degraded=False):
        c = Completion(rid=req.rid, logits=logits_row,
                       pred=int(logits_row.argmax()), exit_stage=stage,
                       t_arrival=req.t_arrival, t_done=now,
                       t_start=req.t_start, deadline=req.deadline,
                       degraded=degraded)
        completions[req.rid] = c
        metrics.record_completion(c)

    def _land(self, k, items, out, now, pend, completions, metrics,
              track=None):
        """Process segment ``k``'s output: complete confident exits,
        promote survivors (carry reference + their declined head's logits)
        to ``pend[k + 1]``.  Shared with the replica pool, which lands
        flights asynchronously."""
        if k < self.n_segs - 1:
            exits, carry = out
            s = self.model.stage_exits[k]
            conf = exit_confidence(exits[s]).cpu().numpy()
            head = exits[s].to(torch.float32).cpu().numpy()
            n_exit = 0
            for i, (req, *_) in enumerate(items):
                if conf[i] > self.threshold:
                    n_exit += 1
                    self._complete(req, head[i], s, now, completions,
                                   metrics)
                else:                         # compact: reference the row
                    pend[k + 1].append((req, carry, i, s, head[i]))
            if self.tracer.enabled:
                self.tracer.instant(
                    'compaction', now, track=track or self._track,
                    stage=k, n_exit=n_exit, n_survive=len(items) - n_exit)
        else:
            logits = out.to(torch.float32).cpu().numpy()
            for i, (req, *_) in enumerate(items):
                self._complete(req, logits[i], -1, now, completions, metrics)

    def _trace_dispatch(self, items, now):
        """Close each request's queue span: the wait ends NOW (the span
        opened at arrival, or at the requeue after a failover kill)."""
        for req, *_ in items:
            t0 = (req.t_arrival if req.t_enqueued is None
                  else req.t_enqueued)
            self.tracer.async_span(
                'request.queue', t0, now,
                track=f'cohort{req.rid // self.slots}', cid=req.rid,
                rid=req.rid, requeued=req.t_enqueued is not None)

    def _run_segment(self, k, pend, completions, metrics, now):
        items = [pend[k].popleft()
                 for _ in range(min(len(pend[k]), self.slots))]
        if k == 0:
            for req, *_ in items:
                req.t_start = now             # service starts; wait ends
            if self.tracer.enabled:
                self._trace_dispatch(items, now)
        batch = _gather_rows([(src, idx) for _, src, idx, *_ in items],
                             self.slots)
        out = []

        def execute():
            out.append(_synchronize(self.model.run_stage(k, batch)))
        cost = self._clock.charge(k, execute)
        if self.tracer.enabled:
            self.tracer.add(
                'stage.exec', now, now + cost, track=self._track, stage=k,
                live=len(items), slots=self.slots,
                rids=[r.rid for r, *_ in items])
        now += cost
        if self.slo is not None:
            self.slo.observe(k, cost)
        metrics.record_batch(k, len(items), self.slots, t=now - cost,
                             cost=cost)
        self._land(k, items, out[0], now, pend, completions, metrics)
        return now

    # ------------------------------------------------------------ SLO hooks

    def _admit(self, r, now, pend, metrics) -> bool:
        if self.slo is None or r.deadline is None:
            return True
        ok, budget, need = self.slo.admit_explain(r.deadline, now,
                                                  len(pend[0]), self.slots)
        if ok:
            return True
        self.slo.n_rejected += 1
        metrics.record_rejection(r.rid, now, 'admission',
                                 t_arrival=r.t_arrival)
        if self.tracer.enabled:
            self.tracer.instant('request.admit', now, track='scheduler',
                                rid=r.rid, admitted=False,
                                reason='admission',
                                budget_s=round(budget, 6),
                                need_s=round(need, 6))
        return False

    def _slo_degrade(self, pend, k_star, now, completions, metrics):
        """Before charging segment ``k_star`` (cost ``c``): any pending
        deadline that cannot survive the charge is resolved NOW — degraded
        to its stored head logits (segments >= 1), or rejected (segment 0,
        no head yet; admission margins make this rare).  Runs at ``now``,
        before time advances, so the resolution itself is never late."""
        c = self.slo._cost(k_star)
        for j, buf in enumerate(pend):
            kept, pos = deque(), 0
            for item in buf:
                req = item[0]
                if req.deadline is None:
                    kept.append(item)
                    pos += 1
                    continue
                in_batch = j == k_star and pos < self.slots
                if self.slo.affordable(req.deadline, now, j, c, in_batch):
                    kept.append(item)
                    pos += 1
                elif j == 0:
                    self.slo.n_rejected += 1
                    metrics.record_rejection(req.rid, now, 'missed',
                                             t_arrival=req.t_arrival)
                    if self.tracer.enabled:
                        self.tracer.instant('request.admit', now,
                                            track='scheduler', rid=req.rid,
                                            admitted=False, reason='missed')
                else:
                    self.slo.n_degraded += 1
                    self._complete(req, item[4], item[3], now, completions,
                                   metrics, degraded=True)
            buf.clear()
            buf.extend(kept)

    def run_trace(self, requests):
        """Serve a whole arrival trace; returns ``({rid: Completion},
        ServingMetrics)``.  Terminates exactly when every request has
        completed or been rejected (the queue and every stage buffer
        drained)."""
        queue = RequestQueue(requests)
        pend = [deque() for _ in range(self.n_segs)]
        completions, metrics = {}, ServingMetrics()
        now = queue.next_arrival() or 0.0
        last_depth = None
        while queue or any(pend):
            for r in queue.pop_ready(now, self.slots - len(pend[0])):
                if self._admit(r, now, pend, metrics):
                    pend[0].append((r, r.x, None, None, None))
            depth = len(pend[0]) + queue.n_ready(now)
            if depth != last_depth:
                metrics.record_gauge('queue_depth', now, depth)
                last_depth = depth
            k = self._pick(pend, more_arrivals=bool(queue), now=now)
            if self.slo is not None:
                urgent = self.slo.urgent_segment(pend, now)
                if urgent is not None:
                    k = urgent                # deadline overrides fill
            if k is None:
                horizons = [t for t in (queue.next_arrival(),)
                            if t is not None]
                if self.max_wait is not None and any(pend):
                    oldest = min(p[0][0].t_arrival for p in pend if p)
                    horizons.append(oldest + self.max_wait)
                if self.slo is not None:
                    wake = self.slo.wake(pend, now)
                    if wake is not None:
                        horizons.append(wake)
                if not horizons:   # everything left was rejected this round
                    continue
                now = max(now, min(horizons))
                continue
            if self.slo is not None:
                self._slo_degrade(pend, k, now, completions, metrics)
                if not pend[k]:               # the sweep emptied the batch
                    continue
            now = self._run_segment(k, pend, completions, metrics, now)
        return completions, metrics


class StaticBatchScheduler:
    """The baseline: full batches through the monolithic ``fn_exits``.

    Early exits are applied to the *results* (same decision rule as the
    compacting scheduler, so answers agree bit-exactly on a resident
    export) but every slot pays full depth — the compute the E pass saved
    is given back at serve time.  ``batch_cost`` injects the measured
    monolithic batch cost for the simulated clock (None = wall time).
    """

    def __init__(self, model, *, slots=32, threshold=None, batch_cost=None,
                 tracer=None):
        if model.fn_exits is None:
            raise ValueError('model was exported without exit heads')
        self.model = model
        self.slots = batch_slots(slots)
        self.threshold = (model.exit_threshold if threshold is None
                          else threshold)
        self._clock = _Clock(None if batch_cost is None else [batch_cost])
        self.tracer = as_tracer(tracer)
        self._track = 'executor0'

    def run_trace(self, requests):
        queue = RequestQueue(requests)
        completions, metrics = {}, ServingMetrics()
        now = queue.next_arrival() or 0.0
        while queue:
            ready = queue.pop_ready(now, self.slots)
            while len(ready) < self.slots and queue:   # wait to fill
                now = max(now, queue.next_arrival())
                ready += queue.pop_ready(now, self.slots - len(ready))
            for req in ready:
                req.t_start = now
                if self.tracer.enabled:
                    self.tracer.async_span(
                        'request.queue', req.t_arrival, now,
                        track=f'cohort{req.rid // self.slots}',
                        cid=req.rid, rid=req.rid)
            batch = _gather_rows([(r.x, None) for r in ready], self.slots)
            out = []

            def execute():
                out.append(_synchronize(
                    self.model.fn_exits(self.model.params, batch)))
            cost = self._clock.charge(0, execute)
            if self.tracer.enabled:
                self.tracer.add('stage.exec', now, now + cost,
                                track=self._track, stage=0,
                                live=len(ready), slots=self.slots,
                                rids=[r.rid for r in ready])
            now += cost
            metrics.record_batch(0, len(ready), self.slots, t=now - cost,
                                 cost=cost)
            logits, exits = out[0]
            stage, ans = exit_decisions(logits, exits, self.threshold)
            for i, req in enumerate(ready):
                c = Completion(rid=req.rid, logits=ans[i],
                               pred=int(ans[i].argmax()),
                               exit_stage=int(stage[i]),
                               t_arrival=req.t_arrival, t_done=now,
                               t_start=req.t_start, deadline=req.deadline)
                completions[req.rid] = c
                metrics.record_completion(c)
        return completions, metrics
