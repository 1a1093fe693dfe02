"""Continuous batching with early-exit slot compaction, over torch tensors.

The model's layer plan is split at the exit boundaries
(``ServingModel.stage_fns``).  Each round runs ONE segment on a batch
padded to the fixed slot geometry (``kernels/tiling.batch_slots``);
samples whose exit confidence clears the threshold complete at once,
surviving slots are compacted (gathered dense) into the next segment's
pending buffer as int8 :class:`~repro_torch.core.export.QAct` rows, and
the freed slots are backfilled from the queue.

Bit-exactness contract: slots are independent at fixed batch geometry
(convs, matmuls, GroupNorm and softmax are all per-sample at fixed B), so
every request's answer is bit-exact against the monolithic ``fn_exits``
run on that request alone at the same slot geometry, whichever requests
shared its batches.

Time runs on one executor's clock: arrival timestamps gate admission, and
each executed batch advances the clock by its wall time, measured after
``torch.cuda.synchronize()``.  The SLO layer, the replica pool, placement
and the static-batch baseline are ported in later slices.
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


class ContinuousBatchScheduler:
    """Continuous-batching scheduler with early-exit slot compaction.

    ``model`` must be exported with exit heads (``stage_fns`` present).
    ``slots`` is padded up to the tile geometry and stays fixed for the
    scheduler's lifetime.  ``threshold=None`` uses the model's operating
    point.  Pending-buffer entries are ``(req, src, idx)``: ``(src, idx)``
    reference the request's input or its carry row in its last segment's
    output batch."""

    def __init__(self, model, *, slots=32, threshold=None, max_wait=None,
                 tracer=None):
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
        self.tracer = as_tracer(tracer)
        self._track = 'executor0'

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

    def _complete(self, req, logits_row, stage, now, completions, metrics):
        c = Completion(rid=req.rid, logits=logits_row,
                       pred=int(logits_row.argmax()), exit_stage=stage,
                       t_arrival=req.t_arrival, t_done=now,
                       t_start=req.t_start)
        completions[req.rid] = c
        metrics.record_completion(c)

    def _land(self, k, items, out, now, pend, completions, metrics):
        """Process segment ``k``'s output: complete confident exits, promote
        survivors (a reference to their carry row) to ``pend[k + 1]``."""
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
                else:
                    pend[k + 1].append((req, carry, i))
            if self.tracer.enabled:
                self.tracer.instant(
                    'compaction', now, track=self._track, stage=k,
                    n_exit=n_exit, n_survive=len(items) - n_exit)
        else:
            logits = out.to(torch.float32).cpu().numpy()
            for i, (req, *_) in enumerate(items):
                self._complete(req, logits[i], -1, now, completions, metrics)

    def _run_segment(self, k, pend, completions, metrics, now):
        items = [pend[k].popleft()
                 for _ in range(min(len(pend[k]), self.slots))]
        if k == 0:
            for req, *_ in items:
                req.t_start = now             # service starts; wait ends
                if self.tracer.enabled:
                    self.tracer.async_span(
                        'request.queue', req.t_arrival, now,
                        track=f'cohort{req.rid // self.slots}', cid=req.rid,
                        rid=req.rid)
        batch = _gather_rows([(src, idx) for _, src, idx in items],
                             self.slots)
        t0 = time.perf_counter()
        out = _synchronize(self.model.run_stage(k, batch))
        cost = time.perf_counter() - t0
        if self.tracer.enabled:
            self.tracer.add(
                'stage.exec', now, now + cost, track=self._track, stage=k,
                live=len(items), slots=self.slots,
                rids=[r.rid for r, *_ in items])
        now += cost
        metrics.record_batch(k, len(items), self.slots, t=now - cost,
                             cost=cost)
        self._land(k, items, out, now, pend, completions, metrics)
        return now

    def run_trace(self, requests):
        """Serve a whole arrival trace; returns ``({rid: Completion},
        ServingMetrics)``.  Terminates exactly when every request has
        completed (the queue and every stage buffer drained)."""
        queue = RequestQueue(requests)
        pend = [deque() for _ in range(self.n_segs)]
        completions, metrics = {}, ServingMetrics()
        now = queue.next_arrival() or 0.0
        last_depth = None
        while queue or any(pend):
            for r in queue.pop_ready(now, self.slots - len(pend[0])):
                pend[0].append((r, r.x, None))
            depth = len(pend[0]) + queue.n_ready(now)
            if depth != last_depth:
                metrics.record_gauge('queue_depth', now, depth)
                last_depth = depth
            k = self._pick(pend, more_arrivals=bool(queue), now=now)
            if k is None:
                horizons = [queue.next_arrival()]
                if self.max_wait is not None and any(pend):
                    oldest = min(p[0][0].t_arrival for p in pend if p)
                    horizons.append(oldest + self.max_wait)
                now = max(now, min(t for t in horizons if t is not None))
                continue
            now = self._run_segment(k, pend, completions, metrics, now)
        return completions, metrics
