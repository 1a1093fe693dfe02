"""Replica-pool scheduler: elastic executors, straggler de-prioritization,
chaos-tested checkpoint-backed failover (the reference's
``serving/replica.py`` over the port's scheduler; each dispatched batch is
synchronized, ``torch.cuda.synchronize()``, where the reference blocks on
its result).

This folds the seed ``runtime/`` ideas into the serving path as one
event-driven scheduler over N *logical replicas* of an exported model:

* **the reference's elastic.py idea** — the pool scales replica count from observed load
  (queued + pending requests over the slot geometry), spinning replicas up
  with a configurable delay and retiring idle ones;
* **straggler.py's monitor** — re-keyed from hosts to replicas: every
  landed batch feeds ``cost / expected_stage_cost`` into the shared
  :class:`~repro_torch.runtime.straggler.StragglerMonitor` EWMA
  (``observe_one``); flagged replicas are de-prioritized for new
  dispatches and, after ``evict_after`` consecutive flags, replaced;
* **ft.py's pattern** — a :class:`ChaosPlan` injects
  :class:`~repro_torch.runtime.SimulatedFailure` kills (a replica dies mid-batch
  or idle) and straggler slowdowns at seeded times.  A killed replica's
  in-flight requests *requeue* — segment-0 requests through
  ``RequestQueue.requeue`` (FIFO by original arrival), deeper ones at the
  front of their pending buffer with their carry intact — and a
  replacement is restored through the caller's ``restore`` hook, normally
  :meth:`~repro_torch.serving.registry.ModelRegistry.restore`, which re-exports
  the model from its persisted chain checkpoint
  (``checkpoint/chain_io.py``).

Bit-exactness under chaos: every completion is computed by a
deterministically-compiled segment on the fixed slot geometry, and a
requeued request re-runs its segment on the SAME carry rows — so answers
are bit-exact vs an undisturbed run (and vs the request-alone monolithic
oracle) no matter how many kills, slowdowns, or requeues happened on the
way.  The resident-export slot-independence contract makes this provable;
``launch/serve_cnn.py --chaos`` and the tests assert it.

The pool runs on the **simulated clock only** (``stage_costs`` required):
one host process cannot execute replicas concurrently for real, but it
can execute their batches eagerly and order completions by simulated
event time — which also makes chaos runs deterministic and the SLO
never-late guarantee exact (a flight's cost, including its replica's
slowdown, is known at dispatch).
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass

import numpy as np

from repro_torch.runtime.ft import SimulatedFailure
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.request import RequestQueue
from repro_torch.serving.scheduler import (ContinuousBatchScheduler,
                                           _gather_rows, _synchronize)


@dataclass(frozen=True)
class ChaosPlan:
    """Seeded failure schedule: ``kills`` are ``(t, replica_id)`` — the
    replica dies at ``t`` (mid-batch if one is in flight); ``replica_id
    None`` kills whichever replica is busy at ``t`` (a real chaos
    harness's "kill a node doing work", preferring one that is not
    already a straggler).  ``slowdowns`` are ``(t, replica_id, factor)``
    — from ``t`` on, the replica's batches cost ``factor``x the measured
    stage cost (a straggler)."""
    kills: tuple = ()
    slowdowns: tuple = ()

    @classmethod
    def seeded(cls, seed: int, n_replicas: int, horizon: float, *,
               n_kills: int = 1, n_slowdowns: int = 1,
               factor_range=(2.5, 4.0)) -> 'ChaosPlan':
        """A reproducible plan over the trace: busy-replica kills late in
        the arrival window (the backlog is deepest there, so every
        replica has work in flight), slowdowns on a concrete replica
        early (so the straggler lands slow batches — and gets flagged —
        well before the kill)."""
        rng = np.random.default_rng(seed)
        kills = tuple(
            (float(rng.uniform(0.6, 0.9) * horizon), None)
            for _ in range(n_kills))
        slowdowns = tuple(
            (float(rng.uniform(0.05, 0.3) * horizon),
             int(rng.integers(n_replicas)),
             float(rng.uniform(*factor_range)))
            for _ in range(n_slowdowns))
        return cls(kills=kills, slowdowns=slowdowns)

    def slow_factor(self, rid: int, now: float) -> float:
        """The replica's current slowdown (max over active events; 1.0 =
        healthy)."""
        return max([f for t, r, f in self.slowdowns
                    if r == rid and now >= t], default=1.0)


@dataclass
class _Replica:
    rid: int
    model: object
    free_at: float = 0.0
    alive: bool = True
    n_batches: int = 0


@dataclass
class _Flight:
    """One dispatched segment batch: executed eagerly, lands at ``t_end``
    on the simulated clock — unless a kill fires first (``t_kill``), in
    which case the output is discarded and the items requeue."""
    seq: int
    replica: _Replica
    k: int
    items: list
    out: object
    t_start: float
    t_end: float
    t_kill: float | None = None

    @property
    def t_land(self) -> float:
        return self.t_end if self.t_kill is None else self.t_kill


class ReplicaPoolScheduler(ContinuousBatchScheduler):
    """See the module docstring.  Inherits the pending-buffer layout,
    landing logic, exit rule, and SLO hooks from
    :class:`~repro_torch.serving.scheduler.ContinuousBatchScheduler`."""

    def __init__(self, model, *, slots=32, threshold=None, stage_costs=None,
                 max_wait=None, slo=None, replicas=2, min_replicas=1,
                 max_replicas=8, spinup=0.0, restore=None,
                 restore_delay=0.0, chaos=None, straggler_threshold=1.5,
                 evict_after=10 ** 9, tracer=None):
        if stage_costs is None:
            raise ValueError(
                'ReplicaPoolScheduler needs stage_costs: the pool is '
                'event-driven on the simulated clock (one host process '
                'cannot run N replicas concurrently for real)')
        super().__init__(model, slots=slots, threshold=threshold,
                         stage_costs=stage_costs, max_wait=max_wait,
                         slo=slo, tracer=tracer)
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError('need 1 <= min_replicas <= max_replicas')
        self.stage_costs = [float(c) for c in stage_costs]
        self.n_init = max(min_replicas, min(replicas, max_replicas))
        self.min_replicas, self.max_replicas = min_replicas, max_replicas
        self.spinup = spinup
        self.restore = restore or (lambda: model)
        self.restore_delay = restore_delay
        self.chaos = chaos or ChaosPlan()
        self.monitor = StragglerMonitor(n_hosts=1,
                                        threshold=straggler_threshold,
                                        evict_after=evict_after)

    # ------------------------------------------------------------ pool ops

    def _spawn(self, model, now, delay=0.0):
        r = _Replica(rid=self._next_rid, model=model,
                     free_at=now + delay)
        self._next_rid += 1
        self.pool.append(r)
        return r

    def _live(self):
        return [r for r in self.pool if r.alive]

    def _failover(self, dead, t, metrics, reason):
        """Replace a dead replica from the chain checkpoint (``restore``
        hook); the replacement joins after ``restore_delay``."""
        dead.alive = False
        repl = self._spawn(self.restore(), t, self.restore_delay)
        metrics.record_event('failover', t, replica=repl.rid,
                             replaced=dead.rid, reason=reason,
                             n_replicas=len(self._live()))
        if self.tracer.enabled:
            self.tracer.add('failover.restore', t, t + self.restore_delay,
                            track=f'replica{repl.rid}',
                            replaced=dead.rid, reason=reason)
        return repl

    def _consume_kills(self, now, flights, metrics):
        """Fire kill events due by ``now``.  A replica with a batch in
        flight dies mid-batch (the flight is marked killed and lands at
        the kill time, requeueing its requests); an idle replica just
        dies.  Either way a replacement is restored from checkpoint."""
        remaining = []
        for t, rid in self._kills:
            if t > now:
                remaining.append((t, rid))
                continue
            if rid is None:                # kill a busy replica: prefer
                busy = sorted(             # one not already slowed
                    (f for f in flights if f.t_kill is None
                     and f.replica.alive and f.t_start <= t < f.t_end),
                    key=lambda f: (self.chaos.slow_factor(
                        f.replica.rid, t) > 1.0, f.replica.rid))
                victim = (busy[0].replica if busy
                          else next(iter(self._live()), None))
            else:
                victim = next((r for r in self.pool
                               if r.rid == rid and r.alive), None)
            if victim is None:             # already dead: consume, ignore
                continue
            rid = victim.rid
            fail = SimulatedFailure(f'replica {rid} lost at t={t:.6f}')
            inflight = next((f for f in flights
                             if f.replica is victim and f.t_kill is None
                             and f.t_start <= t < f.t_end), None)
            if inflight is not None:
                inflight.t_kill = t        # lands as a kill, not a result
            metrics.record_event('kill', t, replica=rid,
                                 mid_batch=inflight is not None,
                                 reason=repr(fail))
            if self.tracer.enabled:
                self.tracer.instant('kill', t, track=f'replica{rid}',
                                    mid_batch=inflight is not None)
            self._failover(victim, t, metrics, reason=repr(fail))
        self._kills = remaining

    def _scale(self, pend, queue, flights, now, metrics):
        """elastic.py's idea at request level: target replica count from
        the work in the system (queued-and-arrived + pending + in flight)
        over the slot geometry."""
        backlog = sum(len(b) for b in pend) + queue.n_ready(now) \
            + sum(len(f.items) for f in flights)
        target = min(self.max_replicas,
                     max(self.min_replicas,
                         math.ceil(backlog / self.slots)))
        live = self._live()
        while len(live) < target:
            r = self._spawn(self.model, now, self.spinup)
            live.append(r)
            metrics.record_event('scale_up', now, replica=r.rid,
                                 n_replicas=len(live), backlog=backlog)
        idle = [r for r in live if r.free_at <= now]
        # retire idle replicas beyond the target: stragglers first, then
        # newest — the provisioned baseline replicas stay stable
        idle.sort(key=lambda r: (not self.monitor.flagged(r.rid), -r.rid))
        while len(live) > max(target, self.min_replicas) and idle:
            r = idle.pop(0)
            r.alive = False
            live.remove(r)
            metrics.record_event('scale_down', now, replica=r.rid,
                                 n_replicas=len(live), backlog=backlog)

    # ----------------------------------------------------------- dispatch

    def _dispatch(self, replica, k, pend, metrics, now):
        """Pop a segment-``k`` batch, execute it eagerly on ``replica``'s
        model, and put the result in flight until ``now + cost`` (cost
        scaled by the replica's current chaos slowdown)."""
        items = [pend[k].popleft()
                 for _ in range(min(len(pend[k]), self.slots))]
        if k == 0:
            for req, *_ in items:
                req.t_start = now
            if self.tracer.enabled:
                self._trace_dispatch(items, now)
        batch = _gather_rows([(src, idx) for _, src, idx, *_ in items],
                             self.slots)
        out = _synchronize(replica.model.run_stage(k, batch))
        slow = self.chaos.slow_factor(replica.rid, now)
        cost = self.stage_costs[k] * slow
        fl = _Flight(seq=self._seq, replica=replica, k=k, items=items,
                     out=out, t_start=now, t_end=now + cost)
        self._seq += 1
        replica.free_at = fl.t_end
        replica.n_batches += 1
        return fl

    def _land_flight(self, fl, pend, queue, completions, metrics):
        """A flight reaches its land time: killed flights requeue their
        requests (carry intact — the re-run is bit-exact); successful
        flights complete/promote exactly like the single-executor path,
        then feed the straggler monitor."""
        t = fl.t_land
        track = f'replica{fl.replica.rid}'
        if fl.t_kill is not None:
            if self.tracer.enabled:    # the truncated execution: no result
                self.tracer.add('stage.exec', fl.t_start, t, track=track,
                                stage=fl.k, live=len(fl.items),
                                slots=self.slots, killed=True,
                                rids=[it[0].rid for it in fl.items])
            for item in reversed(fl.items):
                req = item[0]
                if fl.k == 0:
                    req.t_start = None     # service restarts from scratch
                    req.t_enqueued = t     # next queue span opens here
                    queue.requeue(req)
                else:
                    pend[fl.k].appendleft(item)
            return
        if self.tracer.enabled:
            self.tracer.add('stage.exec', fl.t_start, fl.t_end, track=track,
                            stage=fl.k, live=len(fl.items),
                            slots=self.slots,
                            rids=[it[0].rid for it in fl.items])
        metrics.record_batch(fl.k, len(fl.items), self.slots,
                             t=fl.t_start, cost=fl.t_end - fl.t_start)
        self._land(fl.k, fl.items, fl.out, t, pend, completions, metrics,
                   track=track)
        expected = self.stage_costs[fl.k]
        ratio = (fl.t_end - fl.t_start) / max(expected, 1e-12)
        for action, rid in self.monitor.observe_one(fl.replica.rid, ratio):
            if action == 'flag':
                metrics.record_event('straggler_flag', t, replica=rid,
                                     ratio=round(ratio, 3))
            elif action == 'evict' and fl.replica.alive:
                fl.replica.alive = False
                repl = self._spawn(self.model, t, self.spinup)
                metrics.record_event('evict', t, replica=rid,
                                     replaced_by=repl.rid,
                                     n_replicas=len(self._live()))

    def _pool_degrade(self, pend, now, horizon, completions, metrics):
        """SLO sweep before the clock advances to ``horizon``: any pending
        deadline that could not be served even by starting at ``horizon``
        resolves NOW (degraded past segment 0, rejected at segment 0) —
        at ``now``, which is still within its budget."""
        charge = horizon - now
        for j, buf in enumerate(pend):
            kept = deque()
            for item in buf:
                req = item[0]
                if req.deadline is None or self.slo.affordable(
                        req.deadline, now, j, charge, in_batch=False):
                    kept.append(item)
                elif j == 0:
                    self.slo.n_rejected += 1
                    metrics.record_rejection(req.rid, now, 'missed',
                                             t_arrival=req.t_arrival)
                else:
                    self.slo.n_degraded += 1
                    self._complete(req, item[4], item[3], now, completions,
                                   metrics, degraded=True)
            buf.clear()
            buf.extend(kept)

    def _dispatch_filter(self, k, pend, now, cost, completions, metrics):
        """Pre-dispatch SLO filter on the batch about to fly: an item that
        would land past its deadline (exact — the flight cost, slowdown
        included, is known) degrades/rejects instead of flying."""
        kept = deque()
        for item in pend[k]:
            req = item[0]
            if req.deadline is None or len(kept) >= self.slots or \
                    self.slo.affordable(req.deadline, now, k, cost,
                                        in_batch=True):
                kept.append(item)
            elif k == 0:
                self.slo.n_rejected += 1
                metrics.record_rejection(req.rid, now, 'missed',
                                         t_arrival=req.t_arrival)
            else:
                self.slo.n_degraded += 1
                self._complete(req, item[4], item[3], now, completions,
                               metrics, degraded=True)
        pend[k].clear()
        pend[k].extend(kept)

    # ---------------------------------------------------------- event loop

    def run_trace(self, requests):
        """Event-driven serve of a whole arrival trace over the pool;
        returns ``({rid: Completion}, ServingMetrics)``."""
        queue = RequestQueue(requests)
        pend = [deque() for _ in range(self.n_segs)]
        completions, metrics = {}, ServingMetrics()
        self.pool, self._next_rid, self._seq = [], 0, 0
        self._last_depth = None
        self._kills = sorted(self.chaos.kills)
        flights = []
        now = queue.next_arrival() or 0.0
        for _ in range(self.n_init):
            self._spawn(self.model, now)
        metrics.record_event('pool_start', now,
                             n_replicas=len(self._live()))

        while queue or any(pend) or flights:
            self._consume_kills(now, flights, metrics)
            # land due flights in event order (kills land at t_kill)
            due = sorted((f for f in flights if f.t_land <= now),
                         key=lambda f: (f.t_land, f.seq))
            for fl in due:
                flights.remove(fl)
                self._land_flight(fl, pend, queue, completions, metrics)
            if not (queue or any(pend) or flights):
                break                      # landing drained the last work
            # admit arrivals up to the pool's buffering capacity
            cap = self.slots * max(len(self._live()), 1) - len(pend[0])
            for r in queue.pop_ready(now, max(cap, 0)):
                if self._admit(r, now, pend, metrics):
                    pend[0].append((r, r.x, None, None, None))
            depth = len(pend[0]) + queue.n_ready(now)
            if depth != getattr(self, '_last_depth', None):
                metrics.record_gauge('queue_depth', now, depth)
                self._last_depth = depth
            self._scale(pend, queue, flights, now, metrics)
            # dispatch: healthy free replicas first, stragglers last
            free = sorted((r for r in self._live() if r.free_at <= now),
                          key=lambda r: (self.monitor.flagged(r.rid),
                                         r.rid))
            dispatched = False
            for replica in free:
                more = bool(queue) or bool(flights)
                k = self._pick(pend, more_arrivals=more, now=now)
                if self.slo is not None:
                    urgent = self.slo.urgent_segment(pend, now)
                    if urgent is not None:
                        k = urgent
                if k is None:
                    break
                if self.slo is not None:
                    cost = self.stage_costs[k] * self.chaos.slow_factor(
                        replica.rid, now)
                    self._dispatch_filter(k, pend, now, cost, completions,
                                          metrics)
                    if not pend[k]:
                        continue
                flights.append(self._dispatch(replica, k, pend, metrics,
                                              now))
                dispatched = True
            if dispatched:
                continue                   # new flights may land instantly
            # idle: advance to the next event
            horizons = [f.t_land for f in flights]
            horizons += [t for t, _ in self._kills]
            nxt = queue.next_arrival()
            if nxt is not None:
                horizons.append(nxt)
            if any(pend):
                horizons += [r.free_at for r in self._live()
                             if r.free_at > now]
                if self.max_wait is not None:
                    oldest = min(p[0][0].t_arrival for p in pend if p)
                    horizons.append(oldest + self.max_wait)
            if self.slo is not None:
                wake = self.slo.wake(pend, now)
                if wake is not None:
                    horizons.append(wake)
            horizons = [h for h in horizons if h > now]
            if not horizons:
                raise RuntimeError(
                    'replica pool stalled: pending work but no future '
                    'event (this is a scheduler bug); '
                    f'now={now} pend={[len(b) for b in pend]} '
                    f'queue={len(queue)} flights={len(flights)} '
                    f'live={[(r.rid, r.free_at) for r in self._live()]}')
            horizon = min(horizons)
            if self.slo is not None:
                self._pool_degrade(pend, now, horizon, completions,
                                   metrics)
            now = horizon
        return completions, metrics
