"""Serving metrics: latency percentiles, throughput, exit mix, occupancy,
SLO attainment, and resilience events (a copy of the reference's jax-free
``serving/metrics.py``; the port imports nothing from the JAX package).

One :class:`ServingMetrics` instance rides along with a scheduler run.  The
scheduler reports every completion, every executed batch (stage index +
live-slot count), every SLO rejection, and — on the replica pool — every
resilience event (replica kill, failover, straggler flag, scale up/down);
``summary()`` folds them into the numbers the benchmarks record:

* p50/p99 end-to-end latency, split into **queue-wait** (arrival ->
  service start, ``Completion.t_start``) and **execute** (service start ->
  done) percentiles;
* throughput over the makespan and batch occupancy (the fraction of slots
  doing useful work, the quantity early-exit compaction exists to raise);
* **availability** (completions / offered requests — 1.0 means zero lost
  even under chaos), **SLO attainment** (on-time completions over all
  deadline-carrying requests, rejected included), the **degraded-exit
  mix** (requests the SLO layer force-exited at an earlier head), and
  ``n_late`` — by the never-late contract this must be 0;
* resilience counters: ``failovers``, ``kills``, ``straggler_flags``,
  ``scale_ups``/``scale_downs``, peak replica count.

Beyond the aggregates, the instance keeps *timestamped* samples —
``(t_done, latency)`` per completion, ``(t, stage, live, slots, cost)``
per batch, and named gauges (``queue_depth``, ``replicas``) — and
``timeseries()`` folds them into fixed-window series (queue depth
mean/peak, rolling p99 latency, occupancy, replica count, per-stage exec
share) recorded into the BENCH JSONs; ``telemetry_digest()`` compresses
that into the one-liner the benchmarks print.

Makespan starts at the earliest *offered* arrival (completions AND
SLO rejections — ``record_rejection`` takes the request's ``t_arrival``),
so a run whose earliest arrivals are all rejected does not report an
inflated throughput.

Percentiles interpolate between order statistics (numpy's 'linear'
definition) so small smoke traces still give stable numbers.
"""
from __future__ import annotations

from dataclasses import dataclass, field


def percentile(values, q: float) -> float:
    """Linear-interpolated percentile of ``values`` (q in [0, 100])."""
    xs = sorted(float(v) for v in values)
    if not xs:
        return 0.0
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


@dataclass
class ServingMetrics:
    """Accumulates per-completion and per-batch records for one run."""
    latencies: list = field(default_factory=list)
    queue_waits: list = field(default_factory=list)
    executes: list = field(default_factory=list)
    exit_stages: list = field(default_factory=list)
    degraded_stages: list = field(default_factory=list)
    batches: list = field(default_factory=list)   # (stage_idx, live, slots)
    rejections: list = field(default_factory=list)  # (rid, t, reason)
    events: list = field(default_factory=list)    # (kind, t, info)
    lat_samples: list = field(default_factory=list)   # (t_done, latency)
    batch_samples: list = field(default_factory=list)
    # ^ (t, stage_idx, live, slots, cost) — only when the scheduler passes t
    gauges: dict = field(default_factory=dict)    # name -> [(t, value)]
    device_samples: list = field(default_factory=list)  # (t, cost, device)
    n_deadline: int = 0
    n_on_time: int = 0
    n_late: int = 0
    t_first_arrival: float | None = None
    t_first_offered: float | None = None          # completions + rejections
    t_last_done: float = 0.0

    def _offer(self, t_arrival: float) -> None:
        if self.t_first_offered is None or t_arrival < self.t_first_offered:
            self.t_first_offered = t_arrival

    def record_completion(self, c) -> None:
        self.latencies.append(c.latency)
        self.lat_samples.append((c.t_done, c.latency))
        self.exit_stages.append(c.exit_stage)
        if c.degraded:
            self.degraded_stages.append(c.exit_stage)
        if c.t_start is not None:
            self.queue_waits.append(c.queue_wait)
            self.executes.append(c.execute)
        if c.deadline is not None:
            self.n_deadline += 1
            if c.on_time:
                self.n_on_time += 1
            else:
                self.n_late += 1
        if self.t_first_arrival is None or c.t_arrival < self.t_first_arrival:
            self.t_first_arrival = c.t_arrival
        self._offer(c.t_arrival)
        self.t_last_done = max(self.t_last_done, c.t_done)

    def record_batch(self, stage_idx: int, live: int, slots: int,
                     t: float | None = None,
                     cost: float | None = None,
                     device: int | None = None) -> None:
        """``device`` (the pipeline scheduler passes its device ordinal)
        additionally feeds the per-device busy series behind
        :meth:`device_occupancy`."""
        self.batches.append((stage_idx, live, slots))
        if t is not None:
            self.batch_samples.append((t, stage_idx, live, slots,
                                       0.0 if cost is None else cost))
            if device is not None:
                self.device_samples.append((t, 0.0 if cost is None
                                            else cost, device))

    def record_rejection(self, rid: int, t: float, reason: str,
                         t_arrival: float | None = None) -> None:
        """An SLO-rejected request: counted, never served late.  Pass the
        request's ``t_arrival`` so the makespan covers offered load even
        when the earliest arrivals were all rejected."""
        self.rejections.append((rid, t, reason))
        self._offer(t if t_arrival is None else t_arrival)

    def record_gauge(self, name: str, t: float, value: float) -> None:
        """A sampled time-series value ('queue_depth', 'replicas', ...)."""
        self.gauges.setdefault(name, []).append((t, float(value)))

    def record_event(self, kind: str, t: float, **info) -> None:
        """A resilience event from the replica pool: 'kill', 'failover',
        'straggler_flag', 'scale_up', 'scale_down', 'evict'.  Events that
        carry ``n_replicas`` also sample the 'replicas' gauge, so replica
        count over time falls out of the existing event stream."""
        self.events.append((kind, t, info))
        if 'n_replicas' in info:
            self.record_gauge('replicas', t, info['n_replicas'])

    def _count_events(self, kind: str) -> int:
        return sum(1 for k, _, _ in self.events if k == kind)

    def summary(self) -> dict:
        n = len(self.latencies)
        offered = n + len(self.rejections)
        first = (self.t_first_offered if self.t_first_offered is not None
                 else self.t_first_arrival)
        makespan = self.t_last_done - (first or 0.0) if n else 0.0
        exited = sum(1 for s in self.exit_stages if s >= 0)
        stages = sorted({s for s, _, _ in self.batches})
        occ = {s: [l for st, l, _ in self.batches if st == s]
               for s in stages}
        slots = {s: next(sl for st, _, sl in self.batches if st == s)
                 for s in stages}
        out = {
            'n_requests': n,
            'p50_latency_s': round(percentile(self.latencies, 50), 6),
            'p99_latency_s': round(percentile(self.latencies, 99), 6),
            'p50_queue_wait_s': round(percentile(self.queue_waits, 50), 6),
            'p99_queue_wait_s': round(percentile(self.queue_waits, 99), 6),
            'p50_execute_s': round(percentile(self.executes, 50), 6),
            'p99_execute_s': round(percentile(self.executes, 99), 6),
            'throughput_rps': round(n / makespan, 3) if makespan > 0 else 0.0,
            'exit_fraction': round(exited / n, 4) if n else 0.0,
            'exit_mix': {str(s): self.exit_stages.count(s)
                         for s in sorted(set(self.exit_stages))},
            'n_batches': {str(s): len(occ[s]) for s in stages},
            'batch_occupancy': {
                str(s): round(sum(occ[s]) / (len(occ[s]) * slots[s]), 4)
                for s in stages if occ[s]},
            'availability': round(n / offered, 4) if offered else 0.0,
            'n_rejected': len(self.rejections),
            'n_degraded': len(self.degraded_stages),
            'degraded_exit_mix': {
                str(s): self.degraded_stages.count(s)
                for s in sorted(set(self.degraded_stages))},
        }
        if self.n_deadline or self.rejections:
            denom = self.n_deadline + len(self.rejections)
            out['slo'] = {
                'n_with_deadline': denom,
                'n_on_time': self.n_on_time,
                'n_late': self.n_late,
                'attainment': round(self.n_on_time / denom, 4)
                if denom else 0.0,
            }
        if self.events:
            out['resilience'] = {
                'kills': self._count_events('kill'),
                'failovers': self._count_events('failover'),
                'straggler_flags': self._count_events('straggler_flag'),
                'evictions': self._count_events('evict'),
                'scale_ups': self._count_events('scale_up'),
                'scale_downs': self._count_events('scale_down'),
                'peak_replicas': max(
                    (i.get('n_replicas', 0) for _, _, i in self.events),
                    default=0),
            }
        return out

    # ------------------------------------------------------- time series

    def timeseries(self, n_windows: int = 24) -> dict:
        """Fold the timestamped samples into ``n_windows`` equal windows
        over the run (earliest offered arrival -> last completion).
        Empty latency/occupancy windows report ``None`` (no samples, not
        zero); gauge windows carry the last known value forward."""
        t0 = (self.t_first_offered if self.t_first_offered is not None
              else (self.t_first_arrival or 0.0))
        t1 = self.t_last_done
        if t1 <= t0 or not (self.lat_samples or self.batch_samples):
            return {}
        w = (t1 - t0) / n_windows

        def bucket(t):
            return min(n_windows - 1, max(0, int((t - t0) / w)))

        lat_bins = [[] for _ in range(n_windows)]
        for t, lat in self.lat_samples:
            lat_bins[bucket(t)].append(lat)
        rolling_p99 = [round(percentile(b, 99), 6) if b else None
                       for b in lat_bins]
        occ_bins = [[] for _ in range(n_windows)]
        stage_cost: dict[int, float] = {}
        for t, stage, live, slots, cost in self.batch_samples:
            occ_bins[bucket(t)].append(live / slots)
            stage_cost[stage] = stage_cost.get(stage, 0.0) + cost
        occupancy = [round(sum(b) / len(b), 4) if b else None
                     for b in occ_bins]
        total_cost = sum(stage_cost.values())
        exec_share = {str(s): round(c / total_cost, 4)
                      for s, c in sorted(stage_cost.items())} \
            if total_cost > 0 else {}
        out = {
            'n_windows': n_windows,
            'window_s': round(w, 6),
            't0': round(t0, 6),
            'completions': [len(b) for b in lat_bins],
            'rolling_p99_s': rolling_p99,
            'occupancy': occupancy,
            'stage_exec_share': exec_share,
        }
        for name, samples in sorted(self.gauges.items()):
            mean_bins = [[] for _ in range(n_windows)]
            peak = [None] * n_windows
            for t, v in samples:
                b = bucket(t)
                mean_bins[b].append(v)
                peak[b] = v if peak[b] is None else max(peak[b], v)
            last = None                    # carry forward through gaps
            for i in range(n_windows):
                if mean_bins[i]:
                    last = mean_bins[i][-1]
                elif last is not None:
                    peak[i] = last
            out[name] = {
                'mean': [round(sum(b) / len(b), 3) if b
                         else peak[i] for i, b in enumerate(mean_bins)],
                'peak': peak,
                'overall_peak': max((v for _, v in samples), default=0.0),
            }
        worst = [(p, i) for i, p in enumerate(rolling_p99) if p is not None]
        if worst:
            p, i = max(worst)
            out['worst_p99_window'] = {
                'p99_s': p,
                't_start': round(t0 + i * w, 6),
                't_end': round(t0 + (i + 1) * w, 6),
            }
        return out

    def device_occupancy(self, n_windows: int = 24) -> dict:
        """Per-device busy-fraction time series over the run window.

        Each executed batch the scheduler tagged with a ``device``
        contributes its ``[t, t + cost)`` interval to that device's busy
        time; every window reports ``busy / window`` per device (a device
        saturating a window reads 1.0).  Empty unless the scheduler
        records device ordinals (the pipeline scheduler does)."""
        if not self.device_samples:
            return {}
        t0 = (self.t_first_offered if self.t_first_offered is not None
              else (self.t_first_arrival or 0.0))
        t1 = max(self.t_last_done,
                 max(t + c for t, c, _ in self.device_samples))
        if t1 <= t0:
            return {}
        w = (t1 - t0) / n_windows
        devices = sorted({d for _, _, d in self.device_samples})
        busy = {d: [0.0] * n_windows for d in devices}
        for t, cost, d in self.device_samples:
            a, b = t, t + cost
            i0 = max(0, int((a - t0) / w))
            i1 = min(n_windows - 1, int((b - t0) / w))
            for i in range(i0, i1 + 1):
                lo, hi = t0 + i * w, t0 + (i + 1) * w
                overlap = min(b, hi) - max(a, lo)
                if overlap > 0:
                    busy[d][i] += overlap
        return {str(d): [round(v / w, 4) for v in busy[d]]
                for d in devices}

    def telemetry_digest(self, n_windows: int = 24) -> str:
        """One line for benchmark logs: peak queue depth, worst rolling-p99
        window, per-stage exec share."""
        ts = self.timeseries(n_windows)
        if not ts:
            return 'telemetry: no timestamped samples'
        parts = []
        depth = ts.get('queue_depth')
        if depth:
            parts.append(f"peak queue depth {depth['overall_peak']:.0f}")
        worst = ts.get('worst_p99_window')
        if worst:
            parts.append(
                f"worst p99 {worst['p99_s'] * 1e3:.2f}ms in "
                f"[{worst['t_start']:.3f}s, {worst['t_end']:.3f}s)")
        if ts['stage_exec_share']:
            share = ' '.join(f's{k}={v:.0%}'
                             for k, v in ts['stage_exec_share'].items())
            parts.append(f'exec share {share}')
        reps = ts.get('replicas')
        if reps:
            parts.append(f"peak replicas {reps['overall_peak']:.0f}")
        return 'telemetry: ' + ' | '.join(parts)
