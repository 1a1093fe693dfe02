"""Serving metrics: latency percentiles, throughput, exit mix, occupancy.

A copy of the part of the reference's jax-free module that this slice
uses (the port imports nothing from the JAX package); SLO attainment,
resilience events and per-device occupancy come with the SLO, replica and
placement slices.

One :class:`ServingMetrics` instance rides along with a scheduler run.  The
scheduler reports every completion and every executed batch (stage index
+ live-slot count); ``summary()`` folds them into:

* p50/p99 end-to-end latency, split into **queue-wait** (arrival ->
  service start, ``Completion.t_start``) and **execute** (service start ->
  done) percentiles;
* throughput over the makespan (earliest arrival -> last completion), the
  exit mix, and batch occupancy (the fraction of slots doing useful work,
  the quantity early-exit compaction exists to raise).

Beyond the aggregates, the instance keeps *timestamped* samples —
``(t_done, latency)`` per completion, ``(t, stage, live, slots, cost)``
per batch, and named gauges (``queue_depth``) — and ``timeseries()`` folds
them into fixed-window series; ``telemetry_digest()`` compresses that into
one line.

Percentiles interpolate between order statistics (numpy's 'linear'
definition) so small traces still give stable numbers.
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
    batches: list = field(default_factory=list)   # (stage_idx, live, slots)
    lat_samples: list = field(default_factory=list)   # (t_done, latency)
    batch_samples: list = field(default_factory=list)
    # ^ (t, stage_idx, live, slots, cost)
    gauges: dict = field(default_factory=dict)    # name -> [(t, value)]
    t_first_arrival: float | None = None
    t_last_done: float = 0.0

    def record_completion(self, c) -> None:
        self.latencies.append(c.latency)
        self.lat_samples.append((c.t_done, c.latency))
        self.exit_stages.append(c.exit_stage)
        if c.t_start is not None:
            self.queue_waits.append(c.queue_wait)
            self.executes.append(c.execute)
        if self.t_first_arrival is None or c.t_arrival < self.t_first_arrival:
            self.t_first_arrival = c.t_arrival
        self.t_last_done = max(self.t_last_done, c.t_done)

    def record_batch(self, stage_idx: int, live: int, slots: int, t: float,
                     cost: float) -> None:
        self.batches.append((stage_idx, live, slots))
        self.batch_samples.append((t, stage_idx, live, slots, cost))

    def record_gauge(self, name: str, t: float, value: float) -> None:
        """A sampled time-series value ('queue_depth', ...)."""
        self.gauges.setdefault(name, []).append((t, float(value)))

    def summary(self) -> dict:
        n = len(self.latencies)
        makespan = self.t_last_done - (self.t_first_arrival or 0.0) \
            if n else 0.0
        exited = sum(1 for s in self.exit_stages if s >= 0)
        stages = sorted({s for s, _, _ in self.batches})
        occ = {s: [l for st, l, _ in self.batches if st == s]
               for s in stages}
        slots = {s: next(sl for st, _, sl in self.batches if st == s)
                 for s in stages}
        return {
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
        }

    # ------------------------------------------------------- time series

    def timeseries(self, n_windows: int = 24) -> dict:
        """Fold the timestamped samples into ``n_windows`` equal windows
        over the run (earliest arrival -> last completion).  Empty
        latency/occupancy windows report ``None`` (no samples, not zero);
        gauge windows carry the last known value forward."""
        t0 = self.t_first_arrival or 0.0
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

    def telemetry_digest(self, n_windows: int = 24) -> str:
        """One line for logs: peak queue depth, worst rolling-p99 window,
        per-stage exec share."""
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
        return 'telemetry: ' + ' | '.join(parts)
