"""Straggler detection + mitigation hooks (a copy of the reference's
jax-free ``runtime/straggler.py``).

On a synchronous SPMD fleet a straggling host delays every step (the
collectives act as barriers).  Mitigation implemented here:

  * detection — EWMA of per-step wall time with a multiplicative threshold;
  * data reassignment — because the input pipeline is deterministic in
    (step, host_id), a slow host's shard can be re-mapped to a hot spare by
    permuting host_ids (no data loss, no resharding);
  * escalation — after ``evict_after`` consecutive flags the host is
    reported for eviction, which triggers the elastic path
    (runtime/elastic.py) on the next restart.

On-device timing comes from the launcher; in tests times are injected.

The serving replica pool (repro_torch/serving/replica.py) re-keys the monitor to
*replicas*: hosts are replica ids and the observed quantity is each
batch's cost normalized by the expected stage cost (healthy ~1.0), fed one
at a time through :meth:`StragglerMonitor.observe_one` as batches land —
a flagged replica is de-prioritized for new dispatches and, after
``evict_after`` consecutive flags, replaced through the failover path.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class StragglerMonitor:
    n_hosts: int
    threshold: float = 1.5          # x EWMA before a host is flagged
    alpha: float = 0.2
    evict_after: int = 3
    ewma: float | None = field(default=None, init=False)
    flags: dict = field(default_factory=dict, init=False)
    host_map: list = field(default=None, init=False)    # logical -> physical
    spares: list = field(default_factory=list)

    def __post_init__(self):
        self.host_map = list(range(self.n_hosts))

    def observe(self, host_times: dict[int, float]):
        """Feed per-host step times; returns list of mitigation actions."""
        actions = []
        mean = sum(host_times.values()) / len(host_times)
        self.ewma = mean if self.ewma is None else \
            (1 - self.alpha) * self.ewma + self.alpha * mean
        for h, t in host_times.items():
            if t > self.threshold * self.ewma:
                self.flags[h] = self.flags.get(h, 0) + 1
                if self.spares:
                    spare = self.spares.pop(0)
                    idx = self.host_map.index(h)
                    self.host_map[idx] = spare
                    actions.append(('reassign', h, spare))
                if self.flags[h] >= self.evict_after:
                    actions.append(('evict', h))
            else:
                self.flags.pop(h, None)
        return actions

    def observe_one(self, host: int, t: float):
        """Feed ONE host's observation (the serving pool's re-keying:
        batches land one at a time, ``t`` is the batch cost normalized by
        the expected stage cost).  Updates the fleet EWMA and this host's
        flag count; returns mitigation actions — ``('flag', host)`` on
        each threshold crossing and ``('evict', host)`` after
        ``evict_after`` consecutive ones.  Hosts need not be < n_hosts
        (replica ids grow as the pool fails over); the host_map/spares
        machinery is untouched."""
        actions = []
        self.ewma = t if self.ewma is None else \
            (1 - self.alpha) * self.ewma + self.alpha * t
        if t > self.threshold * self.ewma:
            self.flags[host] = self.flags.get(host, 0) + 1
            actions.append(('flag', host))
            if self.flags[host] >= self.evict_after:
                actions.append(('evict', host))
        else:
            self.flags.pop(host, None)
        return actions

    def flagged(self, host: int) -> bool:
        """Is ``host`` currently flagged as a straggler?"""
        return self.flags.get(host, 0) > 0

    def data_host_id(self, logical_host: int) -> int:
        """Physical host currently serving a logical data shard."""
        return self.host_map[logical_host]
