"""Pipeline-parallel placement: pack model stages onto devices, serve them
(the reference's ``serving/placement.py`` on torch devices).

Two layers live here:

1. **The placement solver** (:func:`solve_placement`) — a pure function
   from measured per-stage batch costs and a device count to a
   :class:`Placement`: every ``(model, stage)`` pair of every chain gets
   exactly one device.  The baseline is greedy **LPT** (longest
   processing time first): stages sorted by cost descending, each
   assigned to the least-loaded device.  The report carries the classic
   guarantees alongside the achieved loads:

   * ``guarantee`` — the sound greedy bound ``total/M + c_max``: the
     achieved ``max_load`` NEVER exceeds it;
   * ``opt_lower`` — a lower bound on the optimal makespan,
     ``max(total/M, c_max, c_(M) + c_(M+1))`` (some device must run two
     of the M+1 largest stages);
   * ``bound`` — ``(4/3 - 1/(3M)) * opt_lower``, the LPT competitive
     ratio applied to the OPT lower bound; ``balance = max_load /
     opt_lower`` then brackets how far from optimal the packing can be.

   N registered chains pack onto M devices through the same call —
   ``ModelRegistry.plan_placement`` feeds it every model's measured
   costs at its own slot geometry.

2. **The pipeline-parallel scheduler**
   (:class:`PipelineParallelScheduler`) — the continuous-batching
   scheduler's pending-buffer/landing machinery run event-driven over M
   device *ordinals*: stage *k* executes on its placed device
   (``ServingModel.place_stages`` puts a params copy on each distinct
   device), and the int8 :class:`~repro_torch.core.export.QAct` carry
   moves to the consuming stage's device with ``tensor.to(dev)`` at every
   stage boundary.  A hop between two ordinals is a ``transfer.carry``
   span on the destination ordinal's trace track, charged
   ``transfer_frac`` of the consuming stage's cost on the simulated
   clock.  Each segment is synchronized (``torch.cuda.synchronize(dev)``
   on a card) before it is put in flight, where the reference blocks on
   its result.

   **Never-idle dispatch rule**: a device with pending work for any of
   its stages never waits — a device finishing stage *k* for cohort A
   immediately starts stage *k* for cohort B (deepest assigned stage
   first).  The single exception is stage 0, which may wait to fill a
   batch while arrivals are still coming (``max_wait`` bounds the
   aging), exactly like the single-device scheduler.

   ``compact=True`` is the continuous mode: survivors from any cohort
   merge into the next stage's pending buffer (freed slots backfill).
   ``compact=False`` is the static-cohort mode: a batch formed at stage
   0 travels as a unit — exited rows complete but their slots ride
   empty, never backfilled.

   Chaos: a :class:`~repro_torch.serving.replica.ChaosPlan` kills a
   *device* at a seeded time — its in-flight batch is discarded and the
   items requeue (segment-0 by original arrival through
   ``RequestQueue.requeue``, deeper ones at the front of their pending
   buffer with their carry intact), the device leaves the pool, and the
   placement is re-solved over the survivors (deterministic: same
   solver, same seed).  With one device left a kill is recorded as
   ``kill_skipped``.  Slot independence at fixed geometry makes every
   completion bit-exact against the monolithic ``fn_exits`` path no
   matter how requests were cohorted, transferred or requeued.

Departures from the reference, forced by torch's devices:

* **Ordinals are tracked, not read.**  The reference reads the device a
  carry is committed to (``_ordinal_of``).  A torch tensor on ``cpu`` or
  ``cuda:0`` cannot tell two ordinals apart when they share one physical
  device, which they do on the CPU and on a one-card host.  So the
  scheduler records, for each carry a flight returns, the ordinal of
  that flight (:meth:`PipelineParallelScheduler._ordinal_of` looks it
  up; stage-0 inputs have none).  On distinct devices this gives the
  reference's ``src_devs``.
* **Devices on one controller.**  :func:`pipeline_devices` gives
  ``cuda:i`` for each card and raises without one; CPU callers pass the
  scheduler ``devices=`` (e.g. ``('cpu',) * 8``).  Given a
  ``DeviceMesh`` it returns the device of each rank of the mesh's
  model-index-0 slice.
* **``max_wait``** is tested as ``t_arrival + max_wait <= now``, the
  float sum the event loop advances to, as in the port's single-device
  scheduler (the reference's ``now - t_arrival >= max_wait`` can round
  the other way and stall at that horizon).

Like the replica pool, the scheduler runs on the **simulated clock only**
(``stage_costs`` required): one host process cannot execute M devices
concurrently for real, but it can execute their batches eagerly and
order landings by simulated event time — which also makes chaos runs
deterministic.
"""
from __future__ import annotations

import math
import random
from collections import deque
from collections.abc import Mapping
from dataclasses import dataclass
from functools import cached_property

import torch

from repro_torch.core.export import QAct
from repro_torch.launch.mesh import data_axes
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.replica import ChaosPlan
from repro_torch.serving.request import RequestQueue
from repro_torch.serving.scheduler import (ContinuousBatchScheduler,
                                           _gather_rows)

#: key used when ``solve_placement`` is handed a bare cost sequence
DEFAULT_MODEL = 'model'


def lpt_ratio(n_devices: int) -> float:
    """LPT's competitive ratio on ``n_devices`` identical machines:
    ``max_load <= (4/3 - 1/(3M)) * OPT`` (Graham 1969)."""
    return 4.0 / 3.0 - 1.0 / (3.0 * n_devices)


def _rank_device(device_type: str, rank: int) -> torch.device:
    """The device a rank of this host drives: card ``rank`` modulo the
    cards of the host (as ``LOCAL_RANK`` picks it), else the CPU."""
    if device_type == 'cuda':
        return torch.device('cuda', rank % torch.cuda.device_count())
    return torch.device(device_type)


def pipeline_ranks(mesh) -> tuple:
    """The ranks of ``mesh``'s model-index-0 slice, flattened in
    ``data_axes`` order: the ranks :func:`pipeline_devices` places
    stages on."""
    names = tuple(mesh.mesh_dim_names)
    keep = data_axes(mesh)
    arr = mesh.mesh
    for i in reversed(range(len(names))):
        if names[i] not in keep:
            arr = arr.select(i, 0)
    return tuple(int(r) for r in arr.reshape(-1))


def pipeline_devices(mesh=None) -> tuple:
    """The device list serving placement packs onto.

    ``mesh=None`` -> every card of this host (``cuda:0`` ..); raises with
    no card (CPU callers hand the scheduler ``devices=`` themselves).
    Given a ``DeviceMesh`` (``launch/mesh.py``), pipeline stages are
    placed along its *data* axes only — the 'model' axis is reserved for
    intra-stage sharding, so the model-index-0 slice is taken and the rest
    flattened (``data_axes`` order, :func:`pipeline_ranks`), one device a
    rank.  ``make_local_mesh()`` thus yields the single local device, and
    a ``(4, 2)`` (data, model) mesh yields 4 pipeline targets.
    """
    if mesh is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'pipeline_devices: no CUDA device; CPU callers pass the '
                "scheduler devices= (e.g. ('cpu',) * 8)")
        return tuple(torch.device('cuda', i)
                     for i in range(torch.cuda.device_count()))
    return tuple(_rank_device(mesh.device_type, r)
                 for r in pipeline_ranks(mesh))


@dataclass(frozen=True)
class Placement:
    """One solved packing of ``(model, stage)`` pairs onto devices.

    ``assignment`` is a sorted tuple of ``((model, stage), device)``;
    ``loads[d]`` is device ``d``'s summed stage cost.  See the module
    docstring for the ``guarantee`` / ``opt_lower`` / ``bound``
    semantics."""
    n_devices: int
    assignment: tuple
    loads: tuple
    opt_lower: float
    guarantee: float
    bound: float

    @cached_property
    def _by_key(self) -> dict:
        return dict(self.assignment)

    @property
    def max_load(self) -> float:
        return max(self.loads)

    @property
    def balance(self) -> float:
        """``max_load / opt_lower`` — 1.0 means provably optimal."""
        return self.max_load / self.opt_lower if self.opt_lower > 0 else 1.0

    def device_of(self, stage: int, model: str = DEFAULT_MODEL) -> int:
        return self._by_key[(model, stage)]

    def stages_on(self, device: int) -> tuple:
        """Sorted ``(model, stage)`` pairs assigned to ``device``."""
        return tuple(k for k, d in self.assignment if d == device)

    def summary(self) -> dict:
        return {
            'n_devices': self.n_devices,
            'assignment': {f'{m}:{k}': d for (m, k), d in self.assignment},
            'loads': [round(v, 6) for v in self.loads],
            'max_load': round(self.max_load, 6),
            'opt_lower': round(self.opt_lower, 6),
            'lpt_ratio': round(lpt_ratio(self.n_devices), 6),
            'bound': round(self.bound, 6),
            'guarantee': round(self.guarantee, 6),
            'balance': round(self.balance, 4),
        }


def solve_placement(stage_costs, n_devices: int, *, seed: int = 0
                    ) -> Placement:
    """Greedy-LPT packing of every model's stages onto ``n_devices``.

    ``stage_costs`` is a per-stage cost sequence for one model, or a
    ``{model_name: costs}`` mapping for N models (the multi-model
    registry path).  Costs are unit-free (us, s — whatever the
    calibration measured); they only need to share a unit.  Ties between
    equal-cost stages break by a ``seed``-keyed shuffle, so the solver
    is a pure function of ``(stage_costs, n_devices, seed)`` — re-solved
    placements (e.g. after a device kill) are reproducible.

    Degenerate inputs are fine: one device (everything lands on it),
    more stages than devices (devices hold several stages), zero-cost
    stages (placed like any other).  Negative or non-finite costs and an
    empty stage list are errors.
    """
    if n_devices < 1:
        raise ValueError(f'need at least one device, got {n_devices}')
    if isinstance(stage_costs, Mapping):
        costs = {str(m): tuple(float(c) for c in cs)
                 for m, cs in stage_costs.items()}
    else:
        costs = {DEFAULT_MODEL: tuple(float(c) for c in stage_costs)}
    if not costs or any(not cs for cs in costs.values()):
        raise ValueError('every model needs at least one stage cost')
    for m, cs in costs.items():
        bad = [c for c in cs if c < 0 or not math.isfinite(c)]
        if bad:
            raise ValueError(f'model {m!r}: stage costs must be finite '
                             f'and >= 0, got {bad}')
    items = [(m, k, c) for m, cs in sorted(costs.items())
             for k, c in enumerate(cs)]
    rng = random.Random(seed)
    tie = [rng.random() for _ in items]
    order = sorted(range(len(items)),
                   key=lambda i: (-items[i][2], tie[i]))
    loads = [0.0] * n_devices
    assign = {}
    for i in order:
        m, k, c = items[i]
        d = min(range(n_devices), key=lambda j: (loads[j], j))
        assign[(m, k)] = d
        loads[d] += c
    total = sum(c for _, _, c in items)
    cs_desc = sorted((c for _, _, c in items), reverse=True)
    opt_lower = max(total / n_devices, cs_desc[0])
    if len(cs_desc) > n_devices:
        opt_lower = max(opt_lower,
                        cs_desc[n_devices - 1] + cs_desc[n_devices])
    return Placement(
        n_devices=n_devices,
        assignment=tuple(sorted(assign.items())),
        loads=tuple(loads),
        opt_lower=opt_lower,
        guarantee=total / n_devices + (cs_desc[0] if cs_desc else 0.0),
        bound=lpt_ratio(n_devices) * opt_lower)


def _to(src, dev):
    """A carry batch (tensor or QAct) on ``dev``; the same object where it
    is there already."""
    if isinstance(src, QAct):
        q = src.q.to(dev)
        return src if q is src.q else QAct(q, src.scale)
    return src.to(dev)


def _nbytes(batch) -> int:
    t = batch.q if isinstance(batch, QAct) else batch
    return t.numel() * t.element_size()


@dataclass
class _Flight:
    """One dispatched segment batch on a device: executed eagerly at
    dispatch, lands at ``t_end`` on the simulated clock — unless a kill
    fires first (``t_kill``), in which case the output is discarded and
    the items requeue.  ``t_exec`` is when execution starts: dispatch
    time plus the carry-transfer charge (``src_devs`` nonempty)."""
    seq: int
    dev: int
    k: int
    items: list
    out: object
    t_dispatch: float
    t_exec: float
    t_end: float
    src_devs: tuple = ()
    nbytes: int = 0
    t_kill: float | None = None

    @property
    def t_land(self) -> float:
        return self.t_end if self.t_kill is None else self.t_kill


class PipelineParallelScheduler(ContinuousBatchScheduler):
    """See the module docstring.  Inherits the pending-buffer layout,
    exit rule, and landing logic from
    :class:`~repro_torch.serving.scheduler.ContinuousBatchScheduler`;
    runs them event-driven over the placed devices.  ``devices`` is the
    ordinal -> torch device list (default :func:`pipeline_devices`);
    ordinals may share a physical device."""

    def __init__(self, model, *, slots=32, threshold=None, stage_costs=None,
                 devices=None, placement=None, name=DEFAULT_MODEL,
                 compact=True, max_wait=None, chaos=None,
                 transfer_frac=0.02, seed=0, tracer=None):
        if stage_costs is None:
            raise ValueError(
                'PipelineParallelScheduler needs stage_costs: placement '
                'is cost-based and the pipeline is event-driven on the '
                'simulated clock (one host process cannot run M devices '
                'concurrently for real)')
        super().__init__(model, slots=slots, threshold=threshold,
                         stage_costs=stage_costs, max_wait=max_wait,
                         tracer=tracer)
        self.stage_costs = [float(c) for c in stage_costs]
        self.devices = (tuple(torch.device(d) for d in devices)
                        if devices is not None else pipeline_devices())
        if not self.devices:
            raise ValueError('need at least one device')
        if placement is not None \
                and placement.n_devices != len(self.devices):
            raise ValueError(
                f'placement solved for {placement.n_devices} devices, '
                f'got {len(self.devices)}')
        self._placement0 = placement
        self.name = name
        self.compact = compact
        self.chaos = chaos or ChaosPlan()
        self.transfer_frac = float(transfer_frac)
        self.seed = seed
        self.base_model = model
        self.alive = list(range(len(self.devices)))
        self.placement = placement
        self._src_ord = {}
        self._solve_and_place()

    # ------------------------------------------------------ placement ops

    def _solve_and_place(self):
        """(Re-)solve the placement over the alive devices and put the
        model's stage params on their assigned devices."""
        n = len(self.alive)
        if self.placement is None or self.placement.n_devices != n:
            self.placement = solve_placement({self.name: self.stage_costs},
                                             n, seed=self.seed)
        self.stage_dev = tuple(
            self.alive[self.placement.device_of(k, model=self.name)]
            for k in range(self.n_segs))
        self.model = self.base_model.place_stages(
            tuple(self.devices[d] for d in self.stage_dev))

    def _ordinal_of(self, src):
        """The ordinal whose flight returned the carry batch ``src`` (None
        for a request's input): recorded at landing, since a torch device
        does not tell apart two ordinals that share it."""
        hit = self._src_ord.get(id(src))
        return None if hit is None else hit[1]

    # ----------------------------------------------------------- dispatch

    def _pop_items(self, k, pend):
        """Up to ``slots`` items for one flight.  Static mode keeps
        cohorts intact past stage 0: pop only while the head item shares
        the front cohort (survivor groups are contiguous — they land,
        and requeue after kills, as units)."""
        if self.compact or k == 0:
            return [pend[k].popleft()
                    for _ in range(min(len(pend[k]), self.slots))]
        c0 = self._cohort[pend[k][0][0].rid]
        items = []
        while pend[k] and len(items) < self.slots \
                and self._cohort[pend[k][0][0].rid] == c0:
            items.append(pend[k].popleft())
        return items

    def _pick_dev(self, d, pend, more_arrivals, now):
        """Never-idle rule: the deepest of ``d``'s assigned stages with
        pending work; stage 0 waits to fill while arrivals are still
        coming (``max_wait`` ages partial batches out)."""
        for k in reversed(range(self.n_segs)):
            if self.stage_dev[k] != d:
                continue
            if k > 0:
                if pend[k]:
                    return k
                continue
            if len(pend[0]) >= self.slots:
                return 0
            if pend[0]:
                if not more_arrivals:
                    return 0
                if self.max_wait is not None and \
                        pend[0][0][0].t_arrival + self.max_wait <= now:
                    return 0
        return None

    def _dispatch(self, d, k, pend, metrics, now):
        """Pop a stage-``k`` batch, move its carry onto device ``d``
        (``.to(dev)`` — the ``transfer.carry`` charge when any source came
        from another ordinal), execute eagerly, synchronize, and put the
        result in flight until ``t_exec + cost``."""
        items = self._pop_items(k, pend)
        if k == 0:
            cohort = self._next_cohort
            self._next_cohort += 1
            for req, *_ in items:
                req.t_start = now
                self._cohort[req.rid] = cohort
            if self.tracer.enabled:
                self._trace_dispatch(items, now)
        dev = self.devices[d]
        src_ords = set()
        if k > 0:
            moved, sources = {}, []
            for _, src, idx, *_ in items:
                if id(src) not in moved:
                    o = self._ordinal_of(src)
                    if o is not None and o != d:
                        src_ords.add(o)
                    moved[id(src)] = _to(src, dev)
                sources.append((moved[id(src)], idx))
            batch = _gather_rows(sources, self.slots)
        else:
            batch = _to(_gather_rows([(src, idx) for _, src, idx, *_
                                      in items], self.slots), dev)
        nbytes = _nbytes(batch)
        out = self.model.run_stage(k, batch)
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        cost = self.stage_costs[k] * self.chaos.slow_factor(d, now)
        t_exec = now + (self.transfer_frac * self.stage_costs[k]
                        if src_ords else 0.0)
        fl = _Flight(seq=self._seq, dev=d, k=k, items=items, out=out,
                     t_dispatch=now, t_exec=t_exec, t_end=t_exec + cost,
                     src_devs=tuple(sorted(src_ords)), nbytes=nbytes)
        self._seq += 1
        self._free_at[d] = fl.t_end
        return fl

    def _land_flight(self, fl, pend, queue, completions, metrics):
        """A flight reaches its land time.  Killed flights requeue their
        requests (carry intact — the re-run is bit-exact); successful
        flights complete/promote exactly like the single-executor path,
        and their carry is recorded under the flight's ordinal."""
        t = fl.t_land
        track = f'device{fl.dev}'
        if fl.t_kill is not None:
            if self.tracer.enabled:
                t_tr = min(fl.t_kill, fl.t_exec)
                if fl.src_devs and t_tr > fl.t_dispatch:
                    self.tracer.add(
                        'transfer.carry', fl.t_dispatch, t_tr, track=track,
                        stage=fl.k, src_devices=list(fl.src_devs),
                        dst_device=fl.dev, bytes=fl.nbytes,
                        killed=fl.t_kill <= fl.t_exec)
                if fl.t_kill > fl.t_exec:
                    self.tracer.add(
                        'stage.exec', fl.t_exec, fl.t_kill, track=track,
                        stage=fl.k, live=len(fl.items), slots=self.slots,
                        killed=True, rids=[it[0].rid for it in fl.items])
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
            if fl.src_devs and fl.t_exec > fl.t_dispatch:
                self.tracer.add(
                    'transfer.carry', fl.t_dispatch, fl.t_exec, track=track,
                    stage=fl.k, src_devices=list(fl.src_devs),
                    dst_device=fl.dev, bytes=fl.nbytes)
            self.tracer.add(
                'stage.exec', fl.t_exec, fl.t_end, track=track, stage=fl.k,
                live=len(fl.items), slots=self.slots,
                rids=[it[0].rid for it in fl.items])
        metrics.record_batch(fl.k, len(fl.items), self.slots, t=fl.t_exec,
                             cost=fl.t_end - fl.t_exec, device=fl.dev)
        if fl.k < self.n_segs - 1:
            carry = fl.out[1]              # held, so its id stays unique
            self._src_ord[id(carry)] = (carry, fl.dev)
        self._land(fl.k, fl.items, fl.out, t, pend, completions, metrics,
                   track=track)

    # --------------------------------------------------------------- chaos

    def _consume_kills(self, now, flights, metrics):
        """Fire device-kill events due by ``now``: mark the victim's
        in-flight batch killed (it lands at the kill time, requeueing),
        drop the device from the pool.  Returns True if the pool shrank
        (the caller re-solves the placement after landings)."""
        fired, remaining = False, []
        for t, dv in self._kills:
            if t > now:
                remaining.append((t, dv))
                continue
            if len(self.alive) <= 1:
                metrics.record_event('kill_skipped', t, device=dv,
                                     reason='last device')
                continue
            if dv is None:                 # kill a busy device: prefer
                busy = sorted(             # one not already slowed
                    (f for f in flights if f.t_kill is None
                     and f.dev in self.alive
                     and f.t_dispatch <= t < f.t_end),
                    key=lambda f: (self.chaos.slow_factor(f.dev, t) > 1.0,
                                   f.dev))
                victim = busy[0].dev if busy else self.alive[0]
            else:
                if dv not in self.alive:   # already dead: consume, ignore
                    continue
                victim = dv
            inflight = next((f for f in flights
                             if f.dev == victim and f.t_kill is None
                             and f.t_dispatch <= t < f.t_end), None)
            if inflight is not None:
                inflight.t_kill = t
            metrics.record_event('kill', t, device=victim,
                                 mid_batch=inflight is not None,
                                 n_devices=len(self.alive) - 1)
            if self.tracer.enabled:
                self.tracer.instant('kill', t, track=f'device{victim}',
                                    mid_batch=inflight is not None)
            self.alive.remove(victim)
            fired = True
        self._kills = remaining
        return fired

    # ---------------------------------------------------------- event loop

    def run_trace(self, requests):
        """Event-driven serve of a whole arrival trace over the placed
        devices; returns ``({rid: Completion}, ServingMetrics)``."""
        queue = RequestQueue(requests)
        pend = [deque() for _ in range(self.n_segs)]
        completions, metrics = {}, ServingMetrics()
        self._seq, self._next_cohort, self._cohort = 0, 0, {}
        self._src_ord = {}
        self.alive = list(range(len(self.devices)))
        self.placement = self._placement0
        self._solve_and_place()
        self._free_at = {d: 0.0 for d in self.alive}
        self._kills = sorted(self.chaos.kills)
        flights = []
        now = queue.next_arrival() or 0.0
        metrics.record_event('placement', now, n_devices=len(self.alive),
                             max_load=round(self.placement.max_load, 6),
                             bound=round(self.placement.bound, 6))
        last_depth = None
        while queue or any(pend) or flights:
            fired = self._consume_kills(now, flights, metrics)
            due = sorted((f for f in flights if f.t_land <= now),
                         key=lambda f: (f.t_land, f.seq))
            for fl in due:
                flights.remove(fl)
                self._land_flight(fl, pend, queue, completions, metrics)
            if fired:                      # survivors get a fresh packing
                self.placement = None
                self._solve_and_place()
                metrics.record_event(
                    'placement', now, n_devices=len(self.alive),
                    max_load=round(self.placement.max_load, 6),
                    bound=round(self.placement.bound, 6))
            if not (queue or any(pend) or flights):
                break                      # landing drained the last work
            cap = self.slots * max(len(self.alive), 1) - len(pend[0])
            for r in queue.pop_ready(now, max(cap, 0)):
                pend[0].append((r, r.x, None, None, None))
            depth = len(pend[0]) + queue.n_ready(now)
            if depth != last_depth:
                metrics.record_gauge('queue_depth', now, depth)
                last_depth = depth
            dispatched = False
            for d in self.alive:
                if self._free_at[d] > now:
                    continue
                k = self._pick_dev(d, pend, more_arrivals=bool(queue),
                                   now=now)
                if k is None:
                    continue
                flights.append(self._dispatch(d, k, pend, metrics, now))
                dispatched = True
            if dispatched:
                continue                   # new flights may land instantly
            horizons = [f.t_land for f in flights]
            horizons += [t for t, _ in self._kills]
            nxt = queue.next_arrival()
            if nxt is not None:
                horizons.append(nxt)
            if any(pend):
                horizons += [self._free_at[d] for d in self.alive
                             if self._free_at[d] > now]
                if self.max_wait is not None:
                    oldest = min(p[0][0].t_arrival for p in pend if p)
                    horizons.append(oldest + self.max_wait)
            horizons = [h for h in horizons if h > now]
            if not horizons:
                raise RuntimeError(
                    'pipeline stalled: pending work but no future event '
                    '(this is a scheduler bug); '
                    f'now={now} pend={[len(b) for b in pend]} '
                    f'queue={len(queue)} flights={len(flights)} '
                    f'alive={self.alive}')
            now = min(horizons)
        self._src_ord = {}
        return completions, metrics
