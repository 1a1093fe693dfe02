"""Placement: pack model stages onto devices (the solver half of the
reference's ``serving/placement.py``).

:func:`solve_placement` is a pure function from measured per-stage batch
costs and a device count to a :class:`Placement`: every ``(model,
stage)`` pair of every chain gets exactly one device.  The baseline is
greedy **LPT** (longest processing time first): stages sorted by cost
descending, each assigned to the least-loaded device.  The report carries
the classic guarantees alongside the achieved loads:

* ``guarantee`` — the sound greedy bound ``total/M + c_max``: the
  achieved ``max_load`` NEVER exceeds it;
* ``opt_lower`` — a lower bound on the optimal makespan,
  ``max(total/M, c_max, c_(M) + c_(M+1))`` (some device must run two of
  the M+1 largest stages);
* ``bound`` — ``(4/3 - 1/(3M)) * opt_lower``, the LPT competitive ratio
  applied to the OPT lower bound; ``balance = max_load / opt_lower`` then
  brackets how far from optimal the packing can be.

N registered chains pack onto M devices through the same call —
``ModelRegistry.plan_placement`` feeds it every model's measured costs at
its own slot geometry.

The reference's pipeline-parallel scheduler, ``pipeline_devices`` and
``ServingModel.place_stages`` place stages across several devices; on one
card they reduce to one device, so they come with the distributed slice
(ROADMAP queue A item 10).
"""
from __future__ import annotations

import math
import random
from collections.abc import Mapping
from dataclasses import dataclass
from functools import cached_property

#: key used when ``solve_placement`` is handed a bare cost sequence
DEFAULT_MODEL = 'model'


def lpt_ratio(n_devices: int) -> float:
    """LPT's competitive ratio on ``n_devices`` identical machines:
    ``max_load <= (4/3 - 1/(3M)) * OPT`` (Graham 1969)."""
    return 4.0 / 3.0 - 1.0 / (3.0 * n_devices)


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
