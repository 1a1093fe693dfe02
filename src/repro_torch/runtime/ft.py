"""Fault-tolerant training loop: checkpoint/restart with failure injection
(the reference's ``runtime/ft.py`` over the port's
``checkpoint/manager.py``).

At 1000+ nodes the MTBF of the fleet is minutes to hours, so the training
driver, not the operator, must own recovery.  The loop:

  * checkpoints (async) every ``ckpt_every`` steps via CheckpointManager,
  * treats any exception from the step function (injected or real: a
    rank dropping out surfaces as a collective error) as a failure event,
  * restores the latest committed checkpoint, rewinds the data iterator to
    the restored step (the synthetic pipeline is deterministic by step, so
    rewind = recompute), and resumes,
  * gives up after ``max_restarts`` consecutive failures at the same step
    (a poison-pill guard, telling transient node loss from a
    deterministic bug).

The state may hold DTensors: the checkpoint gathers them, rank 0 writes,
and a restore puts every leaf back on its mesh and placements
(``checkpoint/manager.py``), so the loop is the same on one rank and on
many.  A run that resumes on a different mesh goes through
``runtime/elastic.py``'s ``elastic_restore``.  The serving replica pool
(``serving/replica.py``) records a :class:`SimulatedFailure` as the
reason of each seeded kill.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable

from repro_torch.checkpoint import CheckpointManager

log = logging.getLogger('repro_torch.ft')


class SimulatedFailure(RuntimeError):
    """Raised by failure injectors in tests/drills."""


@dataclass
class FaultTolerantLoop:
    step_fn: Callable                    # (state, batch) -> (state, metrics)
    batch_fn: Callable                   # (step) -> batch   (deterministic!)
    ckpt: CheckpointManager
    ckpt_every: int = 50
    max_restarts: int = 5
    failure_injector: Callable | None = None   # (step) -> None | raise
    restarts: int = field(default=0, init=False)
    events: list = field(default_factory=list, init=False)

    def run(self, state, start_step: int, num_steps: int):
        step = start_step
        fails_here = 0
        while step < start_step + num_steps:
            try:
                if self.failure_injector is not None:
                    self.failure_injector(step)
                t0 = time.monotonic()
                state, metrics = self.step_fn(state, self.batch_fn(step))
                dt = time.monotonic() - t0
                if step % self.ckpt_every == 0:
                    self.ckpt.save(step, state)
                step += 1
                fails_here = 0
                self.events.append(('step', step, dt, metrics))
            except Exception as e:                        # noqa: BLE001
                fails_here += 1
                self.restarts += 1
                self.events.append(('failure', step, repr(e)))
                log.warning('step %d failed (%s); restoring', step, e)
                if fails_here > self.max_restarts:
                    raise RuntimeError(
                        f'step {step} failed {fails_here}x — poison pill'
                    ) from e
                try:
                    state, restored = self.ckpt.restore_latest(state)
                    step = restored + 1
                except FileNotFoundError:
                    step = start_step       # no checkpoint yet: cold restart
        self.ckpt.save(step - 1, state)
        self.ckpt.wait()
        return state, step
