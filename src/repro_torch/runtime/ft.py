"""Failure injection for drills: the part of the reference's
``runtime/ft.py`` that serving uses.  The replica pool
(``serving/replica.py``) raises nothing: it records a
:class:`SimulatedFailure` as the reason of each seeded kill.  The
reference's checkpoint/restart ``FaultTolerantLoop`` comes with the
distributed slice (ROADMAP queue A item 10)."""
from __future__ import annotations


class SimulatedFailure(RuntimeError):
    """Raised by failure injectors in tests/drills."""
