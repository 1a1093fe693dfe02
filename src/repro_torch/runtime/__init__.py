"""Runtime primitives the serving replica pool uses: the chaos payload
:class:`SimulatedFailure` (``ft.py``) and the EWMA
:class:`StragglerMonitor` (``straggler.py``), re-keyed from hosts to
replicas.  The training loop's ``FaultTolerantLoop`` and the elastic
restore come with the distributed slice (ROADMAP queue A item 10)."""
from repro_torch.runtime.ft import SimulatedFailure  # noqa: F401
from repro_torch.runtime.straggler import StragglerMonitor  # noqa: F401
