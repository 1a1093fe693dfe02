"""Training-fleet runtime: fault tolerance, elastic restore, stragglers.

These primitives were built for the training loop (checkpoint-resume
under simulated host failures, reshard-on-load across meshes, EWMA
straggler detection on the synchronous fleet).  The serving runtime
(``repro_torch.serving``) folds the same ideas into the request path: the
replica pool (``serving/replica.py``) uses :class:`SimulatedFailure` as
its chaos-kill payload, re-keys :class:`StragglerMonitor` from hosts to
replicas (``observe_one``), and reuses elastic.py's load-driven scaling
idea at request level.
"""
from repro_torch.runtime.ft import FaultTolerantLoop, SimulatedFailure  # noqa: F401
from repro_torch.runtime.elastic import reshard_tree, elastic_restore  # noqa: F401
from repro_torch.runtime.straggler import StragglerMonitor  # noqa: F401
