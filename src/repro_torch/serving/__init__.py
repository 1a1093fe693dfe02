"""Request-level serving runtime over exported ServingModels: a time-gated
request queue (``request.py``), a continuous-batching scheduler that
compacts early-exited slots and backfills from the queue, and the static
full-depth baseline (``scheduler.py``), an SLO layer for deadline
admission and graceful degradation through the exit heads (``slo.py``),
an elastic replica pool with straggler de-prioritization and chaos-tested
checkpoint-backed failover (``replica.py``), a registry that loads and
restores models from chain checkpoints (``registry.py``), the placement
solver (``placement.py``) and the latency/throughput/occupancy/SLO/
resilience metrics (``metrics.py``).  Driven by ``launch/serve_cnn.py
--server``.  The reference's pipeline-parallel scheduler and
``pipeline_devices`` come with the distributed slice (ROADMAP queue A
item 10)."""
from repro_torch.serving.metrics import ServingMetrics, percentile  # noqa: F401
from repro_torch.serving.placement import (Placement,  # noqa: F401
                                           lpt_ratio, solve_placement)
from repro_torch.serving.registry import ModelRegistry  # noqa: F401
from repro_torch.serving.replica import (ChaosPlan,  # noqa: F401
                                         ReplicaPoolScheduler)
from repro_torch.serving.request import (Completion, Request,  # noqa: F401
                                         RequestQueue)
from repro_torch.serving.scheduler import (  # noqa: F401
    ContinuousBatchScheduler, StaticBatchScheduler, exit_decisions)
from repro_torch.serving.slo import SLOPolicy  # noqa: F401
