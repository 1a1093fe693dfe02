"""Request-level serving runtime over exported ServingModels: a time-gated
request queue (``request.py``), the continuous-batching scheduler that
compacts early-exited slots and backfills from the queue
(``scheduler.py``), and the latency/throughput/occupancy metrics
(``metrics.py``).  Driven by ``launch/serve_cnn.py --server``."""
from repro_torch.serving.metrics import (ServingMetrics,  # noqa: F401
                                         percentile)
from repro_torch.serving.request import (Completion, Request,  # noqa: F401
                                         RequestQueue)
from repro_torch.serving.scheduler import (  # noqa: F401
    ContinuousBatchScheduler, exit_decisions)
