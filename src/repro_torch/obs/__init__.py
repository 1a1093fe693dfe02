"""Runtime observability: span tracing with a Chrome-trace exporter."""
from repro_torch.obs.trace import (NULL_TRACER, NullTracer, Span,  # noqa: F401
                                   Tracer, as_tracer, spans_to_chrome)
