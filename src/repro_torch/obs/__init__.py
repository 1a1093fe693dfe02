"""Runtime observability: span tracing (Chrome-trace export and load) and
trace validation for the serving stack."""
from repro_torch.obs.trace import (NULL_TRACER, NullTracer, Span, Tracer,
                                   as_tracer, load_chrome_trace,
                                   spans_to_chrome)
from repro_torch.obs.validate import TraceInvariantError, check_trace

__all__ = ['NULL_TRACER', 'NullTracer', 'Span', 'Tracer', 'as_tracer',
           'load_chrome_trace', 'spans_to_chrome', 'TraceInvariantError',
           'check_trace']
