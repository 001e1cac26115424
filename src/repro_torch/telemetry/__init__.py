"""Observability for the port's serving stack: the span tracer
(``trace``), the metrics registry (``metrics``) and the always-on flight
recorder (``flightrec``) — the same modules as the JAX package's, with
the tracer's device fence on ``torch.cuda.synchronize``."""
from repro_torch.telemetry.flightrec import (FlightRecorder,  # noqa: F401
                                             get_recorder, set_recorder)
from repro_torch.telemetry.metrics import (Counter, Gauge,  # noqa: F401
                                           Histogram, Registry)
from repro_torch.telemetry.trace import (NULL_TRACER, Span,  # noqa: F401
                                         Tracer, get_tracer, set_tracer)

__all__ = ["FlightRecorder", "get_recorder", "set_recorder", "Counter",
           "Gauge", "Histogram", "Registry", "NULL_TRACER", "Span",
           "Tracer", "get_tracer", "set_tracer"]
