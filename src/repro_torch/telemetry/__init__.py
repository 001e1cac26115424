"""Observability for the port's serving stack: the span tracer
(``trace``), the metrics registry (``metrics``), the always-on flight
recorder (``flightrec``) and the per-request timelines folded from a
trace (``timeline``) — the same modules as the JAX package's, with the
tracer's device fence on ``torch.cuda.synchronize``."""
from repro_torch.telemetry.flightrec import (FlightRecorder,  # noqa: F401
                                             get_recorder, set_recorder)
from repro_torch.telemetry.metrics import (Counter, Gauge,  # noqa: F401
                                           Histogram, Registry)
from repro_torch.telemetry.timeline import (RequestTimeline,  # noqa: F401
                                            Segment, build_timelines,
                                            check_timelines,
                                            format_timeline,
                                            timelines_from_chrome,
                                            timelines_from_jsonl,
                                            timelines_from_tracer)
from repro_torch.telemetry.trace import (NULL_TRACER, Span,  # noqa: F401
                                         Tracer, get_tracer, set_tracer)

__all__ = ["FlightRecorder", "get_recorder", "set_recorder", "Counter",
           "Gauge", "Histogram", "Registry", "NULL_TRACER", "Span",
           "Tracer", "get_tracer", "set_tracer", "Segment",
           "RequestTimeline", "build_timelines", "timelines_from_tracer",
           "timelines_from_chrome", "timelines_from_jsonl",
           "check_timelines", "format_timeline"]
