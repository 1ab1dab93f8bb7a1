"""Observability of the port — its own copies of paddle_tpu/obs/'s
stdlib-only modules, with the reference's names:

  * `obs.trace` — the bounded-ring span tracer (`get_tracer()`, off by
    default), JSONL and Chrome trace export;
  * `obs.flight` — the flight recorder's event ring and postmortem
    bundles (`get_flight_recorder()`, off by default);
  * `obs.metrics` — counters, gauges and histograms, the Prometheus
    render, the metric-name `CATALOG`;
  * `obs.compile_watch` — per-signature compile events and the storm
    detector (`get_compile_watch()`, always on).

Not ported yet (ROADMAP.md, Queue 1): `hbm.py`, `timeseries.py`,
`slo.py`, `statset_collector` and `barrier_collector`.
"""

from paddle_tpu_torch.obs.compile_watch import (CompileWatch,  # noqa: F401
                                                compile_collector,
                                                get_compile_watch,
                                                signature_of)
from paddle_tpu_torch.obs.flight import (FlightRecorder,  # noqa: F401
                                         flight_collector,
                                         get_flight_recorder, load_bundle)
from paddle_tpu_torch.obs.metrics import (CATALOG, Counter,  # noqa: F401
                                          Gauge, Histogram, MetricsRegistry,
                                          tracer_collector)
from paddle_tpu_torch.obs.trace import (Tracer, flush_trace_file,  # noqa: F401
                                        get_tracer, merge_chrome,
                                        new_span_id, new_trace_id,
                                        process_info, spans_to_chrome,
                                        trace_reply)

__all__ = ["Tracer", "get_tracer", "spans_to_chrome", "merge_chrome",
           "flush_trace_file", "trace_reply", "new_trace_id", "new_span_id",
           "process_info", "MetricsRegistry", "Counter", "Gauge",
           "Histogram", "CATALOG", "tracer_collector", "CompileWatch",
           "get_compile_watch", "compile_collector", "signature_of",
           "FlightRecorder", "get_flight_recorder", "flight_collector",
           "load_bundle"]
