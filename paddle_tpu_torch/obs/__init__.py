"""Observability of the port — its own copies of paddle_tpu/obs/'s
modules, with the reference's names:

  * `obs.trace` — the bounded-ring span tracer (`get_tracer()`, off by
    default), JSONL and Chrome trace export;
  * `obs.flight` — the flight recorder's event ring and postmortem
    bundles (`get_flight_recorder()`, off by default);
  * `obs.metrics` — counters, gauges and histograms, the Prometheus
    render, the metric-name `CATALOG`, `statset_collector` (a
    utils/stat.py StatSet as quantile gauges);
  * `obs.compile_watch` — per-signature compile events and the storm
    detector (`get_compile_watch()`, always on);
  * `obs.hbm` — device-memory gauges from the CUDA caching allocator
    (absent on the CPU), parameter and KV-pool bytes;
  * `obs.timeseries` — the health plane's downsampled ring per metric
    series (`MetricHistory`), its sampler thread and the `history` RPC;
  * `obs.slo` — SLO specs and multi-window burn-rate alerting over it.

Not ported yet (ROADMAP.md, Queue 1): `barrier_collector`.
"""

from paddle_tpu_torch.obs.compile_watch import (CompileWatch,  # noqa: F401
                                                compile_collector,
                                                get_compile_watch,
                                                signature_of)
from paddle_tpu_torch.obs.flight import (FlightRecorder,  # noqa: F401
                                         flight_collector,
                                         get_flight_recorder, load_bundle)
from paddle_tpu_torch.obs.hbm import hbm_collector, hbm_snapshot  # noqa: F401
from paddle_tpu_torch.obs.metrics import (CATALOG, Counter,  # noqa: F401
                                          Gauge, Histogram, MetricsRegistry,
                                          statset_collector,
                                          tracer_collector)
from paddle_tpu_torch.obs.slo import (SloEvaluator, SloSpec,  # noqa: F401
                                      default_pserver_slos,
                                      default_router_slos,
                                      default_serving_slos)
from paddle_tpu_torch.obs.timeseries import (HistorySampler,  # noqa: F401
                                             MetricHistory,
                                             history_collector,
                                             history_reply, merge_history,
                                             relabel_series_key)
from paddle_tpu_torch.obs.trace import (Tracer, flush_trace_file,  # noqa: F401
                                        get_tracer, merge_chrome,
                                        new_span_id, new_trace_id,
                                        process_info, spans_to_chrome,
                                        trace_reply)

__all__ = ["Tracer", "get_tracer", "spans_to_chrome", "merge_chrome",
           "flush_trace_file", "trace_reply", "new_trace_id", "new_span_id",
           "process_info", "MetricsRegistry", "Counter", "Gauge",
           "Histogram", "CATALOG", "statset_collector", "tracer_collector",
           "CompileWatch", "get_compile_watch", "compile_collector",
           "signature_of", "FlightRecorder", "get_flight_recorder",
           "flight_collector", "load_bundle", "hbm_collector",
           "hbm_snapshot", "MetricHistory", "HistorySampler",
           "history_collector", "history_reply", "merge_history",
           "relabel_series_key", "SloSpec", "SloEvaluator",
           "default_serving_slos", "default_router_slos",
           "default_pserver_slos"]
