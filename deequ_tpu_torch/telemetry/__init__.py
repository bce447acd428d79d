"""Unified telemetry: spans, counters, run listeners, structured export.

Counterpart of ``deequ_tpu/telemetry/``, with the same JSONL event
schema, span, counter and event names, so ``tools/obs_report.py`` and
``tools/trace_report.py`` read either package's logs:

- :mod:`spans` — nested attribute-carrying spans with thread-local
  context, each doubling as a ``torch.profiler.record_function`` range
  (and an NVTX range once CUDA is initialised)
- :mod:`metrics` — always-on counters/gauges/latency histograms with a
  Prometheus text exposition
- :mod:`listeners` — Spark-listener-style run callbacks
- :mod:`runtime` — the :class:`Telemetry` object tying them together,
  with per-run captures and a JSONL event log
- :mod:`export` — summary serde/merging and JSONL reading
- :mod:`oprecords` — repository-persisted per-run operational records
  (imported lazily by the runner/serde; not re-exported here to keep
  this package importable from the data layer without cycles)
- :mod:`phases` — the scan wall-decomposition clock

``get_telemetry()`` returns the process default; ``configure(...)``
flips ``enabled``/``jsonl_path`` on it. Counters stay live even when
disabled (monotonic accounting, e.g. ``transfer.bytes``); everything
else becomes a shared no-op. The process default is this package's
own: the JAX package's telemetry counts apart.
"""

from deequ_tpu_torch.telemetry.export import (
    MetricsServer,
    SloTracker,
    merge_summaries,
    parse_slo_objectives,
    read_jsonl,
    serve_metrics,
    summarize_phases,
    summary_from_json,
    summary_to_json,
)
from deequ_tpu_torch.telemetry.listeners import CollectingRunListener, RunListener
from deequ_tpu_torch.telemetry.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from deequ_tpu_torch.telemetry.phases import PhaseClock
from deequ_tpu_torch.telemetry.runtime import (
    RunCapture,
    Telemetry,
    configure,
    get_telemetry,
)
from deequ_tpu_torch.telemetry.spans import (
    NOOP_SPAN,
    Span,
    TraceContext,
    Tracer,
    clock,
    profiler_trace,
)

__all__ = [
    "CollectingRunListener",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "MetricsServer",
    "NOOP_SPAN",
    "PhaseClock",
    "RunCapture",
    "RunListener",
    "SloTracker",
    "Span",
    "Telemetry",
    "TraceContext",
    "Tracer",
    "clock",
    "configure",
    "get_telemetry",
    "merge_summaries",
    "parse_slo_objectives",
    "profiler_trace",
    "read_jsonl",
    "serve_metrics",
    "summarize_phases",
    "summary_from_json",
    "summary_to_json",
]
