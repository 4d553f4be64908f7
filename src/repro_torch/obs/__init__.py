"""repro_torch.obs — telemetry of the port (the reference's
``repro.obs``): metrics registry, span tracing, device-resident step
counters, and the request-scoped layer of the serving stack: trace
context, per-tenant SLOs (``slo``), the flight recorder (``flight``),
Perfetto and OpenMetrics export.

Quickstart::

    import os; os.environ["REPRO_TRACE"] = "1"
    import repro_torch.obs as obs
    obs.configure()                    # pick up the knob (or pass mode=)
    ... run session steps / serve requests ...
    print(obs.summary())               # unified text table
    print(obs.kernel_counters())       # the kernels' device counters
    obs.export_jsonl("telemetry.jsonl")  # spans + metrics, one JSON/line
    obs.export_perfetto("trace.json")  # open in ui.perfetto.dev
    print(obs.export_openmetrics())    # Prometheus-style scrape text
"""
from .registry import (REGISTRY, Counter, Gauge, Histogram,  # noqa: F401
                       MetricSet, Registry)
from .tracing import (configure, current_trace, export_jsonl,  # noqa: F401
                      recent_spans, record_span, span, timeline,
                      trace_enabled, trace_mode, trace_path, trace_scope)
from .device import (TELEM_HEADER, kernel_counters,  # noqa: F401
                     level_occupancy, pack_step_telemetry,
                     unpack_step_telemetry)
from .lifecycle import on_reset, run_reset_hooks  # noqa: F401
from .perfetto import export_perfetto, to_trace_events  # noqa: F401
from .openmetrics import export_openmetrics  # noqa: F401
from . import slo, flight  # noqa: F401  (registers their reset hooks)


def metric_set(component: str) -> MetricSet:
    """New instance-scoped MetricSet registered with the global registry."""
    return REGISTRY.metric_set(component)


def summary() -> str:
    """Text table of every metric in the global registry, then the
    kernels' device counters (``kernel_counters``) if any kernel ran on a
    card."""
    lines = [REGISTRY.summary()]
    for kernel, counts in kernel_counters().items():
        for name, v in counts.items():
            if name != "by_signature":
                lines.append(f"# {kernel:<18}{name:<34}{v:>14d}")
    return "\n".join(lines)


def metrics_dict() -> dict:
    """The unified metric schema ({"schema": "repro.obs/v1", "metrics":
    [...]})."""
    return REGISTRY.metrics_dict()


def reset() -> None:
    """Clear the global registry, the span ring buffer, and every
    component-local state registered via :func:`on_reset` (SLO windows,
    flight ring), so back-to-back test scenarios start clean."""
    from . import tracing
    REGISTRY.reset()
    tracing.reset()
    run_reset_hooks()
