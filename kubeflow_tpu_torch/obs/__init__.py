"""First-party observability: spans, histograms, Prometheus exposition,
Perfetto export.

The system's headline numbers (prefix-hit rate, recovery_seconds, warm
scale-up, tokens/s/stream) were measured through hand-rolled phase dicts
and flat counters; this package is the uniform instrument behind all of
them:

- ``trace``:     lightweight spans (name, t0/t1, attrs, parent) in a
                 lock-fenced per-process ring buffer, with
                 W3C-traceparent-style context propagation for the
                 stdlib HTTP surfaces (router -> model server -> engine,
                 heartbeat POSTs).
- ``histogram``: log-bucketed Prometheus histograms (``_bucket`` /
                 ``_sum`` / ``_count`` text exposition + bucket-resolved
                 percentiles) — bounded memory no matter the
                 observation count.
- ``expo``:      the ONE exposition helper every ``/metrics`` surface
                 renders through (``# HELP`` / ``# TYPE`` per family,
                 ``_total``-suffixed counters enforced) plus the
                 lint-style validator the test suite and smoke use.
- ``export``:    merge spans from many processes into Chrome-trace-event
                 JSON that Perfetto / chrome://tracing load directly,
                 and build operator-side job traces from heartbeat phase
                 reports + the reconciler recovery log.

Pure stdlib on purpose (like serving/scheduler.py): the control plane
must import this without dragging jax in.
"""

from kubeflow_tpu_torch.obs.histogram import Histogram, log_buckets
from kubeflow_tpu_torch.obs.trace import (
    Span, SpanCollector, collector, format_traceparent, parse_traceparent,
)

__all__ = [
    "Histogram", "log_buckets",
    "Span", "SpanCollector", "collector",
    "format_traceparent", "parse_traceparent",
]
