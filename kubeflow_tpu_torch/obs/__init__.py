"""Observability: the Prometheus registry (and the process default one),
the ``/metrics`` server (``http``), JSONL trace spans and the serving
request ledger (stdlib only)."""

from .registry import Registry  # noqa: F401
from .trace import SpanWriter, default_tracer, load_spans  # noqa: F401
