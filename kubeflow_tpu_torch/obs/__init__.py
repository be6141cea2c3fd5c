"""Observability: the Prometheus registry, JSONL trace spans and the
serving request ledger (stdlib only)."""

from .registry import Registry  # noqa: F401
from .trace import SpanWriter, default_tracer, load_spans  # noqa: F401
