"""Observability: the Prometheus registry (and the process default one),
the ``/metrics`` server (``http``), JSONL trace spans, the goodput
ledgers (``goodput``: the training job's and the serving request's) and
the train step's comm profile (``collectives``); stdlib only."""

from .registry import (DEFAULT_BUCKETS, Registry, counter,  # noqa: F401
                       default_registry, gauge, histogram)
from .trace import SpanWriter, default_tracer, load_spans  # noqa: F401
from .http import ObsServer  # noqa: F401
from .goodput import (BADPUT_CATEGORIES, GOODPUT,  # noqa: F401
                      GOODPUT_ANNOTATION, categories_sum_ok,
                      cluster_rollup, decompose, export_job_ledger,
                      ledger_for)
