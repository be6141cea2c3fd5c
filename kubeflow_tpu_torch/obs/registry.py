"""Dependency-free Prometheus-text metrics registry.

The port's copy of ``kubeflow_tpu/obs/registry.py``: Counter / Gauge /
Histogram families with labels and ``render()`` emitting the standard
Prometheus text exposition (format 0.0.4). The model server, each
servable and the replica health registry hold their own ``Registry`` so
that several of them coexist in one process without sharing counts.

- **Dependency-free.** The text format from the spec, nothing more.
- **Hot-path cheap.** Call sites resolve their labeled child once and
  hold it (``family.labels(...)`` returns a stable handle).
"""

from __future__ import annotations

import math
import threading
from typing import Sequence

# Prometheus-conventional latency buckets, widened at the top for the
# control-plane paths (reconcile passes, queue waits span ms → minutes).
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 300.0)

_NAME_OK = set("abcdefghijklmnopqrstuvwxyz"
               "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


def _check_name(name: str) -> str:
    if not name or name[0].isdigit() or any(c not in _NAME_OK for c in name):
        raise ValueError(f"invalid metric name {name!r}")
    return name


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _fmt(v: float) -> str:
    """Exposition value format: integers without the trailing ``.0`` —
    wire-compatible with the hand-rolled expositions this registry
    replaced (``kubeflow_availability 1``, not ``1.0``)."""
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


class _Child:
    """One labeled series of a family. Thread-safe via the family lock."""

    __slots__ = ("_family", "_lock", "_value", "_buckets", "_counts",
                 "_sum", "_count")

    def __init__(self, family: "_Family"):
        self._family = family
        self._lock = family._lock
        self._value = 0.0
        if family.kind == "histogram":
            self._buckets = family.buckets
            self._counts = [0] * len(self._buckets)
            self._sum = 0.0
            self._count = 0

    # counters / gauges -----------------------------------------------------

    def inc(self, amount: float = 1.0) -> None:
        if self._family.kind == "counter" and amount < 0:
            raise ValueError("counter can only increase")
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        if self._family.kind != "gauge":
            raise TypeError(f"{self._family.kind} cannot dec()")
        with self._lock:
            self._value -= amount

    def set(self, value: float) -> None:
        """Gauges set freely; counters accept set() ONLY as the snapshot
        bridge for sources that keep their own monotonic totals (the
        model server's per-servable stats) — the exposition stays a
        counter, the source stays the one bookkeeper."""
        if self._family.kind == "histogram":
            raise TypeError("histogram cannot set()")
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    # histograms ------------------------------------------------------------

    def observe(self, value: float) -> None:
        if self._family.kind != "histogram":
            raise TypeError(f"{self._family.kind} cannot observe()")
        v = float(value)
        with self._lock:
            for i, le in enumerate(self._buckets):
                if v <= le:
                    self._counts[i] += 1
                    break
            self._sum += v
            self._count += 1

    def _snapshot(self) -> tuple:
        """(cumulative buckets, sum, count) under ONE lock acquisition:
        an observe() landing between two reads would otherwise scrape an
        exposition whose _count disagrees with its +Inf bucket."""
        with self._lock:
            out = {}
            acc = 0
            for le, n in zip(self._buckets, self._counts):
                acc += n
                out[le] = acc
            out[math.inf] = self._count
            return out, self._sum, self._count


class _Family:
    """One named metric: TYPE/HELP plus its labeled children."""

    def __init__(self, name: str, help: str, kind: str,
                 label_names: Sequence[str],
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = _check_name(name)
        self.help = help
        self.kind = kind
        self.label_names = tuple(label_names)
        for ln in self.label_names:
            _check_name(ln)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._lock = threading.Lock()
        self._children: dict[tuple, _Child] = {}
        if not self.label_names:
            # unlabeled series exist (as zero) from registration — a
            # scrape must see a fresh prober's counters, not absence
            self._children[()] = _Child(self)

    def labels(self, **kv) -> _Child:
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.label_names)}")
        key = tuple(str(kv[ln]) for ln in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = _Child(self)
                self._children[key] = child
        return child

    def remove(self, **kv) -> None:
        """Drop one labeled series (a job that no longer exists must not
        export its last phase forever)."""
        key = tuple(str(kv.get(ln, "")) for ln in self.label_names)
        with self._lock:
            self._children.pop(key, None)

    # unlabeled families proxy the single default child ---------------------

    def _default(self) -> _Child:
        if self.label_names:
            raise ValueError(
                f"{self.name} declares labels {self.label_names}; "
                "use .labels(...)")
        return self.labels()

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    def set(self, value: float) -> None:
        self._default().set(value)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    @property
    def value(self) -> float:
        return self._default().value

    # exposition ------------------------------------------------------------

    def _labels_str(self, key: tuple, extra: str = "") -> str:
        parts = [f'{ln}="{_escape_label(v)}"'
                 for ln, v in zip(self.label_names, key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            children = sorted(self._children.items())
        for key, child in children:
            if self.kind == "histogram":
                buckets, s, c = child._snapshot()
                for le, n in buckets.items():
                    le_pair = 'le="' + _fmt(le) + '"'
                    lines.append(f"{self.name}_bucket"
                                 f"{self._labels_str(key, le_pair)} {n}")
                lines.append(f"{self.name}_sum{self._labels_str(key)} "
                             f"{_fmt(s)}")
                lines.append(f"{self.name}_count{self._labels_str(key)} {c}")
            else:
                lines.append(f"{self.name}{self._labels_str(key)} "
                             f"{_fmt(child.value)}")
        return lines


class Registry:
    """A set of metric families. Components that must not share state
    across instances (model servers, servables — several can coexist in
    one process) each hold their own Registry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _get(self, name: str, help: str, kind: str,
             labels: Sequence[str],
             buckets: Sequence[float] = DEFAULT_BUCKETS):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                # idempotent re-registration (modules re-instrument on
                # re-import); a CHANGED shape is a programming error
                if fam.kind != kind or fam.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} re-registered as {kind}"
                        f"{tuple(labels)}; existing: {fam.kind}"
                        f"{fam.label_names}")
                return fam
            fam = _Family(name, help, kind, labels, buckets=buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str,
                labels: Sequence[str] = ()) -> _Family:
        return self._get(name, help, "counter", labels)

    def gauge(self, name: str, help: str,
              labels: Sequence[str] = ()) -> _Family:
        return self._get(name, help, "gauge", labels)

    def histogram(self, name: str, help: str, labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> _Family:
        return self._get(name, help, "histogram", labels, buckets=buckets)

    def render(self) -> str:
        """The Prometheus text exposition, families in name order."""
        lines: list[str] = []
        with self._lock:
            families = sorted(self._families.items())
        for _, fam in families:
            lines.extend(fam.render())
        return "\n".join(lines) + "\n" if lines else ""

