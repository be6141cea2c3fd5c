"""Trace spans as JSONL records: a request's or a job's timeline.

The port's copy of ``kubeflow_tpu/obs/trace.py``, cut to what the
serving tier, the worker and the operator loop use. A job's trace id is
minted by the control plane on first contact and persisted as the
``observability.kubeflow.org/trace-id`` annotation; the operator renders
it into every worker pod as ``KFTPU_TRACE_ID``. Every component appends span records to one JSONL
sink: ``{"trace_id", "span_id", "parent_id", "name", "component",
"start", "end", "attrs"}`` in wall-clock seconds, so spans from several
threads and processes order on one axis. The sink is named by
``KFTPU_SPAN_PATH`` (``default_tracer``) or passed explicitly
(``SpanWriter``); ``load_spans`` reads it back.
Writers are append-only and line-atomic (one ``write()`` per record).
Stdlib only.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import uuid
from typing import Optional

# env contract (rendered by controllers/tpujob.py into worker pods)
TRACE_ID_ENV = "KFTPU_TRACE_ID"
SPAN_PATH_ENV = "KFTPU_SPAN_PATH"
# sink size cap: at this many bytes the active JSONL rotates to
# ``<path>.1`` (one generation — long soaks previously grew the sink
# unbounded). 0/unset = no rotation.
SPAN_MAX_BYTES_ENV = "KFTPU_SPAN_MAX_BYTES"


# where the minted trace id persists on the job object (the one value
# every component — operator, worker, dashboard — agrees on)
TRACE_ID_ANNOTATION = "observability.kubeflow.org/trace-id"


def mint_trace_id(uid: str = "") -> str:
    """A fresh trace id — DERIVED from the object's uid when one exists,
    so concurrent minters compute the SAME id and neither side's early
    spans are orphaned by a lost patch race."""
    if uid:
        import hashlib
        return hashlib.sha1(uid.encode()).hexdigest()[:16]
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


# per-path rotation locks: several SpanWriter instances in ONE process
# (operator + scheduler default tracers, the worker's tracer + its
# dedicated dump writer) share a sink — their rotations must serialize
_rotate_locks: dict = {}
_rotate_locks_guard = threading.Lock()


def _rotate_lock(path: str) -> threading.Lock:
    key = os.path.abspath(path)
    with _rotate_locks_guard:
        lock = _rotate_locks.get(key)
        if lock is None:
            lock = _rotate_locks[key] = threading.Lock()
        return lock


class SpanWriter:
    """Appends span records to a JSONL sink, one writer per component
    per process; each record names its ``trace_id`` (the request id)."""

    def __init__(self, path: str, component: str,
                 max_bytes: Optional[int] = None):
        self.path = path
        self.component = component
        if max_bytes is None:
            try:
                max_bytes = int(os.environ.get(SPAN_MAX_BYTES_ENV) or 0)
            except ValueError:
                max_bytes = 0
        self.max_bytes = max(0, int(max_bytes))
        self._lock = threading.Lock()
        # the per-path rotation lock is resolved ONCE here: resolving it
        # per-emit would take the blocking _rotate_locks_guard on the
        # hot path — and inside the SIGTERM handler's dump, where
        # re-acquiring a guard the interrupted main thread holds would
        # deadlock the very teardown being evidenced
        self._rotate = _rotate_lock(path) if self.max_bytes else None
        self._fh = None
        self._warned = False

    # ------------------------------------------------------------- emission

    def emit(self, name: str, *, start: float, end: Optional[float] = None,
             trace_id: Optional[str] = None, span_id: Optional[str] = None,
             parent_id: Optional[str] = None, **attrs) -> dict:
        record = {
            "trace_id": trace_id or "",
            "span_id": span_id or new_span_id(),
            "parent_id": parent_id or "",
            "name": name,
            "component": self.component,
            "start": round(start, 6),
            "end": round(end if end is not None else start, 6),
        }
        if attrs:
            record["attrs"] = attrs
        line = json.dumps(record) + "\n"
        # observability must never kill the work it observes: an
        # unwritable sink (full volume, revoked mount) drops the record
        # — warned once — and the closed handle means the next emit
        # retries the open, so spans resume when the sink recovers
        with self._lock:
            try:
                if self._fh is None:
                    d = os.path.dirname(self.path)
                    if d:
                        os.makedirs(d, exist_ok=True)
                    self._fh = open(self.path, "a")
                if self.max_bytes:
                    self._rotate_if_needed(len(line))
                self._fh.write(line)
                self._fh.flush()
            except OSError as e:
                if not self._warned:
                    self._warned = True
                    import logging
                    logging.getLogger(__name__).warning(
                        "span sink %s unwritable (%s); dropping spans "
                        "until it recovers", self.path, e)
                if self._fh is not None:
                    try:
                        self._fh.close()
                    except OSError:
                        pass
                    self._fh = None
        return record

    def event(self, name: str, trace_id: Optional[str] = None,
              **attrs) -> dict:
        """A point event (zero-duration span): phase transitions."""
        return self.emit(name, start=time.time(), trace_id=trace_id, **attrs)

    def _rotate_if_needed(self, incoming: int) -> None:
        """Size-cap rotation (KFTPU_SPAN_MAX_BYTES), safe for the
        deployed shape of MANY writers appending to one sink (operator,
        scheduler, every worker). Two hazards the naive rotate has:

        - a writer holding a handle onto a file ANOTHER writer already
          renamed keeps appending to the stale inode — its spans
          (including flight-record dumps) silently land in ``.1`` and
          vanish from the live trace. Every capped write re-checks the
          handle's inode against the path and reopens on mismatch.
        - a writer rotating off its own stale size clobbers a sibling's
          FRESH active file over the prior generation. Rotation runs
          under a process-wide per-path lock and re-checks the LIVE
          file size first, so only a genuinely over-cap active file is
          ever renamed.

        Cross-process rotation remains best-effort (no file locking in
        scope): the inode re-check bounds the damage to one writer
        reopening a line late, never to silent span loss."""
        try:
            if os.stat(self.path).st_ino != os.fstat(
                    self._fh.fileno()).st_ino:
                self._fh.close()
                self._fh = open(self.path, "a")
        except OSError:
            # path gone mid-check (sibling rotated + nothing rewrote
            # it yet): reopen creates the fresh active generation
            self._fh.close()
            self._fh = open(self.path, "a")
        if self._fh.tell() + incoming <= self.max_bytes or \
                self._fh.tell() == 0:
            return
        # NON-BLOCKING: the SIGTERM flight-record dump writes through a
        # dedicated writer that shares only THIS lock with the main
        # thread — a handler blocking on a lock its interrupted holder
        # can never release would deadlock the teardown. A contended
        # rotation is simply skipped: the write overshoots the cap by
        # one record and the next uncontended write rotates.
        lock = self._rotate
        if not lock.acquire(blocking=False):
            return
        try:
            try:
                live = os.path.getsize(self.path)
            except OSError:
                live = 0
            if live + incoming > self.max_bytes and live > 0:
                self._fh.close()
                self._fh = None
                os.replace(self.path, self.path + ".1")
                self._fh = open(self.path, "a")
            elif os.stat(self.path).st_ino != os.fstat(
                    self._fh.fileno()).st_ino:
                # a sibling rotated while we raced for the lock
                self._fh.close()
                self._fh = open(self.path, "a")
        finally:
            lock.release()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


# One cached writer per component, so every model server in a process
# shares the env-named sink. When the env sink changes, the stale writer
# is closed and replaced, never accumulated as a leaked fd.
_writers: dict = {}   # component -> (path, SpanWriter)
_writers_lock = threading.Lock()


def default_tracer(component: str) -> Optional[SpanWriter]:
    path = os.environ.get(SPAN_PATH_ENV)
    if not path:
        return None
    with _writers_lock:
        cached = _writers.get(component)
        if cached is not None:
            old_path, w = cached
            if old_path == path:
                return w
            w.close()
        w = SpanWriter(path, component)
        _writers[component] = (path, w)
        return w


@contextlib.contextmanager
def adopt_trace_env(env_map: dict):
    """Temporarily adopt the operator-rendered trace contract
    (KFTPU_TRACE_ID / KFTPU_SPAN_PATH) from a pod's env map — the
    in-process soak segments' stand-in for actually running inside the
    pod, so their worker spans stitch onto the job's control-plane
    trace (cluster/chaos.py)."""
    saved: dict = {}
    for key in (TRACE_ID_ENV, SPAN_PATH_ENV):
        value = env_map.get(key)
        if value:
            saved[key] = os.environ.get(key)
            os.environ[key] = value
    try:
        yield
    finally:
        for key, old in saved.items():
            if old is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = old


# -------------------------------------------------------------- reading back

def load_spans(path: str, trace_id: Optional[str] = None) -> list[dict]:
    """All span records in the sink (optionally one trace's), sorted by
    (start, end) so the list reads as the timeline. Torn/garbage lines
    are skipped — a reader must cope with a writer mid-append."""
    out: list[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(rec, dict) or "name" not in rec:
                    continue
                if trace_id is None or rec.get("trace_id") == trace_id:
                    out.append(rec)
    except OSError:
        return []
    out.sort(key=lambda r: (r.get("start", 0.0), r.get("end", 0.0)))
    return out

