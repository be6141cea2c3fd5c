"""Checkpoints on the JAX package's on-disk contract, written by the port.

The port of ``kubeflow_tpu/runtime/checkpoint.py``. The directory layout,
its integrity layer and the manager's API are the JAX package's:

- **Step directories** named by the step number. A step counts only once
  committed, marked by ``_CHECKPOINT_METADATA``: it is written into
  ``<step>.kftpu-tmp`` and renamed into place, so a writer that dies
  leaves no step directory, and a step without the marker (a half
  finished commit) is never offered by ``latest_step()`` or restored.
- **Checksum manifest** ``kftpu.manifest.json``: per-file size and crc32,
  plus the ``"run"`` block ``{replicaDegree, globalBatch}``, committed by
  atomic rename once the payload is complete. Restore verifies it first;
  a truncated or bit-flipped payload fails verification.
- **Fallback restore**: with no explicit step, intact steps are walked
  newest-first, past any step that fails verification or raises while
  restoring (``max_step`` caps the walk for an anomaly rollback).
  ``ElasticContractError`` is never absorbed by the walk.
- **LKG marker** ``kftpu.lkg.json``: the newest last-known-good step,
  monotonic; retention keeps the last N intact steps and never the LKG.
- **Retried save I/O** with exponential backoff: the temporary
  directory, each process's payload files and the commit (marker and
  rename) are each retried ``save_retries`` times before the save fails.
  The histogram ``kftpu_checkpoint_seconds{op}`` and the counter
  ``kftpu_checkpoint_elastic_restores_total``.

The payload is the port's own and not interchangeable with the JAX
package's: the port does not read orbax payloads and the JAX package does
not read these. Under ``state/`` each process writes one
``torch.save`` file of its tensors (``rank-00000.pt`` …), and process 0
an ``index.json`` of every leaf's path, global shape and dtype and the
tree's plain scalars. A tree (runtime/trainstep.py ``state_tree``) holds
each leaf under its name; a leaf that the sharded update splits is a
:class:`~kubeflow_tpu_torch.parallel.sharding_rules.Shard`, saved as its
global logical array from every rank's block, so the saved shapes do not
depend on the degree. Restore reads the files memory-mapped, assembles
each global leaf and cuts it to the reader's layout, which may split
another dimension than the writer's (a restore at another degree).

Saving is asynchronous on the hot path: :meth:`CheckpointManager.save`
copies the tree to host memory (pinned buffers, reused from save to
save, for CUDA tensors) and writes it on a background thread. One
process commits its step on that thread, manifest included. In a gang
each rank writes its own file; process 0 commits a step (rename, marker,
manifest, retention, a deferred LKG marker) at the next ``save`` or
``wait``, after a barrier on the gang's group says every rank's payload
has landed. ``wait()`` returns once every step saved so far is
committed.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
import zlib
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..obs import registry as obsreg
from ..obs.goodput import SPAN_CKPT_RESTORE, SPAN_CKPT_SAVE
from ..parallel.sharding_rules import Shard
from .bootstrap import resolve_device
from .trainstep import TrainState, load_state_tree, state_tree

log = logging.getLogger(__name__)

# a step is committed once this marker is in its directory (the name the
# JAX package's orbax commit leaves)
ORBAX_COMMIT_MARKER = "_CHECKPOINT_METADATA"
# the integrity manifest, written after the commit
MANIFEST_NAME = "kftpu.manifest.json"
# the last-known-good marker (runtime/sentinel.py)
LKG_MARKER = "kftpu.lkg.json"
# a step being written; never a step directory (not an integer name)
TMP_SUFFIX = ".kftpu-tmp"
PAYLOAD_DIR = "state"
INDEX_NAME = "index.json"
PAYLOAD_FORMAT = "kftpu-torch/1"


def _obs_duration(op: str):
    """Histogram child for one checkpoint operation: save (the
    synchronous submission of the async write), restore, verify."""
    return obsreg.default_registry().histogram(
        "kftpu_checkpoint_seconds",
        "checkpoint operation wall time by op (save = synchronous "
        "submission of the async write; restore; verify = manifest "
        "crc pass)", labels=("op",)).labels(op=op)


class ElasticContractError(ValueError):
    """A breach of the elastic-resize restore contract (a changed global
    batch, a degree the global batch does not divide): never absorbed by
    the newest-first fallback walk, since every candidate step carries
    the same breach."""


def _stat_key(path: str) -> tuple:
    """What any write, truncation or replacement of a file changes."""
    st = os.stat(path)
    return st.st_ino, st.st_size, st.st_mtime_ns, st.st_ctime_ns


def _crc32_file(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                break
            crc = zlib.crc32(buf, crc)
    return crc


class _CrcFile:
    """A binary file that keeps the size and crc32 of what is written
    through it."""

    def __init__(self, f):
        self.f, self.size, self.crc = f, 0, 0

    def write(self, b) -> int:
        self.crc = zlib.crc32(b, self.crc)
        self.size += len(memoryview(b).cast("B"))
        return self.f.write(b)

    def flush(self) -> None:
        self.f.flush()


def _fsync_write(path: str, write: Callable) -> tuple[int, int]:
    """Write a file through ``write(f)`` and fsync it; (size, crc32) of
    what was written."""
    with open(path, "wb") as f:
        w = _CrcFile(f)
        write(w)
        f.flush()
        os.fsync(f.fileno())
    return w.size, w.crc


def write_manifest(step_dir: str, run_meta: Optional[dict] = None,
                   known: Optional[dict] = None) -> dict:
    """Record every payload file's size and crc32 (and ``run_meta``, the
    writer's replicaDegree and globalBatch, under "run") and commit the
    manifest by atomic rename. ``known`` maps a file's path relative to
    the step directory to the (size, crc32) its writer computed while
    writing it; such a file of that size is not read again."""
    known = known or {}
    entries: dict[str, dict] = {}
    for root, _dirs, files in os.walk(step_dir):
        for fname in files:
            if fname == MANIFEST_NAME:
                continue
            path = os.path.join(root, fname)
            rel = os.path.relpath(path, step_dir)
            size = os.path.getsize(path)
            crc = known[rel][1] if rel in known and \
                known[rel][0] == size else _crc32_file(path)
            entries[rel] = {"size": size, "crc32": crc}
    manifest = {"version": 1, "files": entries}
    if run_meta:
        manifest["run"] = dict(run_meta)
    tmp = os.path.join(step_dir, MANIFEST_NAME + ".tmp")
    _fsync_write(tmp, lambda f: f.write(json.dumps(manifest).encode()))
    os.replace(tmp, os.path.join(step_dir, MANIFEST_NAME))
    return manifest


def verify_step_dir(step_dir: str) -> tuple[bool, str]:
    """(intact, reason). An uncommitted step or one whose files differ
    from its manifest is not intact; a committed step without a manifest
    is accepted (the manifest follows the commit)."""
    if not os.path.isdir(step_dir):
        return False, "missing"
    if not os.path.exists(os.path.join(step_dir, ORBAX_COMMIT_MARKER)):
        return False, "uncommitted (no commit metadata)"
    mpath = os.path.join(step_dir, MANIFEST_NAME)
    if not os.path.exists(mpath):
        return True, "no manifest (accepted)"
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return False, f"unreadable manifest: {e}"
    for rel, want in manifest.get("files", {}).items():
        path = os.path.join(step_dir, rel)
        if not os.path.exists(path):
            return False, f"missing file {rel}"
        size = os.path.getsize(path)
        if size != want.get("size"):
            return False, (f"size mismatch {rel}: {size} != "
                           f"{want.get('size')} (truncated write?)")
        if _crc32_file(path) != want.get("crc32"):
            return False, f"checksum mismatch {rel}"
    return True, "verified"


def _flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dicts → ``{"a/b/c": leaf}``."""
    out = {}
    for key, value in tree.items():
        key = str(key)
        if "/" in key:
            raise ValueError(f"checkpoint tree key {key!r} contains '/'")
        if isinstance(value, dict):
            out.update(_flatten(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = value
    return out


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def _rank_file(index: int) -> str:
    return f"rank-{index:05d}.pt"


def _sums_file(index: int) -> str:
    """Process ``index``'s record of its files' sizes and crc32s, read by
    process 0 for the manifest."""
    return f"rank-{index:05d}.crc.json"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class CheckpointManager:
    """Saves and restores training-state trees in ``directory`` with
    commit and corruption detection, previous-step fallback, retention
    and the LKG marker. In a gang every process makes one over the same
    directory and calls ``save`` at the same steps; ``process_index``,
    ``process_count`` and ``group`` (the gang's process group, for the
    commit barrier) default to torch.distributed's world, or one
    process."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1,
                 save_retries: int = 2, retry_backoff_s: float = 0.5,
                 run_meta: Optional[dict] = None,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 group: Any = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.save_retries = max(0, int(save_retries))
        self.retry_backoff_s = retry_backoff_s
        self.save_interval_steps = max(1, int(save_interval_steps or 1))
        # stamped into every manifest's "run" block (elastic resizing)
        self.run_meta = dict(run_meta) if run_meta else None
        self.max_to_keep = max_to_keep
        group_up = dist.is_available() and dist.is_initialized()
        self.process_index = int(process_index if process_index is not None
                                 else dist.get_rank() if group_up else 0)
        self.process_count = int(process_count if process_count is not None
                                 else dist.get_world_size() if group_up
                                 else 1)
        self.group = group
        self._lock = threading.Lock()
        # steps saved but not yet committed, and the LKG tag waiting for
        # its step's commit
        self._pending: set[int] = set()
        # process 0's own files of a pending step: {rel path: (size, crc)}
        self._sums: dict[int, dict] = {}
        self._lkg_deferred: Optional[int] = None
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None
        self._saved_any = False
        # host buffers the CUDA snapshot copies into, reused save to save
        self._pinned: dict[str, torch.Tensor] = {}
        # steps known intact, each with the stat keys of its files when
        # it was verified (or, for a step this manager committed, when its
        # manifest was written from the write-time crc32s): a poll or a
        # retention pass re-hashes no unchanged step, and a file
        # truncated, rewritten or removed since is verified again
        self._intact_cache: dict[int, dict[str, tuple]] = {}
        # (op, wall start, wall end, step) per save submission and
        # restore, drained by the worker into trace spans; bounded
        self._op_log: list[tuple] = []
        # per save: the step; seconds synchronous (of them, waiting for
        # the previous write), then on the writer thread the host copies
        # landing, the payload written and fsynced, the commit (one
        # process), from the call to the end; this process's payload
        # bytes. Per restore: the step, seconds.
        self.save_stats: list[dict] = []
        self.restore_stats: list[dict] = []

    def _log_op(self, op: str, t0_wall: float, step) -> None:
        self._op_log.append((op, t0_wall, time.time(),
                             int(step) if step is not None else -1))
        del self._op_log[:-256]

    def drain_op_log(self) -> list[tuple]:
        """Pop the recorded (op, wall_start, wall_end, step) entries."""
        out, self._op_log = self._op_log, []
        return out

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _barrier(self) -> None:
        if self.process_count > 1:
            dist.barrier(group=self.group)

    # ------------------------------------------------------------------ save

    def should_save(self, step: int) -> bool:
        """Whether ``save(step)`` without ``force`` writes, as orbax
        decides for the JAX package: always into a directory with no
        step yet, else on the interval and newer than every step on disk
        or in flight."""
        with self._lock:
            newest = max([*self.all_steps(), *self._pending], default=None)
        return newest is None or (
            step > newest and step % self.save_interval_steps == 0)

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Save ``state`` (a ``TrainState``, or a tree of nested dicts of
        tensors, numpy arrays, Shards and plain scalars) at ``step``;
        False when the interval gate skips it. Returns once the state is
        copied to host memory; the write runs on a background thread, and
        its failure surfaces at the next ``save`` or ``wait``."""
        step = int(step)
        if not force and not self.should_save(step):
            return False
        t0_wall = time.time()
        t0 = time.perf_counter()
        self._finish_writes()
        wait_s = time.perf_counter() - t0
        self._prepare(step)
        tree = state_tree(state) if isinstance(state, TrainState) else state
        self._submit(step, tree, t0)
        self._saved_any = True
        sync_s = time.perf_counter() - t0
        self.save_stats[-1].update(sync_s=sync_s, wait_s=wait_s)
        log.info("checkpoint saved at step %d -> %s", step, self.directory)
        _obs_duration("save").observe(sync_s)
        self._log_op(SPAN_CKPT_SAVE, t0_wall, step)
        return True

    def _retried(self, what: str, step: int, fn: Callable[[], Any]) -> Any:
        """``fn()``, a save's file-system I/O, retried ``save_retries``
        times with exponential backoff (transient errors of a network
        file system); ``fn`` must be safe to run again."""
        delay = self.retry_backoff_s
        for attempt in range(self.save_retries + 1):
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — transient fs/IO errors
                if attempt >= self.save_retries:
                    raise
                log.warning("checkpoint %s @%d failed (%s); retry %d/%d "
                            "in %.1fs", what, step, e, attempt + 1,
                            self.save_retries, delay)
                time.sleep(delay)
                delay *= 2

    def _prepare(self, step: int) -> None:
        """The gang-synchronous part of a save: every rank's earlier
        payload has landed (barrier), process 0 commits those steps,
        clears the corrupt remains of ``step`` and makes its temporary
        directory, and the ranks pass a second barrier. An intact step
        already at ``step`` raises on every rank."""
        self._barrier()
        if self.process_index == 0:
            self._commit_pending()
            self._clear_corrupt_step(step)
            tmp = self._step_dir(step) + TMP_SUFFIX

            def make_tmp() -> None:
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(os.path.join(tmp, PAYLOAD_DIR))

            self._retried("prepare", step, make_tmp)
        self._barrier()
        if os.path.isdir(self._step_dir(step)):
            raise FileExistsError(
                f"checkpoint step {step} already exists in "
                f"{self.directory} and is intact")

    def _host_copy(self, key: str, t: torch.Tensor) -> torch.Tensor:
        """A host copy of ``t``: into a pinned buffer, asynchronously on
        the current stream, for a CUDA tensor; a clone otherwise."""
        t = t.detach()
        if t.device.type != "cuda":
            return t.clone(memory_format=torch.contiguous_format)
        buf = self._pinned.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._pinned[key] = buf
        buf.copy_(t, non_blocking=True)
        return buf

    def _submit(self, step: int, tree: dict, t0: float) -> None:
        """Snapshot this process's part of ``tree`` to host memory and
        start the background write."""
        tensors: dict[str, torch.Tensor] = {}
        leaves: dict[str, dict] = {}
        scalars: dict[str, Any] = {}
        events = set()
        for path, v in _flatten(tree).items():
            if isinstance(v, Shard):
                if v.index != self.process_index:
                    raise ValueError(
                        f"{path}: block {v.index} of {v.count} held by "
                        f"process {self.process_index}")
                leaves[path] = {"shape": list(v.shape),
                                "dtype": _dtype_name(v.block.dtype),
                                "dim": v.dim, "blocks": v.count}
                t = v.block
            elif isinstance(v, (torch.Tensor, np.ndarray)):
                t = torch.as_tensor(v)
                leaves[path] = {"shape": list(t.shape),
                                "dtype": _dtype_name(t.dtype)}
                if self.process_index != 0:
                    continue      # whole leaves: process 0 writes them
            elif v is None or isinstance(v, (bool, int, float, str)):
                scalars[path] = v
                continue
            else:
                raise TypeError(f"checkpoint leaf {path}: "
                                f"{type(v).__name__}")
            tensors[path] = self._host_copy(path, t)
            if t.device.type == "cuda":
                events.add(t.device)
        ready = []
        for dev in events:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            ready.append(ev)
        index = {"format": PAYLOAD_FORMAT, "step": step,
                 "processes": self.process_count, "leaves": leaves,
                 "scalars": scalars} if self.process_index == 0 else None
        stats = {"step": step, "sync_s": 0.0, "wait_s": 0.0,
                 "copy_s": None, "write_s": None, "commit_s": None,
                 "total_s": None, "bytes": 0}
        self.save_stats.append(stats)
        with self._lock:
            self._pending.add(step)
        self._writer = threading.Thread(
            target=self._write, args=(step, tensors, index, ready, stats,
                                      t0),
            name=f"checkpoint-write-{step}")
        self._writer.start()

    def _write(self, step: int, tensors: dict, index: Optional[dict],
               ready: list, stats: dict, t0: float) -> None:
        """The background write of one process's payload (and, for one
        process, the commit)."""
        try:
            t1 = time.perf_counter()
            for ev in ready:
                ev.synchronize()
            t2 = time.perf_counter()
            pdir = os.path.join(self._step_dir(step) + TMP_SUFFIX,
                                PAYLOAD_DIR)
            name = _rank_file(self.process_index)

            def write_files() -> dict:
                sums = {f"{PAYLOAD_DIR}/{name}": _fsync_write(
                    os.path.join(pdir, name),
                    lambda f: torch.save(tensors, f))}
                if index is not None:
                    sums[f"{PAYLOAD_DIR}/{INDEX_NAME}"] = _fsync_write(
                        os.path.join(pdir, INDEX_NAME),
                        lambda f: f.write(json.dumps(index).encode()))
                if self.process_index != 0:
                    _fsync_write(os.path.join(
                        pdir, _sums_file(self.process_index)),
                        lambda f: f.write(json.dumps(sums).encode()))
                return sums

            sums = self._retried("write", step, write_files)
            stats["bytes"] = sums[f"{PAYLOAD_DIR}/{name}"][0]
            if self.process_index == 0:
                with self._lock:
                    self._sums[step] = sums
            t3 = time.perf_counter()
            stats.update(copy_s=t2 - t1, write_s=t3 - t2)
            if self.process_count == 1:
                self._commit(step)
                stats["commit_s"] = time.perf_counter() - t3
            stats["total_s"] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — surfaced in wait()
            with self._lock:
                self._pending.discard(step)
                self._sums.pop(step, None)
            self._write_error = e

    def _finish_writes(self) -> None:
        """Join this process's background write; raise its failure."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        err, self._write_error = self._write_error, None
        if err is not None:
            raise err

    def _commit_pending(self) -> None:
        with self._lock:
            pending = sorted(self._pending)
        for step in pending:
            self._commit(step)

    def _commit(self, step: int) -> None:
        """Process 0: mark the step committed, rename it into place,
        write its manifest (from the sizes and crc32s every process
        recorded while writing its files), apply retention and a deferred
        LKG tag."""
        tmp = self._step_dir(step) + TMP_SUFFIX
        with self._lock:
            known = self._sums.pop(step, {})
        for i in range(1, self.process_count):
            try:
                with open(os.path.join(tmp, PAYLOAD_DIR, _sums_file(i))) as f:
                    known.update({k: tuple(v)
                                  for k, v in json.load(f).items()})
            except (OSError, ValueError):
                pass       # the manifest then reads that file itself
        final = self._step_dir(step)

        def mark_and_rename() -> None:
            known[ORBAX_COMMIT_MARKER] = _fsync_write(
                os.path.join(tmp, ORBAX_COMMIT_MARKER),
                lambda f: f.write(json.dumps(
                    {"step": step, "format": PAYLOAD_FORMAT,
                     "time": time.time()}).encode()))
            os.rename(tmp, final)

        self._retried("commit", step, mark_and_rename)
        try:
            manifest = write_manifest(final, run_meta=self.run_meta,
                                      known=known)
            self._mark_intact(step, manifest)
        except OSError as e:
            # a missing manifest only downgrades verification
            log.warning("manifest write for step %d failed: %s", step, e)
        with self._lock:
            self._pending.discard(step)
            lkg = self._lkg_deferred \
                if self._lkg_deferred is not None and \
                self._lkg_deferred <= step else None
        if lkg is not None:
            self._write_lkg(lkg)
            with self._lock:
                if self._lkg_deferred == lkg:
                    self._lkg_deferred = None
        self._retain()

    def wait(self) -> None:
        """Return once every step saved so far is committed (in a gang,
        on every rank: the commit sits between two barriers); raise a
        background write's failure."""
        self._finish_writes()
        if self.process_count > 1 and self._saved_any:
            self._barrier()
            if self.process_index == 0:
                self._commit_pending()
            self._barrier()

    def _clear_corrupt_step(self, step: int) -> None:
        """Remove a non-intact step directory (the remains of a save that
        restore fell back past); an intact one is never touched."""
        step_dir = self._step_dir(step)
        if not os.path.isdir(step_dir):
            return
        ok, reason = self.verify_step(step)
        if ok:
            return
        log.warning("clearing corrupt remains of step %d (%s)", step, reason)
        shutil.rmtree(step_dir, ignore_errors=True)

    def _retain(self) -> None:
        """Keep the last N intact steps and the LKG; a non-intact
        directory costs no slot and is never deleted here (it may be a
        writer's). Process 0 only. A step this manager committed, or
        verified before, is checked by the stat of its files, so
        retention re-hashes no unchanged step and still sees one
        corrupted since."""
        if not self.max_to_keep or self.max_to_keep <= 0:
            return
        intact = [s for s in self.all_steps() if self.verify_step(s)[0]]
        keep = set(intact[-self.max_to_keep:])
        lkg = self.lkg_step()
        if lkg is not None:
            keep.add(lkg)
        for s in intact:
            if s in keep:
                continue
            log.info("retention: dropping intact step %d (keep-last-%d "
                     "+ LKG)", s, self.max_to_keep)
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
            with self._lock:
                self._intact_cache.pop(s, None)

    # -------------------------------------------------------- LKG tagging

    def lkg_step(self) -> Optional[int]:
        """The last-known-good step: the marker file's, or a newer tag of
        this manager whose step is still being committed; None when
        neither exists."""
        try:
            with open(os.path.join(self.directory, LKG_MARKER)) as f:
                step = json.load(f).get("step")
        except (OSError, ValueError):
            step = None
        marked = int(step) if isinstance(step, int) else None
        deferred = self._lkg_deferred
        if deferred is not None and (marked is None or deferred > marked):
            return deferred
        return marked

    def tag_lkg(self, step: int) -> None:
        """Mark ``step`` last-known-good: monotonic and atomic, written by
        process 0 once the step is committed (a tag of a step still in
        flight waits for its commit)."""
        step = int(step)
        cur = self.lkg_step()
        if cur is not None and cur >= step:
            return
        with self._lock:
            if step in self._pending:
                if self._lkg_deferred is None or self._lkg_deferred < step:
                    self._lkg_deferred = step
                return
        self._write_lkg(step)

    def _write_lkg(self, step: int) -> None:
        if self.process_index == 0:
            tmp = os.path.join(self.directory, LKG_MARKER + ".tmp")
            _fsync_write(tmp, lambda f: f.write(json.dumps(
                {"step": step, "time": time.time()}).encode()))
            os.replace(tmp, os.path.join(self.directory, LKG_MARKER))
        from .sentinel import lkg_gauge
        lkg_gauge().set(step)

    def discard_steps_after(self, step: int) -> None:
        """Delete every step directory newer than ``step`` (the anomaly
        rollback restored the LKG; newer steps are tainted). Process 0
        only."""
        if self.process_index != 0:
            return
        for s in self.all_steps():
            if s > step:
                log.warning("rollback: discarding tainted step %d "
                            "(> LKG %d)", s, step)
                shutil.rmtree(self._step_dir(s), ignore_errors=True)
                with self._lock:
                    self._intact_cache.pop(s, None)

    # ----------------------------------------------------------- inspection

    def all_steps(self) -> list[int]:
        """Integer-named step directories, ascending (committed or not)."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(int(n) for n in names
                      if n.isdigit() and
                      os.path.isdir(os.path.join(self.directory, n)))

    def _mark_intact(self, step: int, manifest: dict) -> None:
        """Cache ``step`` as intact under the stat keys of its manifest's
        files and of the manifest."""
        step_dir = self._step_dir(step)
        paths = [os.path.join(step_dir, rel)
                 for rel in (*manifest.get("files", {}), MANIFEST_NAME)]
        try:
            stats = {p: _stat_key(p) for p in paths}
        except OSError:
            return
        with self._lock:
            self._intact_cache[step] = stats

    def verify_step(self, step: int) -> tuple[bool, str]:
        """(intact, reason), from the cache while none of the step's
        files changed since it was known intact, else against its
        manifest."""
        step_dir = self._step_dir(step)
        with self._lock:
            stats = self._intact_cache.get(step)
        if stats is not None:
            try:
                if all(_stat_key(p) == k for p, k in stats.items()):
                    return True, "verified (cached)"
            except OSError:
                pass
            with self._lock:
                self._intact_cache.pop(step, None)
        t0 = time.perf_counter()
        ok, reason = verify_step_dir(step_dir)
        _obs_duration("verify").observe(time.perf_counter() - t0)
        if ok:
            try:
                with open(os.path.join(step_dir, MANIFEST_NAME)) as f:
                    self._mark_intact(step, json.load(f))
            except (OSError, ValueError):
                pass     # no manifest: accepted, never cached
        return ok, reason

    def run_meta_of(self, step: int) -> dict:
        """The "run" block of a step's manifest; {} without one."""
        mpath = os.path.join(self._step_dir(step), MANIFEST_NAME)
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return {}
        run = manifest.get("run")
        return dict(run) if isinstance(run, dict) else {}

    def intact_steps(self) -> list[int]:
        """Committed and checksum-verified steps, ascending."""
        out = []
        for step in self.all_steps():
            ok, reason = self.verify_step(step)
            if ok:
                out.append(step)
            else:
                log.warning("checkpoint step %d skipped: %s", step, reason)
        return out

    def latest_step(self) -> Optional[int]:
        """The newest intact step, verifying newest-first."""
        for step in reversed(self.all_steps()):
            ok, reason = self.verify_step(step)
            if ok:
                return step
            log.warning("checkpoint step %d skipped: %s", step, reason)
        return None

    # --------------------------------------------------------------- restore

    def _restore_with_fallback(self, restore_fn: Callable[[int], Any],
                               step: Optional[int],
                               max_step: Optional[int] = None) -> Any:
        """An explicit step is verified and restored, or raises. Otherwise
        intact steps are walked newest-first (at most ``max_step``),
        falling back past any that fails verification or restore."""
        def timed(s: int) -> Any:
            t0_wall = time.time()
            t0 = time.perf_counter()
            out = restore_fn(s)
            secs = time.perf_counter() - t0
            _obs_duration("restore").observe(secs)
            self.restore_stats.append({"step": s, "s": secs})
            self._log_op(SPAN_CKPT_RESTORE, t0_wall, s)
            return out

        if step is not None:
            ok, reason = self.verify_step(step)
            if not ok:
                raise ValueError(
                    f"checkpoint step {step} in {self.directory} is not "
                    f"intact: {reason}")
            return timed(step)
        last_err: Optional[BaseException] = None
        for candidate in reversed(self.all_steps()):
            if max_step is not None and candidate > max_step:
                continue
            ok, reason = self.verify_step(candidate)
            if not ok:
                log.warning("checkpoint step %d skipped: %s",
                            candidate, reason)
                continue
            try:
                return timed(candidate)
            except ElasticContractError:
                raise   # a breach is a breach at every step
            except Exception as e:  # noqa: BLE001 — fall back a step
                last_err = e
                log.warning("restore of step %d failed (%s); falling back "
                            "to the previous intact step", candidate, e)
        if last_err is not None:
            raise last_err
        raise FileNotFoundError(f"no intact checkpoint in {self.directory}")

    def check_elastic_resume(self, step: Optional[int],
                             replica_degree: Optional[int],
                             global_batch: Optional[int]) -> dict:
        """The elastic-resize contract, checked before the reshape: a step
        written at another replica degree restores only at the same
        global batch, which must divide the new degree. Returns
        {"resharded": True, "from": N, "to": M}, or {} when the step has
        no run metadata or the degree is unchanged; raises
        ElasticContractError on a breach."""
        if step is None:
            step = self.latest_step()
        if step is None or replica_degree is None:
            return {}
        saved = self.run_meta_of(step)
        saved_degree = saved.get("replicaDegree")
        if not saved_degree or saved_degree == replica_degree:
            return {}
        saved_gb = saved.get("globalBatch")
        if saved_gb and global_batch and saved_gb != global_batch:
            raise ElasticContractError(
                f"elastic restore of step {step}: checkpoint was "
                f"written at global batch {saved_gb} but this worker "
                f"runs {global_batch} — resizing keeps the global "
                f"batch FIXED (only the replica degree changes); "
                f"refusing a silent trajectory change")
        if global_batch and global_batch % replica_degree:
            raise ElasticContractError(
                f"elastic restore of step {step}: global batch "
                f"{global_batch} does not divide the new replica "
                f"degree {replica_degree}")
        log.info("elastic restore @%d: reshaping state across replica "
                 "degrees %d -> %d (global batch fixed)", step,
                 saved_degree, replica_degree)
        obsreg.counter(
            "kftpu_checkpoint_elastic_restores_total",
            "restores that reshaped sharded state across a different "
            "data-parallel replica degree (elastic resize)").inc()
        return {"resharded": True, "from": saved_degree,
                "to": replica_degree}

    def read_tree(self, step: int, only: tuple = ()) -> dict:
        """The saved tree of ``step`` as global CPU tensors (memory-mapped
        from the payload files) and plain scalars; ``only`` restricts it
        to those top-level keys."""
        pdir = os.path.join(self._step_dir(step), PAYLOAD_DIR)
        with open(os.path.join(pdir, INDEX_NAME)) as f:
            index = json.load(f)
        if index.get("format") != PAYLOAD_FORMAT:
            raise ValueError(f"step {step}: payload format "
                             f"{index.get('format')!r}, not "
                             f"{PAYLOAD_FORMAT!r}")
        files: dict[int, dict] = {}

        def rank_file(i: int) -> dict:
            if i not in files:
                files[i] = torch.load(os.path.join(pdir, _rank_file(i)),
                                      map_location="cpu", mmap=True,
                                      weights_only=True)
            return files[i]

        def wanted(path: str) -> bool:
            return not only or path.split("/", 1)[0] in only

        flat: dict[str, Any] = {}
        for path, meta in index["leaves"].items():
            if not wanted(path):
                continue
            if meta.get("blocks"):
                t = torch.cat([rank_file(i)[path]
                               for i in range(meta["blocks"])],
                              dim=meta["dim"])
            else:
                t = rank_file(0)[path]
            if list(t.shape) != meta["shape"] or \
                    _dtype_name(t.dtype) != meta["dtype"]:
                raise ValueError(
                    f"step {step} leaf {path}: {_dtype_name(t.dtype)} "
                    f"{list(t.shape)}, index says {meta['dtype']} "
                    f"{meta['shape']}")
            flat[path] = t
        flat.update({p: v for p, v in index["scalars"].items()
                     if wanted(p)})
        return _unflatten(flat)

    def restore(self, state_template: TrainState,
                step: Optional[int] = None,
                expect_run: Optional[tuple] = None,
                max_step: Optional[int] = None) -> TrainState:
        """Restore into the template, a ``TrainState`` built at the
        reader's degree: loaded in place on its devices, its optimizer
        state cut to the reader's layout (runtime/trainstep.py
        ``load_state_tree``). ``expect_run`` = (replica_degree,
        global_batch) of the reader: the elastic contract is checked
        against each step the walk actually restores."""
        def _restore(s: int) -> TrainState:
            if expect_run is not None:
                self.check_elastic_resume(s, *expect_run)
            return load_state_tree(state_template, self.read_tree(s))

        return self._restore_with_fallback(_restore, step,
                                           max_step=max_step)

    def restore_params(self, step: Optional[int] = None, device="cuda",
                       variables: bool = False) -> Any:
        """The params of the newest intact step (or ``step``), template
        free, on ``device`` (cuda unless the caller asks for the CPU;
        raises without a card): the ``params`` subtree of a trainer's
        state, or the whole tree of a params-only checkpoint. With
        ``variables``, ``{"params": ..., **variables}`` (ResNet's
        ``batch_stats``)."""
        device = resolve_device(device)

        def _restore(s: int) -> Any:
            tree = self.read_tree(s, only=("params", "variables"))
            if not tree:
                tree = self.read_tree(s)
            params = tree.get("params", tree)
            out = {"params": params, **tree.get("variables", {})} \
                if variables else params
            return _to(out, device)

        return self._restore_with_fallback(_restore, step)

    def close(self, wait: bool = True) -> None:
        """``wait()`` (best-effort: a failure is logged), or with ``wait``
        False only join this process's background write; then release
        the host buffers."""
        try:
            if wait:
                self.wait()
            else:
                self._finish_writes()
        except Exception as e:  # noqa: BLE001 — close stays best-effort
            log.warning("checkpoint close failed: %s", e)
        self._pinned = {}


def _to(tree: dict, device: torch.device) -> dict:
    """Private copies of a tree's tensors on ``device``."""
    return {k: _to(v, device) if isinstance(v, dict) else
            v.to(device, copy=True) if isinstance(v, torch.Tensor) else v
            for k, v in tree.items()}

