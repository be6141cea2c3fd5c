"""The persistent kernel build cache: what makes a restart warm.

The port's copy of ``kubeflow_tpu/runtime/compile_cache.py``. The port
runs no graph compiler: what a cold process pays before its first step
or its first answer is the ``nvcc`` build of each CUDA kernel it launches
(ops/_build.py). Those builds are keyed by content (source, headers,
flags, toolkit release) and written atomically, so a directory of them
is a cache that any number of processes may share: pointing
``ops/_build.py`` at one on the checkpoint or model volume makes every
start after the first load its kernels instead of building them.

Wiring, as in the JAX package: ``KFTPU_COMPILE_CACHE_DIR`` (the
operator renders ``<checkpointDir>/.jax-compile-cache``; the name stays
the JAX package's so one manifest serves both), and the worker, the
model server, the gRPC server and the batch-predict job call
``enable_compilation_cache()`` before their first kernel launch.

Metrics (counted by ops/_build.py into the process registry), under the
JAX package's names so one dashboard reads both:

- ``kftpu_compile_cache_events_total{event}``: ``hit`` = a kernel library
  loaded from the build directory; ``miss`` = an ``nvcc`` run;
  ``request`` = either.
- ``kftpu_xla_compile_seconds_total{stage}``: ``compile_or_load`` = the
  seconds of every hit and miss; ``cache_load`` = the hits' share of it.

``compile_stats()`` keeps the JAX package's keys; its
``xla_backend_compiles`` is the count of ``nvcc`` runs. :func:`start_kind`
is the warm/cold rule; "aot" comes from the worker's AOT ladder only
(runtime/aot.py), as in the JAX package.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

from ..ops import _build

log = logging.getLogger(__name__)

COMPILE_CACHE_ENV = "KFTPU_COMPILE_CACHE_DIR"
# the default cache location on the checkpoint / model volume
COMPILE_CACHE_SUBDIR = ".jax-compile-cache"

# Cluster-shared cache: the operator points every gang of a namespace at
# <root>/<namespace>, so the first job to build a kernel warms it for
# every other job, rebind, resize and serving scale-up in that namespace
# (the build key holds nvcc's release, so nodes with another toolkit
# build their own libraries beside the others).
SHARED_CACHE_ROOT_ENV = "KFTPU_SHARED_CACHE_ROOT"

_active: Optional[str] = None


def namespace_cache_dir(root: str, namespace: str) -> str:
    """One cache directory per namespace under the shared volume:
    namespaces are the tenancy boundary."""
    return root.rstrip("/") + "/" + namespace


def default_cache_dir(volume_dir: str) -> str:
    """``<volume>/.jax-compile-cache`` with normalized slashes."""
    return volume_dir.rstrip("/") + "/" + COMPILE_CACHE_SUBDIR


def enable_compilation_cache(path: Optional[str] = None) -> Optional[str]:
    """Build and load every kernel library in ``path`` (defaults to
    $KFTPU_COMPILE_CACHE_DIR) and nowhere else. No-op when neither is set.
    Returns the active cache dir, or None.

    Safe to call more than once; failures downgrade to a warning — a
    broken cache volume must never kill a training gang or a model
    server. A bucket URI (``gs://...``) is refused with a warning: the
    build directory is a local path, and ``os.makedirs`` would make a
    ``gs:`` directory on ephemeral disk."""
    global _active
    path = path or os.environ.get(COMPILE_CACHE_ENV)
    if not path:
        return None
    if _active == path:
        return path
    if "://" in path:
        log.warning("compilation cache disabled (%s): the kernel build "
                    "cache needs a local path", path)
        return None
    try:
        os.makedirs(path, exist_ok=True)
        if not os.access(path, os.W_OK | os.X_OK):
            raise PermissionError(f"{path} is not writable")
    except OSError as e:   # the cache is an optimization only
        log.warning("compilation cache disabled (%s): %s", path, e)
        return None
    _build.set_cache_dir(path)
    _active = path
    log.info("persistent kernel build cache at %s", path)
    return path


def compile_stats() -> dict:
    """Snapshot of the process's kernel builds and loads, under the JAX
    package's keys. Diff two snapshots around a program region to
    attribute its builds: ``cache_hits`` libraries loaded from disk,
    ``cache_misses`` and ``xla_backend_compiles`` ``nvcc`` runs."""
    st = _build.stats()
    hits, misses = st["hits"], st["misses"]
    return {"cache_hits": hits, "cache_misses": misses,
            "cache_requests": hits + misses,
            "compiles_or_loads": hits + misses,
            "compile_or_load_s": st["hit_s"] + st["build_s"],
            "cache_load_s": st["hit_s"],
            "xla_backend_compiles": misses}


def start_kind(before: dict, after: dict) -> str:
    """The start-kind rule over a window of two ``compile_stats()``
    snapshots: warm when the window loaded a library from the cache and
    ran no ``nvcc``, cold otherwise."""
    hits = after["cache_hits"] - before["cache_hits"]
    builds = after["xla_backend_compiles"] - before["xla_backend_compiles"]
    return "warm" if hits > 0 and builds == 0 else "cold"
