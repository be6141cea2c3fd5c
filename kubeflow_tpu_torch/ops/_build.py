"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` holds a plain ``extern "C"`` interface (no PyTorch
headers), so one ``nvcc`` call takes seconds, where an extension that
includes PyTorch's headers takes minutes; ``csrc/*.cuh`` are headers the
sources share. The shared library lands in the build directory under a
name keyed by a hash of the source, the headers, the flags and ``nvcc
--version``'s release line, so an edited source or header, or another
toolkit, rebuilds and an unchanged one is loaded as it is. A missing
``nvcc`` or a failed build raises: there is no fallback on the card.

The build directory is ``kubeflow_tpu_torch/_build/``, or, once
``runtime/compile_cache.enable_compilation_cache`` has set one, the
compile cache's directory and only that (a volume shared by the
processes of a namespace: the first builds, the rest load). Every
library loaded from disk counts as a hit and every ``nvcc`` run as a
miss, with their seconds (``stats()``), also in the process registry
under the JAX package's compile-cache families
(runtime/compile_cache.py says what each counts).

``loaded_libraries()`` names the libraries this process has loaded, each
with its file name and sha256, and ``load_recorded`` loads one by such a
record, from the build directory only and never through ``nvcc``: the
AOT warm start (runtime/aot.py) keeps them in its step record.

    python -m kubeflow_tpu_torch.ops._build     # build every source, print ptxas
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

from ..obs import registry as obsreg

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# where the CUDA toolkit is looked for after CUDA_HOME, CUDA_PATH and PATH
DEFAULT_CUDA_HOME = "/usr/local/cuda"

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_loaded_paths: dict[str, str] = {}     # name -> the file it was loaded from
# the compile cache's directory, when one is enabled (set_cache_dir)
_cache_dir: Optional[str] = None
# per process: libraries loaded from disk (hits) and nvcc runs (misses)
_stats = {"hits": 0, "misses": 0, "hit_s": 0.0, "build_s": 0.0}
_stats_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def sources() -> list[str]:
    """Names of every CUDA source in csrc/ (without the .cu suffix)."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append(os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        f"nvcc not found (CUDA_HOME, CUDA_PATH, PATH, {DEFAULT_CUDA_HOME}"
        f"/bin): the CUDA kernels cannot be built, and the CUDA path has "
        f"no fallback")


def set_cache_dir(path: Optional[str]) -> None:
    """Build into and load from ``path`` only (None: back to _build/)."""
    global _cache_dir
    with _lock:
        _cache_dir = path
        _loaded.clear()
        _loaded_paths.clear()


def build_dir() -> str:
    """Where libraries are built and looked for: the compile cache's
    directory when one is set, ``_build/`` otherwise."""
    return _cache_dir or BUILD_DIR


def stats() -> dict:
    """This process's hits (libraries loaded from disk) and misses
    (``nvcc`` runs), with their seconds."""
    with _stats_lock:
        return dict(_stats)


def _count(event: str, seconds: float) -> None:
    """One ``"hit"`` or ``"miss"``: the process's stats and metrics."""
    key, secs = ("hits", "hit_s") if event == "hit" else \
        ("misses", "build_s")
    with _stats_lock:
        _stats[key] += 1
        _stats[secs] += seconds
    # families resolved per event: the default registry is resettable
    events = obsreg.counter(
        "kftpu_compile_cache_events_total",
        "persistent compilation cache activity (hit/miss/request)",
        labels=("event",))
    events.labels(event=event).inc()
    events.labels(event="request").inc()
    stages = obsreg.counter(
        "kftpu_xla_compile_seconds_total",
        "cumulative seconds by stage: every kernel library built or "
        "loaded vs the loads from the cache", labels=("stage",))
    stages.labels(stage="compile_or_load").inc(seconds)
    if event == "hit":
        stages.labels(stage="cache_load").inc(seconds)


@functools.lru_cache(maxsize=None)
def _release_of(nvcc: str) -> str:
    out = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, timeout=60).stdout
    return next((line.strip() for line in out.splitlines()
                 if "release" in line), out.strip())


def nvcc_release() -> str:
    """``nvcc --version``'s release line, or "" where there is no nvcc
    (the build then raises)."""
    try:
        return _release_of(find_nvcc())
    except (KernelBuildError, OSError, subprocess.SubprocessError):
        return ""


def _source_path(name: str) -> str:
    path = os.path.join(CSRC_DIR, f"{name}.cu")
    if not os.path.isfile(path):
        raise KernelBuildError(f"no CUDA source {path}")
    return path


def library_path(name: str) -> str:
    """Where the build of ``csrc/<name>.cu`` lives, keyed by its content,
    the content of every header in csrc/, the flags and the toolkit's
    release."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [_source_path(name)] + [os.path.join(CSRC_DIR, f)
                                        for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc_release().encode())
    return os.path.join(build_dir(), f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str, verbose: bool) -> tuple[subprocess.Popen, str, str]:
    out = library_path(name)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", tmp, _source_path(name)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: str, out: str) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise KernelBuildError(
            f"nvcc failed on csrc/{name}.cu (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
    return log


def build_all(names: Optional[list[str]] = None,
              verbose: bool = False) -> dict[str, dict]:
    """Compile the named sources (default: all), one ``nvcc`` process per
    source, all started together. Returns ``{name: {"path", "log",
    "seconds"}}``; ``verbose`` adds ``-Xptxas -v`` (registers, shared
    memory and spills per kernel) to the log."""
    names = sources() if names is None else list(names)
    t0 = time.perf_counter()
    started = [(n, *_start(n, verbose)) for n in names]
    result = {}
    t_prev = t0
    for name, proc, tmp, out in started:
        log = _finish(name, proc, tmp, out)
        t_done = time.perf_counter()
        # the builds overlap: each miss is charged the wall time since the
        # previous one finished, so the misses sum to the wall time
        _count("miss", t_done - t_prev)
        t_prev = t_done
        result[name] = {"path": out, "log": log, "seconds": t_done - t0}
    return result


def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library for ``csrc/<name>.cu``, built on first
    use. Thread-safe; raises KernelBuildError when it cannot be built."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        path = library_path(name)
        t0 = time.perf_counter()
        hit = os.path.exists(path)
        if not hit:
            _finish(name, *_start(name, verbose=False))
        lib = ctypes.CDLL(path)
        _count("hit" if hit else "miss", time.perf_counter() - t0)
        _loaded[name] = lib
        _loaded_paths[name] = path
        return lib


def file_digest(path: str) -> str:
    """sha256 of a file's bytes, hex."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def loaded_libraries() -> list[tuple[str, str, str]]:
    """``(name, file name under build_dir(), sha256)`` of every library
    this process has loaded, sorted by name."""
    with _lock:
        paths = sorted(_loaded_paths.items())
    return [(name, os.path.basename(path), file_digest(path))
            for name, path in paths]


def load_recorded(name: str, file_name: str, sha256: str) -> ctypes.CDLL:
    """Load ``csrc/<name>.cu``'s library from the record of an earlier
    process: ``file_name`` under :func:`build_dir` with the digest
    ``sha256``. Never runs ``nvcc``: raises KernelBuildError when the
    file is missing, its digest differs, or it is not the build of this
    checkout's sources (its name is keyed by their hash). Counted as a
    hit, as :func:`load_library` counts a load from disk."""
    with _lock:
        if os.path.basename(library_path(name)) != file_name:
            raise KernelBuildError(
                f"{file_name} is not the build of this checkout's "
                f"csrc/{name}.cu")
        path = os.path.join(build_dir(), file_name)
        if not os.path.exists(path):
            raise KernelBuildError(f"{path} is not in the build cache")
        if _loaded_paths.get(name) == path:
            return _loaded[name]
        t0 = time.perf_counter()
        if file_digest(path) != sha256:
            raise KernelBuildError(f"{path}: sha256 differs from the "
                                   f"record's")
        lib = ctypes.CDLL(path)
        _count("hit", time.perf_counter() - t0)
        _loaded[name] = lib
        _loaded_paths[name] = path
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        lib.kftpu_cuda_error_string.restype = ctypes.c_char_p
        lib.kftpu_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.kftpu_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


if __name__ == "__main__":
    for n, r in build_all(verbose=True).items():
        print(f"{n}: {r['path']} in {r['seconds']:.1f}s\n{r['log']}")
