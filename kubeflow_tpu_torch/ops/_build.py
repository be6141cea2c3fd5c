"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` holds a plain ``extern "C"`` interface (no PyTorch
headers), so one ``nvcc`` call takes seconds, where an extension that
includes PyTorch's headers takes minutes; ``csrc/*.cuh`` are headers the
sources share. The shared library lands in ``kubeflow_tpu_torch/_build/``
under a name keyed by a hash of the source, the headers and the flags, so
an edited source or header rebuilds and an unchanged one is loaded as it
is. A missing ``nvcc`` or a failed build raises: there is no
fallback on the card.

    python -m kubeflow_tpu_torch.ops._build     # build every source, print ptxas
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# where the CUDA toolkit is looked for after CUDA_HOME, CUDA_PATH and PATH
DEFAULT_CUDA_HOME = "/usr/local/cuda"

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


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


def _source_path(name: str) -> str:
    path = os.path.join(CSRC_DIR, f"{name}.cu")
    if not os.path.isfile(path):
        raise KernelBuildError(f"no CUDA source {path}")
    return path


def library_path(name: str) -> str:
    """Where the build of ``csrc/<name>.cu`` lives, keyed by its content,
    the content of every header in csrc/ and the flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [_source_path(name)] + [os.path.join(CSRC_DIR, f)
                                        for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str, verbose: bool) -> tuple[subprocess.Popen, str, str]:
    out = library_path(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
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
    for name, proc, tmp, out in started:
        log = _finish(name, proc, tmp, out)
        result[name] = {"path": out, "log": log,
                        "seconds": time.perf_counter() - t0}
    return result


def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library for ``csrc/<name>.cu``, built on first
    use. Thread-safe; raises KernelBuildError when it cannot be built."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        path = library_path(name)
        if not os.path.exists(path):
            _finish(name, *_start(name, verbose=False))
        lib = ctypes.CDLL(path)
        _loaded[name] = lib
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
