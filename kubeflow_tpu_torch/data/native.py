"""ctypes binding to the native data-pipeline core (native/datapipe) and
the native augment (native/augment).

The port of ``kubeflow_tpu/data/native.py``. It builds the same C++
sources, read from the repository's ``native/`` and never written there,
into the port's own build directory
(``make -C native BUILD=kubeflow_tpu_torch/_build/native``), under the
port's own file lock, and loads only that library: the JAX package's
``native/build/libkfdatapipe.so`` belongs to the JAX package.

Built lazily with the system g++ (ctypes over a C ABI).
``native_available()`` gates the fast path; without a toolchain or a
build everything degrades to the pure-Python pipeline and the numpy
augment, which produce the same bytes (tests/test_torch_data.py).
Which implementation ran is counted per batch on the port's process
registry (``kftpu_input_impl_batches_total{stage, impl}``, see
``data/imagenet.py``), so a run on the card can prove it used the native
core.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Iterator, Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_DIR)
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
BUILD_DIR = os.path.join(_PKG_DIR, "_build", "native")
_SO_NAME = "libkfdatapipe.so"

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def _so_path() -> str:
    return os.path.join(BUILD_DIR, _SO_NAME)


def _build() -> bool:
    """make into the port's build dir, serialized across processes: a
    fleet of workers starting with a stale .so must not race g++ against
    each other's dlopen."""
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        lock_path = os.path.join(BUILD_DIR, ".build.lock")
        with open(lock_path, "w") as lock:
            try:
                import fcntl
                fcntl.flock(lock, fcntl.LOCK_EX)
            except ImportError:  # non-posix: best effort
                pass
            subprocess.run(["make", "-C", _NATIVE_DIR,
                            f"BUILD={BUILD_DIR}"],
                           check=True, capture_output=True, timeout=120)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        log.warning("native datapipe build failed (%s); using the "
                    "pure-Python pipeline", e)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        so_path = _so_path()

        def try_load():
            lib = ctypes.CDLL(so_path)
            lib.kf_augment_u8  # symbol probe: stale pre-augment builds
            return lib

        lib = None
        if os.path.exists(so_path):
            try:
                lib = try_load()
            except (OSError, AttributeError):
                lib = None  # stale/corrupt build: rebuild below
        if lib is None:
            if not _build():
                _build_failed = True
                return None
            try:
                lib = try_load()
            except (OSError, AttributeError) as e:
                log.warning("cannot load %s: %s", so_path, e)
                _build_failed = True
                return None
        lib.dp_create.restype = ctypes.c_void_p
        lib.dp_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_uint64, ctypes.c_int32]
        lib.dp_next.restype = ctypes.c_int32
        lib.dp_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_uint8),
                                ctypes.c_int64]
        lib.dp_reset.restype = None
        lib.dp_reset.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.dp_total_records.restype = ctypes.c_int64
        lib.dp_total_records.argtypes = [ctypes.c_void_p]
        lib.dp_num_batches.restype = ctypes.c_int64
        lib.dp_num_batches.argtypes = [ctypes.c_void_p]
        lib.dp_last_error.restype = ctypes.c_char_p
        lib.dp_last_error.argtypes = [ctypes.c_void_p]
        lib.dp_destroy.restype = None
        lib.dp_destroy.argtypes = [ctypes.c_void_p]
        lib.kf_augment.restype = None
        lib.kf_augment.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32]
        lib.kf_augment_u8.restype = None
        lib.kf_augment_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_uint64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


class NativeRecordPipeline:
    """Same contract as PyRecordPipeline, backed by the C++ core."""

    impl = "native"

    def __init__(self, paths: Sequence[str], record_bytes: int,
                 batch_records: int, *, queue_depth: int = 4, seed: int = 0,
                 drop_remainder: bool = True, num_threads: int = 2):
        lib = _load()
        if lib is None:
            raise RuntimeError("native datapipe unavailable "
                               "(use PyRecordPipeline)")
        self._lib = lib
        self.record_bytes = record_bytes
        self.batch_records = batch_records
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        self._handle = lib.dp_create(
            arr, len(paths), record_bytes, batch_records, queue_depth,
            num_threads, seed & (2 ** 64 - 1), 1 if drop_remainder else 0)
        if not self._handle:
            raise RuntimeError(
                f"dp_create failed for {list(paths)} "
                f"(record_bytes={record_bytes})")
        self.total_records = lib.dp_total_records(self._handle)

    @property
    def num_batches(self) -> int:
        return self._lib.dp_num_batches(self._handle)

    def reset(self, seed: int) -> None:
        self._lib.dp_reset(self._handle, seed & (2 ** 64 - 1))

    def __iter__(self) -> Iterator[np.ndarray]:
        buf = np.empty((self.batch_records * self.record_bytes,), np.uint8)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        while True:
            n = self._lib.dp_next(self._handle, ptr, buf.nbytes)
            if n == 0:
                return
            if n < 0:
                err = self._lib.dp_last_error(self._handle)
                raise RuntimeError(
                    f"datapipe error: {(err or b'').decode()}")
            yield buf[: n * self.record_bytes].reshape(
                n, self.record_bytes).copy()

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.dp_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


def native_augment(images: "np.ndarray", base_state: int, pad: int,
                   mean: "np.ndarray", std: "np.ndarray", *,
                   do_flip: bool = True, do_crop: bool = True,
                   num_threads: int = 4) -> "np.ndarray":
    """Fused flip + reflect-pad crop + normalize (native/augment/augment.cc):
    uint8 (N,H,W,3) records → float32 feed buffer in one multithreaded
    pass. Parameter derivation matches data/imagenet.py::augment_params
    bit-identically (the shared splitmix64 spec)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native augment unavailable")
    images = np.ascontiguousarray(images, np.uint8)
    n, h, w, c = images.shape
    if c != 3 or h != w:
        raise ValueError(f"expected (N,H,H,3) uint8, got {images.shape}")
    out = np.empty((n, h, w, 3), np.float32)
    mean32 = np.ascontiguousarray(mean, np.float32)
    std32 = np.ascontiguousarray(std, np.float32)
    lib.kf_augment(
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, h, w, pad, base_state & (2 ** 64 - 1),
        mean32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        1 if do_flip else 0, 1 if do_crop else 0, num_threads)
    return out


def native_augment_u8(images: "np.ndarray", base_state: int, pad: int, *,
                      do_flip: bool = True, do_crop: bool = True,
                      num_threads: int = 4) -> "np.ndarray":
    """Augment WITHOUT normalization, uint8→uint8: the device-normalize
    input mode ships 1/4 the bytes host→device and normalizes on the card
    (data/imagenet.py device_normalize)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native augment unavailable")
    images = np.ascontiguousarray(images, np.uint8)
    n, h, w, c = images.shape
    if c != 3 or h != w:
        raise ValueError(f"expected (N,H,H,3) uint8, got {images.shape}")
    out = np.empty((n, h, w, 3), np.uint8)
    lib.kf_augment_u8(
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, h, w, pad, base_state & (2 ** 64 - 1),
        1 if do_flip else 0, 1 if do_crop else 0, num_threads)
    return out
