"""ImageNet-style record dataset: fixed-size image records under the
record pipeline (native C++ fast path, Python fallback).

The port of ``kubeflow_tpu/data/imagenet.py``: the same record layout,
shard writer, shuffle, augment and batch stream, byte for byte
(tests/test_torch_data.py), and ``device_normalize`` in torch. It
imports torch only inside ``device_normalize``, because the augment
worker processes (data/mp_augment.py) import this module and must not
pull in torch's CUDA state.

The reference's flagship workload trains ResNet-50 on real ImageNet via
tf_cnn_benchmarks --data_dir (tf-controller-examples/tf-cnn/launcher.py:
68-93); this is the TPU-native input path for the same job: shard files of
fixed-size records streamed by the prefetching record pipeline
(data/native.py / data/pipeline.py), decoded and augmented host-side with
numpy, fed to the device as one placed batch per step.

Record layout (record_bytes = 4 + H*W*3):
    int32 LE label | uint8 image[H][W][3]

A `meta.json` sidecar makes shard dirs self-describing:
    {"image_size": H, "num_classes": N, "record_bytes": B,
     "num_records": R, "format": "kftpu-imagenet-v1"}

Augmentation is the tf_cnn_benchmarks training default reduced to what
fixed-size storage supports: random horizontal flip + random crop with
4-pixel reflection padding, seeded per epoch so runs are deterministic
per (seed, epoch) — the determinism contract the tests pin down.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional

import numpy as np

from .pipeline import RecordPipeline

META_NAME = "meta.json"
FORMAT = "kftpu-imagenet-v1"
LABEL_BYTES = 4

# ImageNet channel stats (tf_cnn_benchmarks preprocessing constants)
MEAN_RGB = np.array([0.485, 0.456, 0.406], np.float32)
STDDEV_RGB = np.array([0.229, 0.224, 0.225], np.float32)

_MASK = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15

# per-batch count of which implementation produced it, on the port's
# process registry: stage "records" (the shard reader) or "augment"
IMPL_COUNTER = "kftpu_input_impl_batches_total"


def count_impl(stage: str, impl: str) -> None:
    """One batch of ``stage`` produced by ``impl`` ("native" or "py")."""
    from ..obs import registry as obsreg
    obsreg.counter(IMPL_COUNTER,
                   "input batches by pipeline stage and implementation",
                   labels=("stage", "impl")).labels(
        stage=stage, impl=impl).inc()


def augment_impl() -> str:
    """Which implementation ``augment_batch`` runs in this process:
    "native" (native/augment/augment.cc) unless it cannot be built or
    ``KFTPU_AUGMENT_IMPL=py`` selects the numpy version."""
    from .native import native_available
    if native_available() and \
            os.environ.get("KFTPU_AUGMENT_IMPL", "native") != "py":
        return "native"
    return "py"


def augment_base(seed: int, epoch: int, batch_index: int) -> int:
    """The per-batch augment RNG base; stream = pure fn of (data, seed)."""
    return (((seed << 20) ^ epoch) * 1_000_003 + batch_index) & _MASK


def augment_params(base: int, n: int, pad: int
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-record (flip, dy, dx) — the splitmix64 derivation mirrored in
    native/augment/augment.cc params_for (keep in sync!). Vectorized."""
    idx = np.arange(1, n + 1, dtype=np.uint64)
    state = (np.uint64(base) + idx * np.uint64(_GOLDEN)) & np.uint64(_MASK)

    def splitmix(state):
        state = (state + np.uint64(_GOLDEN)) & np.uint64(_MASK)
        z = state
        z = ((z ^ (z >> np.uint64(30))) *
             np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(_MASK)
        z = ((z ^ (z >> np.uint64(27))) *
             np.uint64(0x94D049BB133111EB)) & np.uint64(_MASK)
        return z ^ (z >> np.uint64(31)), state

    z1, state = splitmix(state)
    z2, state = splitmix(state)
    flip = (z1 & np.uint64(1)) != 0
    span = np.uint64(2 * pad + 1)
    dy = ((z2 >> np.uint64(1)) % span).astype(np.int64)
    dx = ((z2 >> np.uint64(33)) % span).astype(np.int64)
    return flip, dy, dx


def _py_augment(images: np.ndarray, base: int, pad: int, *,
                do_flip: bool, do_crop: bool,
                normalize: bool = True) -> np.ndarray:
    """Numpy fallback producing the native kernel's exact output."""
    n, h, w, _ = images.shape
    flip, dy, dx = augment_params(base, n, pad)
    if not do_flip:
        flip = np.zeros(n, bool)
    if not do_crop:
        dy = np.full(n, pad, np.int64)
        dx = np.full(n, pad, np.int64)
    coords = np.arange(h)

    def reflect(v, size):
        v = np.abs(v)
        return np.where(v >= size, 2 * size - 2 - v, v)

    out = np.empty((n, h, w, 3),
                   np.float32 if normalize else np.uint8)
    for i in range(n):
        sy = reflect(coords + dy[i] - pad, h)
        sx = reflect(coords + dx[i] - pad, w)
        if flip[i]:
            sx = w - 1 - sx
        out[i] = images[i][np.ix_(sy, sx)]
    if not normalize:
        return out
    # same op order as the C++ kernel (x*scale - shift, f32) so the two
    # paths are bit-identical
    scale = np.float32(1.0) / (np.float32(255.0) * STDDEV_RGB)
    shift = MEAN_RGB / STDDEV_RGB
    out *= scale
    out -= shift
    return out


def decode_records(raw: np.ndarray, image_size: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(N, record_bytes) uint8 rows → ((N,H,H,3) uint8 image view,
    (N,) int32 labels). Shared by ImageNetSource and the multi-process
    augment workers (data/mp_augment.py) so the two paths cannot drift."""
    n = raw.shape[0]
    labels = raw[:, :LABEL_BYTES].copy().view("<i4").reshape(n)
    images = raw[:, LABEL_BYTES:].reshape(n, image_size, image_size, 3)
    return images, labels.astype(np.int32, copy=False)


def augment_batch(images: np.ndarray, base: int, pad: int, *,
                  do_flip: bool, do_crop: bool, output: str = "normalized",
                  image_dtype=np.float32) -> np.ndarray:
    """One fused augment pass over a decoded uint8 batch: flip +
    reflect-pad crop (+ normalize unless output='uint8', the
    device-normalize mode). Native C++ fast path
    (native/augment/augment.cc), numpy fallback computing the
    bit-identical result from the same splitmix64 parameters
    (KFTPU_AUGMENT_IMPL=py kill-switches the native kernel — also how
    ``bench.py --mode input`` pins BOTH A/B arms to the GIL-bound
    implementation for a matched architecture comparison). Pure
    function of (images, base) — the determinism contract the
    single-thread and multi-process paths both ride."""
    from .native import native_augment, native_augment_u8
    use_native = augment_impl() == "native"
    if output == "uint8":
        if use_native:
            return native_augment_u8(images, base, pad,
                                     do_flip=do_flip, do_crop=do_crop)
        return _py_augment(images, base, pad, do_flip=do_flip,
                           do_crop=do_crop, normalize=False)
    if use_native:
        out = native_augment(images, base, pad, MEAN_RGB, STDDEV_RGB,
                             do_flip=do_flip, do_crop=do_crop)
    else:
        out = _py_augment(images, base, pad, do_flip=do_flip,
                          do_crop=do_crop)
    return out.astype(image_dtype, copy=False)


def device_normalize(images_u8):
    """The on-device half of the uint8 input mode: identical math to the
    host normalize (x*(1/(255*std)) - mean/std, f32) on an NHWC uint8
    tensor, on whatever device it lies. The constants are computed in
    numpy exactly as the JAX package computes them (f32 std promoted by
    the float 255.0 and 1.0), so only uint8 crosses host→device."""
    import torch
    scale = torch.from_numpy(np.asarray(1.0 / (255.0 * STDDEV_RGB),
                                        np.float32))
    shift = torch.from_numpy(np.asarray(MEAN_RGB / STDDEV_RGB, np.float32))
    dev = images_u8.device
    return images_u8.float() * scale.to(dev) - shift.to(dev)


def record_bytes(image_size: int) -> int:
    return LABEL_BYTES + image_size * image_size * 3


def write_shards(out_dir: str, images: np.ndarray, labels: np.ndarray,
                 *, shard_records: int = 1024,
                 num_classes: Optional[int] = None) -> dict:
    """Write (N,H,W,3) uint8 images + (N,) int labels as record shards.

    The fixture/ingest writer (the analog of the reference's imagenet
    preprocessing scripts feeding tf_cnn_benchmarks)."""
    images = np.ascontiguousarray(images, np.uint8)
    labels = np.asarray(labels)
    if images.ndim != 4 or images.shape[3] != 3 or \
            images.shape[1] != images.shape[2]:
        raise ValueError(f"images must be (N,H,H,3) uint8, got {images.shape}")
    if len(labels) != len(images):
        raise ValueError("images/labels length mismatch")
    image_size = images.shape[1]
    os.makedirs(out_dir, exist_ok=True)
    n = len(images)
    shard = 0
    for start in range(0, n, shard_records):
        end = min(start + shard_records, n)
        path = os.path.join(out_dir, f"shard-{shard:05d}.rec")
        with open(path, "wb") as f:
            for i in range(start, end):
                f.write(np.int32(labels[i]).tobytes())
                f.write(images[i].tobytes())
        shard += 1
    meta = {
        "format": FORMAT,
        "image_size": image_size,
        "num_classes": int(num_classes if num_classes is not None
                           else int(labels.max()) + 1 if n else 0),
        "record_bytes": record_bytes(image_size),
        "num_records": n,
    }
    with open(os.path.join(out_dir, META_NAME), "w") as f:
        json.dump(meta, f)
    return meta


def read_meta(data_dir: str) -> dict:
    path = os.path.join(data_dir, META_NAME)
    with open(path) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: unknown format {meta.get('format')!r}")
    return meta


def shard_paths(data_dir: str) -> list[str]:
    return sorted(
        os.path.join(data_dir, f) for f in os.listdir(data_dir)
        if f.endswith(".rec"))


class _Prefetcher:
    """Run an iterator on a daemon thread, `depth` items ahead (the
    input-overlap half of launcher.py's async data pipeline). stop() is
    safe to call from the consumer side and JOINS the producer, so the
    owner may tear down resources the iterator uses afterwards."""

    _END = object()

    def __init__(self, it: Iterator, depth: int):
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        # producer outcome, tracked OUTSIDE the queue: the queued END /
        # exception item can be lost (a stop() drain, a failed _put), and
        # a consumer that then sees only a dead thread must be able to
        # tell "finished cleanly" from "died mid-epoch" — the latter used
        # to end iteration silently, truncating the epoch while the run
        # "succeeded" on partial data.
        self._done = False
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._produce, args=(it,),
                                        daemon=True,
                                        name="imagenet-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        import queue
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, it) -> None:
        try:
            for item in it:
                if not self._put(item):
                    self._done = True   # consumer-initiated stop, not a death
                    return
            self._done = True
            self._put(self._END)
        except BaseException as e:  # noqa: BLE001 - surface to consumer
            self._error = e
            self._put(e)

    def __iter__(self) -> Iterator:
        import queue
        try:
            while True:
                try:
                    item = self._q.get(timeout=0.5)
                except queue.Empty:
                    if not self._thread.is_alive():
                        if self._error is not None:
                            # the queued exception was lost (put raced a
                            # stop/drain) — raise the tracked copy
                            raise self._error
                        if not self._done:
                            raise RuntimeError(
                                "prefetch producer died without an error "
                                "or EOF — refusing to pass a truncated "
                                "epoch off as complete")
                        return
                    continue
                if item is self._END:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            self.stop()

    def stop(self) -> None:
        import queue
        self._stop.set()
        try:  # unblock a producer stuck on a full queue
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)


class ImageNetSource:
    """Decoded, augmented, normalized batches from a shard dir.

    Yields {"images": float32 (B,H,H,3) normalized, "labels": int32 (B,)}.
    Epochs reshuffle with a derived seed; augmentation RNG is seeded per
    epoch so the stream is a pure function of (data, seed)."""

    def __init__(self, data_dir: str, batch_size: int, *,
                 augment: bool = True, pad_px: int = 4,
                 num_threads: int = 2, queue_depth: int = 4,
                 image_dtype: Optional[np.dtype] = None,
                 output: str = "normalized",
                 drop_remainder: bool = True,
                 workers: int = 0,
                 ring_slots: Optional[int] = None):
        if workers < 0:
            raise ValueError(f"workers must be >= 0, got {workers}")
        if output not in ("normalized", "uint8"):
            raise ValueError(f"output {output!r} not in "
                             "('normalized', 'uint8')")
        if output == "uint8" and image_dtype is not None:
            raise ValueError(
                "image_dtype conflicts with output='uint8' (bytes ship "
                "as-is; normalize on device picks the compute dtype)")
        # "uint8": ship raw augmented bytes and normalize ON DEVICE
        # (device_normalize) — 1/4 the host→device traffic
        self.output = output
        self.meta = read_meta(data_dir)
        self.image_size = int(self.meta["image_size"])
        self.num_classes = int(self.meta["num_classes"])
        self.batch_size = batch_size
        self.augment = augment
        self.pad_px = pad_px
        self.image_dtype = image_dtype or np.float32
        # multi-process augment stage: decode+augment fan out over
        # `workers` spawned processes writing a shared-memory ring
        # (data/mp_augment.py), byte-identical to the in-process path.
        # 0 = the single prefetch-thread path.
        self.workers = int(workers)
        self._ring_slots = ring_slots
        self._mp_pool = None
        self._num_threads = num_threads
        self._queue_depth = queue_depth
        self._paths = shard_paths(data_dir)
        if not self._paths:
            raise FileNotFoundError(f"no .rec shards in {data_dir}")
        # validate from meta; the pipeline itself is constructed lazily on
        # first epoch() with the real seed (constructing it here would
        # start a prefetch pass epoch() immediately throws away)
        self.drop_remainder = drop_remainder
        n_rec = int(self.meta["num_records"])
        self.num_batches = (n_rec // batch_size if drop_remainder
                            else -(-n_rec // batch_size))
        if self.num_batches == 0:
            raise ValueError(
                f"{data_dir}: {self.meta['num_records']} records < "
                f"batch_size {batch_size} (empty epochs)")
        self._pipeline = None
        self._prefetcher = None

    # -- decode / augment (host-side) ---------------------------------------

    def _decode(self, raw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        return decode_records(raw, self.image_size)

    def _augment_normalize(self, images: np.ndarray, base: int,
                           augment: bool) -> np.ndarray:
        return augment_batch(images, base, self.pad_px,
                             do_flip=augment, do_crop=augment,
                             output=self.output,
                             image_dtype=self.image_dtype)

    # -- iteration -----------------------------------------------------------

    def _epoch_pipeline(self, epoch: int, seed: int):
        """The record pipeline reset/constructed for one epoch's shuffle."""
        if self._pipeline is None:
            self._pipeline = RecordPipeline(
                self._paths, self.meta["record_bytes"], self.batch_size,
                num_threads=self._num_threads,
                queue_depth=self._queue_depth, seed=seed + epoch,
                drop_remainder=self.drop_remainder)
        else:
            self._pipeline.reset(seed + epoch)
        return self._pipeline

    def epoch(self, epoch: int, seed: int = 0, skip: int = 0
              ) -> Iterator[dict]:
        """One pass over the data for the given epoch index. ``skip``
        drops the first N batches (resume); determinism holds because the
        augment RNG is derived per (seed, epoch, batch index), not drawn
        sequentially."""
        pipeline = self._epoch_pipeline(epoch, seed)
        impl = augment_impl()
        for i, raw in enumerate(pipeline):
            if i < skip:
                continue
            images, labels = self._decode(raw)
            base = augment_base(seed, epoch, i)
            out = {"images": self._augment_normalize(images, base,
                                                     self.augment),
                   "labels": labels}
            count_impl("records", pipeline.impl)
            count_impl("augment", impl)
            yield out

    def batches(self, seed: int = 0, start_batch: int = 0,
                prefetch: int = 2) -> Iterator[dict]:
        """Infinite stream across epochs (the train-loop feed).
        ``start_batch`` = global batch index to resume from (checkpoint
        restarts must not replay already-seen batches). ``prefetch``
        decode+augment batches ahead on a worker thread so host
        preprocessing overlaps device compute (0 = synchronous). With
        ``workers > 0`` the decode+augment stage instead fans out over
        that many spawned processes through a shared-memory ring
        (data/mp_augment.py) — same batches, byte-identical."""
        if self.workers > 0:
            yield from self._mp_batches(seed, start_batch)
            return

        def gen():
            epoch = start_batch // self.num_batches
            skip = start_batch % self.num_batches
            while True:
                yield from self.epoch(epoch, seed, skip=skip)
                epoch += 1
                skip = 0

        if prefetch <= 0:
            yield from gen()
            return
        # the source owns the prefetcher: close() must JOIN the producer
        # before destroying the pipeline it reads from. One active stream
        # per source: a new batches() call supersedes the previous one
        # (two producers would race the shared record pipeline).
        if self._prefetcher is not None:
            self._prefetcher.stop()
        self._prefetcher = _Prefetcher(gen(), depth=prefetch)
        yield from self._prefetcher

    def _mp_batches(self, seed: int, start_batch: int) -> Iterator[dict]:
        """The multi-process augment stage: this process only READS raw
        record batches (the shuffle order must come from the one shared
        pipeline) and memcpys them into the shared-memory ring; spawned
        workers decode+augment each slab in place; batches come back in
        submit order. Determinism: identical to the single-thread path
        because the augment RNG is a pure function of
        (seed, epoch, batch index) — pinned by tests."""
        from .mp_augment import AugmentPool
        if self._mp_pool is not None:
            self._mp_pool.close()
        pool = AugmentPool(
            workers=self.workers,
            batch_records=self.batch_size,
            record_bytes=int(self.meta["record_bytes"]),
            image_size=self.image_size,
            output=self.output,
            image_dtype=self.image_dtype,
            pad_px=self.pad_px,
            augment=self.augment,
            slots=self._ring_slots)
        self._mp_pool = pool

        def feed():
            epoch = start_batch // self.num_batches
            skip = start_batch % self.num_batches
            while True:
                pipeline = self._epoch_pipeline(epoch, seed)
                for i, raw in enumerate(pipeline):
                    if i < skip:
                        continue
                    count_impl("records", pipeline.impl)
                    yield raw, augment_base(seed, epoch, i)
                epoch += 1
                skip = 0

        pool.start(feed())
        yield from pool

    def close(self) -> None:
        # stop + join the producers FIRST: the prefetch thread / the mp
        # feeder may be inside the native pipeline's dp_next, which must
        # not race dp_destroy
        if self._prefetcher is not None:
            self._prefetcher.stop()
            self._prefetcher = None
        if self._mp_pool is not None:
            self._mp_pool.close()
            self._mp_pool = None
        if self._pipeline is not None:
            self._pipeline.close()
            self._pipeline = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
