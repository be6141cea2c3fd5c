"""The port's input pipeline against the JAX package's, on the CPU.

Records are written to ``tmp_path`` at 32 px (as tests/test_input_pipeline.py
does), from numpy arrays made from a seed.

- The shard files, ``epoch_order`` and the Python record pipeline's order
  equal ``kubeflow_tpu.data``'s; the native core's order equals the
  Python one.
- ``ImageNetSource`` batches are byte-identical to the JAX package's for
  the same (seed, epoch, batch index): both output modes, ``workers`` 0
  and 2, across an epoch boundary, on resume from ``start_batch=k`` and
  for the short last batch with ``drop_remainder=False``.
- The native and numpy augment are bit-identical; ``device_normalize``
  equals the JAX function within 1e-6.
- ``DevicePrefetcher`` on the CPU: the depth bound, the order, close,
  producer exceptions and no retention.
- ``AugmentPool``: a dead worker is detected without hanging, and close
  leaves no processes.
"""

from __future__ import annotations

import gc
import multiprocessing as mp
import os
import time
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.data import imagenet as JI
from kubeflow_tpu.data import pipeline as JP
from kubeflow_tpu_torch.data import imagenet as TI
from kubeflow_tpu_torch.data import native as TN
from kubeflow_tpu_torch.data import pipeline as TP
from kubeflow_tpu_torch.data.device_prefetch import DevicePrefetcher
from kubeflow_tpu_torch.obs import registry as obsreg

SIZE = 32
N = 44          # 5 batches of 8 a epoch, and a short last batch of 4
CLASSES = 10
B = 8


def _records(seed: int, n: int = N):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)
    labels = rng.integers(0, CLASSES, n)
    return images, labels


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    images, labels = _records(11)
    d = tmp_path_factory.mktemp("torch-records")
    TI.write_shards(str(d), images, labels, shard_records=16,
                    num_classes=CLASSES)
    return str(d)


def _no_leaked_children(before: set) -> bool:
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if {p.pid for p in mp.active_children()} <= before:
            return True
        time.sleep(0.05)
    return False


def _impl_count(stage: str, impl: str) -> float:
    return obsreg.counter(TI.IMPL_COUNTER, "", labels=("stage", "impl")
                          ).labels(stage=stage, impl=impl).value


# -- records and order -------------------------------------------------------

def test_write_shards_equals_jax(data_dir, tmp_path):
    images, labels = _records(11)
    JI.write_shards(str(tmp_path), images, labels, shard_records=16,
                    num_classes=CLASSES)
    names = sorted(os.listdir(data_dir))
    assert names == sorted(os.listdir(tmp_path))
    assert len(TI.shard_paths(data_dir)) == 3
    for name in names:
        with open(os.path.join(data_dir, name), "rb") as a, \
                open(os.path.join(tmp_path, name), "rb") as b:
            assert a.read() == b.read(), name
    assert TI.read_meta(data_dir) == JI.read_meta(str(tmp_path))


@pytest.mark.parametrize("n,seed", [(0, 0), (1, 5), (7, 3), (257, 2 ** 63)])
def test_epoch_order_matches_jax(n, seed):
    np.testing.assert_array_equal(TP.epoch_order(n, seed),
                                  JP.epoch_order(n, seed))


@pytest.mark.parametrize("drop", [True, False])
def test_py_record_pipeline_matches_jax(data_dir, drop):
    paths = TI.shard_paths(data_dir)
    rb = TI.record_bytes(SIZE)
    with TP.PyRecordPipeline(paths, rb, B, seed=9, drop_remainder=drop) \
            as t, JP.PyRecordPipeline(paths, rb, B, seed=9,
                                      drop_remainder=drop) as j:
        got, ref = list(t), list(j)
    assert len(got) == len(ref) == (5 if drop else 6)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_native_order_equals_python(data_dir):
    assert TN.native_available()
    assert TN.BUILD_DIR.endswith(os.path.join("kubeflow_tpu_torch",
                                              "_build", "native"))
    paths = TI.shard_paths(data_dir)
    rb = TI.record_bytes(SIZE)
    for drop in (True, False):
        with TN.NativeRecordPipeline(paths, rb, B, seed=4,
                                     drop_remainder=drop) as n, \
                TP.PyRecordPipeline(paths, rb, B, seed=4,
                                    drop_remainder=drop) as p:
            got, ref = list(n), list(p)
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


# -- the source: byte for byte against the JAX package -----------------------

def _take(cls, d, k, start=0, **kw):
    src = cls(d, batch_size=B, **kw)
    try:
        it = src.batches(seed=3, start_batch=start)
        return [{key: v.copy() for key, v in next(it).items()}
                for _ in range(k)]
    finally:
        src.close()


def _assert_same(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a["images"].dtype == b["images"].dtype
        assert a["labels"].dtype == b["labels"].dtype
        np.testing.assert_array_equal(a["labels"], b["labels"])
        assert a["images"].tobytes() == b["images"].tobytes()


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("output", ["normalized", "uint8"])
def test_source_batches_equal_jax(data_dir, output, workers):
    """Seven batches of a 5-batch epoch: the reshuffle and the
    per-(seed, epoch, index) augment at the boundary included."""
    before = _impl_count("augment", "native")
    ref = _take(JI.ImageNetSource, data_dir, 7, output=output)
    got = _take(TI.ImageNetSource, data_dir, 7, output=output,
                workers=workers)
    _assert_same(got, ref)
    assert got[0]["images"].dtype == (np.uint8 if output == "uint8"
                                      else np.float32)
    # the port's counter says the native augment made them, in this
    # process or in the spawned workers (the prefetch thread and the
    # ring may have made a few more)
    assert _impl_count("augment", "native") - before >= 7


@pytest.mark.parametrize("workers", [0, 2])
def test_resume_from_start_batch_equals_jax(data_dir, workers):
    ref = _take(JI.ImageNetSource, data_dir, 4, start=4, output="uint8")
    got = _take(TI.ImageNetSource, data_dir, 4, start=4, output="uint8",
                workers=workers)
    _assert_same(got, ref)
    full = _take(TI.ImageNetSource, data_dir, 8, output="uint8")
    _assert_same(got, full[4:])


def test_short_last_batch_equals_jax(data_dir):
    """The eval source: no augment, host normalize, drop_remainder=False:
    6 batches, the last of 4 records."""
    kw = dict(batch_size=B, augment=False, drop_remainder=False)
    t = TI.ImageNetSource(data_dir, **kw)
    j = JI.ImageNetSource(data_dir, **kw)
    try:
        got, ref = list(t.epoch(0, 5)), list(j.epoch(0, 5))
    finally:
        t.close()
        j.close()
    assert t.num_batches == j.num_batches == 6
    assert [len(b["labels"]) for b in got] == [8] * 5 + [4]
    _assert_same(got, ref)


@pytest.mark.parametrize("output", ["normalized", "uint8"])
def test_native_and_numpy_augment_bit_identical(output):
    images, _ = _records(21, n=6)
    base = TI.augment_base(7, 2, 3)
    kw = dict(do_flip=True, do_crop=True)
    if output == "uint8":
        nat = TN.native_augment_u8(images, base, 4, **kw)
    else:
        nat = TN.native_augment(images, base, 4, TI.MEAN_RGB,
                                TI.STDDEV_RGB, **kw)
    py = TI._py_augment(images, base, 4, normalize=output != "uint8", **kw)
    ref = JI._py_augment(images, base, 4, normalize=output != "uint8", **kw)
    assert nat.tobytes() == py.tobytes() == ref.tobytes()
    flip, dy, dx = TI.augment_params(base, 6, 4)
    jflip, jdy, jdx = JI.augment_params(base, 6, 4)
    np.testing.assert_array_equal(flip, jflip)
    np.testing.assert_array_equal(dy, jdy)
    np.testing.assert_array_equal(dx, jdx)


def test_augment_impl_switch(monkeypatch):
    images, _ = _records(22, n=3)
    assert TI.augment_impl() == "native"
    nat = TI.augment_batch(images, 99, 4, do_flip=True, do_crop=True,
                           output="uint8")
    monkeypatch.setenv("KFTPU_AUGMENT_IMPL", "py")
    assert TI.augment_impl() == "py"
    py = TI.augment_batch(images, 99, 4, do_flip=True, do_crop=True,
                          output="uint8")
    assert nat.tobytes() == py.tobytes()


def test_device_normalize_matches_jax():
    images, _ = _records(23, n=4)
    got = TI.device_normalize(torch.from_numpy(images))
    ref = np.asarray(JI.device_normalize(jnp.asarray(images)))
    assert got.dtype == torch.float32 and got.shape == images.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    # and the host normalize of the same bytes
    host = TI._py_augment(images, 0, 4, do_flip=False, do_crop=False)
    np.testing.assert_allclose(got.numpy(), host, rtol=0, atol=1e-6)


# -- DevicePrefetcher on the CPU ----------------------------------------------

def _batches(n):
    for i in range(n):
        yield {"images": np.full((8, 4), i, np.float32),
               "labels": np.arange(8, dtype=np.int32)}


def _place(b):
    return {k: torch.as_tensor(v).clone() for k, v in b.items()}


def test_prefetcher_depth_bounds_runahead_and_keeps_order():
    pulled = []

    def tracking():
        for i, b in enumerate(_batches(10)):
            pulled.append(i)
            yield b

    pf = DevicePrefetcher(tracking(), _place, depth=3)
    assert pf.device == torch.device("cpu")
    got = next(pf)
    assert len(pulled) == 3 and pf.in_flight == 2
    assert float(got["images"][0, 0]) == 0.0
    rest = [float(b["images"][0, 0]) for b in pf]
    assert rest == [float(i) for i in range(1, 10)]
    assert pf.in_flight == 0
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetcher_close_drops_staged_batches():
    pf = DevicePrefetcher(_batches(10), _place, depth=4)
    next(pf)
    assert pf.in_flight == 3
    pf.close()
    assert pf.in_flight == 0
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetcher_propagates_producer_exception():
    def source():
        yield from _batches(2)
        raise ValueError("decode blew up")

    pf = DevicePrefetcher(source(), _place, depth=2)
    next(pf)
    with pytest.raises(ValueError, match="decode blew up"):
        next(pf)


def test_prefetcher_does_not_retain_consumed_batches():
    pf = DevicePrefetcher(_batches(6), _place, depth=2)
    refs = []
    for batch in pf:
        refs.append(weakref.ref(batch["images"]))
        del batch
    gc.collect()
    assert len(refs) == 6 and all(r() is None for r in refs)


def test_prefetcher_counts_and_validates():
    fam = obsreg.counter("kftpu_input_batches_total", "",
                         labels=("stage",)).labels(stage="device_put")
    before = fam.value
    assert len(list(DevicePrefetcher(_batches(5), _place, depth=2))) == 5
    assert fam.value - before == 5
    with pytest.raises(ValueError, match="depth"):
        DevicePrefetcher(iter([]), _place, depth=0)


# -- AugmentPool lifecycle ------------------------------------------------------

def test_augment_pool_worker_death_detected(data_dir):
    src = TI.ImageNetSource(data_dir, batch_size=B, workers=1)
    try:
        it = src.batches(seed=1)
        next(it)
        for p in src._mp_pool._procs:
            p.terminate()
            p.join(5)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="died"):
            for _ in range(64):   # the ring drains, then the check fires
                next(it)
        assert time.monotonic() - t0 < 30
    finally:
        src.close()


def test_augment_pool_close_leaves_no_processes(data_dir):
    before = {p.pid for p in mp.active_children()}
    src = TI.ImageNetSource(data_dir, batch_size=B, workers=2)
    it = src.batches(seed=1)
    for _ in range(3):
        next(it)
    assert len(mp.active_children()) == len(before) + 2
    src.close()
    assert _no_leaked_children(before)
    src.close()   # idempotent
