"""Host-side input pipeline: the port of ``kubeflow_tpu/data``.

- ``pipeline`` — ``PyRecordPipeline`` and ``epoch_order``: fixed-size
  records from shard files, seeded splitmix64 epoch shuffle, threaded
  prefetch (the spec the native core is held to).
- ``native``   — ctypes binding to ``native/datapipe`` and
  ``native/augment``, built into ``kubeflow_tpu_torch/_build/native``.
- ``imagenet`` — the record layout, ``write_shards``, the augment and
  ``ImageNetSource``; ``device_normalize`` in torch.
- ``mp_augment`` — ``AugmentPool``: decode+augment in spawned processes
  over a shared-memory ring.
- ``device_prefetch`` — ``DevicePrefetcher``: pinned host buffers copied
  on a side CUDA stream, ``depth`` batches ahead of the step.

This package's ``__init__`` imports no torch, nor do ``pipeline``,
``native``, ``imagenet`` and ``mp_augment``: the augment workers are
spawned processes that import ``imagenet`` and must stay free of
torch's CUDA state. ``device_normalize`` imports torch where it runs;
``device_prefetch`` is imported only by the trainer.
"""

from .pipeline import PyRecordPipeline, RecordPipeline, epoch_order
from .native import NativeRecordPipeline, native_available

__all__ = ["RecordPipeline", "PyRecordPipeline", "NativeRecordPipeline",
           "native_available", "epoch_order"]
