"""kubeflow_tpu_torch — the PyTorch/CUDA port of kubeflow_tpu for the H100.

Mirrors ``kubeflow_tpu``'s layout module for module; each module here has
its counterpart of the same name there, which stays the reference. The
port imports ``torch`` and ``numpy`` and nothing of JAX or of
``kubeflow_tpu``. Every Pallas kernel on a ported path becomes a
hand-written Hopper kernel (``csrc/``, built by ``ops/_build.py``) with a
plain PyTorch version beside it for CPU tensors.

Ported so far (serving and training the Transformer LM; training
ResNet-50 from record shards or the synthetic pool, serving it; training
either data-parallel across processes; checkpoints, preemption, the
numeric sentinel and serving from a trainer's checkpoints):

- ``api``      — the job-spec vocabularies the training path validates,
  ``ShardingSpec`` and the topology contract's env.
- ``cluster``  — the REST client the worker patches its pod with, and
  the checkpoint corruptors of the chaos drills.
- ``data``     — the record pipeline (Python and the native core of
  ``native/``, built into ``_build/native``), ``ImageNetSource`` with
  its augment in process or in spawned workers, ``device_normalize``,
  and ``DevicePrefetcher`` (pinned buffers, a side CUDA stream).
- ``obs``      — metrics registry and ``/metrics`` server, JSONL spans, the
  serving request ledger.
- ``katib``    — the worker's trial-observation reporter.
- ``ops``      — flash attention forward and backward, fused Adam, the
  fused ghost-BN training blocks and the fused inference block (CUDA
  kernels).
- ``models``   — the Transformer LM and ResNet (default, fused training
  and fused inference paths), and the flax → torch converters.
- ``parallel`` — the mesh over the ranks, the sharded update's per-leaf
  rule and the collectives (host staging of a gloo group's CUDA tensors
  counted).
- ``runtime``  — recipe (every optimizer family, LARS and RMSProp
  included, and the runtime schedule), train step (replicated or ZeRO-2
  data parallelism), metrics (JSONL, TensorBoard, the flight recorder,
  ``torch.profiler`` captures, the heartbeat), bootstrap, checkpoints
  (the JAX package's directory contract, the port's payload), the
  numeric sentinel and the worker.
- ``serving``  — servable, micro-batcher, REST model server and client,
  batch predict.
- ``utils``    — TensorBoard event files.

This package's ``__init__`` imports no torch: the augment workers of
``data`` are spawned processes that import ``data.imagenet`` only.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card present they raise.
"""

__version__ = "0.1.0"
