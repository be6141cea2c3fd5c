"""kubeflow_tpu_torch — the PyTorch/CUDA port of kubeflow_tpu for the H100.

Mirrors ``kubeflow_tpu``'s layout module for module; each module here has
its counterpart of the same name there, which stays the reference. The
port imports ``torch`` and ``numpy`` and nothing of JAX or of
``kubeflow_tpu``. Every Pallas kernel on a ported path becomes a
hand-written Hopper kernel (``csrc/``, built by ``ops/_build.py``) with a
plain PyTorch version beside it for CPU tensors.

Ported so far (serving and training the Transformer LM):

- ``api``      — the job-spec vocabularies the training path validates.
- ``obs``      — metrics registry, JSONL spans, the serving request ledger.
- ``ops``      — flash attention forward and backward, fused Adam (CUDA
  kernels).
- ``models``   — the Transformer LM with its loss, and the flax → torch
  weight and Adam-state converters.
- ``runtime``  — recipe, train step, metrics, bootstrap and the worker.
- ``serving``  — servable, micro-batcher, REST model server and client.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card present they raise.
"""

__version__ = "0.1.0"
