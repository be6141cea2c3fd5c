"""Serving data plane on the card.

- :mod:`servable` — model loading (random weights from a seed for now;
  ``transformer_lm`` and ``resnet18`` … ``resnet152``), bucketed predict on
  a device, int8 quantization behind a parity gate.
- :mod:`batch_predict` — the offline batch-prediction job (.npy / .npz /
  .jsonl in, one JSONL record per row out).
- :mod:`batcher`  — micro-batching queue (continuous or window
  admission), bounded ``max_pending`` load shedding.
- :mod:`http_server` — REST front: /v1/models/<name>[:predict|/metadata],
  /v1/routers/<name>[:predict|:feedback], /healthz, /metrics; ``main()``
  also starts the gRPC front.
- :mod:`grpc_server` — TF-Serving's PredictionService (Predict,
  GetModelStatus) over the REST server's MicroBatchers
  (:mod:`tpu_serving_pb2`, the JAX package's generated messages).
- :mod:`router` — A/B, epsilon-greedy and shadow experiment routers.
- :mod:`fleet` — the health-routed, breaker-guarded router over N
  replicas: failover under a deadline budget, tail hedging.
- :mod:`client` — the REST and gRPC predict clients.
- :mod:`request_trace` — per-request ids, stage spans and ledgers.
- :mod:`replica_state` — per-model rolling health and SLO burn rates.
"""

from .servable import Servable, ModelRepository  # noqa: F401
from .batcher import MicroBatcher, QueueFullError  # noqa: F401
from .http_server import ModelServer  # noqa: F401
from .replica_state import ModelSLO, ReplicaState  # noqa: F401
from .request_trace import ServingObs  # noqa: F401
from .batch_predict import run_batch_predict  # noqa: F401
