"""The training runtime: one process on one device, or one rank of a
data-parallel gang.

- ``recipe``    — optimizers (stock ``torch.optim``, the optax chains of
  LARS, RMSProp and the runtime schedule, the fused-Adam kernel), LR
  schedules, the global-norm clip, the recipe fingerprints.
- ``trainstep`` — ``TrainState`` and ``TrainStepBuilder``: forward,
  backward, the gradient reduction (all-reduce, or the ZeRO-2
  reduce-scatter and all-gather), clip, update; ``build_compiled``, the
  step captured as one CUDA graph.
- ``aot``       — the keyed AOT step record of the warm-start ladder.
- ``metrics``   — ``MetricsLogger`` (JSONL, TensorBoard), the lagged
  window fetch, the flight recorder, the profiler hooks and the pod
  heartbeat (``HeartbeatReporter``).
- ``bootstrap`` — ``WorkerContext`` from the topology-contract env: the
  process group, the mesh, this rank's card.
- ``checkpoint`` — ``CheckpointManager``: the JAX package's directory
  contract (commit marker, crc32 manifest, LKG marker, fallback walk,
  the elastic contract) over the port's ``torch.save`` payload; async
  saves, restores at any degree.
- ``sentinel``  — the numeric-integrity detectors, the anomaly evidence
  and exit code 76, the chaos numeric-fault hook.
- ``worker``    — ``train()`` and the CLI.
"""
