"""The training runtime: one process on one device, or one rank of a
data-parallel gang.

- ``recipe``    — optimizers (stock ``torch.optim``, the optax chains of
  LARS, RMSProp and the runtime schedule, the fused-Adam kernel), LR
  schedules, the global-norm clip, the recipe fingerprints.
- ``trainstep`` — ``TrainState`` and ``TrainStepBuilder``: forward,
  backward, the gradient reduction (all-reduce, or the ZeRO-2
  reduce-scatter and all-gather), clip, update.
- ``metrics``   — ``MetricsLogger`` (JSONL, TensorBoard), the lagged
  window fetch, the flight recorder, the profiler hooks and the pod
  heartbeat (``HeartbeatReporter``).
- ``bootstrap`` — ``WorkerContext`` from the topology-contract env: the
  process group, the mesh, this rank's card.
- ``worker``    — ``train()`` and the CLI.
"""
