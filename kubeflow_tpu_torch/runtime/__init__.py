"""The training runtime, for one process on one device.

- ``recipe``    — optimizers (stock ``torch.optim``, the optax chains of
  LARS, RMSProp and the runtime schedule, the fused-Adam kernel), LR
  schedules, the global-norm clip, the recipe fingerprints.
- ``trainstep`` — ``TrainState`` and ``TrainStepBuilder``: forward,
  backward, clip, update.
- ``metrics``   — ``MetricsLogger`` (JSONL, TensorBoard), the lagged
  window fetch, the flight recorder and the profiler hooks.
- ``bootstrap`` — ``WorkerContext`` from the topology-contract env.
- ``worker``    — ``train()`` and the CLI.
"""
