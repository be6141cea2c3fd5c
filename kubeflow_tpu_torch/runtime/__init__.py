"""The training runtime, for one process on one device.

- ``recipe``    — optimizers (stock ``torch.optim`` and the fused-Adam
  kernel), LR schedules, the global-norm clip.
- ``trainstep`` — ``TrainState`` and ``TrainStepBuilder``: forward,
  backward, clip, update.
- ``metrics``   — ``MetricsLogger`` (JSONL) and the lagged window fetch.
- ``bootstrap`` — ``WorkerContext`` from the topology-contract env.
- ``worker``    — ``train()`` and the CLI.
"""
