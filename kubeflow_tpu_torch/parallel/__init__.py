"""Data parallelism across processes.

- ``mesh``           — the mesh over the ranks (``ShardingSpec`` resolved
  against the process group), the replica axes and the per-rank batch.
- ``sharding_rules`` — the per-leaf dimension the sharded weight update
  (ZeRO-2) splits.
- ``collectives``    — the collectives the train step and the models
  call, on any backend, with the counted host staging of a gloo group's
  CUDA tensors and the differentiable cross-rank sum.
"""
