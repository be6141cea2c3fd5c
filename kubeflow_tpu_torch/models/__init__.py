"""Built-in workloads.

- ``resnet``: ResNet-18…152, the worker's default workload and the
  servables' default model: the exact-BN default path, the fused ghost-BN
  training path (K4/K5) and the fused inference path (K6), parameters and
  running statistics in the JAX package's shapes and names.
- ``transformer``: decoder-only Transformer LM, parameters in the JAX
  package's shapes, with its loss, eval and workload spec.
- ``convert``: the flax params tree (and ResNet's ``batch_stats``) → this
  package's state dict, a JAX ``FusedBlockWeights`` → the port's, and a
  JAX Adam state → the port's optimizer state.
"""

# The supported ResNet family (tf_cnn_benchmarks --model surface), defined
# here so the worker can enumerate it without importing the model.
RESNET_DEPTHS = (18, 34, 50, 101, 152)
