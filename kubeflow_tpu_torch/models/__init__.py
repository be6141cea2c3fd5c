"""Built-in workloads.

- ``transformer``: decoder-only Transformer LM, parameters in the JAX
  package's shapes, with its loss, eval and workload spec.
- ``convert``: the flax params tree → this package's state dict, and a
  JAX Adam state → the port's optimizer state.
"""
