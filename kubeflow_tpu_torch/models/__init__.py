"""Built-in workloads.

- ``transformer``: decoder-only Transformer LM, parameters in the JAX
  package's shapes.
- ``convert``: the flax params tree → this package's state dict.
"""
