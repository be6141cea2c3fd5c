"""The port's own copy of the API layer (``kubeflow_tpu/api``): the
manifest helpers (``k8s``), the training-job CRD types with a GPU
accelerator replica (``trainingjob``) and the GPU topology vocabulary and
contract (``topology``). The port imports nothing of the JAX package."""
