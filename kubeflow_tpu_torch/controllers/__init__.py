"""The port's operator loop: the controller runtime (``runtime``) and the
training-job reconciler (``tpujob``), copied from
``kubeflow_tpu/controllers`` so the soaks and the card drive the port's
worker without the JAX package."""
