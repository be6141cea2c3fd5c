"""The port's operator loop: the controller runtime (``runtime``), the
training-job reconciler (``tpujob``) and the manager process that hosts
them with the slice scheduler behind a lease (``__main__``), copied from
``kubeflow_tpu/controllers`` so the soaks and the card drive the port's
worker without the JAX package."""
