"""The port's cluster client: as much of ``kubeflow_tpu/cluster`` as the
worker needs to annotate its own pod."""
