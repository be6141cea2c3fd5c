"""The port's cluster side: as much of ``kubeflow_tpu/cluster`` as the
worker needs to annotate its own pod (``http_client``), and the chaos
drills of checkpoints and of the serving fleet (``chaos``)."""
