"""The port's scheduler vocabulary: as much of ``kubeflow_tpu/scheduler``
as the serving fleet uses (the evidence-decay fold of ``health``)."""
