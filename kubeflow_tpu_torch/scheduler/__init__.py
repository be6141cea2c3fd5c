"""The port's scheduler vocabulary: as much of ``kubeflow_tpu/scheduler``
as the operator and the serving fleet use (``health``: the evidence-decay
fold, the host events, the quarantine and suspect parses). The slice
scheduler itself is ROADMAP item 19."""
