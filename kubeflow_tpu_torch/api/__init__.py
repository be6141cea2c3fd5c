"""The port's own copy of the job-spec vocabularies it needs
(``kubeflow_tpu/api/trainingjob.py``): the port imports nothing of the
JAX package."""
