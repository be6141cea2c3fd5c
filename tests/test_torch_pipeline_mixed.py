"""The pipelined LM on {data 2, pipeline 2}: each data replica's rows through its own
two-stage pipeline, the stages' gradients summed over data, against the JAX package's
``TrainStepBuilder`` on the same mesh shape, at the bars of
tests/test_torch_pipeline_train.py."""

from tests.test_torch_pipeline_train import check_pipeline_mesh


def test_pipeline_step_matches_jax():
    check_pipeline_mesh({"data": 2, "pipeline": 2})
