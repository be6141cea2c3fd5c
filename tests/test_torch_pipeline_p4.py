"""The pipelined LM on {pipeline 4}: one layer a stage, three links, against the JAX package's
``TrainStepBuilder`` on the same mesh shape, at the bars of
tests/test_torch_pipeline_train.py."""

from tests.test_torch_pipeline_train import check_pipeline_mesh


def test_pipeline_step_matches_jax():
    check_pipeline_mesh({"pipeline": 4})
