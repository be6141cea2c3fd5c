"""The pipelined LM on {pipeline 2, tensor 2}: each stage's blocks split over tensor
(Megatron's pattern), the hops between the ranks of equal tensor
coordinate, against the JAX package's
``TrainStepBuilder`` on the same mesh shape, at the bars of
tests/test_torch_pipeline_train.py."""

from tests.test_torch_pipeline_train import check_pipeline_mesh


def test_pipeline_step_matches_jax():
    check_pipeline_mesh({"pipeline": 2, "tensor": 2})
