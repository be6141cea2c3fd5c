"""LARS on a mixed mesh: the MoE LM on ``{data 2, tensor 2}`` (4 gloo
ranks, the replicated update) against the JAX package's
``TrainStepBuilder`` on the same mesh shape, at the bars of
tests/test_torch_model_parallel.py. LARS's per-tensor norms ‖p‖ and ‖u‖
of a tensor-sharded leaf are the sums of its blocks' over the world's
ranks (two data ranks hold each block: counted twice in both norms,
which the trust ratio cancels); weight decay 1e-4 on the rank > 1
leaves.
"""

from tests.test_torch_model_parallel import LARS, MOE, check_against_jax


def test_lars_on_a_mixed_mesh_matches_jax():
    check_against_jax(dict(data=2, tensor=2), MOE, "einsum", "replicated",
                      LARS)
