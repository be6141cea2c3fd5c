"""The MoE LM on a data-only mesh, ``{data 2}`` (2 gloo ranks, the
replicated update), against the JAX package's ``TrainStepBuilder`` on
the same mesh shape, at the bars of tests/test_torch_model_parallel.py
(f32: loss, grad norm and ``moe_aux_loss`` within 1e-5 relative at every
step, each param within 1e-5 of its largest magnitude after 3 steps).
No axis shards a param, yet the Switch aux loss's ``f`` and ``P`` are
means over the global batch, as GSPMD computes the JAX function: each
rank's rows alone give another loss and router gradient whenever
routing is unbalanced.
"""

from tests.test_torch_model_parallel import MOE, OPT, check_against_jax


def test_moe_on_a_data_mesh_matches_jax():
    check_against_jax(dict(data=2), MOE, "einsum", "replicated", OPT)
