"""Model-parallel training on the mixed meshes of 4 gloo ranks against
the JAX package's ``TrainStepBuilder`` on the same mesh shape, at the
bars of tests/test_torch_model_parallel.py (f32: loss, grad norm and
``moe_aux_loss`` within 1e-5 relative at every step, each param within
1e-5 of its largest magnitude after 3 steps):

- ``{data 2, tensor 2}``, the MoE LM with the sharded update (the port's
  ``zero2-gspmd``: one more dimension of each block over data; the
  experts' MLP columns over tensor);
- ``{data 2, expert 2}``, the MoE LM (the aux loss's statistics summed
  over the data axis, the combine over expert). LARS on
``{data 2, tensor 2}`` is in tests/test_torch_model_parallel_lars.py.
"""

import pytest

from tests.test_torch_model_parallel import MOE, OPT, check_against_jax

CASES = [
    ("data2-tensor2", dict(data=2, tensor=2), MOE, "einsum", "sharded", OPT),
    ("data2-expert2", dict(data=2, expert=2), MOE, "einsum", "replicated",
     OPT),
]


@pytest.mark.parametrize("name,mesh,cfg,attention,mode,opt", CASES,
                         ids=[c[0] for c in CASES])
def test_mixed_mesh_step_matches_jax(name, mesh, cfg, attention, mode, opt):
    check_against_jax(mesh, cfg, attention, mode, opt)
