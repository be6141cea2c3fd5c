"""The whole fused ResNet-50 against the JAX package's, the batch-tiled
routing (tests/test_torch_fused_block_train.py holds the kernels' plain
versions against the Pallas kernels, and its helpers;
tests/test_torch_fused_block_spatial_model.py the same model with the
spatial kernel forced on stages 1-2).
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu.models import resnet as JR
from kubeflow_tpu.ops import fused_block_train as J
from kubeflow_tpu.ops import fused_block_train_spatial as JS
from kubeflow_tpu_torch.models import resnet as R
from kubeflow_tpu_torch.models.convert import resnet_variables_from_jax
from kubeflow_tpu_torch.ops import fused_block_train as T
from kubeflow_tpu_torch.ops import fused_block_train_spatial as TS
from tests.test_torch_fused_block_train import _jax_fused
from tests.test_torch_resnet import numpy_variables


@pytest.mark.parametrize("force_spatial", [False])
def test_fused_model_matches_jax(force_spatial, monkeypatch):
    """resnet50 @ 64 px, batch 4, tile_bt 2, f32: the port's
    fused_train_apply (plain versions on the CPU) against the JAX
    package's (its Pallas kernels in interpret mode): logits, the new
    batch_stats and every gradient, within 1e-4 of the largest value (of
    all gradients, for gradients) plus twice the JAX values' own noise
    floor, the most they move by when the images move by 2^-20 of
    themselves (at this size the gradients move by up to 6% in norm).
    64 px, not 32: at 32 px stage 4 is 1x1 and a ghost tile of 2 images
    holds 2 samples, where BN's output is ±1 whatever its input and its
    backward is rounding noise times rsqrt(var + eps) (gradients of 4e7
    that no comparison resolves). ``force_spatial`` shrinks the budget in
    both packages' modules (as tests/test_ops.py does) so that stages 1
    and 2 take the spatial kernel (th 4, two or four strips) and stages 3
    and 4 the batch-tiled one: one model through both."""
    if force_spatial:
        budget = JS._strip_bytes(4, 16, 256, 64, 256)
        for mod in (J, JS, T, TS):
            monkeypatch.setattr(mod, "VMEM_BUDGET_BYTES", budget)
    routes = R.fused_block_routing(50, 64)
    assert routes == JR.fused_block_routing(50, 64)
    assert (routes["stage2_block2"] == "fused-spatial(th=4)") == \
        force_spatial
    assert routes["stage4_block2"] == "fused-batch"
    params, stats = numpy_variables(50, 64, seed=7)
    rng = np.random.default_rng(8)
    images = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    labels = np.array([3, 1, 4, 1], np.int32)
    jax_fused = _jax_fused(params, stats, 2)
    ref = jax_fused(images, labels)
    # the noise floor: the most the same function moves when the images
    # move by 2^-20 of themselves (three draws), about what f32 rounding
    # through 50 layers does
    moved = [jax_fused((images * (1 + 2.0 ** -20 * rng.standard_normal(
        images.shape))).astype(np.float32), labels) for _ in range(3)]

    tp, ts = resnet_variables_from_jax(params, stats)
    for p in tp.values():
        p.requires_grad_(True)
    logits, new = R.fused_train_apply(
        {"params": tp, "batch_stats": ts}, torch.from_numpy(images),
        tile_bt=2, dtype=torch.float32)
    loss = R.cross_entropy_loss(logits, torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, list(tp.values()))
    got = {"logits": logits.detach().numpy(),
           **{f"stat {k}": v.numpy() for k, v in new.items()},
           **{f"grad {k}": g.numpy() for k, g in zip(tp, grads)}}
    assert set(got) == set(ref)
    g_max = max(np.abs(v).max() for k, v in ref.items()
                if k.startswith("grad"))
    for k, r in ref.items():
        floor = max(np.abs(m[k] - r).max() for m in moved)
        scale = g_max if k.startswith("grad") else np.abs(r).max()
        err = np.abs(got[k] - r).max()
        assert err <= 1e-4 * scale + 2 * floor, \
            f"{k}: max|d| {err}, noise floor {floor}, scale {scale}"
