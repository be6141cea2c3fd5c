"""ResNet over 2 data-parallel ranks against the JAX package on a
``data = 2`` mesh: the fused ghost-BN path (K4/K5's plain versions here,
each rank's ghost tiles its own rows, the batch moments averaged before
the EMA) and the default path's BatchNorm over the global batch.

The ranks are gloo processes spawned by ``tests/test_torch_dp.py``'s
``spawn``; JAX is imported inside the test functions only.
"""

import numpy as np
import torch

from kubeflow_tpu_torch.api.trainingjob import ShardingSpec
from kubeflow_tpu_torch.models import resnet as R
from kubeflow_tpu_torch.models.convert import (flatten_params,
                                               resnet_variables_from_jax)
from kubeflow_tpu_torch.parallel.mesh import build_mesh
from test_torch_dp import _port_run, spawn

CLASSES = 10


def _port_resnet(rank, world, params, stats, batch, fused, opt, steps):
    mesh = build_mesh(ShardingSpec(data=world))
    model = R.make_resnet(50 if fused else 18, num_classes=CLASSES,
                          dtype=torch.float32)
    loss_fn = R.make_fused_loss_fn(model, tile_bt=2, mesh=mesh) if fused \
        else R.make_loss_fn(model, mesh=mesh)
    tp, ts = resnet_variables_from_jax(params, stats)
    return _port_run(rank, world, "sharded", loss_fn,
                     {k: v.numpy() for k, v in tp.items()},
                     {"batch_stats": {k: v.numpy() for k, v in ts.items()}},
                     batch, steps, opt)


def _jax_stepper(params, stats, fused, opt):
    """``run(batch, steps) -> (metrics by step, params, batch_stats)``
    of the JAX package's sharded step on a data = 2 mesh, from the same
    init each call; compiled once for every batch of one shape."""
    import jax
    import jax.numpy as jnp
    from kubeflow_tpu.api.trainingjob import ShardingSpec as JSpec
    from kubeflow_tpu.models import resnet as JR
    from kubeflow_tpu.parallel.mesh import build_mesh as j_build_mesh
    from kubeflow_tpu.runtime.trainstep import TrainStepBuilder as JBuilder
    mesh = j_build_mesh(JSpec(data=2), jax.devices()[:2])
    model = JR.make_resnet(50 if fused else 18, num_classes=CLASSES,
                           dtype=jnp.float32)
    loss_fn = JR.make_fused_loss_fn(model, tile_bt=2, mesh=mesh) if fused \
        else JR.make_loss_fn(model)
    b = JBuilder(mesh=mesh, loss_fn=loss_fn, optimizer=opt,
                 weight_update="sharded")
    step = b.build()

    def run(batch, steps):
        state = b.init(lambda rng: (params, {"batch_stats": stats}),
                       jax.random.PRNGKey(0))
        placed = b.place_batch(batch)
        hist = []
        for _ in range(steps):
            state, m = step(state, placed)
            hist.append({k: np.asarray(v) for k, v in m.items()})
        return hist, flatten_params(jax.device_get(state.params)), \
            flatten_params(jax.device_get(state.variables["batch_stats"]))

    return run


def _stats_close(got: dict, ref: dict) -> None:
    for k, v in ref.items():
        err = np.abs(got[k] - v).max()
        assert err <= 1e-4 * np.abs(v).max(), f"{k}: {err}"


def test_fused_resnet50_over_two_ranks_matches_jax():
    """ResNet-50 at 64 px, batch 4, tile_bt 2, f32 (the smallest geometry
    tests/test_torch_fused_block_train.py runs) over 2 ranks of 2 rows:
    one SGD step at lr 1 without the clip, so the param change is the
    reduced gradient. Each rank's ghost tiles are its own rows on both
    sides (JAX's shard_map), the moments averaged over the ranks before
    the EMA. Against the JAX package's make_fused_loss_fn on a data = 2
    mesh (Pallas in interpret mode): the loss within rtol 1e-4, the new
    batch_stats within 1e-4 of their largest value, and the gradient
    within 1e-4 of its largest element plus twice the JAX side's noise
    floor (what its gradient moves when the images move by 2^-20 of
    themselves), as the one-process test bounds it. Both ranks end with
    the same batch_stats."""
    import optax
    from tests.test_torch_resnet import numpy_variables
    params, stats = numpy_variables(50, 64, seed=7)
    rng = np.random.default_rng(8)
    images = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    labels = np.array([3, 1, 4, 1], np.int32)
    p0 = flatten_params(params)
    run = _jax_stepper(params, stats, True, optax.sgd(1.0))

    def jax_grads(imgs):
        hist, p1, st = run({"images": imgs, "labels": labels}, 1)
        return hist, {k: p0[k] - p1[k] for k in p0}, st

    j_hist, j_grads, j_stats = jax_grads(images)
    moved = [jax_grads((images * (1 + 2.0 ** -20 * rng.standard_normal(
        images.shape))).astype(np.float32))[1] for _ in range(2)]
    ranks = spawn(_port_resnet, 2, params, stats,
                  {"images": images, "labels": labels}, True,
                  dict(name="sgd", learning_rate=1.0, grad_clip=None), 1)
    g_max = max(np.abs(g).max() for g in j_grads.values())
    for r, out in enumerate(ranks):
        assert out["strategy"] == "zero2-gspmd"
        np.testing.assert_allclose(out["hist"][0]["loss"],
                                   j_hist[0]["loss"], rtol=1e-4)
        _stats_close(out["variables"]["batch_stats"], j_stats)
        for k, g in j_grads.items():
            floor = max(np.abs(m[k] - g).max() for m in moved)
            err = np.abs((p0[k] - out["params"][k]) - g).max()
            assert err <= 1e-4 * g_max + 2 * floor, \
                f"rank {r} {k}: max|d| {err}, floor {floor}"
    for k, v in ranks[0]["variables"]["batch_stats"].items():
        np.testing.assert_array_equal(
            v, ranks[1]["variables"]["batch_stats"][k], err_msg=k)


def test_default_path_global_batchnorm_matches_the_jax_mesh():
    """ResNet-18 at 33 px, f32, batch 8 over 2 ranks of 4 rows, sharded,
    2 momentum steps: BatchNorm's statistics over the global batch (the
    sums all-reduced forward and backward) against the JAX package's
    step on a data = 2 mesh (GSPMD's global-batch BN): the loss within
    rtol 1e-4 per step and the running statistics within 1e-4 of their
    largest value, the bars tests/test_torch_resnet.py holds one process
    to."""
    import optax
    from tests.test_torch_resnet import numpy_variables
    params, stats = numpy_variables(18, 33, seed=4)
    rng = np.random.default_rng(5)
    batch = {"images": rng.standard_normal((8, 33, 33, 3)).astype(
        np.float32), "labels": (np.arange(8) * 3 % CLASSES).astype(np.int32)}
    run = _jax_stepper(params, stats, False, optax.sgd(0.01, momentum=0.9))
    j_hist, _, j_stats = run(batch, 2)
    ranks = spawn(_port_resnet, 2, params, stats, batch, False,
                  dict(name="momentum", learning_rate=0.01, grad_clip=None),
                  2)
    for r, out in enumerate(ranks):
        assert out["strategy"] == "zero2-gspmd"
        for i, (jm, tm) in enumerate(zip(j_hist, out["hist"])):
            np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-4,
                                       err_msg=f"rank {r} step {i}")
        _stats_close(out["variables"]["batch_stats"], j_stats)
