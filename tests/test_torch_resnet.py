"""ResNet's default path: the port's models/resnet.py against the flax
module, and the worker training ResNet on the CPU.

Both sides take the same numpy weights (a flax-shaped tree from a seed,
converted by ``resnet_variables_from_jax``) and the same numpy batch.

- f32: resnet18 and resnet50 at 32 px and resnet18 at 33 px (odd sizes
  pad SAME asymmetrically: the stem pads (2, 3) on even sizes, the pool and
  the strided convs (0, 1)), batch 4, 10 classes. Eval-mode logits, loss
  and top-1/top-5 within 1e-4 of the largest value (the same arithmetic
  summed in another order through up to 50 layers). Train-mode logits,
  the loss, the updated ``batch_stats`` and every gradient within 1e-4 of
  the largest value (of the tensor; of all gradients for gradients) plus
  twice their own noise floor: what the JAX values move by when the batch
  is taken in another order. At 32 px the last stage is 1x1 (2x2 at 33
  px), so its train-mode BatchNorms take E[x²] − E[x]² over 4 samples and
  cancel: at resnet50 @ 32 px the JAX logits move by 2e-3 of their
  largest value and some stage-4 gradients by half of theirs under a
  reordering of the batch, and no comparison resolves more.
- bf16: resnet18 at 33 px, eval logits within 3e-2 of the largest logit
  and the train-mode loss within 1e-2 relative: the two frameworks round
  conv outputs and BN results to bf16 at the same places, but sum in
  another order, so a value can land one bf16 step (2^-8) away at any of
  20 layers.
- Two steps of the port's TrainStepBuilder (momentum SGD, the recipe's
  clip) against the JAX one on the default path: the loss and the running
  statistics at each step within 1e-4 relative.
- ``train(device="cpu")`` on the fused path (K4 routes on the CPU to its
  plain version) and on the default path with the eval pass.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import resnet as J
from kubeflow_tpu.parallel.mesh import build_mesh
from kubeflow_tpu.runtime.recipe import make_optimizer as j_make_optimizer
from kubeflow_tpu.runtime.trainstep import TrainStepBuilder as JBuilder
from kubeflow_tpu_torch.models import resnet as R
from kubeflow_tpu_torch.models.convert import (flatten_params,
                                               resnet_variables_from_jax)
from kubeflow_tpu_torch.runtime import worker
from kubeflow_tpu_torch.runtime.recipe import make_optimizer
from kubeflow_tpu_torch.runtime.trainstep import TrainStepBuilder

CLASSES, BATCH = 10, 4


def numpy_variables(depth: int, size: int, seed: int = 0):
    """A flax-shaped (params, batch_stats) of numpy arrays from ``seed``:
    kernels N(0, 1/fan_in), BN scales near 1, biases and running means
    near 0, running variances in [0.5, 1.5]."""
    model = J.make_resnet(depth, num_classes=CLASSES, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        if name.endswith("kernel"):
            fan_in = int(np.prod(leaf.shape[:-1]))
            a = rng.standard_normal(leaf.shape) / np.sqrt(fan_in)
        elif name.endswith("scale"):
            a = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        elif name.endswith("var"):
            a = rng.uniform(0.5, 1.5, leaf.shape)
        else:
            a = 0.1 * rng.standard_normal(leaf.shape)
        return a.astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    return v["params"], v["batch_stats"]


def numpy_batch(size: int, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((BATCH, size, size, 3)).astype(
                np.float32),
            "labels": (np.arange(BATCH) * 3 % CLASSES).astype(np.int32)}


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), \
        f"{what}: max|d| {err} vs max|ref| {np.abs(ref).max()}"


def test_names_and_shapes_equal_flax():
    for depth in (18, 50):
        params, stats = numpy_variables(depth, 32)
        tp, ts = resnet_variables_from_jax(params, stats)
        shapes, norms = R.make_resnet(depth, CLASSES).shapes()
        assert {k: tuple(v.shape) for k, v in tp.items()} == \
            {k: tuple(s) for k, s in shapes.items()}
        assert set(ts) == {f"{n}.{k}" for n in norms for k in ("mean",
                                                                "var")}
        assert all(ts[f"{n}.mean"].shape == (c,) for n, c in norms.items())
        # with the outer collection keys too
        tp2, ts2 = resnet_variables_from_jax({"params": params},
                                             {"batch_stats": stats})
        assert set(tp2) == set(tp) and set(ts2) == set(ts)
        # the port's own init draws the same names, shapes and zero scales
        ip, iv = R.make_resnet(depth, CLASSES).init(
            torch.Generator().manual_seed(0))
        assert set(ip) == set(tp) and set(iv["batch_stats"]) == set(ts)
        last = "BatchNorm_2" if depth >= 50 else "BatchNorm_1"
        assert float(ip[f"stage1_block1.{last}.scale"].abs().max()) == 0.0
        assert float(ip["stage1_block1.BatchNorm_0.scale"].min()) == 1.0


def _train_quantities(model, params, stats, batch):
    """Train-mode logits, loss, updated running stats and gradients from
    the flax model (numpy, by the port's names)."""
    def f(p, s, b):
        logits, upd = model.apply({"params": p, "batch_stats": s},
                                  b["images"], train=True,
                                  mutable=["batch_stats"])
        loss = J.cross_entropy_loss(logits, b["labels"])
        return loss, (logits, upd["batch_stats"])

    (loss, (logits, upd)), grads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(params, stats, batch)
    return {"logits": np.asarray(logits), "loss": np.asarray(loss),
            **{f"stat {k}": v for k, v in flatten_params(upd).items()},
            **{f"grad {k}": v for k, v in flatten_params(grads).items()}}


@pytest.mark.parametrize("depth,size", [(18, 32), (50, 32), (18, 33)])
def test_default_path_matches_flax_f32(depth, size):
    params, stats = numpy_variables(depth, size)
    batch = numpy_batch(size)
    model = J.make_resnet(depth, num_classes=CLASSES, dtype=jnp.float32)
    ref = _train_quantities(model, params, stats, batch)
    # the train-mode quantities' own noise floor: the same function on the
    # batch in another order (perm is its own inverse)
    perm = np.array([1, 0, 3, 2])
    moved = _train_quantities(model, params, stats,
                              {k: v[perm] for k, v in batch.items()})
    moved["logits"] = moved["logits"][perm]
    j_eval_logits = jax.jit(lambda p, s, x: model.apply(
        {"params": p, "batch_stats": s}, x, train=False))(
        params, stats, batch["images"])
    j_eval = jax.jit(J.make_eval_fn(model))(
        params, {"batch_stats": stats}, batch)

    tm = R.make_resnet(depth, num_classes=CLASSES, dtype=torch.float32)
    tp, ts = resnet_variables_from_jax(params, stats)
    for p in tp.values():
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    t_loss, t_aux = R.make_loss_fn(tm)(tp, {"batch_stats": ts}, tb, None)
    t_grads = torch.autograd.grad(t_loss, list(tp.values()))
    t_logits, _ = tm.apply(tp, ts, tb["images"], train=True)
    t_stats = t_aux["variables"]["batch_stats"]
    assert not any(v.requires_grad for v in t_stats.values())
    got = {"logits": t_logits.detach().numpy(),
           "loss": t_loss.detach().numpy(),
           **{f"stat {k}": v.numpy() for k, v in t_stats.items()},
           **{f"grad {k}": g.numpy() for k, g in zip(tp, t_grads)}}
    assert set(got) == set(ref)
    g_max = max(np.abs(v).max() for k, v in ref.items()
                if k.startswith("grad"))
    for k, r in ref.items():
        floor = np.abs(moved[k] - r).max()
        scale = g_max if k.startswith("grad") else np.abs(r).max()
        err = np.abs(got[k] - r).max()
        assert err <= 1e-4 * scale + 2 * floor, \
            f"{k}: max|d| {err}, noise floor {floor}, scale {scale}"
    assert float(t_aux["accuracy"]) == float(
        np.mean(ref["logits"].argmax(-1) == batch["labels"]))

    with torch.no_grad():
        t_eval_logits = tm.apply(tp, ts, tb["images"], train=False)
        t_eval = R.make_eval_fn(tm)(tp, {"batch_stats": ts}, tb)
    _close(t_eval_logits, j_eval_logits, 1e-4, "eval logits")
    _close(t_eval["eval_loss"], j_eval["eval_loss"], 1e-4, "eval loss")
    for k in ("top1", "top5"):
        assert float(t_eval[k]) == float(j_eval[k]), k


def test_default_path_matches_flax_bf16():
    params, stats = numpy_variables(18, 33, seed=2)
    batch = numpy_batch(33, seed=3)
    model = J.make_resnet(18, num_classes=CLASSES)
    j_logits = jax.jit(lambda p, s, x: model.apply(
        {"params": p, "batch_stats": s}, x, train=False))(
        params, stats, batch["images"])
    j_loss, _ = jax.jit(J.make_loss_fn(model))(
        params, {"batch_stats": stats}, batch, None)
    tm = R.make_resnet(18, num_classes=CLASSES)
    assert tm.dtype == torch.bfloat16
    tp, ts = resnet_variables_from_jax(params, stats)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        t_logits = tm.apply(tp, ts, tb["images"], train=False)
        t_loss, _ = R.make_loss_fn(tm)(tp, {"batch_stats": ts}, tb, None)
    assert t_logits.dtype == torch.float32
    _close(t_logits, j_logits, 3e-2, "bf16 eval logits")
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-2)


def test_same_padding_matches_flax():
    """flax SAME: the 7x7/s2 stem pads (2, 3) at 224, torch's padding=3
    would pad (3, 3); the 3x3/s2 pool pads (0, 1) with -inf."""
    assert R._same_pads(224, 7, 2) == (2, 3)
    assert R._same_pads(33, 7, 2) == (3, 3)
    assert R._same_pads(56, 3, 2) == (0, 1)
    assert R._same_pads(56, 1, 2) == (0, 0)
    assert R._same_pads(7, 3, 1) == (1, 1)
    x = torch.arange(2 * 6 * 6 * 1, dtype=torch.float32).reshape(2, 6, 6, 1)
    got = R.max_pool_same(-x)
    ref = nn.max_pool(-jnp.asarray(x.numpy()), (3, 3), strides=(2, 2),
                      padding="SAME")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_trainstep_two_steps_match_jax():
    """The port's TrainStepBuilder against the JAX one, 2 momentum-SGD
    steps on the default path (resnet18 @ 33 px, f32): the loss and the
    EMA'd running statistics per step."""
    params, stats = numpy_variables(18, 33, seed=4)
    batch = numpy_batch(33, seed=5)
    opt = dict(learning_rate=0.01, schedule="constant", total_steps=2)
    jm = J.make_resnet(18, num_classes=CLASSES, dtype=jnp.float32)
    j_opt, _ = j_make_optimizer("momentum", **opt)
    jb = JBuilder(mesh=build_mesh(devices=jax.devices()[:1]),
                  loss_fn=J.make_loss_fn(jm), optimizer=j_opt)
    js = jb.init(lambda rng: (params, {"batch_stats": stats}),
                 jax.random.PRNGKey(0))
    j_step, j_batch = jb.build(), jb.place_batch(batch)

    tm = R.make_resnet(18, num_classes=CLASSES, dtype=torch.float32)
    tb_ = TrainStepBuilder(
        loss_fn=R.make_loss_fn(tm), device="cpu",
        optimizer=lambda p: make_optimizer(p, "momentum", **opt)[0])
    tp, ts = resnet_variables_from_jax(params, stats)
    t_state = tb_.init(lambda rng: (tp, {"batch_stats": ts}), None)
    t_step, t_batch = tb_.build(), tb_.place_batch(batch)
    for step in range(2):
        js, jm_ = j_step(js, j_batch)
        t_state, tm_ = t_step(t_state, t_batch)
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                                   rtol=1e-4, err_msg=f"step {step + 1}")
        j_stats = flatten_params(jax.device_get(
            js.variables["batch_stats"]))
        t_stats = t_state.variables["batch_stats"]
        for k in j_stats:
            assert not t_stats[k].requires_grad
            _close(t_stats[k], j_stats[k], 1e-4, f"step {step + 1} {k}")


def test_worker_trains_resnet_on_cpu(tmp_path):
    """The fused path (every stride-1 block through K4's plain version on
    the CPU) and the default path with the eval pass, through train()."""
    kw = dict(device="cpu", steps=2, global_batch=4, sync_every=1,
              handle_sigterm=False)
    fused = worker.train(workload="resnet50", workload_kwargs={
        "image_size": 32, "num_classes": 10, "fused": True,
        "fused_tile_bt": 1}, metrics_path=str(tmp_path / "f.jsonl"), **kw)
    assert fused.steps == 2
    assert np.isfinite(fused.final_metrics["loss"])
    lines = (tmp_path / "f.jsonl").read_text().splitlines()
    assert len(lines) == 2
    plain = worker.train(workload="resnet18", workload_kwargs={
        "image_size": 32, "num_classes": 10}, eval_every=2, eval_batches=1,
        label_smoothing=0.1, **kw)
    assert np.isfinite(plain.final_metrics["loss"])
    assert {"eval_loss", "top1", "top5", "accuracy"} <= \
        set(plain.final_metrics)


def test_fused_refusals():
    with pytest.raises(ValueError, match="bottleneck"):
        R.make_fused_loss_fn(R.resnet18(num_classes=10))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        R.make_fused_loss_fn(R.resnet50(num_classes=10), mesh=2)
    with pytest.raises(SystemExit):
        worker.main(["--workload", "resnet18", "--fused-blocks",
                     "--device", "cpu"])
