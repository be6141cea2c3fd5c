"""The port's training recipe against the JAX package's.

- ``lr_schedule`` against the optax schedules ``kubeflow_tpu`` builds, for
  all four schedules with and without warmup, at every count of the run
  and past it: within 1e-6 relative (the port evaluates in Python floats,
  optax in f32).
- ``make_optimizer`` for sgd, momentum, nesterov, adam, adamw and the
  fused_adam tier against JAX ``make_optimizer`` over 3 steps with the
  default clip on, weight decay 1e-4 on the rank > 1 leaves, a cosine
  schedule, and gradients scaled so the clip triggers on the second step
  only: params within 1e-6 (f32; the two chains round in other places,
  which moves an O(1) param by an ulp or two).
- The clip against ``optax.clip_by_global_norm`` bit for bit, on both
  branches; the fused tier with its clip inside the kernel against the
  JAX chain over 4 steps, within 1e-5.
- The refusals.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.api import trainingjob as JA
from kubeflow_tpu.runtime import recipe as J
from kubeflow_tpu_torch.api import trainingjob as TA
from kubeflow_tpu_torch.runtime import recipe as T

tfo = importlib.import_module("kubeflow_tpu_torch.ops.fused_adam")

SHAPES = {"dense.kernel": (7, 5), "dense.bias": (5,),
          "head.kernel": (5, 13), "head.bias": (13,)}
GRAD_SCALES = (0.05, 3.0, 0.05)   # global norms ~0.3, ~19, ~0.3


@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("name", J.SCHEDULES)
def test_lr_schedule_matches_optax(name, warmup):
    total = 12
    j = J.lr_schedule(name, 0.1, total, warmup)
    t = T.lr_schedule(name, 0.1, total, warmup)
    for count in range(total + 3):
        np.testing.assert_allclose(t(count), float(j(count)), rtol=1e-6,
                                   atol=1e-9, err_msg=f"count {count}")


def test_step_schedule_boundaries_compound():
    """3 steps: two boundaries collide on one count and compound."""
    j = J.lr_schedule("step", 1.0, 3)
    t = T.lr_schedule("step", 1.0, 3)
    assert [t(c) for c in range(4)] == pytest.approx(
        [float(j(c)) for c in range(4)], rel=1e-6)


def _params(seed=3) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _tree(flat):
    out: dict = {}
    for name, a in flat.items():
        mod, leaf = name.split(".")
        out.setdefault(mod, {})[leaf] = jnp.asarray(a)
    return out


@pytest.mark.parametrize("name,kernels", [
    ("sgd", "stock"), ("momentum", "stock"), ("nesterov", "stock"),
    ("adam", "stock"), ("adamw", "stock"), ("adam", "fused_adam")])
def test_make_optimizer_matches_jax(name, kernels):
    kw = dict(learning_rate=1e-2, schedule="cosine", total_steps=3,
              weight_decay=1e-4, kernels=kernels)
    flat = _params()
    j_opt, _ = J.make_optimizer(name, **kw)
    jp = _tree(flat)
    j_state = j_opt.init(jp)
    params = {k: torch.from_numpy(a.copy()) for k, a in flat.items()}
    t_opt, _ = T.make_optimizer(params, name, **kw)
    norms = []
    for scale in GRAD_SCALES:
        g = jax.tree.map(lambda p: jnp.sin(p) * scale, jp)
        norms.append(float(optax.global_norm(g)))
        up, j_state = j_opt.update(g, j_state, jp)
        jp = optax.apply_updates(jp, up)
        for p in params.values():
            p.grad = torch.sin(p) * scale
        t_opt.step()
    assert norms[0] < 1.0 < norms[1] and norms[2] < 1.0   # clip on step 2
    assert t_opt.count == 3
    for key, p in params.items():
        mod, leaf = key.split(".")
        np.testing.assert_allclose(p.numpy(), np.asarray(jp[mod][leaf]),
                                   atol=1e-6, rtol=0, err_msg=key)


@pytest.mark.parametrize("scale", [0.05, 3.0])
def test_clip_is_optax_form(scale):
    flat = _params(seed=5)
    g = jax.tree.map(lambda p: jnp.sin(p) * scale, _tree(flat))
    j_clipped, _ = optax.clip_by_global_norm(1.0).update(g, None)
    grads = [torch.sin(torch.from_numpy(a)) * scale for a in flat.values()]
    norm = T.clip_by_global_norm_(grads, 1.0)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(g)),
                               rtol=1e-6)
    for t, key in zip(grads, flat):
        mod, leaf = key.split(".")
        np.testing.assert_allclose(t.numpy(),
                                   np.asarray(j_clipped[mod][leaf]),
                                   atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("scale", [0.05, 3.0])
@pytest.mark.parametrize("clip", ["clip_by_global_norm_", "fused plain"])
def test_clip_matches_optax_bit_for_bit(clip, scale):
    """Both of the port's clips (the stock tiers' and the fused kernel's
    plain version) against optax.clip_by_global_norm on the same f32
    gradients, on both branches (norm ~0.3 and ~19 against 1.0): equal to
    the last bit, given the norm optax takes. The norm itself is a sum in
    another order, held to 1e-6 in test_clip_is_optax_form."""
    flat = _params(seed=6)
    g = jax.tree.map(lambda p: jnp.sin(p) * scale, _tree(flat))
    j_clipped, _ = optax.clip_by_global_norm(1.0).update(g, None)
    norm = torch.tensor(np.asarray(optax.global_norm(g)))
    grads = [torch.from_numpy(np.array(g[k.split(".")[0]][
        k.split(".")[1]])) for k in flat]
    if clip == "clip_by_global_norm_":
        T.clip_by_global_norm_(grads, 1.0, norm=norm)
    else:
        grads = [tfo.clip_plain(x, norm, 1.0) for x in grads]
    for t, key in zip(grads, flat):
        mod, leaf = key.split(".")
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(j_clipped[mod][leaf]))


def test_fused_adam_with_clip_matches_jax_chain():
    """make_optimizer(adam, fused_adam, grad_clip 0.7) against the JAX
    package's chain (optax's clip, then its fused Pallas kernel in
    interpret mode) over 4 steps whose gradient norms cross 0.7 both ways:
    params within 1e-5, tests/test_torch_fused_adam.py's bar."""
    kw = dict(learning_rate=1e-2, schedule="cosine", total_steps=4,
              weight_decay=1e-4, kernels="fused_adam", grad_clip=0.7)
    flat = _params(seed=7)
    j_opt, _ = J.make_optimizer("adam", **kw)
    jp = _tree(flat)
    j_state = j_opt.init(jp)
    params = {k: torch.from_numpy(a.copy()) for k, a in flat.items()}
    t_opt, _ = T.make_optimizer(params, "adam", **kw)
    norms = []
    for step, scale in enumerate((3.0, 0.05, 3.0, 0.05)):
        g = jax.tree.map(lambda p: jnp.sin(p + step) * scale, jp)
        norms.append(float(optax.global_norm(g)))
        up, j_state = j_opt.update(g, j_state, jp)
        jp = optax.apply_updates(jp, up)
        for p in params.values():
            p.grad = torch.sin(p + step) * scale
        t_opt.step()
    assert norms[0] > 0.7 > norms[1] and norms[2] > 0.7 > norms[3]
    for key, p in params.items():
        mod, leaf = key.split(".")
        np.testing.assert_allclose(p.numpy(), np.asarray(jp[mod][leaf]),
                                   atol=1e-5, rtol=0, err_msg=key)


def test_decay_mask_includes_embeddings():
    params = {"tok_embed.embedding": torch.zeros(4, 2),
              "ln_f.scale": torch.zeros(2), "head.kernel": torch.zeros(2, 4)}
    assert T.decay_mask(params) == {"tok_embed.embedding": True,
                                    "ln_f.scale": False, "head.kernel": True}


def test_refusals():
    p = [torch.zeros(2, 2, requires_grad=True)]
    with pytest.raises(ValueError, match="requires optimizer"):
        T.make_optimizer(p, "momentum", kernels="fused_adam")
    for name in ("lars", "rmsprop"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            T.make_optimizer(p, name)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        T.make_optimizer(p, "adam", runtime_schedule=True)
    with pytest.raises(ValueError, match="incompatible"):
        T.make_optimizer(p, "adam", kernels="fused_adam",
                         runtime_schedule=True)
    with pytest.raises(ValueError, match="not one of"):
        T.make_optimizer(p, "adagrad")
    with pytest.raises(ValueError, match="not one of"):
        T.lr_schedule("exponential", 0.1, 10)


def test_vocabularies_match_jax():
    assert T.OPTIMIZERS == J.OPTIMIZERS and T.SCHEDULES == J.SCHEDULES
    assert T.STEP_BOUNDARIES == J.STEP_BOUNDARIES
    for name in ("OPTIMIZER_KERNELS", "ATTENTION_KERNELS", "SERVING_KERNELS",
                 "WEIGHT_UPDATE_MODES"):
        assert getattr(TA, name) == getattr(JA, name), name
    assert T.scale_lr(0.1, 512) == J.scale_lr(0.1, 512)
