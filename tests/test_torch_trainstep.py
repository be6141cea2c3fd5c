"""The slice as a whole: the port's TrainStepBuilder against the JAX one.

Both sides start from the same numpy weights (a flax-shaped tree made
from a seed, converted by ``transformer_params_from_jax``) and take 3
steps on the same numpy batch, through each package's transformer
workload spec, recipe (adam, lr 1e-3, the default clip 1.0) and train
step, at ``TransformerConfig.tiny()`` widths (2 layers, embed 64, 4 heads
x 16, MLP 128, vocab 256) on 2 x 32 tokens. The JAX flash path runs its
Pallas kernels and the fused tier its Pallas update in interpret mode.

Tolerances, f32: loss, grad_norm and perplexity within rtol 1e-4 at every
step (the same arithmetic summed in another order, through 2 layers and
a 256-wide head); params after 3 steps within 1e-5 (the JAX package's
bar for its fused update) in all but 0.1% of elements, and every element
within 3 x lr. Adam moves each param by about lr times g / |g|, so an
element whose gradient is within f32 summation noise of zero may move by
any amount up to lr in either framework: a systematic fault moves many
elements, gradient noise a handful. bf16: loss and grad_norm within rtol 3e-2,
the slice-1 bf16 bar (the two frameworks round activations at different
places inside a layer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import transformer as J
from kubeflow_tpu.parallel.mesh import build_mesh
from kubeflow_tpu.runtime.recipe import make_optimizer as j_make_optimizer
from kubeflow_tpu.runtime.trainstep import TrainStepBuilder as JBuilder
from kubeflow_tpu_torch.models import transformer as T
from kubeflow_tpu_torch.models.convert import (flatten_params,
                                               transformer_params_from_jax)
from kubeflow_tpu_torch.parallel.mesh import MESH_AXES, Mesh
from kubeflow_tpu_torch.runtime import recipe as recipe_mod
from kubeflow_tpu_torch.runtime import trainstep as trainstep_mod
from kubeflow_tpu_torch.runtime.recipe import make_optimizer
from kubeflow_tpu_torch.runtime.trainstep import TrainStepBuilder

TINY = dict(vocab_size=256, num_layers=2, embed_dim=64, num_heads=4,
            head_dim=16, mlp_dim=128, max_seq_len=128)
SEQ, BATCH, STEPS = 32, 2, 3
OPT = dict(learning_rate=1e-3, schedule="constant", total_steps=STEPS)


def numpy_params(seed: int = 0) -> dict:
    """A flax-shaped params tree of numpy arrays from ``seed``."""
    model = J.TransformerLM(J.TransformerConfig(dtype=jnp.float32, **TINY))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SEQ), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        if name.endswith("scale"):
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
        if name.endswith("bias"):
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = leaf.shape[1] if name.endswith("embedding") else (
            leaf.shape[0] * leaf.shape[1] if name.endswith("attn/out/kernel")
            else leaf.shape[0])
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _tokens(seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], (BATCH, SEQ)).astype(np.int32)


def run_jax(params, tokens, attention, kernels, dtype=jnp.float32):
    spec = J.workload_spec(J.TransformerConfig(attention=attention,
                                               dtype=dtype, **TINY), SEQ)
    opt, _ = j_make_optimizer("adam", kernels=kernels, **OPT)
    builder = JBuilder(mesh=build_mesh(devices=jax.devices()[:1]),
                       loss_fn=spec.loss_fn, optimizer=opt)
    state = builder.init(lambda rng: (params, {}), jax.random.PRNGKey(0))
    step, batch = builder.build(), builder.place_batch({"tokens": tokens})
    history = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        history.append({k: float(v) for k, v in m.items()})
    return history, flatten_params(jax.device_get(state.params))


def run_port(params, tokens, attention, kernels, dtype=torch.float32):
    spec = T.workload_spec(T.TransformerConfig(attention=attention,
                                               dtype=dtype, **TINY), SEQ)
    builder = TrainStepBuilder(
        loss_fn=spec.loss_fn, device="cpu",
        optimizer=lambda p: make_optimizer(p, "adam", kernels=kernels,
                                           **OPT)[0])
    state = builder.init(
        lambda rng: (transformer_params_from_jax(params), {}), None)
    step, batch = builder.build(), builder.place_batch({"tokens": tokens})
    history = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        history.append({k: float(v) for k, v in m.items()})
    assert state.step == STEPS
    return history, {k: p.detach().numpy() for k, p in state.params.items()}


@pytest.mark.parametrize("attention,kernels", [
    ("einsum", "stock"), ("flash", "stock"), ("einsum", "fused_adam"),
    ("flash", "fused_adam")])
def test_f32_steps_match_jax(attention, kernels):
    params, tokens = numpy_params(), _tokens()
    j_hist, j_params = run_jax(params, tokens, attention, kernels)
    t_hist, t_params = run_port(params, tokens, attention, kernels)
    for i, (jm, tm) in enumerate(zip(j_hist, t_hist)):
        assert set(tm) == {"loss", "grad_norm", "perplexity"}
        for k in ("loss", "grad_norm", "perplexity"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4,
                                       err_msg=f"step {i + 1} {k}")
    assert t_hist[-1]["loss"] < t_hist[0]["loss"]
    assert set(t_params) == set(j_params)
    diff = np.concatenate([np.abs(t_params[n] - j_params[n]).ravel()
                           for n in j_params])
    assert diff.max() <= STEPS * OPT["learning_rate"], diff.max()
    assert (diff > 1e-5).mean() <= 1e-3, np.sort(diff)[-10:]


def test_bf16_steps_match_jax():
    params, tokens = numpy_params(seed=2), _tokens(seed=3)
    j_hist, _ = run_jax(params, tokens, "einsum", "stock",
                        dtype=jnp.bfloat16)
    t_hist, _ = run_port(params, tokens, "einsum", "stock",
                         dtype=torch.bfloat16)
    for i, (jm, tm) in enumerate(zip(j_hist, t_hist)):
        for k in ("loss", "grad_norm"):
            assert np.isfinite(tm[k])
            np.testing.assert_allclose(tm[k], jm[k], rtol=3e-2,
                                       err_msg=f"step {i + 1} {k}")


def test_builder_refuses_unported_layouts():
    """The sharded update is ported (tests/test_torch_dp.py): on one
    replica it is the replicated strategy. A mesh axis whose sharding is
    not ported raises, citing its ROADMAP item; an unknown layout is a
    ValueError."""
    kw = dict(loss_fn=None, optimizer=None, device="cpu")
    assert TrainStepBuilder(weight_update="sharded",
                            **kw).strategy == "replicated"
    for axis, item in (("fsdp", "item 6"), ("tensor", "item 6"),
                       ("sequence", "item 6"),
                       ("expert", "item 11"), ("pipeline", "item 11")):
        shape = {**dict.fromkeys(MESH_AXES, 1), axis: 2}
        with pytest.raises(NotImplementedError,
                           match=f"not yet ported.*{item}"):
            TrainStepBuilder(mesh=Mesh(shape=shape), **kw)
    with pytest.raises(ValueError, match="weight_update"):
        TrainStepBuilder(weight_update="zero3", **kw)


def test_eval_step_matches_jax():
    params, tokens = numpy_params(seed=4), _tokens(seed=5)
    cfg = dict(attention="einsum", **TINY)
    j_eval = J.make_eval_fn(J.TransformerLM(J.TransformerConfig(
        dtype=jnp.float32, **cfg)))
    jm = j_eval(jax.tree.map(jnp.asarray, params), {},
                {"tokens": jnp.asarray(tokens)})
    spec = T.workload_spec(T.TransformerConfig(dtype=torch.float32, **cfg))
    builder = TrainStepBuilder(loss_fn=spec.loss_fn, device="cpu",
                               optimizer=lambda p: None)
    state = builder.init(
        lambda rng: (transformer_params_from_jax(params), {}), None)
    tm = builder.build_eval(spec.eval_fn)(
        state, builder.place_batch({"tokens": tokens}))
    for k in ("eval_loss", "eval_perplexity", "eval_token_accuracy"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("kernels", ["stock", "fused_adam"])
def test_step_takes_the_global_norm_once(kernels, monkeypatch):
    """One training step with the clip on takes the pre-clip global norm
    once (the metric and the clip share it). In the fused tier nothing in
    the step reads a tensor's value back to the host (the stock tier's
    torch.optim.Adam reads its own step counter, which it keeps there)."""
    calls = []
    norm = recipe_mod.global_norm

    def counted(grads):
        calls.append(1)
        return norm(grads)

    for mod in (recipe_mod, trainstep_mod):
        monkeypatch.setattr(mod, "global_norm", counted)
    params, tokens = numpy_params(seed=6), _tokens(seed=7)
    spec = T.workload_spec(T.TransformerConfig(attention="einsum", **TINY),
                           SEQ)
    builder = TrainStepBuilder(
        loss_fn=spec.loss_fn, device="cpu",
        optimizer=lambda p: make_optimizer(p, "adam", kernels=kernels,
                                           **OPT)[0])
    state = builder.init(
        lambda rng: (transformer_params_from_jax(params), {}), None)
    step, batch = builder.build(), builder.place_batch({"tokens": tokens})

    def no_sync(*args, **kwargs):
        raise AssertionError("the step read a device value on the host")

    with monkeypatch.context() as m:
        if kernels == "fused_adam":
            for name in ("item", "cpu", "tolist", "numpy", "__float__",
                         "__bool__"):
                m.setattr(torch.Tensor, name, no_sync)
        state, metrics = step(state, batch)
    assert len(calls) == 1
    assert np.isfinite(float(metrics["grad_norm"]))
    assert state.step == 1


def test_init_copies_the_callers_arrays():
    """On the CPU the state must not alias the arrays init_fn hands over
    (``.to`` of an f32 array on its own device copies nothing): three
    steps leave the caller's numpy params and variables as they were."""
    params = {"w": np.ones((4, 2), np.float32), "b": np.zeros(2, np.float32)}
    variables = {"stats": {"m": np.zeros(2, np.float32)}}
    keep = {k: v.copy() for k, v in params.items()}

    def loss_fn(p, v, batch, rng):
        y = batch["x"] @ p["w"] + p["b"]
        m = v["stats"]["m"] * 0.9 + 0.1 * y.mean(0).detach()
        return (y ** 2).mean(), {"variables": {"stats": {"m": m}}}

    builder = TrainStepBuilder(
        loss_fn=loss_fn, device="cpu",
        optimizer=lambda p: make_optimizer(p, "momentum", 0.1)[0])
    state = builder.init(lambda rng: (params, variables), None)
    step = builder.build()
    batch = builder.place_batch({"x": np.ones((3, 4), np.float32)})
    for _ in range(3):
        state, _ = step(state, batch)
    assert not np.array_equal(state.params["w"].detach().numpy(), keep["w"])
    for k, v in keep.items():
        np.testing.assert_array_equal(params[k], v, err_msg=k)
    np.testing.assert_array_equal(variables["stats"]["m"], 0.0)
