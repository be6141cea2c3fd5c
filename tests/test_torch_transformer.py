"""The port's TransformerLM against the JAX package's, on the same weights.

Weights and tokens are made with numpy from a seed, in the shapes of the
flax params tree; ``transformer_params_from_jax`` turns the tree into the
port's state dict. Config: 2 layers, embed 64, 4 heads x 16, MLP 128,
S 32, vocab 256. The JAX flash path runs its Pallas kernel in interpret
mode on the CPU.

Tolerances: f32 logits within 1e-4 absolute (the same arithmetic summed
in another order, through 2 layers and a 256-wide head) with
``next_token`` equal; bf16 within 3e-2 of max |logit| (bf16 keeps 8 bits
of mantissa, and the two frameworks round at different places inside a
layer, e.g. gelu and the einsum softmax). The hazard cases show the f32
tolerance catches an exact gelu or torch's default LayerNorm eps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kubeflow_tpu.models import transformer as J
from kubeflow_tpu_torch.models import transformer as T
from kubeflow_tpu_torch.models.convert import (flatten_params,
                                               transformer_params_from_jax)

CFG = dict(vocab_size=256, num_layers=2, embed_dim=64, num_heads=4,
           head_dim=16, mlp_dim=128, max_seq_len=32)
F32_ATOL = 1e-4
BF16_RTOL = 3e-2


def numpy_params(seed: int = 0, embed_scale: float = 1.0) -> dict:
    """A flax-shaped params tree of numpy arrays from ``seed``: kernels
    ~ N(0, 1/fan_in), embeddings ~ N(0, 1/E) times ``embed_scale``,
    LayerNorm scale near 1 and bias near 0."""
    model = J.TransformerLM(J.TransformerConfig(dtype=jnp.float32, **CFG))
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0),
        jnp.zeros((1, CFG["max_seq_len"]), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        shape = leaf.shape
        if name.endswith("scale"):
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name.endswith("bias"):
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name.endswith("embedding"):
            std = embed_scale / np.sqrt(shape[1])
        elif name.endswith("attn/out/kernel"):
            std = 1.0 / np.sqrt(shape[0] * shape[1])
        else:
            std = 1.0 / np.sqrt(shape[0])
        return (std * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def tokens(batch: int = 3, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], (batch, CFG["max_seq_len"])).astype(np.int32)


def jax_logits(params, toks, attention, dtype=jnp.float32) -> np.ndarray:
    cfg = J.TransformerConfig(attention=attention, dtype=dtype, **CFG)
    return np.asarray(J.TransformerLM(cfg).apply(
        {"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(toks)))


def torch_model(params, attention, dtype=torch.float32) -> T.TransformerLM:
    model = T.TransformerLM(T.TransformerConfig(
        attention=attention, dtype=dtype, **CFG))
    model.load_state_dict(transformer_params_from_jax(params), strict=True)
    return model.eval()


def torch_logits(params, toks, attention, dtype=torch.float32):
    with torch.no_grad():
        out = torch_model(params, attention, dtype)(torch.from_numpy(toks))
    assert out.dtype == torch.float32        # the head runs in f32
    return out.numpy()


def test_converter_is_a_name_map():
    params = numpy_params()
    sd = transformer_params_from_jax({"params": params})
    flat = flatten_params(params)
    assert set(sd) == set(flat)
    assert tuple(sd["layer0.attn.qkv.kernel"].shape) == (64, 3, 4, 16)
    assert tuple(sd["layer0.attn.out.kernel"].shape) == (4, 16, 64)
    assert tuple(sd["layer1.mlp.wi.kernel"].shape) == (64, 128)
    assert tuple(sd["tok_embed.embedding"].shape) == (256, 64)
    assert tuple(sd["pos_embed.embedding"].shape) == (32, 64)
    for name, a in flat.items():
        np.testing.assert_array_equal(sd[name].numpy(), a)
    # the port's module has exactly these parameters, in these shapes
    model = T.TransformerLM(T.TransformerConfig(**CFG))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: a.shape for k, a in flat.items()}


@pytest.mark.parametrize("attention", ["einsum", "flash"])
def test_f32_logits_match_jax(attention):
    params, toks = numpy_params(), tokens()
    ref = jax_logits(params, toks, attention)
    got = torch_logits(params, toks, attention)
    assert got.shape == (3, 32, 256)
    np.testing.assert_allclose(got, ref, atol=F32_ATOL, rtol=0)
    np.testing.assert_array_equal(got[:, -1].argmax(-1),
                                  ref[:, -1].argmax(-1))


@pytest.mark.parametrize("attention", ["einsum", "flash"])
def test_bf16_logits_match_jax(attention):
    params, toks = numpy_params(seed=2), tokens(seed=3)
    ref = jax_logits(params, toks, attention, dtype=jnp.bfloat16)
    got = torch_logits(params, toks, attention, dtype=torch.bfloat16)
    assert ref.dtype == np.float32 and np.isfinite(got).all()
    err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert err <= BF16_RTOL, f"bf16 logits off by {err:.4f} of max|logit|"


def test_exact_gelu_would_fail(monkeypatch):
    """flax's nn.gelu is the tanh approximation; torch's default gelu is
    exact. The exact one moves the logits past the f32 tolerance."""
    params, toks = numpy_params(), tokens()
    ref = jax_logits(params, toks, "einsum")
    exact = F.gelu
    monkeypatch.setattr(T.F, "gelu",
                        lambda x, approximate="none": exact(x))
    got = torch_logits(params, toks, "einsum")
    assert np.max(np.abs(got - ref)) > F32_ATOL


def test_torch_layernorm_eps_would_fail(monkeypatch):
    """flax's LayerNorm eps is 1e-6, torch's default 1e-5. With small
    activations (embeddings at a tenth of their usual scale) the wrong
    eps moves the logits past the f32 tolerance; the right one does not."""
    params, toks = numpy_params(embed_scale=0.1), tokens()
    ref = jax_logits(params, toks, "einsum")
    np.testing.assert_allclose(torch_logits(params, toks, "einsum"), ref,
                               atol=F32_ATOL, rtol=0)
    monkeypatch.setattr(T.LayerNorm, "eps", 1e-5)
    got = torch_logits(params, toks, "einsum")
    assert np.max(np.abs(got - ref)) > F32_ATOL


def test_config_refuses_unported_paths():
    with pytest.raises(NotImplementedError, match="ring"):
        T.TransformerConfig(attention="ring")
    with pytest.raises(NotImplementedError, match="experts"):
        T.TransformerConfig(num_experts=4)
    with pytest.raises(ValueError, match="attention"):
        T.TransformerConfig(attention="sparse")


def test_default_widths_match_jax():
    """The served widths are the JAX package's defaults."""
    j, t = J.TransformerConfig(), T.TransformerConfig()
    for key in ("vocab_size", "num_layers", "embed_dim", "num_heads",
                "head_dim", "mlp_dim", "max_seq_len"):
        assert getattr(t, key) == getattr(j, key), key
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
