"""The port's mixture-of-experts MLP and the MoE / remat LM against the
JAX package's, on the same numpy weights and inputs.

The layer (embed 12, MLP 16, 4 experts, B 2, S 8) is held in f32 and in
bf16, at top-1 (the raw router probability: the router gets a gradient
from the task loss) and top-2 (renormalised gates), and at capacity
factor 0.01 (capacity 1: most tokens overflow, the one-hot hazard):
the output, the weighted aux loss and the gradients of ``router``,
``wi``, ``wo`` and ``x`` of ``Σ out·r + aux`` for a fixed random ``r``.
Identical experts give the dense MLP; ``top_k > E`` raises.

The LM is ``tests/test_moe.py``'s tiny MoE config (vocab 64, 2 layers,
embed 32, 2 heads x 16, MLP 64, 4 experts, S 16): logits, loss,
``moe_aux_loss`` and every gradient of the loss against JAX
``make_loss_fn``, with and without remat; remat on against off in the
port, which must be the same function.

Tolerances: f32 relative 1e-5 of each tensor's largest magnitude plus
1e-7 absolute (the same arithmetic summed in another order; a gradient
that only the 0.01-weighted aux loss reaches is ~5e-4 at most, where f32
sums of O(1) terms leave ~1e-7; routing is discrete, and the seeded
router logits sit far from ties). bf16 layer: 3e-2 of the largest
magnitude (8 bits of mantissa; the two frameworks round the products at
different places), the aux loss 1e-5 relative (the router is f32 on both
sides). bf16 LM: the router's input is a bf16 activation, so a token
whose top choices are close may route differently: all but 1/32 of the
positions within 3e-2 of the largest logit (one of 64 flips here, by
0.48), the loss within 1e-3 and the aux loss within 1e-4 relative.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import transformer as J
from kubeflow_tpu.models.moe import MoEMLP as JMoE
from kubeflow_tpu_torch.models import transformer as T
from kubeflow_tpu_torch.models.convert import (flatten_params,
                                               transformer_params_from_jax)
from kubeflow_tpu_torch.models.moe import MoEMLP

B, S, M, H, E = 2, 8, 12, 16, 4
F32_RTOL = 1e-5
F32_ATOL = 1e-7
BF16_RTOL = 3e-2
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def close(got, want, rtol, what="", atol=None):
    """max |got − want| within ``rtol`` of max |want| (plus the f32
    absolute floor where rtol is f32's)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    if atol is None:
        atol = F32_ATOL if rtol == F32_RTOL else 0.0
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale + atol, \
        f"{what}: max|Δ| {err} > {rtol} x {scale} + {atol}"


def layer_inputs(seed: int):
    rng = np.random.default_rng(seed)
    params = {"router": rng.standard_normal((M, E)).astype(np.float32),
              "wi": (rng.standard_normal((E, M, H)) /
                     np.sqrt(M)).astype(np.float32),
              "wo": (rng.standard_normal((E, H, M)) /
                     np.sqrt(H)).astype(np.float32)}
    x = rng.standard_normal((B, S, M)).astype(np.float32)
    r = rng.standard_normal((B, S, M)).astype(np.float32)
    return params, x, r


def jax_layer(params, x, r, top_k, cf, dtype):
    layer = JMoE(num_experts=E, mlp_dim=H, top_k=top_k, capacity_factor=cf,
                 dtype=dtype)

    def f(p, x):
        out, mods = layer.apply({"params": p}, x, mutable=["losses"])
        aux = mods["losses"]["moe_aux"]
        return jnp.sum(out.astype(jnp.float32) * r) + aux, (out, aux)

    (_, (out, aux)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    return (np.asarray(out.astype(jnp.float32)), float(aux),
            {**{k: np.asarray(v) for k, v in gp.items()},
             "x": np.asarray(gx)})


def torch_layer(params, x, r, top_k, cf, dtype):
    layer = MoEMLP(E, M, H, top_k=top_k, capacity_factor=cf, dtype=dtype)
    with torch.no_grad():
        for k, v in params.items():
            getattr(layer, k).copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = layer(xt)
    (torch.sum(out.float() * torch.from_numpy(r)) + aux).backward()
    grads = {k: getattr(layer, k).grad.numpy() for k in params}
    grads["x"] = xt.grad.numpy()
    return out.detach().float().numpy(), float(aux), grads


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("top_k,cf", [(1, 1.25), (2, 1.25), (2, 0.01)],
                         ids=["top1", "top2", "overflow"])
def test_layer_matches_jax(dtype, top_k, cf):
    params, x, r = layer_inputs(seed=3 + top_k)
    jdt, tdt = DT[dtype]
    j_out, j_aux, j_grads = jax_layer(params, x, r, top_k, cf, jdt)
    t_out, t_aux, t_grads = torch_layer(params, x, r, top_k, cf, tdt)
    tol = F32_RTOL if dtype == "f32" else BF16_RTOL
    close(t_out, j_out, tol, "out")
    np.testing.assert_allclose(t_aux, j_aux, rtol=1e-5)
    for k in ("router", "wi", "wo", "x"):
        close(t_grads[k], j_grads[k], tol, k)
    if cf == 0.01:
        # capacity 1: at most one token per expert and row survives
        kept = np.abs(t_out).max(-1) > 0
        assert kept.sum() <= B * E < B * S
    if top_k == 1:
        # Switch semantics: the task loss reaches the router
        assert np.abs(t_grads["router"]).max() > 0


def test_identical_experts_give_the_dense_mlp():
    """Every expert the same FFN, capacity for every token, top-2
    renormalised: the combine weights sum to 1 per token, so the layer is
    the dense MLP (f32)."""
    rng = np.random.default_rng(7)
    wi = (rng.standard_normal((M, H)) / np.sqrt(M)).astype(np.float32)
    wo = (rng.standard_normal((H, M)) / np.sqrt(H)).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((B, S, M)).astype(np.float32))
    layer = MoEMLP(E, M, H, top_k=2, capacity_factor=float(E),
                   dtype=torch.float32)
    with torch.no_grad():
        layer.router.copy_(torch.from_numpy(
            rng.standard_normal((M, E)).astype(np.float32)))
        layer.wi.copy_(torch.from_numpy(wi)[None].expand(E, M, H))
        layer.wo.copy_(torch.from_numpy(wo)[None].expand(E, H, M))
    mlp = T.MLP(T.TransformerConfig(embed_dim=M, mlp_dim=H,
                                    dtype=torch.float32))
    with torch.no_grad():
        mlp.wi.kernel.copy_(torch.from_numpy(wi))
        mlp.wo.kernel.copy_(torch.from_numpy(wo))
        out, _ = layer(x)
        close(out.numpy(), mlp(x).numpy(), F32_RTOL, "dense")


def test_top_k_beyond_the_experts_raises():
    with pytest.raises(ValueError, match="top_k"):
        MoEMLP(2, 8, 16, top_k=3)(torch.zeros(1, 4, 8))
    with pytest.raises(ValueError, match="top_k"):
        MoEMLP(2, 8, 16, top_k=0)(torch.zeros(1, 4, 8))


# -- the MoE LM -----------------------------------------------------------------

LM = dict(vocab_size=64, num_layers=2, embed_dim=32, num_heads=2,
          head_dim=16, mlp_dim=64, max_seq_len=32, num_experts=4)
LM_SEQ = 16


def lm_params(seed: int) -> dict:
    """A flax-shaped params tree of the tiny MoE LM from ``seed``."""
    model = J.TransformerLM(J.TransformerConfig(dtype=jnp.float32, **LM))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, LM_SEQ), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        shape = leaf.shape
        if name.endswith("scale"):
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(
                np.float32)
        if name.endswith("bias"):
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name.endswith("embedding"):
            std = 1.0 / np.sqrt(shape[1])
        elif name.endswith(("attn/out/kernel", "moe/wi", "moe/wo")):
            std = 1.0 / np.sqrt(shape[1] if "moe" in name
                                else shape[0] * shape[1])
        else:
            std = 1.0 / np.sqrt(shape[0])
        return (std * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def lm_tokens(seed: int, batch: int = 4) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, LM["vocab_size"], (batch, LM_SEQ)).astype(np.int32)


def jax_lm(params, tokens, remat=False, dtype=jnp.float32):
    model = J.TransformerLM(J.TransformerConfig(dtype=dtype, remat=remat,
                                                **LM))
    loss_fn = J.make_loss_fn(model)
    p = jax.tree.map(jnp.asarray, params)
    batch = {"tokens": jnp.asarray(tokens)}
    (loss, aux), grads = jax.value_and_grad(
        lambda q: loss_fn(q, {}, batch, None), has_aux=True)(p)
    logits = model.apply({"params": p}, jnp.asarray(tokens))
    return {"logits": np.asarray(logits), "loss": float(loss),
            "moe_aux_loss": float(aux["moe_aux_loss"]),
            "grads": flatten_params(jax.device_get(grads))}


def torch_lm(params, tokens, remat=False, dtype=torch.float32):
    cfg = T.TransformerConfig(dtype=dtype, remat=remat, **LM)
    spec = T.workload_spec(cfg, LM_SEQ)
    p = {k: v.requires_grad_(True)
         for k, v in transformer_params_from_jax(params).items()}
    batch = {"tokens": torch.from_numpy(tokens)}
    loss, aux = spec.loss_fn(p, {}, batch, None)
    loss.backward()
    model = T.TransformerLM(cfg)
    model.load_state_dict({k: v.detach() for k, v in p.items()})
    with torch.no_grad():
        logits = model(batch["tokens"])
    return {"logits": logits.numpy(), "loss": float(loss),
            "moe_aux_loss": float(aux["moe_aux_loss"]),
            "grads": {k: v.grad.numpy() for k, v in p.items()}}


@pytest.mark.parametrize("remat", [False, True], ids=["dense", "remat"])
def test_moe_lm_loss_and_grads_match_jax(remat):
    params, tokens = lm_params(seed=21), lm_tokens(seed=22)
    j = jax_lm(params, tokens, remat=remat)
    t = torch_lm(params, tokens, remat=remat)
    close(t["logits"], j["logits"], F32_RTOL, "logits")
    np.testing.assert_allclose(t["loss"], j["loss"], rtol=F32_RTOL)
    np.testing.assert_allclose(t["moe_aux_loss"], j["moe_aux_loss"],
                               rtol=F32_RTOL)
    assert t["moe_aux_loss"] > 0
    assert set(t["grads"]) == set(j["grads"])
    assert {n for n in j["grads"] if ".moe." in n} == {
        f"layer{i}.moe.{w}" for i in range(2)
        for w in ("router", "wi", "wo")}
    for name, g in j["grads"].items():
        close(t["grads"][name], g, F32_RTOL, name)


def test_moe_lm_bf16_matches_jax():
    """The default dtype: bf16 activations, f32 params, router and head."""
    params, tokens = lm_params(seed=23), lm_tokens(seed=24)
    j = jax_lm(params, tokens, dtype=jnp.bfloat16)
    t = torch_lm(params, tokens, dtype=torch.bfloat16)
    per_pos = np.abs(t["logits"] - j["logits"]).max(-1)
    scale = np.abs(j["logits"]).max()
    assert (per_pos > BF16_RTOL * scale).mean() <= 1 / 32, \
        np.sort(per_pos.ravel())[-5:]
    np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-3)
    np.testing.assert_allclose(t["moe_aux_loss"], j["moe_aux_loss"],
                               rtol=1e-4)


@pytest.mark.parametrize("experts", [0, 4], ids=["dense", "moe"])
def test_remat_is_the_same_function(experts):
    """Remat recomputes each block in the backward: loss and every
    gradient equal to the run without it, bit for bit."""
    params, tokens = None, lm_tokens(seed=25)
    cfg = T.TransformerConfig(dtype=torch.float32,
                              **{**LM, "num_experts": experts})
    params = T.init_fn(T.TransformerLM(cfg))(
        torch.Generator().manual_seed(26))[0]
    out = {}
    for remat in (False, True):
        spec = T.workload_spec(replace(cfg, remat=remat), LM_SEQ)
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        loss, aux = spec.loss_fn(p, {}, {"tokens": torch.from_numpy(
            tokens)}, None)
        loss.backward()
        out[remat] = (float(loss), {k: v.grad for k, v in p.items()})
        assert ("moe_aux_loss" in aux) == (experts > 0)
    assert out[False][0] == out[True][0]
    for k, g in out[False][1].items():
        assert torch.equal(g, out[True][1][k]), k
