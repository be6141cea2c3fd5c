"""Pipeline parallelism: the port's GPipe schedule and stacked LM against
the JAX package's.

- ``pipeline_apply`` on stacked residual-linear blocks at {pipeline 2}
  and {pipeline 4} (spawned gloo ranks, ``tests/test_torch_dp.py``
  ``spawn``), M 1, 2 and 4: each rank's outputs, its input gradient and
  its stage's block gradients against JAX's ``pipeline_apply`` on the
  conftest's virtual devices (the ``tests/test_pipeline.py`` pattern),
  within 1e-5 relative; a rank's hops, sends and receives counted. The
  same ranks hold ``ppermute`` on a ring: each rank's value arrives at
  the next, the gradient at the previous.
- An uneven split and a batch the microbatches do not divide raise; no
  pipeline axis loops the layers.
- ``PipelinedTransformerLM`` against the JAX one on converted weights,
  against ``TransformerLM`` on stacked weights, and under remat (the
  same logits and gradients); ``pipelined_logical_axes`` equals the JAX
  tree's; MoE is refused on both paths in the JAX package's words.

Bars: f32, 1e-5 relative to the largest magnitude (the JAX package's
own MPMD parity bar).
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.api.trainingjob import ShardingSpec
from kubeflow_tpu_torch.models import transformer as T
from kubeflow_tpu_torch.models.convert import (transformer_params_from_jax,
                                               stack_blocks, unstack_blocks)
from kubeflow_tpu_torch.parallel import collectives
from kubeflow_tpu_torch.parallel import pipeline as P
from kubeflow_tpu_torch.parallel.mesh import MESH_AXES, Mesh, build_mesh
from kubeflow_tpu_torch.parallel.sharding_rules import cut_block
from tests.test_torch_dp import spawn

RTOL = 1e-5
LAYERS, DIM, BATCH = 4, 16, 8
MICRO = (1, 2, 4)
CFG = dict(vocab_size=64, num_layers=4, embed_dim=32, num_heads=2,
           head_dim=16, mlp_dim=64, max_seq_len=16)


def _inputs():
    rs = np.random.RandomState(0)
    w = (0.3 * rs.randn(LAYERS, DIM, DIM)).astype(np.float32)
    x = rs.randn(BATCH, DIM).astype(np.float32)
    return w, x


def port_block(p, h):
    return h + torch.tanh(h @ p["w"])


def _close(got, want, what):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= RTOL * float(np.abs(want).max()), (what, err)


def _stage(w: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's layers of a stacked leaf, as the rules place them."""
    return cut_block(w, ("pipeline",) + (None,) * (w.dim() - 1),
                     mesh.shape, mesh.coords)


def _linear_rank(rank, world, w, x):
    mesh = build_mesh(ShardingSpec(pipeline=world))
    out = {}
    for m in MICRO:
        collectives.reset_counts()
        local = {"w": _stage(torch.from_numpy(w), mesh)
                 .clone().requires_grad_()}
        xt = torch.from_numpy(x).requires_grad_()
        y = P.pipeline_apply(port_block, local, xt, mesh=mesh,
                             num_microbatches=m)
        (y ** 2).sum().backward()
        out[m] = {"y": y.detach().numpy(), "dx": xt.grad.numpy(),
                  "dw": local["w"].grad.numpy(),
                  "calls": dict(collectives.calls)}
    # the ring: rank r's value goes to r + 1, its gradient comes back
    group = mesh.group_of("pipeline")
    v = torch.full((3,), float(rank + 1), requires_grad=True)
    pairs = [(r, (r + 1) % world, 0) for r in range(world)]
    got, order = collectives.ppermute(v, torch.zeros((), requires_grad=True),
                                      group, pairs, v)
    (got * (rank + 10)).sum().backward()
    collectives.wait_sends()
    out["ring"] = (got.detach().numpy(), v.grad.numpy())
    return out


def _jax_linear(world, w, x, m):
    import jax
    import jax.numpy as jnp
    from kubeflow_tpu.api.trainingjob import ShardingSpec as JSpec
    from kubeflow_tpu.parallel.mesh import build_mesh as j_build_mesh
    from kubeflow_tpu.parallel.pipeline import pipeline_apply
    mesh = j_build_mesh(JSpec(data=1, pipeline=world), jax.devices()[:world])

    def block(p, h):
        return h + jnp.tanh(h @ p["w"])

    def loss(p, xx):
        y = pipeline_apply(block, p, xx, mesh=mesh, num_microbatches=m)
        return jnp.sum(y ** 2), y

    (_, y), (dw, dx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))({"w": w}, x)
    return np.asarray(y), np.asarray(dx), np.asarray(dw["w"])


@pytest.mark.parametrize("world", [2, 4])
def test_pipeline_apply_matches_jax(world):
    w, x = _inputs()
    ranks = spawn(_linear_rank, world, w, x)
    per = LAYERS // world
    for m in MICRO:
        y, dx, dw = _jax_linear(world, w, x, m)
        for r, out in enumerate(ranks):
            got = out[m]
            _close(got["y"], y, f"rank {r} M {m} out")
            _close(got["dx"], dx, f"rank {r} M {m} dx")
            _close(got["dw"], dw[r * per:(r + 1) * per], f"rank {r} M {m} dw")
            # a hop a microbatch each way on every link; the first and
            # last stages hold one link
            links = (r > 0) + (r < world - 1)
            assert got["calls"]["send"] == links * m, got["calls"]
            assert got["calls"]["recv"] == links * m, got["calls"]
            assert got["calls"]["broadcast"] == 1
            assert got["calls"]["all_reduce"] == 1     # the input's sum
    for r, out in enumerate(ranks):
        got, grad = out["ring"]
        assert np.all(got == (r - 1) % world + 1)
        assert np.all(grad == (r + 1) % world + 10)


def _one_rank_mesh(**axes):
    return Mesh(shape={**dict.fromkeys(MESH_AXES, 1), **axes})


def test_uneven_split_and_batch_raise():
    mesh = _one_rank_mesh(pipeline=2)
    w = torch.zeros(3, 4, 4)
    with pytest.raises(ValueError, match="does not split into 2 blocks"):
        _stage(w, mesh)
    with pytest.raises(ValueError, match="not divisible by microbatches"):
        P.pipeline_apply(port_block, {"w": w[:2]}, torch.ones(6, 4),
                         mesh=mesh, num_microbatches=4)
    with pytest.raises(ValueError, match="layers not divisible"):
        P.pipeline_apply(port_block, {"w": w[:2]}, torch.ones(4, 4),
                         mesh=mesh, num_microbatches=2, num_layers=3)


def test_no_pipeline_axis_loops_the_layers():
    import jax
    import jax.numpy as jnp
    w, x = _inputs()
    want = x
    for i in range(LAYERS):
        want = want + np.tanh(want @ w[i])

    def body(h, p):
        return h + jnp.tanh(h @ p["w"]), None
    jax_out, _ = jax.lax.scan(body, x, {"w": w})
    for mesh in (None, _one_rank_mesh(data=2)):
        got = P.pipeline_apply(port_block, {"w": torch.from_numpy(w)},
                               torch.from_numpy(x), mesh=mesh,
                               num_microbatches=2).numpy()
        _close(got, np.asarray(jax_out), "scan")
        _close(got, want, "numpy")


def _jax_lm():
    import jax
    import jax.numpy as jnp
    from kubeflow_tpu.models import transformer as J
    cfg = J.TransformerConfig(dtype=jnp.float32, **CFG)
    model = J.PipelinedTransformerLM(cfg)
    tokens = np.random.default_rng(3).integers(
        0, CFG["vocab_size"], (4, 16)).astype(np.int32)
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(tokens))
    return model, jax.device_get(params), tokens


def test_pipelined_lm_matches_jax_and_the_per_layer_lm():
    jmodel, jparams, tokens = _jax_lm()
    want = np.asarray(jmodel.apply(jparams, tokens))
    cfg = T.TransformerConfig(dtype=torch.float32, **CFG)
    state = transformer_params_from_jax(jparams)
    model = T.PipelinedTransformerLM(cfg)
    model.load_state_dict(state)
    tok = torch.from_numpy(tokens)
    got = model(tok)
    _close(got.detach().numpy(), want, "logits vs JAX")
    assert set(state) == set(model.state_dict())
    # the per-layer LM on the unstacked weights: the same function
    lm = T.TransformerLM(cfg)
    lm.load_state_dict(unstack_blocks(state))
    assert torch.equal(lm(tok), got)
    back = stack_blocks(dict(lm.state_dict()), cfg.num_layers)
    assert all(torch.equal(back[n], state[n]) for n in state)
    # remat: the same logits and gradients
    rm = T.PipelinedTransformerLM(T.replace(cfg, remat=True))
    rm.load_state_dict(state)
    loss_a, _ = T.next_token_loss(got, tok)
    loss_b, _ = T.next_token_loss(rm(tok), tok)
    loss_a.backward()
    loss_b.backward()
    assert torch.equal(loss_a, loss_b)
    for (n, a), (_, b) in zip(model.named_parameters(),
                              rm.named_parameters()):
        assert torch.allclose(a.grad, b.grad, rtol=0, atol=1e-7), n


def test_pipelined_logical_axes_match_jax():
    import jax
    import jax.numpy as jnp
    from kubeflow_tpu.models import transformer as J
    model = J.PipelinedTransformerLM(J.TransformerConfig.tiny())
    abstract = jax.eval_shape(lambda r: model.init(
        r, jnp.zeros((2, 16), jnp.int32)), jax.random.PRNGKey(0))
    jaxes = J.pipelined_logical_axes(abstract)
    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if hasattr(v, "items"):
                walk(v, f"{prefix}{k}.")
            else:
                flat[f"{prefix}{k}"] = tuple(v)
    walk(jaxes)
    with torch.device("meta"):
        sd = dict(T.PipelinedTransformerLM(T.TransformerConfig.tiny())
                  .state_dict())
    assert T.pipelined_logical_axes(sd) == flat
    spec = T.pipelined_workload_spec(T.TransformerConfig.tiny())
    assert spec.param_logical_axes == flat
    assert spec.rules.spec_for(flat["blocks.attn.qkv.kernel"],
                               {"pipeline": 2})[0] == "pipeline"


def test_moe_is_refused_on_both_paths():
    from kubeflow_tpu.models import transformer as J
    moe = T.replace(T.TransformerConfig.tiny(), num_experts=4)
    jmoe = J.TransformerConfig(**{**CFG, "num_experts": 4})
    for port_fn, jax_fn in ((T.pipelined_workload_spec,
                             J.pipelined_workload_spec),
                            (T.multislice_stage_fns,
                             J.multislice_stage_fns)):
        with pytest.raises(NotImplementedError) as jerr:
            jax_fn(jmoe)
        with pytest.raises(NotImplementedError) as perr:
            port_fn(moe)
        assert str(perr.value) == str(jerr.value)
