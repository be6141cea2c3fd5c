"""Model-parallel training: the LM on fsdp, tensor and expert meshes of
gloo ranks against the JAX package's ``TrainStepBuilder`` on the same
mesh shape over the conftest's virtual CPU devices.

Each case spawns the mesh's ranks (``tests/test_torch_dp.py`` ``spawn``:
a free port, a timeout on every join); every rank starts from the same
converted numpy weights, reads the same global batch, keeps its block of
each param by ``TRANSFORMER_RULES`` and trains 3 steps with SGD momentum
and the clip at 0.5 acting on every step (Adam would turn the reduction
order's 1e-9 noise on near-zero gradients into lr-sized steps; K3 over a
rank's blocks is the data-parallel path's, held in
tests/test_torch_dp.py and on the card). The JAX side builds its step
with ``spec.rules`` and ``spec.param_logical_axes`` on the same mesh.
This file holds the one-axis meshes; the mixed ones are in
tests/test_torch_model_parallel_mixed.py, the data-only mesh in
tests/test_torch_model_parallel_data.py, the worker's checkpoints in
tests/test_torch_model_parallel_ckpt.py. The meshes and models:

- ``{tensor 2}``, the dense LM with flash attention (K1/K2's plain
  versions on the local heads; the JAX Pallas kernels in interpret mode);
- ``{fsdp 2}``, the MoE LM, the sharded update (every leaf's update is
  its fsdp block already);
- ``{expert 2}``, the MoE LM;
- ``{data 2, tensor 2}``, the MoE LM with the sharded update (the
  port's ``zero2-gspmd``: one more dimension of each block over data);
- ``{data 2, expert 2}``, the MoE LM;
- ``{data 2, tensor 2}`` again with LARS (its per-tensor trust ratios
  over blocks that two data ranks hold each, weight decay 1e-4;
  tests/test_torch_model_parallel_lars.py).

Bars (f32): loss, grad norm and ``moe_aux_loss`` within 1e-5 relative at
every step; each param, assembled from the ranks' blocks, within 1e-5 of
its largest magnitude after 3 steps. Each rank holds only its blocks:
its param bytes are the one-process bytes over the model degree, plus
what its spec leaves replicated.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.api.trainingjob import ShardingSpec
from kubeflow_tpu_torch.parallel.mesh import build_mesh
from kubeflow_tpu_torch.runtime import recipe
from kubeflow_tpu_torch.runtime.trainstep import (TrainStepBuilder,
                                                  state_tree)
from tests.test_torch_dp import spawn

DENSE = dict(vocab_size=64, num_layers=2, embed_dim=32, num_heads=2,
             head_dim=16, mlp_dim=64, max_seq_len=32)
MOE = dict(DENSE, num_experts=4)
SEQ, BATCH, STEPS = 16, 4, 3
OPT = dict(name="momentum", learning_rate=0.05, momentum=0.9,
           schedule="constant", total_steps=STEPS, grad_clip=0.5)
# LARS's per-tensor norms over blocks, summed over the ranks
LARS = dict(OPT, name="lars", learning_rate=0.1, weight_decay=1e-4)
RTOL = 1e-5

CASES = [
    ("tensor2", dict(tensor=2), DENSE, "flash", "replicated", OPT),
    ("fsdp2", dict(fsdp=2), MOE, "einsum", "sharded", OPT),
    ("expert2", dict(expert=2), MOE, "einsum", "replicated", OPT),
]


def _world(mesh: dict) -> int:
    return int(np.prod(list(mesh.values())))


def numpy_params(cfg: dict, seed: int) -> dict:
    import jax
    import jax.numpy as jnp
    from kubeflow_tpu.models import transformer as J
    model = J.TransformerLM(J.TransformerConfig(dtype=jnp.float32, **cfg))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SEQ), jnp.int32))["params"]
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
        elif name.endswith("attn/out/kernel"):
            std = 1.0 / np.sqrt(shape[0] * shape[1])
        elif name.endswith(("moe/wi", "moe/wo")):
            std = 1.0 / np.sqrt(shape[1])
        else:
            std = 1.0 / np.sqrt(shape[0])
        return (std * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port_rank(rank, world, mesh_dict, cfg, attention, mode, opt, params,
               tokens):
    from kubeflow_tpu_torch.models import transformer as T
    from kubeflow_tpu_torch.models.convert import (shard_params,
                                                   transformer_params_from_jax)
    mesh = build_mesh(ShardingSpec(**mesh_dict))
    spec = T.workload_spec(T.TransformerConfig(
        attention=attention, dtype=torch.float32, **cfg), SEQ, mesh=mesh)
    b = TrainStepBuilder(
        loss_fn=spec.loss_fn, device="cpu", weight_update=mode, mesh=mesh,
        rules=spec.rules, param_logical_axes=spec.param_logical_axes,
        optimizer=lambda p: recipe.make_optimizer(p, **opt)[0])
    full = transformer_params_from_jax(params)
    state = b.init(lambda rng: (full, {}), None)
    # TrainStepBuilder's blocks are the converter's cut of the global state
    for n, blk in shard_params(full, mesh, spec.rules,
                               spec.param_logical_axes).items():
        assert torch.equal(state.params[n].detach(), blk), n
    step = b.build()
    placed = b.place_batch({"tokens": tokens})
    hist = []
    for _ in range(STEPS):
        state, m = step(state, placed)
        hist.append({k: float(v) for k, v in m.items() if v.numel() == 1})
    blocks = {}
    for n, v in state_tree(state)["params"].items():
        if hasattr(v, "block"):
            blocks[n] = (v.block.detach().numpy().copy(), v.index, v.count)
        else:
            blocks[n] = (v.detach().numpy().copy(), None, None)
    return {"hist": hist, "blocks": blocks, "strategy": b.strategy,
            "param_bytes": sum(p.numel() * 4
                               for p in state.params.values())}


def assemble(ranks: list) -> dict:
    """Global params from every rank's blocks."""
    out = {}
    for name, (arr, index, count) in ranks[0]["blocks"].items():
        if index is None:
            out[name] = arr
            continue
        full = np.zeros([s * c for s, c in zip(arr.shape, count)],
                        np.float32)
        for r in ranks:
            blk, idx, cnt = r["blocks"][name]
            sl = tuple(slice(i * s, (i + 1) * s)
                       for i, s in zip(idx, blk.shape))
            full[sl] = blk
        out[name] = full
    return out


def _jax_run(mesh_dict, cfg, attention, mode, opt, params, tokens):
    import jax
    import jax.numpy as jnp
    from kubeflow_tpu.api.trainingjob import ShardingSpec as JSpec
    from kubeflow_tpu.models import transformer as J
    from kubeflow_tpu.parallel.mesh import build_mesh as j_build_mesh
    from kubeflow_tpu.runtime.recipe import make_optimizer as j_make
    from kubeflow_tpu.runtime.trainstep import TrainStepBuilder as JBuilder
    from kubeflow_tpu_torch.models.convert import flatten_params
    mesh = j_build_mesh(JSpec(**{"data": 1, **mesh_dict}),
                        jax.devices()[:_world(mesh_dict)])
    spec = J.workload_spec(J.TransformerConfig(
        attention=attention, dtype=jnp.float32, **cfg), SEQ)
    opt = dict(opt)
    b = JBuilder(mesh=mesh, loss_fn=spec.loss_fn,
                 optimizer=j_make(opt.pop("name"), **opt)[0],
                 rules=spec.rules,
                 param_logical_axes=spec.param_logical_axes,
                 weight_update=mode)
    state = b.init(lambda rng: (params, {}), jax.random.PRNGKey(0))
    step = b.build()
    placed = b.place_batch({"tokens": tokens})
    hist = []
    for _ in range(STEPS):
        state, m = step(state, placed)
        hist.append({k: float(v) for k, v in m.items()})
    return hist, flatten_params(jax.device_get(state.params))


def check_against_jax(mesh, cfg, attention, mode, opt=OPT):
    """The case's ranks against the JAX step (the module's bars)."""
    params = numpy_params(cfg, seed=31)
    tokens = np.random.default_rng(32).integers(
        0, cfg["vocab_size"], (BATCH, SEQ)).astype(np.int32)
    j_hist, j_params = _jax_run(mesh, cfg, attention, mode, opt, params,
                                tokens)
    assert all(m["grad_norm"] > opt["grad_clip"] for m in j_hist)
    ranks = spawn(_port_rank, _world(mesh), mesh, cfg, attention, mode, opt,
                  params, tokens)
    keys = ["loss", "grad_norm"] + (["moe_aux_loss"]
                                    if "num_experts" in cfg else [])
    for r, out in enumerate(ranks):
        for i, (jm, tm) in enumerate(zip(j_hist, out["hist"])):
            for k in keys:
                np.testing.assert_allclose(
                    tm[k], jm[k], rtol=RTOL, err_msg=f"rank {r} step {i} {k}")
    got = assemble(ranks)
    assert set(got) == set(j_params)
    for n, want in j_params.items():
        err = float(np.abs(got[n] - want).max())
        assert err <= RTOL * float(np.abs(want).max()), (n, err)
        moved = float(np.abs(want - params_flat(params)[n]).max())
        assert moved > 0, n
    # each rank holds its blocks only
    one = sum(v.size * 4 for v in j_params.values())
    model_degree = _world(mesh) // mesh.get("data", 1)
    for out in ranks:
        replicated = sum(a.size * 4 for a, idx, _ in out["blocks"].values()
                         if idx is None)
        assert out["param_bytes"] <= one / model_degree + replicated
        assert out["param_bytes"] < one or model_degree == 1
    assert ranks[0]["strategy"] == ("zero2-gspmd" if mode == "sharded"
                                    else "replicated")


def params_flat(params) -> dict:
    from kubeflow_tpu_torch.models.convert import flatten_params
    return flatten_params(params)


@pytest.mark.parametrize("name,mesh,cfg,attention,mode,opt", CASES,
                         ids=[c[0] for c in CASES])
def test_model_parallel_step_matches_jax(name, mesh, cfg, attention, mode,
                                         opt):
    check_against_jax(mesh, cfg, attention, mode, opt)
