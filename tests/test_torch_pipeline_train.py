"""The pipelined LM trained on pipeline meshes of gloo ranks against the
JAX package's ``TrainStepBuilder`` on the same mesh shape over the
conftest's virtual CPU devices.

Each case spawns the mesh's ranks (``tests/test_torch_dp.py`` ``spawn``);
every rank starts from the same converted numpy weights (the JAX
``PipelinedTransformerLM`` tree, ``models/convert.py``
``transformer_params_from_jax``), reads the same global batch, keeps its
stage's layers (and its tensor block) by ``TRANSFORMER_RULES`` and
trains 3 steps with SGD momentum and the clip at 0.5 acting on every
step, flash attention's plain versions on the CPU. This file holds
{pipeline 2}; tests/test_torch_pipeline_p4.py {pipeline 4},
tests/test_torch_pipeline_mixed.py {data 2, pipeline 2} and
tests/test_torch_pipeline_tp.py {pipeline 2, tensor 2} (one spawning
case a file, so the suite's workers share them), and
tests/test_torch_pipeline_ckpt.py the worker's checkpoints. Per case:

- loss and grad norm within 1e-5 relative at every step, on every rank;
- each param, assembled from the ranks' blocks, within 1e-5 of its
  largest magnitude after 3 steps; the embedding equal on every rank
  (its gradient is summed over the stages; only stage 0 consumes it);
- the launches a rank a step: K1, K2a and K2b ``M·L/S`` each (counted
  at their plain versions); on {pipeline 2} also a fused_adam run: one
  K3 a rank a step, its losses within 1e-5 relative of one process's;
- a rank's params: its ``L/S`` layers of every block leaf plus the
  embedding and the head.
"""

import numpy as np
import torch

from kubeflow_tpu_torch.api.trainingjob import ShardingSpec
from kubeflow_tpu_torch.parallel.mesh import build_mesh
from kubeflow_tpu_torch.runtime import recipe
from kubeflow_tpu_torch.runtime.trainstep import (TrainStepBuilder,
                                                  state_tree)
from tests.test_torch_dp import spawn
from tests.test_torch_model_parallel import assemble

CFG = dict(vocab_size=64, num_layers=4, embed_dim=32, num_heads=2,
           head_dim=16, mlp_dim=64, max_seq_len=16)
SEQ, BATCH, STEPS, MICRO = 16, 8, 3, 2
OPT = dict(name="momentum", learning_rate=0.05, momentum=0.9,
           schedule="constant", total_steps=STEPS, grad_clip=0.5)
ADAM = dict(name="adam", learning_rate=1e-3, schedule="constant",
            total_steps=STEPS, grad_clip=0.5, kernels="fused_adam")
RTOL = 1e-5
KERNELS = ("flash_attention_fwd_plain", "flash_attention_bwd_dq_plain",
           "flash_attention_bwd_dkv_plain")


def _world(mesh: dict) -> int:
    return int(np.prod(list(mesh.values())))


def numpy_params(seed: int = 5) -> dict:
    """The JAX pipelined LM's init tree, as numpy."""
    import jax
    import jax.numpy as jnp
    from kubeflow_tpu.models import transformer as J
    model = J.PipelinedTransformerLM(J.TransformerConfig(dtype=jnp.float32,
                                                         **CFG))
    return jax.device_get(model.init(jax.random.PRNGKey(seed),
                                     jnp.zeros((2, SEQ), jnp.int32)))


def _counting(monkeypatch_like: list):
    """Wrap the plain kernels (and K3's) to count their calls."""
    import importlib
    fa = importlib.import_module("kubeflow_tpu_torch.ops.flash_attention")
    fo = importlib.import_module("kubeflow_tpu_torch.ops.fused_adam")
    counts = dict.fromkeys(KERNELS + ("fused_adam_multi_plain",), 0)
    for mod, name in [(fa, k) for k in KERNELS] + [
            (fo, "fused_adam_multi_plain")]:
        real = getattr(mod, name)

        def wrapped(*a, _real=real, _name=name, **kw):
            counts[_name] += 1
            return _real(*a, **kw)
        setattr(mod, name, wrapped)
        monkeypatch_like.append((mod, name, real))
    return counts


def _train(mesh, params, tokens, opt, counts):
    from kubeflow_tpu_torch.models import transformer as T
    from kubeflow_tpu_torch.models.convert import transformer_params_from_jax
    spec = T.pipelined_workload_spec(T.TransformerConfig(
        attention="flash", dtype=torch.float32, **CFG), SEQ, mesh=mesh,
        num_microbatches=MICRO)
    b = TrainStepBuilder(
        loss_fn=spec.loss_fn, device="cpu", mesh=mesh, rules=spec.rules,
        param_logical_axes=spec.param_logical_axes,
        optimizer=lambda p: recipe.make_optimizer(p, **opt)[0])
    full = transformer_params_from_jax(params)
    state = b.init(lambda rng: (full, {}), None)
    step = b.build()
    placed = b.place_batch({"tokens": tokens})
    hist, launches = [], []
    for _ in range(STEPS):
        at = dict(counts)
        state, m = step(state, placed)
        launches.append({k: counts[k] - at[k] for k in counts})
        hist.append({k: float(v) for k, v in m.items() if v.numel() == 1})
    return state, hist, launches


def _port_rank(rank, world, mesh_dict, params, tokens, adam):
    mesh = build_mesh(ShardingSpec(**mesh_dict))
    restore: list = []
    counts = _counting(restore)
    adam_hist = adam_launches = []
    try:
        state, hist, launches = _train(mesh, params, tokens, OPT, counts)
        if adam:
            _, adam_hist, adam_launches = _train(mesh, params, tokens, ADAM,
                                                 counts)
    finally:
        for mod, name, real in restore:
            setattr(mod, name, real)
    blocks = {}
    for n, v in state_tree(state)["params"].items():
        if hasattr(v, "block"):
            blocks[n] = (v.block.detach().numpy().copy(), v.index, v.count)
        else:
            blocks[n] = (v.detach().numpy().copy(), None, None)
    return {"hist": hist, "launches": launches, "blocks": blocks,
            "adam": [h["loss"] for h in adam_hist],
            "adam_launches": adam_launches,
            "coords": mesh.coords,
            "param_bytes": sum(p.numel() * 4
                               for p in state.params.values())}


def _jax_run(mesh_dict, params, tokens):
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
    spec = J.pipelined_workload_spec(J.TransformerConfig(
        attention="flash", dtype=jnp.float32, **CFG), SEQ, mesh=mesh,
        num_microbatches=MICRO)
    opt = dict(OPT)
    b = JBuilder(mesh=mesh, loss_fn=spec.loss_fn,
                 optimizer=j_make(opt.pop("name"), **opt)[0],
                 rules=spec.rules,
                 param_logical_axes=spec.param_logical_axes)
    state = b.init(lambda rng: (params, {}), jax.random.PRNGKey(0))
    step = b.build()
    placed = b.place_batch({"tokens": tokens})
    hist = []
    for _ in range(STEPS):
        state, m = step(state, placed)
        hist.append({k: float(v) for k, v in m.items()})
    return hist, flatten_params(jax.device_get(state.params))


def _one_process_adam(params, tokens) -> list:
    from kubeflow_tpu_torch.models import transformer as T
    from kubeflow_tpu_torch.models.convert import transformer_params_from_jax
    spec = T.pipelined_workload_spec(T.TransformerConfig(
        attention="flash", dtype=torch.float32, **CFG), SEQ)
    b = TrainStepBuilder(
        loss_fn=spec.loss_fn, device="cpu",
        optimizer=lambda p: recipe.make_optimizer(p, **ADAM)[0])
    state = b.init(lambda rng: (transformer_params_from_jax(params), {}),
                   None)
    step = b.build()
    placed = b.place_batch({"tokens": tokens})
    out = []
    for _ in range(STEPS):
        state, m = step(state, placed)
        out.append(float(m["loss"]))
    return out


def check_pipeline_mesh(mesh: dict, adam: bool = False) -> None:
    """The mesh's ranks against the JAX step (the module's bars); with
    ``adam`` also the fused_adam run against one process."""
    from kubeflow_tpu_torch.models.convert import flatten_params
    params = numpy_params()
    tokens = np.random.default_rng(6).integers(
        0, CFG["vocab_size"], (BATCH, SEQ)).astype(np.int32)
    j_hist, j_params = _jax_run(mesh, params, tokens)
    assert all(m["grad_norm"] > OPT["grad_clip"] for m in j_hist)
    ranks = spawn(_port_rank, _world(mesh), mesh, params, tokens, adam)
    adam_one = _one_process_adam(params, tokens) if adam else []
    stages = mesh["pipeline"]
    dp = mesh.get("data", 1)
    per_step = MICRO * CFG["num_layers"] // stages
    for r, out in enumerate(ranks):
        for i, (jm, tm) in enumerate(zip(j_hist, out["hist"])):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(
                    tm[k], jm[k], rtol=RTOL, err_msg=f"rank {r} step {i} {k}")
        want = dict.fromkeys(KERNELS, per_step)
        for got in out["launches"]:
            assert {k: got[k] for k in KERNELS} == want, got
            assert got["fused_adam_multi_plain"] == 0
        assert len(out["adam_launches"]) == (STEPS if adam else 0)
        for got in out["adam_launches"]:
            assert got["fused_adam_multi_plain"] == 1, got
        np.testing.assert_allclose(out["adam"], adam_one, rtol=RTOL)
    got = assemble(ranks)
    assert set(got) == set(j_params)
    start = flatten_params(params)
    for n, want in j_params.items():
        err = float(np.abs(got[n] - want).max())
        assert err <= RTOL * float(np.abs(want).max()), (n, err)
        assert float(np.abs(want - start[n]).max()) > 0, n
    # the embedding is the same on every rank
    for n in ("embed.tok_embed.embedding", "embed.pos_embed.embedding"):
        for out in ranks[1:]:
            a, b = ranks[0]["blocks"][n], out["blocks"][n]
            if a[1] is None:
                assert np.array_equal(a[0], b[0]), n
    # each rank holds its stage: 1/S of the blocks (1/(S·t) under tensor)
    one = sum(v.size * 4 for v in j_params.values())
    blocks = sum(v.size * 4 for n, v in j_params.items()
                 if n.startswith("blocks."))
    model_degree = _world(mesh) // dp
    for out in ranks:
        assert out["param_bytes"] <= one - blocks + blocks / stages
        assert out["param_bytes"] < one
        assert {n for n, (_, idx, _) in out["blocks"].items()
                if idx is not None and n.startswith("blocks.")} == \
            {n for n in j_params if n.startswith("blocks.")}
        if model_degree == stages:
            assert out["param_bytes"] == one - blocks + blocks // stages


def test_pipeline_step_matches_jax():
    check_pipeline_mesh({"pipeline": 2}, adam=True)
