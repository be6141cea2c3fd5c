"""The LM over a ``sequence`` axis: gloo ranks against one process and
against the JAX package's ``TrainStepBuilder`` on the same
``ShardingSpec`` over the conftest's 8 virtual CPU devices.

Two spawns (the tiny dense LM of tests/test_torch_model_parallel.py at
S 16, f32, SGD momentum with the clip at 0.5 acting every step, 3
steps):

- ``{sequence 2}`` from the contract env (``KFTPU_SHARDING``, the
  worker's bootstrap): the LM's loss with einsum, flash (its plain
  version) and ring within 1e-4 of one another and of the JAX loss, as
  ``tests/test_ops.py:135-155``; a rank's logits, loss and reduced
  gradient against one process (the hazards: positions from the chunk's
  offset, the boundary target on the next rank, the gradient summed over
  the axis); 3 ring steps against the JAX ring; then ``worker.train``
  with ``--kernel-attention ring``, checkpointing every 2 steps, whose
  step 2 one process restores and trains on to step 4.
- ``{data 2, sequence 2}`` (einsum) and ``{sequence 2, tensor 2}``
  (flash on the local heads) on 4 ranks, 3 steps each.

Bars: loss and grad norm within 1e-5 relative at every step, each param
within 1e-5 of its largest magnitude after 3 steps (f32; the same
function summed in another order), tighter than phase 8's 1e-3 / 1e-2.
The refusals (the MPMD path, MoE on the stacked LM) name their reason;
MoE, the stacked LM and ResNet on a sequence mesh are
tests/test_torch_sequence_moe.py's, _stacked.py's and _resnet.py's.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.api.trainingjob import ShardingSpec
from kubeflow_tpu_torch.parallel.mesh import MESH_AXES, Mesh, build_mesh
from kubeflow_tpu_torch.runtime import bootstrap, recipe, worker
from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager
from kubeflow_tpu_torch.runtime.trainstep import TrainStepBuilder, state_tree
from tests.test_torch_bootstrap import spawn_contract
from tests.test_torch_dp import spawn
from tests.test_torch_model_parallel import (BATCH, DENSE, OPT, RTOL, SEQ,
                                             STEPS, assemble, numpy_params)

SEQ2 = {"sequence": 2}
MIXED = (("data2seq2", {"data": 2, "sequence": 2}, "einsum"),
         ("seq2tensor2", {"sequence": 2, "tensor": 2}, "flash"))
LOSS_TOL = 1e-4
ONE_LAYER = dict(DENSE, num_layers=1)
KW = dict(workload="transformer", optimizer="momentum", learning_rate=0.05,
          global_batch=BATCH, device="cpu", handle_sigterm=False,
          checkpoint_every=2, sync_every=1, kernel_attention="ring")


def _cfg(cfg: dict, attention: str):
    from kubeflow_tpu_torch.models import transformer as T
    return T.TransformerConfig(attention=attention, dtype=torch.float32,
                               **cfg)


def _inputs(cfg: dict = DENSE) -> tuple:
    params = numpy_params(cfg, seed=31)
    tokens = np.random.default_rng(32).integers(
        0, cfg["vocab_size"], (BATCH, SEQ)).astype(np.int32)
    return params, tokens


def _steps(mesh, cfg, attention, params, tokens) -> dict:
    """3 steps of the port's TrainStepBuilder on ``mesh``: the history
    and this rank's blocks."""
    from kubeflow_tpu_torch.models import transformer as T
    from kubeflow_tpu_torch.models.convert import transformer_params_from_jax
    spec = T.workload_spec(_cfg(cfg, attention), SEQ, mesh=mesh)
    b = TrainStepBuilder(
        loss_fn=spec.loss_fn, device="cpu", mesh=mesh, rules=spec.rules,
        param_logical_axes=spec.param_logical_axes,
        optimizer=lambda p: recipe.make_optimizer(p, **OPT)[0])
    state = b.init(lambda rng: (transformer_params_from_jax(params), {}),
                   None)
    step = b.build()
    placed = b.place_batch({"tokens": tokens})
    hist = []
    for _ in range(STEPS):
        state, m = step(state, placed)
        hist.append({k: float(v) for k, v in m.items()})
    blocks = {}
    for n, v in state_tree(state)["params"].items():
        if hasattr(v, "block"):
            blocks[n] = (v.block.detach().numpy().copy(), v.index, v.count)
        else:
            blocks[n] = (v.detach().numpy().copy(), None, None)
    return {"hist": hist, "blocks": blocks}


def _seq_rank(rank, env, params1, params, tokens, directory):
    """Every {sequence 2} check of one rank, in one process group."""
    from kubeflow_tpu_torch.models import transformer as T
    from kubeflow_tpu_torch.models.convert import transformer_params_from_jax
    from torch.func import functional_call
    ctx = bootstrap.initialize(env, device="cpu")
    mesh = ctx.mesh
    out = {"coords": mesh.coords["sequence"], "losses": {}}
    full1 = transformer_params_from_jax(params1)
    for attention in ("einsum", "flash", "ring"):
        spec = T.workload_spec(_cfg(ONE_LAYER, attention), SEQ, mesh=mesh)
        b = TrainStepBuilder(loss_fn=spec.loss_fn, device="cpu", mesh=mesh,
                             optimizer=lambda p: None)
        batch = b.place_batch({"tokens": tokens})
        with torch.no_grad():
            loss, _ = spec.loss_fn(full1, {}, batch, None)
        out["losses"][attention] = float(loss)
    # the hazards, on the 2-layer LM with ring
    full = transformer_params_from_jax(params)
    with torch.device("meta"):
        model = T.TransformerLM(_cfg(DENSE, "ring"), mesh)
    b = TrainStepBuilder(
        loss_fn=T.make_loss_fn(model), device="cpu", mesh=mesh,
        optimizer=lambda p: recipe.make_optimizer(p, **OPT)[0])
    batch = b.place_batch({"tokens": tokens})
    out["next"] = batch["next_tokens"].numpy()
    with torch.no_grad():
        out["logits"] = functional_call(model, full,
                                        (batch["tokens"],)).numpy()
    state = b.init(lambda rng: (full, {}), None)
    _, m = b.build()(state, batch)
    out["loss"], out["grad_norm"] = float(m["loss"]), float(m["grad_norm"])
    out["steps"] = _steps(mesh, DENSE, "ring", params, tokens)
    # the worker from the same contract, checkpointing every 2 steps
    r = worker.train(steps=4, checkpoint_dir=directory, ctx=ctx,
                     workload_kwargs={"cfg": _cfg(DENSE, "einsum")}, **KW)
    out["worker"] = (r.steps, r.final_metrics["loss"])
    bootstrap.shutdown(ctx)
    return out


def _mixed_rank(rank, world, params, tokens):
    return {name: _steps(build_mesh(ShardingSpec(**mesh)), DENSE, attention,
                         params, tokens)
            for name, mesh, attention in MIXED}


def _jax_run(mesh_dict, attention, params, tokens):
    import jax
    import jax.numpy as jnp
    from kubeflow_tpu.api.trainingjob import ShardingSpec as JSpec
    from kubeflow_tpu.models import transformer as J
    from kubeflow_tpu.parallel.mesh import build_mesh as j_build_mesh
    from kubeflow_tpu.runtime.recipe import make_optimizer as j_make
    from kubeflow_tpu.runtime.trainstep import TrainStepBuilder as JBuilder
    from kubeflow_tpu_torch.models.convert import flatten_params
    n = int(np.prod(list(mesh_dict.values())))
    mesh = j_build_mesh(JSpec(**{"data": 1, **mesh_dict}),
                        jax.devices()[:n])
    spec = J.workload_spec(J.TransformerConfig(
        attention=attention, dtype=jnp.float32,
        mesh=mesh if attention == "ring" else None, **DENSE), SEQ)
    opt = dict(OPT)
    b = JBuilder(mesh=mesh, loss_fn=spec.loss_fn,
                 optimizer=j_make(opt.pop("name"), **opt)[0],
                 rules=spec.rules,
                 param_logical_axes=spec.param_logical_axes)
    state = b.init(lambda rng: (params, {}), jax.random.PRNGKey(0))
    step = b.build()
    placed = b.place_batch({"tokens": tokens})
    hist = []
    with mesh:
        for _ in range(STEPS):
            state, m = step(state, placed)
            hist.append({k: float(v) for k, v in m.items()})
    return hist, flatten_params(jax.device_get(state.params))


def _check_steps(ranks: list, jax_run: tuple) -> None:
    j_hist, j_params = jax_run
    assert all(m["grad_norm"] > OPT["grad_clip"] for m in j_hist)
    for r, out in enumerate(ranks):
        for i, (jm, tm) in enumerate(zip(j_hist, out["hist"])):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(
                    tm[k], jm[k], rtol=RTOL, err_msg=f"rank {r} step {i} {k}")
    got = assemble(ranks)
    assert set(got) == set(j_params)
    for n, want in j_params.items():
        err = float(np.abs(got[n] - want).max())
        assert err <= RTOL * float(np.abs(want).max()), (n, err)


@pytest.fixture(scope="module")
def seq_runs(tmp_path_factory):
    params1, _ = _inputs(ONE_LAYER)
    params, tokens = _inputs()
    directory = str(tmp_path_factory.mktemp("seq2") / "ckpt")
    ranks = spawn_contract(_seq_rank, 2, params1, params, tokens, directory,
                           sharding=SEQ2)
    return ranks, params1, params, tokens, directory


def _one_process(params, tokens):
    """The port's one-process LM on the whole batch: logits, and the
    loss and reduced gradient norm of one step."""
    from kubeflow_tpu_torch.models import transformer as T
    from kubeflow_tpu_torch.models.convert import transformer_params_from_jax
    from torch.func import functional_call
    full = transformer_params_from_jax(params)
    with torch.device("meta"):
        model = T.TransformerLM(_cfg(DENSE, "ring"))
    with torch.no_grad():
        logits = functional_call(model, full,
                                 (torch.tensor(tokens),)).numpy()
    b = TrainStepBuilder(
        loss_fn=T.make_loss_fn(model), device="cpu",
        optimizer=lambda p: recipe.make_optimizer(p, **OPT)[0])
    state = b.init(lambda rng: (full, {}), None)
    _, m = b.build()(state, b.place_batch({"tokens": tokens}))
    return logits, float(m["loss"]), float(m["grad_norm"])


def test_lm_loss_agrees_across_attention_impls(seq_runs):
    """einsum, flash and ring on {sequence 2}: every rank's loss within
    1e-4 of the JAX einsum loss on the whole sequence, and of the
    others'."""
    import jax
    import jax.numpy as jnp
    from kubeflow_tpu.models import transformer as J
    ranks, params1, _, tokens, _ = seq_runs
    model = J.TransformerLM(J.TransformerConfig(dtype=jnp.float32,
                                                **ONE_LAYER))
    want, _ = J.make_loss_fn(model)(params1, {},
                                    {"tokens": tokens},
                                    jax.random.PRNGKey(0))
    for out in ranks:
        for attention, loss in out["losses"].items():
            assert abs(loss - float(want)) < LOSS_TOL, (attention, loss)
    assert ranks[0]["losses"] == ranks[1]["losses"]


def test_positions_start_at_the_chunk_offset(seq_runs):
    """A rank's logits are the one-process logits of its chunk's
    positions: its position embeddings (and mask rows) start at
    ``coords["sequence"]·S/n``."""
    ranks, _, params, tokens, _ = seq_runs
    logits, _, _ = _one_process(params, tokens)
    c = SEQ // 2
    for r, out in enumerate(ranks):
        assert out["coords"] == r
        np.testing.assert_allclose(out["logits"],
                                   logits[:, r * c:(r + 1) * c],
                                   rtol=1e-5, atol=1e-5)


def test_boundary_target_lies_on_the_next_rank(seq_runs):
    """The target of a chunk's last position is the next chunk's first
    token (``next_tokens``, placed beside the chunk); only the global last
    position is masked, so every rank's loss is the one-process loss."""
    ranks, _, params, tokens, _ = seq_runs
    c = SEQ // 2
    np.testing.assert_array_equal(ranks[0]["next"], tokens[:, c:c + 1])
    np.testing.assert_array_equal(ranks[1]["next"], tokens[:, :1])
    _, loss, _ = _one_process(params, tokens)
    for out in ranks:
        np.testing.assert_allclose(out["loss"], loss, rtol=1e-6)


def test_gradients_are_summed_over_the_sequence_axis(seq_runs):
    """Params are replicated over sequence: each rank's gradient is its
    chunk's term, and the train step sums them over the axis (the divisor
    stays the replica degree, 1), so the reduced norm is the one-process
    norm on both ranks."""
    ranks, _, params, tokens, _ = seq_runs
    _, _, norm = _one_process(params, tokens)
    for out in ranks:
        np.testing.assert_allclose(out["grad_norm"], norm, rtol=1e-5)


def test_three_steps_on_sequence2_match_jax(seq_runs):
    ranks, _, params, tokens, _ = seq_runs
    _check_steps([r["steps"] for r in ranks],
                 _jax_run(SEQ2, "ring", params, tokens))


@pytest.fixture(scope="module")
def mixed_runs():
    params, tokens = _inputs()
    ranks = spawn(_mixed_rank, 4, params, tokens)
    return ranks, params, tokens


@pytest.mark.parametrize("name,mesh,attention", MIXED,
                         ids=[c[0] for c in MIXED])
def test_three_steps_on_mixed_meshes_match_jax(mixed_runs, name, mesh,
                                               attention):
    ranks, params, tokens = mixed_runs
    _check_steps([r[name] for r in ranks],
                 _jax_run(mesh, attention, params, tokens))


def test_sequence_checkpoint_restores_in_one_process(seq_runs, tmp_path):
    """The worker on {sequence 2} (ring over the mesh) saves steps 2 and 4
    (and the first step, as every save into an empty directory) with
    ``replicaDegree`` 1; one process with no mesh (ring of size 1,
    the flash path) restores step 2 and trains on to step 4: its loss
    within 1e-5 relative of the ranks', its params within 1e-5 of their
    largest magnitude."""
    ranks, _, _, _, directory = seq_runs
    assert ranks[0]["worker"] == ranks[1]["worker"]
    assert ranks[0]["worker"][0] == 4
    mgr = CheckpointManager(directory)
    assert {2, 4} <= set(mgr.all_steps())
    assert mgr.run_meta_of(2)["replicaDegree"] == 1
    one = str(tmp_path / "one")
    shutil.copytree(os.path.join(directory, "2"), os.path.join(one, "2"))
    r = worker.train(steps=4, checkpoint_dir=one,
                     workload_kwargs={"cfg": _cfg(DENSE, "einsum")}, **KW)
    assert r.steps == 2
    np.testing.assert_allclose(r.final_metrics["loss"],
                               ranks[0]["worker"][1], rtol=RTOL)
    a = mgr.read_tree(4)["params"]
    b = CheckpointManager(one).read_tree(4)["params"]
    for k, want in a.items():
        err = float((b[k] - want).abs().max())
        assert err <= RTOL * float(want.abs().max()), (k, err)


SEQ_MESH = Mesh(shape={**dict.fromkeys(MESH_AXES, 1), "sequence": 2})


def test_refusals_on_a_sequence_mesh():
    """What still raises on a sequence mesh, as in the JAX package: the
    MPMD path (its stage meshes are pure data meshes, so a sequence axis
    there is data parallelism inside a slice, ROADMAP Queue 1 item 11)
    and MoE on the stacked LM, refused on any mesh in the JAX package's
    words; none runs unsharded. MoE, the stacked LM under GPipe and
    ResNet build (tests/test_torch_sequence_moe.py, _stacked.py and
    _resnet.py train them)."""
    from kubeflow_tpu_torch.models import resnet as R
    from kubeflow_tpu_torch.models import transformer as T
    moe = T.TransformerConfig(**ONE_LAYER, num_experts=2)
    cases = [
        ("item 11", lambda: worker.train(
            workload="transformer-pipelined", multislice_pipeline=True,
            steps=1, global_batch=4, device="cpu", handle_sigterm=False,
            ctx=bootstrap.WorkerContext(
                device=torch.device("cpu"),
                sharding=ShardingSpec(sequence=2), mesh=SEQ_MESH))),
        ("pipelined path", lambda: T.pipelined_workload_spec(
            moe, SEQ, mesh=SEQ_MESH)),
    ]
    for item, fn in cases:
        with pytest.raises(NotImplementedError, match=item):
            fn()
    with pytest.raises(NotImplementedError, match="pipelined path"):
        with torch.device("meta"):
            T.PipelinedTransformerLM(moe, SEQ_MESH)
    for spec in (T.workload_spec(moe, SEQ, mesh=SEQ_MESH),
                 T.pipelined_workload_spec(_cfg(DENSE, "einsum"), SEQ,
                                           mesh=SEQ_MESH),
                 R.workload_spec(32, 10, mesh=SEQ_MESH),
                 R.workload_spec(32, 10, fused=True, mesh=SEQ_MESH)):
        assert callable(spec.loss_fn)


def test_ring_config_builds_and_degenerates_to_flash():
    """``attention="ring"`` builds; with no sequence mesh the LM's ring
    is the flash path, the same logits."""
    from kubeflow_tpu_torch.models import transformer as T
    params, tokens = _inputs(ONE_LAYER)
    from kubeflow_tpu_torch.models.convert import transformer_params_from_jax
    from torch.func import functional_call
    full = transformer_params_from_jax(params)
    outs = {}
    for attention in ("ring", "flash"):
        with torch.device("meta"):
            model = T.TransformerLM(_cfg(ONE_LAYER, attention))
        with torch.no_grad():
            outs[attention] = functional_call(model, full,
                                              (torch.tensor(tokens),))
    assert torch.equal(outs["ring"], outs["flash"])
