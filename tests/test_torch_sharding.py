"""The port's sharding rules and mesh layout against the JAX package's.

- ``LogicalRules.spec_for`` over two rule tables (the transformer's, and
  the JAX ResNet's table copied into a port ``LogicalRules``) and every logical-axis tuple the LM uses, on meshes of 8
  virtual devices: the same spec as the JAX package's ``PartitionSpec``
  (size-1 axes dropped, each mesh axis on one dimension at most).
- The port's ``logical_axes`` over the state dict against the JAX
  ``logical_axes`` of the flax tree, leaf by leaf, for the dense and the
  MoE LM.
- ``weight_update_spec`` against the JAX one over shapes × specs ×
  meshes, and on the empty spec of a replicated leaf.
- The rank coordinates (``Mesh.coords``) against the position of device
  ``rank`` in the JAX mesh's device array, and each rank's block
  (``cut_block``) against the shard JAX places on that device.

All exact: these are integer and name computations.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from kubeflow_tpu.api.trainingjob import ShardingSpec as JSpec
from kubeflow_tpu.models import transformer as J
from kubeflow_tpu.parallel import sharding_rules as JR
from kubeflow_tpu.parallel.mesh import build_mesh as j_build_mesh
from kubeflow_tpu_torch.models import transformer as T
from kubeflow_tpu_torch.models.convert import flatten_params
from kubeflow_tpu_torch.parallel import sharding_rules as R
from kubeflow_tpu_torch.parallel.mesh import (MESH_AXES, Mesh, batch_rows,
                                              rank_coords)

MESHES = [dict(data=8), dict(data=2, fsdp=2, tensor=2),
          dict(data=2, expert=2, tensor=2), dict(fsdp=4, tensor=2),
          dict(data=4, tensor=2), dict(tensor=8), dict(fsdp=2, expert=4),
          dict(data=2, expert=2, fsdp=2)]
LOGICAL = [("vocab_table", "embed"), (None, "embed"),
           ("embed", None, "heads", "head_dim"),
           ("heads", "head_dim", "embed"), ("embed", "mlp"),
           ("mlp", "embed"), ("embed", None), ("expert", "embed", "mlp"),
           ("expert", "mlp", "embed"), ("embed", "vocab"), ("embed",),
           ("batch", "sequence"), ("out_chan", "features", "classes"),
           ("embed", "embed"), ("layers", "heads")]


def shape_of(mesh: dict) -> dict:
    return {a: mesh.get(a, 1) for a in MESH_AXES}


def j_mesh(mesh: dict):
    return j_build_mesh(JSpec(**{**dict(data=1), **mesh}),
                        jax.devices()[:8])


def as_tuple(spec) -> tuple:
    out = tuple(spec)
    while out and out[-1] is None:
        out = out[:-1]
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "-".join(
    f"{k}{v}" for k, v in m.items()))
def test_spec_for_matches_jax(mesh):
    jm = j_mesh(mesh)
    for (jr, tr), axes in itertools.product(
            [(JR.TRANSFORMER_RULES, R.TRANSFORMER_RULES),
             (JR.RESNET_RULES, R.LogicalRules(JR.RESNET_RULES.rules))],
            LOGICAL):
        assert tr.spec_for(axes, shape_of(mesh)) == \
            as_tuple(jr.spec_for(axes, jm)), axes
        assert tr.spec_for(axes) == as_tuple(jr.spec_for(axes)), axes
    for n in (1, 2):
        jd = JR.TRANSFORMER_RULES.dcn_aware(n)
        td = R.TRANSFORMER_RULES.dcn_aware(n)
        assert td.rules == jd.rules and td.dcn_unsafe == jd.dcn_unsafe


@pytest.mark.parametrize("experts", [0, 4], ids=["dense", "moe"])
def test_logical_axes_match_jax(experts):
    cfg = dict(vocab_size=64, num_layers=2, embed_dim=32, num_heads=2,
               head_dim=16, mlp_dim=64, max_seq_len=32, num_experts=experts)
    model = J.TransformerLM(J.TransformerConfig(dtype=jnp.float32, **cfg))
    abstract = jax.eval_shape(lambda r: J.init_fn(model, 16)(r)[0],
                              jax.random.PRNGKey(0))
    want = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                want[f"{prefix}{k}"] = v

    walk(J.logical_axes(abstract))
    with torch.device("meta"):
        sd = T.TransformerLM(T.TransformerConfig(**cfg)).state_dict()
    got = T.logical_axes(dict(sd))
    assert got == want
    assert set(got) == set(flatten_params(jax.tree.map(
        lambda a: np.zeros(a.shape), abstract)))
    spec = T.workload_spec(T.TransformerConfig(**cfg), 16)
    assert spec.param_logical_axes == want
    assert spec.rules is R.TRANSFORMER_RULES


SHAPES = [(64, 32), (32, 2, 2, 16), (2, 16, 32), (4, 32, 64), (3, 8),
          (5,), (12, 6), (7, 3)]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "-".join(
    f"{k}{v}" for k, v in m.items()))
def test_weight_update_spec_matches_jax(mesh):
    jm = j_mesh(mesh)
    axes = tuple(a for a in ("data", "fsdp") if mesh.get(a, 1) > 1)
    for shape, logical in itertools.product(SHAPES, LOGICAL):
        if len(logical) > len(shape):
            continue
        logical = logical + (None,) * (len(shape) - len(logical))
        jspec = JR.TRANSFORMER_RULES.spec_for(logical, jm)
        want = JR.weight_update_spec(jspec, shape, jm, axes)
        got = R.weight_update_spec(
            R.TRANSFORMER_RULES.spec_for(logical, shape_of(mesh)), shape,
            shape_of(mesh), axes)
        assert got == (None if want is None else as_tuple(want)), \
            (shape, logical)
    for shape in SHAPES:
        want = JR.weight_update_spec(
            jax.sharding.PartitionSpec(), shape, j_mesh(dict(data=8)),
            ("data",))
        got = R.weight_update_spec((), shape, {"data": 8}, ("data",))
        assert (None if got is None else got.index("data")) == \
            (None if want is None else list(want).index("data"))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "-".join(
    f"{k}{v}" for k, v in m.items()))
def test_rank_coords_and_blocks_match_the_jax_mesh(mesh):
    """Rank r is device r; its coordinates are the device's position in
    the JAX mesh's device array, its block of each LM leaf is the shard
    JAX places on that device, and its batch rows are the ones
    ``P(("data", "fsdp"))`` puts there."""
    jm = j_mesh(mesh)
    shape = shape_of(mesh)
    devices = jax.devices()[:8]
    full = np.arange(64 * 32 * 4, dtype=np.float32).reshape(4, 64, 32)
    logical = ("expert", "embed", "mlp")
    jspec = JR.TRANSFORMER_RULES.spec_for(logical, jm)
    arr = jax.device_put(full, NamedSharding(jm, jspec))
    shards = {s.device.id: np.asarray(s.data)
              for s in arr.addressable_shards}
    rows = np.arange(16)
    placed = jax.device_put(rows, NamedSharding(
        jm, jax.sharding.PartitionSpec(("data", "fsdp"))))
    row_shards = {s.device.id: np.asarray(s.data)
                  for s in placed.addressable_shards}
    tspec = R.TRANSFORMER_RULES.spec_for(logical, shape)
    for r, dev in enumerate(devices):
        pos = np.argwhere(np.asarray(jm.devices) == dev)[0]
        coords = rank_coords(r, shape)
        assert tuple(coords[a] for a in MESH_AXES) == tuple(pos)
        block = R.cut_block(torch.from_numpy(full), tspec, shape, coords)
        np.testing.assert_array_equal(block.numpy(), shards[dev.id])
        m = Mesh(shape=shape, rank=r)
        np.testing.assert_array_equal(rows[batch_rows(16, m)],
                                      row_shards[dev.id])
