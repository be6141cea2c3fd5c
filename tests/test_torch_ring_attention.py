"""Ring attention (ops/ring_attention.py) on gloo ranks against the JAX
package's ``ring_attention`` on a ``ShardingSpec(data=2, sequence=4)``
mesh of the conftest's 8 virtual CPU devices.

One spawn of 4 CPU ranks (``tests/test_torch_dp.py`` ``spawn``) on a
``{sequence 4}`` mesh (the data axis only splits the batch's rows, which
the op does not see, so each rank takes both rows): rank r holds its
chunk of 64 of the 256 positions, runs the ring causal and not,
and one gradient case (the loss ``Σ out·G`` over a seeded cotangent G).
The chunks, put back together, meet the JAX ring and the port's
``reference_attention`` on the whole sequence within 2e-5, as
``tests/test_ops.py:92-110`` holds the JAX ring; the gradients within
1e-4 absolute / 1e-3 relative. The ring's hops are counted: n - 1 sends
and receives a call forward and as many backward, of the stacked K/V
chunk's bytes. Beside them the degenerate axis (a ring of one is the
flash kernel) and the merge's own-chunk-first hazard and the global mask
rows, which the JAX tests never see under GSPMD.
"""

import importlib

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.ops.flash_attention import reference_attention
from tests.test_torch_dp import spawn

# the module (the package exports the function under the same name)
RA = importlib.import_module("kubeflow_tpu_torch.ops.ring_attention")
B, S, H, D = 2, 256, 2, 16
MESH = {"data": 2, "sequence": 4}       # the JAX mesh
PORT_MESH = {"sequence": 4}
ATOL = RTOL = 2e-5


def _qkv(seed: int = 0, b: int = B, s: int = S) -> tuple:
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, H, D)).astype(np.float32)
                 for _ in range(4))


def _ring_rank(rank, world, mesh_dict, q, k, v, g):
    from kubeflow_tpu_torch.api.trainingjob import ShardingSpec
    from kubeflow_tpu_torch.parallel import collectives
    from kubeflow_tpu_torch.parallel.mesh import batch_rows, build_mesh
    mesh = build_mesh(ShardingSpec(**mesh_dict))
    rows = batch_rows(q.shape[0], mesh)
    c = q.shape[1] // mesh.shape["sequence"]
    at = mesh.chunk_offset(c)

    def mine(a):
        return torch.tensor(a[rows, at:at + c])

    out = {}
    for causal in (True, False):
        with torch.no_grad():
            out[causal] = RA.ring_attention(mine(q), mine(k), mine(v),
                                            mesh=mesh, causal=causal
                                            ).numpy()
    leaves = [mine(a).requires_grad_() for a in (q, k, v)]
    collectives.reset_counts()
    y = RA.ring_attention(*leaves, mesh=mesh)
    fwd = (collectives.calls["send"], collectives.calls["recv"],
           collectives.bytes_moved["send"])
    (y * mine(g)).sum().backward()
    bwd = (collectives.calls["send"] - fwd[0],
           collectives.calls["recv"] - fwd[1])
    return {"out": out, "grads": [t.grad.numpy() for t in leaves],
            "fwd": fwd, "bwd": bwd, "rows": rows, "at": at}


def _assemble(ranks, pick) -> np.ndarray:
    full = np.zeros((B, S, H, D), np.float32)
    for r in ranks:
        c = pick(r).shape[1]
        full[r["rows"], r["at"]:r["at"] + c] = pick(r)
    return full


@pytest.fixture(scope="module")
def ring_runs():
    q, k, v, g = _qkv()
    return spawn(_ring_rank, 4, PORT_MESH, q, k, v, g), (q, k, v, g)


def _jax_ring(q, k, v, causal):
    import jax
    from kubeflow_tpu.api.trainingjob import ShardingSpec as JSpec
    from kubeflow_tpu.ops.ring_attention import ring_attention
    from kubeflow_tpu.parallel.mesh import build_mesh as j_build_mesh
    mesh = j_build_mesh(JSpec(**MESH), jax.devices()[:8])
    return np.asarray(jax.jit(lambda q, k, v: ring_attention(
        q, k, v, mesh=mesh, causal=causal))(q, k, v))


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax(ring_runs, causal):
    ranks, (q, k, v, _) = ring_runs
    got = _assemble(ranks, lambda r: r["out"][causal])
    np.testing.assert_allclose(got, _jax_ring(q, k, v, causal), atol=ATOL,
                               rtol=RTOL)
    ref = reference_attention(*(torch.tensor(a) for a in (q, k, v)),
                              causal=causal).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_ring_attention_grad(ring_runs):
    """dq, dk, dv of Σ ring·G against the JAX reference's gradients
    (every rank's K and V get the gradient of every rank's rows through
    the hops' backward)."""
    import jax
    import jax.numpy as jnp
    from kubeflow_tpu.ops.flash_attention import (
        reference_attention as j_ref)
    ranks, (q, k, v, g) = ring_runs
    want = jax.grad(lambda q, k, v: jnp.sum(j_ref(q, k, v) * g),
                    argnums=(0, 1, 2))(q, k, v)
    for i, name in enumerate("qkv"):
        got = _assemble(ranks, lambda r: r["grads"][i])
        np.testing.assert_allclose(got, np.asarray(want[i]), atol=1e-4,
                                   rtol=1e-3, err_msg=f"d{name}")


def test_ring_hops_are_counted(ring_runs):
    """A call on a ring of n = 4: n - 1 hops forward, each one send and
    one receive of the stacked K/V chunk ([2, 2, 64, 2, 16] f32), and
    as many backward."""
    ranks, _ = ring_runs
    chunk = 2 * B * (S // 4) * H * D * 4
    for r in ranks:
        assert r["fwd"] == (3, 3, 3 * chunk)
        assert r["bwd"] == (3, 3)


def test_ring_attention_degenerate_axis(monkeypatch):
    """A sequence axis of size 1 (or no mesh) is the flash kernel: one
    call of ``flash_attention`` (K1 on a card), equal to the JAX ring on
    a data-only mesh."""
    import jax
    from kubeflow_tpu.api.trainingjob import ShardingSpec as JSpec
    from kubeflow_tpu.ops.ring_attention import ring_attention as j_ring
    from kubeflow_tpu.parallel.mesh import build_mesh as j_build_mesh
    from kubeflow_tpu_torch.api.trainingjob import ShardingSpec
    from kubeflow_tpu_torch.parallel.mesh import build_mesh
    q, k, v, _ = _qkv(1, s=64)
    calls = []
    flash = RA.flash_attention
    monkeypatch.setattr(RA, "flash_attention",
                        lambda *a, **kw: calls.append(1) or flash(*a, **kw))
    want = np.asarray(j_ring(q, k, v, mesh=j_build_mesh(
        JSpec(data=8), jax.devices()[:8])))
    for mesh in (None, build_mesh(ShardingSpec())):
        got = RA.ring_attention(*(torch.tensor(a) for a in (q, k, v)),
                                mesh=mesh).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert len(calls) == 2


def test_merge_starts_from_the_ranks_own_chunk():
    """Step 0 holds the rank's own chunk, whose causal rows see their
    diagonal: the running max is finite after it on every rank. A fully
    masked first chunk (one from a later rank) leaves the max at -1e30
    and every p at 1, so l counts the chunk's columns."""
    n, c = 4, 8
    q, k, v, _ = _qkv(2, b=1, s=n * c)
    qf, kvf = torch.tensor(q), torch.stack((torch.tensor(k),
                                            torch.tensor(v)))
    for my in range(n):
        src = RA.ring_sources(my, n)
        assert src[0] == my and sorted(src) == list(range(n))
        rows = slice(my * c, (my + 1) * c)
        acc = torch.zeros((1, c, H, D))
        m = torch.full((1, H, c, 1), RA.NEG_INF)
        l = torch.zeros((1, H, c, 1))
        _, m0, _ = RA.ring_step(qf[:, rows], kvf[:, :, rows], acc, m, l,
                                my, my, True, 0.25)
        assert torch.isfinite(m0).all() and (m0 > RA.NEG_INF / 2).all()
        if my + 1 < n:
            later = slice((my + 1) * c, (my + 2) * c)
            _, mf, lf = RA.ring_step(qf[:, rows], kvf[:, :, later], acc, m,
                                     l, my, my + 1, True, 0.25)
            assert (mf == RA.NEG_INF).all() and (lf == c).all()


def test_mask_rows_start_at_the_chunk_offset():
    """Each chunk's scores are the whole sequence's block at (row offset
    my·Sq, column offset src·Sk), masked by global position."""
    n, c = 4, 8
    q, k, _, _ = _qkv(3, b=1, s=n * c)
    qt, kt = torch.tensor(q), torch.tensor(k)
    whole = RA.chunk_scores(qt, kt, 0.25, 0, 0, True)
    for my in range(n):
        for src in range(n):
            blk = RA.chunk_scores(qt[:, my * c:(my + 1) * c],
                                  kt[:, src * c:(src + 1) * c], 0.25, my,
                                  src, True)
            torch.testing.assert_close(
                blk, whole[..., my * c:(my + 1) * c, src * c:(src + 1) * c],
                rtol=1e-6, atol=1e-6)
