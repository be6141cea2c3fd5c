"""Card-only tests of the PyTorch/CUDA port: each CUDA kernel against its
plain PyTorch version on the card, the LM served through K1, and one
train step through K1, K2 and K3.

Every test here carries the ``gpu`` marker and skips where no card is
present (decided in the ``cuda_device`` fixture, never at import). The
file imports neither JAX nor the JAX package, so it runs where JAX is not
installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: f32 within 1e-5 (both sides f32, summed in another order);
bf16 outputs within 1e-2 + 2^-7 |o| (the kernel and the plain version
compute in f32 and round once to bf16, so they may land one bf16 step
apart); lse within 1e-4 (f32 log of f32 sums). Backward (K2): bf16
within 2^-7 |ref| + 2^-8 max|ref| (one bf16 step, plus half a step at
the largest value for f32 sums of up to S terms taken in another order
before the rounding), f32 within 1e-4 max(1, max|ref|). Fused Adam (K3):
within 1e-6 (both round every operation on its own, in one order).
"""

import importlib

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.ops import _build

tfa = importlib.import_module("kubeflow_tpu_torch.ops.flash_attention")
tfo = importlib.import_module("kubeflow_tpu_torch.ops.fused_adam")

BF16_ATOL, BF16_RTOL = 1e-2, 2.0 ** -7


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, s, h, d, device, dtype, seed=4):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(
        rng.standard_normal((b, s, h, d)).astype(np.float32)).to(
            device, dtype) for _ in range(3))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,causal,dtype", [
    ((1, 2048, 12, 64), True, torch.bfloat16),
    ((2, 1000, 12, 64), True, torch.bfloat16),
    ((2, 1000, 12, 64), False, torch.bfloat16),
    ((3, 77, 4, 32), True, torch.float32),
    ((1, 130, 2, 128), False, torch.float32),
    ((2, 65, 3, 8), True, torch.float32),
    ((1, 1, 1, 16), True, torch.float32),
])
def test_kernel_matches_plain(cuda_device, shape, causal, dtype):
    q, k, v = _qkv(*shape, cuda_device, dtype)
    launches = tfa.flash_attention.launches
    o, lse = tfa.flash_attention(q, k, v, causal=causal, with_lse=True)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == launches + 1
    p_o, p_lse = tfa.flash_attention_fwd_plain(q, k, v, causal=causal)
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert lse.shape == (shape[0], shape[2], shape[1])
    diff = (o.float() - p_o.float()).abs()
    if dtype == torch.bfloat16:
        assert bool((diff <= BF16_ATOL
                     + BF16_RTOL * p_o.float().abs()).all())
    else:
        assert diff.max().item() <= 1e-5
    assert (lse - p_lse).abs().max().item() <= 1e-4


@pytest.mark.gpu
def test_kernel_reads_strided_qkv_slices(cuda_device):
    """The model hands the kernel q/k/v as slices of one fused qkv
    tensor; the kernel reads them through their strides."""
    g = torch.Generator(device="cpu").manual_seed(5)
    qkv = torch.randn(2, 96, 3, 4, 32, generator=g).to(cuda_device)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    o = tfa.flash_attention(q, k, v, causal=True)
    p_o, _ = tfa.flash_attention_fwd_plain(q, k, v, causal=True)
    assert (o - p_o).abs().max().item() <= 1e-5


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros(1, 16, 2, 12, device=cuda_device)   # D not % 8
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(x, x, x)
    y = torch.zeros(1, 16, 2, 16, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_attention(y, y, y)
    z = torch.zeros(1, 16, 2, 16, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        tfa.flash_attention(z, z, z, with_lse=True)


@pytest.mark.gpu
def test_kernel_builds_with_nvcc(cuda_device):
    built = _build.build_all(verbose=True)
    assert sorted(built) == _build.sources()


@pytest.mark.gpu
def test_small_lm_served_through_the_kernel(cuda_device):
    """A 2-layer LM on the card: the flash servable launches K1 once per
    layer per forward and agrees with the einsum servable."""
    from kubeflow_tpu_torch.serving.servable import ModelRepository
    kw = dict(vocab_size=256, num_layers=2, embed_dim=64, num_heads=4,
              head_dim=16, mlp_dim=128, max_seq_len=96)
    repo = ModelRepository()
    flash = repo.load("f", "transformer_lm", attention="flash", **kw)
    einsum = repo.load("e", "transformer_lm", attention="einsum", **kw)
    einsum.swap(flash.params, 1)
    assert flash.device.type == "cuda"
    x = np.random.default_rng(6).integers(0, 256, (3, 96)).astype(np.int32)
    launches = tfa.flash_attention.launches
    got = flash.predict(x)
    assert tfa.flash_attention.launches == launches + 2
    ref = einsum.predict(x)
    rel = np.max(np.abs(got["logits"] - ref["logits"])) / \
        np.max(np.abs(ref["logits"]))
    assert rel <= 3e-2
    assert np.isfinite(got["logits"]).all()


def _close(got, ref, dtype) -> bool:
    d = (got.float() - ref.float()).abs()
    r = ref.float().abs()
    if dtype == torch.bfloat16:
        return bool((d <= 2.0 ** -7 * r + 2.0 ** -8 * r.max()).all())
    return d.max().item() <= 1e-4 * max(1.0, r.max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("shape,causal,dtype", [
    ((2, 2048, 12, 64), True, torch.bfloat16),
    ((2, 1000, 12, 64), True, torch.bfloat16),
    ((2, 1000, 12, 64), False, torch.bfloat16),
    ((2, 333, 4, 32), True, torch.float32),
    ((1, 130, 2, 128), False, torch.float32),
    ((2, 65, 3, 8), True, torch.float32),
    ((1, 1, 1, 16), True, torch.float32),
])
def test_backward_kernels_match_plain(cuda_device, shape, causal, dtype):
    q, k, v = _qkv(*shape, cuda_device, dtype)
    do = _qkv(*shape, cuda_device, dtype, seed=9)[0]
    o, lse = tfa.flash_attention_fwd_plain(q, k, v, causal=causal)
    delta = tfa.attention_delta(o, do)
    before = (tfa.flash_attention_bwd_dq.launches,
              tfa.flash_attention_bwd_dkv.launches)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                         causal=causal)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_bwd_dq.launches,
            tfa.flash_attention_bwd_dkv.launches) == \
        (before[0] + 1, before[1] + 1)
    p_dq = tfa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                            causal=causal)
    p_dk, p_dv = tfa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                   causal=causal)
    for name, got, ref in (("dq", dq, p_dq), ("dk", dk, p_dk),
                           ("dv", dv, p_dv)):
        assert got.dtype == dtype and got.shape == q.shape, name
        assert _close(got, ref, dtype), \
            f"{name}: max|d| {(got.float() - ref.float()).abs().max()}"


@pytest.mark.gpu
def test_autograd_through_strided_qkv(cuda_device):
    """Gradients through K1 + K2 on slices of one fused qkv tensor equal
    the plain backward's."""
    g = torch.Generator(device="cpu").manual_seed(10)
    qkv = torch.randn(2, 96, 3, 4, 32, generator=g).to(cuda_device)
    fused = qkv.clone().requires_grad_(True)
    do = torch.randn(2, 96, 4, 32, generator=g).to(cuda_device)
    out = tfa.flash_attention(fused[:, :, 0], fused[:, :, 1], fused[:, :, 2])
    out.backward(do)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    o, lse = tfa.flash_attention_fwd_plain(q, k, v)
    want = torch.stack(tfa.flash_attention_bwd_plain(q, k, v, o, lse, do),
                       dim=2)
    assert (fused.grad - want).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 5, 1000, 1_000_003])
def test_fused_adam_kernel_matches_plain(cuda_device, n):
    rng = np.random.default_rng(n)
    p, m, v = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
               .to(cuda_device) for _ in range(3))
    v = v.abs()
    ref = [x.clone() for x in (p, m, v)]
    for count in range(3):
        g = torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)).to(cuda_device)
        bc1, bc2 = tfo.bias_corrections(0.9, 0.999, count)
        kw = dict(lr=1e-3, wd=1e-4, bc1=bc1, bc2=bc2, b1=0.9, b2=0.999,
                  eps=1e-8)
        before = tfo.fused_adam.launches
        tfo.fused_adam(p, g, m, v, **kw)
        assert tfo.fused_adam.launches == before + 1
        tfo.fused_adam_plain(*ref[:1], g, *ref[1:], **kw)
    torch.cuda.synchronize()
    for got, want in zip((p, m, v), ref):
        assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.gpu
def test_one_train_step_launches_every_kernel(cuda_device):
    """A 2-layer LM step with flash attention and fused Adam: K1, K2a and
    K2b once per layer, K3 once per parameter tensor."""
    from kubeflow_tpu_torch.models import transformer as T
    from kubeflow_tpu_torch.runtime.recipe import make_optimizer
    from kubeflow_tpu_torch.runtime.trainstep import TrainStepBuilder
    cfg = T.TransformerConfig(vocab_size=256, num_layers=2, embed_dim=64,
                              num_heads=4, head_dim=16, mlp_dim=128,
                              max_seq_len=96, attention="flash")
    spec = T.workload_spec(cfg)
    builder = TrainStepBuilder(
        loss_fn=spec.loss_fn, device=cuda_device,
        optimizer=lambda p: make_optimizer(p, "adam", 1e-3,
                                           kernels="fused_adam")[0])
    state = builder.init(spec.init_fn, torch.Generator().manual_seed(0))
    batch = builder.place_batch(
        spec.batch_fn(torch.Generator().manual_seed(1), 2))
    counts = (tfa.flash_attention, tfa.flash_attention_bwd_dq,
              tfa.flash_attention_bwd_dkv, tfo.fused_adam)
    before = [c.launches for c in counts]
    state, metrics = builder.build()(state, batch)
    torch.cuda.synchronize()
    got = [c.launches - b for c, b in zip(counts, before)]
    assert got == [2, 2, 2, len(state.params)] and len(state.params) == 21
    assert np.isfinite(metrics["loss"].item())
    assert np.isfinite(metrics["grad_norm"].item())
