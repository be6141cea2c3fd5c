"""Card-only tests of the PyTorch/CUDA port: each CUDA kernel against its
plain PyTorch version on the card, the LM served through K1, one train
step through K1, K2 and K3 (one K3 launch a step), one fused ResNet-50
step through K4 and K5,
and one fused ResNet-50 inference forward through K6.

Every test here carries the ``gpu`` marker and skips where no card is
present (decided in the ``cuda_device`` fixture, never at import). The
file imports neither JAX nor the JAX package, so it runs where JAX is not
installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: f32 within 1e-5 (both sides f32, summed in another order);
bf16 outputs within 1e-2 + 2^-7 |o| (the kernel and the plain version
compute in f32 and round once to bf16, so they may land one bf16 step
apart; the bf16 kernel also rounds P to bf16 for its tensor-core P.V,
which over S 2048 stays within 0.4 of this bar in a CPU emulation); lse
within 1e-4 (f32 log of f32 sums). Backward (K2): bf16
within 2^-7 |ref| + 2^-8 max|ref| (one bf16 step, plus half a step at
the largest value for f32 sums of up to S terms taken in another order
before the rounding), f32 within 1e-4 max(1, max|ref|). Fused Adam (K3):
within 1e-6 (both round every operation on its own, in one order). The
fused ghost-BN block (K4, K5) and the fused inference block (K6):
chip_smoke.py's bars, stated beside ``_grad_ok`` and the K6 tests below.
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


# bf16 shapes that stress the tensor-core kernels: every head-dim
# template (32, 64, 128), a head dim padded inside its template (40),
# S = 1, a ragged S, and more than 65535 (batch, head) pairs (the flat
# grid)
BF16_SHAPES = [
    (1, 2048, 12, 64), (2, 1000, 12, 64), (2, 300, 4, 32), (1, 257, 2, 128),
    (2, 190, 3, 40), (3, 1, 2, 64), (2, 65, 3, 64), (2, 16, 32800, 8),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,causal,dtype", [
    ((2, 1000, 12, 64), False, torch.bfloat16),
    *((sh, True, torch.bfloat16) for sh in BF16_SHAPES),
    ((1, 257, 2, 128), False, torch.bfloat16),
    ((2, 65, 3, 40), False, torch.bfloat16),
    ((3, 77, 4, 32), True, torch.float32),
    ((1, 130, 2, 128), False, torch.float32),
    ((2, 65, 3, 8), True, torch.float32),
    ((1, 1, 1, 16), True, torch.float32),
    # f32: head dims that are not a multiple of 8, and the flat grid
    ((2, 100, 3, 36), True, torch.float32),
    ((2, 77, 2, 100), False, torch.float32),
    ((1, 24, 65537, 8), True, torch.float32),
])
def test_kernel_matches_plain(cuda_device, shape, causal, dtype):
    q, k, v = _qkv(*shape, cuda_device, dtype)
    launches = tfa.flash_attention.launches
    o, lse = tfa.flash_attention(q, k, v, causal=causal, with_lse=True)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == launches + 1
    _check_fwd(q, k, v, o, lse, causal)


def _check_fwd(q, k, v, o, lse, causal):
    p_o, p_lse = tfa.flash_attention_fwd_plain(q, k, v, causal=causal)
    dtype = q.dtype
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert o.shape == q.shape
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    diff = (o.float() - p_o.float()).abs()
    if dtype == torch.bfloat16:
        assert bool((diff <= BF16_ATOL
                     + BF16_RTOL * p_o.float().abs()).all())
    else:
        assert diff.max().item() <= 1e-5
    assert (lse - p_lse).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("sq,sk", [(100, 300), (300, 100), (1, 130),
                                   (129, 64)])
def test_bf16_kernel_causal_with_unequal_lengths(cuda_device, sq, sk):
    """Causal with Sq != Sk: the mask stays top-left aligned (cols <=
    rows), so rows past Sk see every key and rows before it fewer."""
    q = _qkv(2, sq, 3, 64, cuda_device, torch.bfloat16, seed=12)[0]
    k, v = _qkv(2, sk, 3, 64, cuda_device, torch.bfloat16, seed=13)[:2]
    o, lse = tfa.flash_attention(q, k, v, causal=True, with_lse=True)
    _check_fwd(q, k, v, o, lse, True)


@pytest.mark.gpu
@pytest.mark.parametrize("s,h,d", [(2048, 12, 64), (333, 4, 32),
                                   (190, 2, 128), (77, 3, 40)])
def test_bf16_kernels_read_strided_qkv_slices(cuda_device, s, h, d):
    """The model's fused-qkv slices in bf16: K1 and K2b copy them
    asynchronously through their strides, no copy made."""
    g = torch.Generator(device="cpu").manual_seed(14)
    qkv = torch.randn(2, s, 3, h, d, generator=g).to(cuda_device,
                                                     torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous() and tfa.async_ready(q)
    o, lse = tfa.flash_attention(q, k, v, causal=True, with_lse=True)
    _check_fwd(q, k, v, o, lse, True)
    do = torch.randn(2, s, h, d, generator=g).to(cuda_device, torch.bfloat16)
    _check_dkv(q, k, v, do, True)


@pytest.mark.gpu
def test_bf16_kernels_refuse_misaligned_views(cuda_device):
    """The bf16 tensor-core kernels copy 16-byte chunks: a view at D 64
    that starts one element in, or whose rows are not 8 elements apart,
    takes the bf16 FMA kernels instead (K1, K2a and K2b), one counted
    launch each on the unaligned route, within the bars against the plain
    versions; nothing is copied behind the caller's back."""
    flat = torch.randn(2 * 64 * 2 * 64 + 8, generator=torch.Generator(
        ).manual_seed(3)).to(cuda_device, torch.bfloat16)
    shifted = flat[1:1 + 2 * 64 * 2 * 64].view(2, 64, 2, 64)
    wide = torch.randn(2, 64, 2, 68, generator=torch.Generator(
        ).manual_seed(4)).to(cuda_device, torch.bfloat16)[..., :64]
    ok = _qkv(2, 64, 2, 64, cuda_device, torch.bfloat16)
    counts = (tfa.flash_attention, tfa.flash_attention_bwd_dq,
              tfa.flash_attention_bwd_dkv)
    for bad in (shifted, wide):
        assert not tfa.async_ready(bad)
        for q, k, v, do in ((bad, ok[1], ok[2], ok[0]),
                            (ok[0], ok[1], bad, ok[2]),
                            (ok[0], ok[1], ok[2], bad)):
            assert tfa.kernel_route(q, k, v, do) == "fma_unaligned"
            before = [(c.launches, c.unaligned_launches) for c in counts]
            o, lse = tfa.flash_attention_fwd_cuda(q, k, v)
            delta = tfa.attention_delta(o, do)
            dq = tfa.flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta)
            dkv = tfa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta)
            torch.cuda.synchronize()
            fwd_unaligned = int(tfa.kernel_route(q, k, v) == "fma_unaligned")
            assert [(c.launches, c.unaligned_launches) for c in counts] == [
                (before[0][0] + 1, before[0][1] + fwd_unaligned),
                (before[1][0] + 1, before[1][1] + 1),
                (before[2][0] + 1, before[2][1] + 1)]
            _check_fwd(q, k, v, o, lse, True)
            p_dq = tfa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta)
            assert _close(dq, p_dq, torch.bfloat16)
            _check_dkv(q, k, v, do, True, dkv, lse, delta)


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
    """Head dims over 256 now run (in chunks); what the kernels refuse is
    an empty head dim, one past the grid's 65535 chunks, f16 and a
    differentiated with_lse."""
    x = torch.zeros(1, 16, 2, 0, device=cuda_device,
                    dtype=torch.bfloat16)               # no head dim
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_fwd_cuda(x, x, x)
    w = torch.zeros(1, 1, 1, 256 * 65535 + 1, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(w, w, w)
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
    ((2, 1000, 12, 64), False, torch.bfloat16),
    # not S = 1: with one key, dq and dk are 0 up to rounding noise, which
    # no relative bar holds (a single q row is in the Sq != Sk test)
    *((sh, True, torch.bfloat16) for sh in BF16_SHAPES[1:] if sh[1] > 1),
    ((1, 257, 2, 128), False, torch.bfloat16),
    ((2, 65, 3, 40), False, torch.bfloat16),
    ((1, 40, 65537, 8), True, torch.bfloat16),
    ((2, 333, 4, 32), True, torch.float32),
    ((1, 130, 2, 128), False, torch.float32),
    ((2, 65, 3, 8), True, torch.float32),
    ((1, 1, 1, 16), True, torch.float32),
    # f32: head dims that are not a multiple of 8, and the flat grid
    ((2, 100, 3, 36), True, torch.float32),
    ((2, 77, 2, 100), False, torch.float32),
    ((1, 40, 65537, 8), True, torch.float32),
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
    assert dq.dtype == dtype and dq.shape == q.shape
    assert _close(dq, p_dq, dtype), \
        f"dq: max|d| {(dq.float() - p_dq.float()).abs().max()}"
    _check_dkv(q, k, v, do, causal, (dk, dv), lse, delta)


# head dims the tensor-core kernels do not take, which the FMA kernels
# take: 256 (their DMAX 256 template, 32-row tiles on the looped side) in
# f32 and bf16, and bf16 head dims that are not a multiple of 8 or lie
# above 128, loaded as bf16 and computed in f32
FMA_HEAD_DIMS = [
    ((2, 300, 3, 256), True, torch.float32),
    ((1, 129, 2, 256), False, torch.float32),
    ((2, 300, 3, 256), True, torch.bfloat16),
    ((1, 129, 2, 256), False, torch.bfloat16),
    ((2, 100, 3, 36), True, torch.bfloat16),
    ((1, 77, 2, 36), False, torch.bfloat16),
    ((1, 65, 2, 200), True, torch.bfloat16),
    ((1, 40, 2, 250), False, torch.float32),
    # above 256: the 256 instance in chunks of 256 columns
    ((2, 130, 3, 320), True, torch.float32),
    ((1, 77, 2, 320), False, torch.bfloat16),
    ((1, 100, 2, 512), True, torch.bfloat16),
    ((2, 65, 2, 512), False, torch.float32),
    ((1, 70, 1, 512), True, torch.float32),
    ((1, 33, 2, 320), True, torch.bfloat16),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,causal,dtype", FMA_HEAD_DIMS)
def test_fma_head_dims_match_plain(cuda_device, shape, causal, dtype):
    """K1, K2a and K2b at head dims the tensor-core kernels do not take,
    each against its plain version under the bars above; one counted
    launch each."""
    q, k, v = _qkv(*shape, cuda_device, dtype)
    assert not tfa.tensor_core_route(q)
    before = (tfa.flash_attention.launches,
              tfa.flash_attention_bwd_dq.launches,
              tfa.flash_attention_bwd_dkv.launches)
    o, lse = tfa.flash_attention(q, k, v, causal=causal, with_lse=True)
    _check_fwd(q, k, v, o, lse, causal)
    do = _qkv(*shape, cuda_device, dtype, seed=9)[0]
    delta = tfa.attention_delta(o, do)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    dkv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                      causal=causal)
    torch.cuda.synchronize()
    assert (tfa.flash_attention.launches,
            tfa.flash_attention_bwd_dq.launches,
            tfa.flash_attention_bwd_dkv.launches) == \
        tuple(b + 1 for b in before)
    p_dq = tfa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                            causal=causal)
    assert dq.dtype == dtype and dq.shape == q.shape
    assert _close(dq, p_dq, dtype), \
        f"dq: max|d| {(dq.float() - p_dq.float()).abs().max()}"
    _check_dkv(q, k, v, do, causal, dkv, lse, delta)


@pytest.mark.gpu
def test_fma_route_takes_misaligned_bf16_views(cuda_device):
    """The FMA kernels read scalars, so a bf16 view at a head dim they
    serve needs no 16-byte alignment (the tensor-core kernels refuse
    one)."""
    base = _qkv(1, 40, 2, 37, cuda_device, torch.bfloat16)
    q, k, v = (x[..., 1:] for x in base)          # D 36, offset by 2 bytes
    assert q.data_ptr() % 16 and not tfa.async_ready(q)
    o = tfa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    p_o, _ = tfa.flash_attention_fwd_plain(q, k, v)
    assert bool(((o.float() - p_o.float()).abs()
                 <= BF16_ATOL + BF16_RTOL * p_o.float().abs()).all())


def _check_dkv(q, k, v, do, causal, got=None, lse=None, delta=None):
    """K2b's (dk, dv) against its plain version; launches K2b when
    ``got`` is not given."""
    if lse is None:
        o, lse = tfa.flash_attention_fwd_plain(q, k, v, causal=causal)
        delta = tfa.attention_delta(o, do)
    if got is None:
        got = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                          causal=causal)
    p_dk, p_dv = tfa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                   causal=causal)
    # with one key p = 1 and ds = p (dp - delta) = 0, so dk is 0 up to
    # rounding noise, which no relative bar holds; dv (the sum of do over
    # the q rows) is held to the bar as everywhere
    held = ("dv",) if k.shape[1] == 1 else ("dk", "dv")
    for name, g, ref in (("dk", got[0], p_dk), ("dv", got[1], p_dv)):
        assert g.dtype == q.dtype and g.shape == k.shape, name
        assert bool(torch.isfinite(g.float()).all()), name
        if name in held:
            assert _close(g, ref, q.dtype), \
                f"{name}: max|d| {(g.float() - ref.float()).abs().max()}"


@pytest.mark.gpu
@pytest.mark.parametrize("sq,sk,causal", [
    (100, 300, True), (100, 300, False), (300, 100, True), (64, 200, True),
    (1, 65, False), (1, 1, True), (65, 1, True), (65, 1, False),
])
def test_bf16_dkv_kernel_with_unequal_lengths(cuda_device, sq, sk, causal):
    """K2b with Sq != Sk: causal k tiles past every q row's diagonal get
    zeros; a single q row (non-causal: causal, it sees one key and its
    gradients are rounding noise) feeds every k tile; one key leaves 127
    of the k tile's 128 rows past Sk, and dv is the sum of do."""
    q, do = _qkv(2, sq, 3, 64, cuda_device, torch.bfloat16, seed=15)[:2]
    k, v = _qkv(2, sk, 3, 64, cuda_device, torch.bfloat16, seed=16)[:2]
    _check_dkv(q, k, v, do, causal)


@pytest.mark.gpu
def test_bf16_dkv_kernel_takes_a_flat_grid(cuda_device):
    """More than 65535 (batch, head) pairs: K2b's flat grid takes them
    (K2a's and the f32 kernels' in test_backward_kernels_match_plain)."""
    q, k, v = _qkv(*BF16_SHAPES[-1], cuda_device, torch.bfloat16, seed=17)
    do = _qkv(*BF16_SHAPES[-1], cuda_device, torch.bfloat16, seed=18)[0]
    _check_dkv(q, k, v, do, True)


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
@pytest.mark.parametrize("scale", [1e-4, 1.0])
def test_fused_adam_kernel_matches_plain(cuda_device, n, scale):
    """One tensor, 3 steps, the clip at 1.0 on (scale 1.0: the norm of n
    normal values is above it from n 5 on) and off (scale 1e-4)."""
    rng = np.random.default_rng(n)
    p, m, v = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
               .to(cuda_device) for _ in range(3))
    v = v.abs()
    ref = [x.clone() for x in (p, m, v)]
    for count in range(3):
        g = scale * torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)).to(cuda_device)
        norm = torch.linalg.vector_norm(g)
        bc1, bc2 = tfo.bias_corrections(0.9, 0.999, count)
        kw = dict(lr=1e-3, bc1=bc1, bc2=bc2, b1=0.9, b2=0.999, eps=1e-8,
                  norm=norm, max_norm=1.0)
        before = tfo.fused_adam.launches
        tfo.fused_adam([p], [g], [m], [v], [1e-4], **kw)
        assert tfo.fused_adam.launches == before + 1
        tfo.fused_adam_plain(*ref[:1], g, *ref[1:], wd=1e-4, **kw)
    torch.cuda.synchronize()
    for got, want in zip((p, m, v), ref):
        assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.gpu
def test_fused_adam_one_launch_over_a_table(cuda_device):
    """450 tensors of ragged lengths, a quarter read through pointers 4
    bytes past 16-byte alignment, 64 without a gradient: one launch per
    384 tensors with a gradient (the kernel's capacity), so 2 for 386,
    each tensor as its plain version updates it, the skipped ones
    untouched."""
    g = torch.Generator(device="cpu").manual_seed(19)
    lengths = [int(x) for x in torch.randint(1, 5000, (450,), generator=g)]
    params = []
    for i, n in enumerate(lengths):
        base = torch.randn(n + 1, generator=g).to(cuda_device)
        params.append(base[1:] if i % 4 == 0 else base[:n].clone())
    ref = [(p.clone(), torch.zeros_like(p), torch.zeros_like(p))
           for p in params]
    opt = tfo.FusedAdam([{"params": params, "weight_decay": 1e-4}], lr=1e-3)
    grads = [torch.randn(n, generator=g).to(cuda_device) for n in lengths]
    for i, (p, gr) in enumerate(zip(params, grads)):
        p.grad = None if i % 7 == 3 else gr
    live = [gr for i, gr in enumerate(grads) if i % 7 != 3]
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(x) for x in live]))
    before = tfo.fused_adam.launches
    opt.step(norm=norm, max_norm=1.0)
    assert tfo.fused_adam.launches == before + 2
    bc1, bc2 = tfo.bias_corrections(0.9, 0.999, 0)
    for i, ((q, m, v), gr) in enumerate(zip(ref, grads)):
        if i % 7 != 3:
            tfo.fused_adam_plain(q, gr, m, v, lr=1e-3,
                                 wd=float(np.float32(1e-4)), bc1=bc1,
                                 bc2=bc2, b1=0.9, b2=0.999, eps=1e-8,
                                 norm=norm, max_norm=1.0)
    torch.cuda.synchronize()
    for i, (p, (q, m, v)) in enumerate(zip(params, ref)):
        assert (p - q).abs().max().item() <= 1e-6, i
        if i % 7 == 3:
            assert p not in opt.state or not opt.state[p]
        else:
            assert (opt.state[p]["mu"] - m).abs().max().item() <= 1e-6, i
            assert (opt.state[p]["nu"] - v).abs().max().item() <= 1e-6, i


@pytest.mark.gpu
def test_one_train_step_launches_every_kernel(cuda_device):
    """A 2-layer LM step with flash attention and fused Adam: K1, K2a and
    K2b once per layer, K3 once over every parameter tensor."""
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
    assert got == [2, 2, 2, 1] and len(state.params) == 21
    assert np.isfinite(metrics["loss"].item())
    assert np.isfinite(metrics["grad_norm"].item())


tfbt = importlib.import_module("kubeflow_tpu_torch.ops.fused_block_train")
tfbts = importlib.import_module(
    "kubeflow_tpu_torch.ops.fused_block_train_spatial")


def _block(cuda_device, n, h, cin, cmid, cout, proj, seed=11):
    g = torch.Generator(device="cpu").manual_seed(seed)

    def arr(*s):
        return (0.1 * torch.randn(s, generator=g)).to(cuda_device)

    w = (arr(cin, cmid), arr(cmid) + 1, arr(cmid), arr(3, 3, cmid, cmid),
         arr(cmid) + 1, arr(cmid), arr(cmid, cout), arr(cout) + 1, arr(cout))
    if proj:
        w += (arr(cin, cout), arr(cout) + 1, arr(cout))
    x = torch.randn((n, h, h, cin), generator=g).to(cuda_device,
                                                    torch.bfloat16)
    dy = torch.randn((n, h, h, cout), generator=g).to(cuda_device,
                                                      torch.bfloat16)
    return x, dy, w


def _grad_ok(got, ref) -> bool:
    """chip_smoke.py's K4/K5 gradient bar: within 2^-5 in norm, and
    elementwise within 2^-5 of the largest value for all but 10^-3 of the
    elements (the plain version rounds dh to bf16 where the kernel rounds
    da; a relu whose input is within f32 noise of 0 may take the other
    branch)."""
    d = (got.float() - ref.float()).abs()
    r = ref.float()
    return (d.norm() <= 2.0 ** -5 * r.norm()).item() and \
        (d > 2.0 ** -5 * r.abs().max()).float().mean().item() <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,cin,cmid,cout,proj,tile_bt,tile_h", [
    (4, 8, 32, 8, 32, False, 2, None),       # K4, small
    (4, 8, 16, 8, 32, True, 2, None),
    (2, 8, 32, 8, 32, False, 1, 4),          # K5, two strips
    (2, 8, 16, 8, 32, True, 2, 2),           # K5, four strips, proj
    (64, 14, 1024, 256, 1024, False, 1, None),   # K4, ResNet-50 stage 3
    (64, 56, 64, 64, 256, True, 1, 14),      # K5, ResNet-50 stage 1 head
    # 98-row ghosts (7^2, tile_bt 2) straddle the products' 128-row tiles
    (6, 7, 64, 32, 64, False, 2, None),
    (4, 7, 32, 64, 96, True, 2, None),
    # K5: seven strips of 2 rows, 16-row segments, several a tile
    (3, 14, 48, 24, 48, False, 1, 2),
    (4, 12, 24, 40, 72, True, 2, 3),
    # the warpgroup product's edges: the smallest widths (8 channels), M
    # and K not multiples of 64, W not a multiple of 8, strips of 1 row
    (2, 6, 8, 8, 8, False, 1, 1),
    (3, 9, 72, 40, 72, False, 1, 3),
    (1, 5, 24, 16, 40, True, 1, None),
    (2, 28, 16, 24, 32, True, 2, 14),
    (5, 7, 8, 72, 8, False, 1, 1),
])
def test_fused_block_kernels_match_plain(cuda_device, n, h, cin, cmid,
                                         cout, proj, tile_bt, tile_h):
    """K4/K5 forward (out, 8 statistics) and backward (dx and every weight
    gradient, from the forward's saved statistics) against the plain
    version and its autograd gradients, on the same bf16 inputs; one
    counted call a direction."""
    x, dy, w = _block(cuda_device, n, h, cin, cmid, cout, proj)
    if tile_h is None:
        mod, name, tiles = tfbt, "fused_block_train", (tile_bt,)
        ref = tfbt.reference_bottleneck_train
        kw = {"tile_bt": tile_bt}
    else:
        mod, name, tiles = tfbts, "fused_block_train_spatial", \
            (tile_bt, tile_h)
        ref = tfbts.reference_bottleneck_train_spatial
        kw = {"tile_bt": tile_bt, "tile_h": tile_h}
    fwd, bwd = getattr(mod, f"{name}_fwd"), getattr(mod, f"{name}_bwd")
    before = (fwd.launches, bwd.launches)
    out, stats, ghost = fwd(x, w, *tiles)
    dx, grads = bwd(x, dy, w, *tiles, ghost=ghost)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    p_out, p_stats = ref(x, w, **kw)
    p_dx, p_grads = tfbt.autograd_backward(ref, x, dy, w, **kw)
    d = (out.float() - p_out.float()).abs()
    assert (d > 2.0 ** -6 * (p_out.float().abs() + 1)).float().mean() <= 1e-4
    for a, b in zip(stats, p_stats):
        assert (a - b).abs().max().item() <= 1e-3 * b.abs().max().item() \
            + 1e-5
    assert dx.dtype == torch.bfloat16 and dx.shape == x.shape
    assert _grad_ok(dx, p_dx)
    if tile_h is not None:
        # chip_smoke.py's seam-row bar: the rows either side of a strip
        # boundary, where the halo terms land, against the backward's own
        # formula, within 2^-6 in norm
        f_dx, _ = tfbts.backward_plain(x, dy, w, **kw)
        seams = [r for s in range(1, h // tile_h)
                 for r in (s * tile_h - 1, s * tile_h)]
        d = dx[:, seams].float() - f_dx[:, seams].float()
        assert d.norm() <= 2.0 ** -6 * f_dx[:, seams].float().norm()
    assert len(grads) == (12 if proj else 9)
    for a, b in zip(grads, p_grads):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert _grad_ok(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,cin,cmid,cout,proj,tile_bt,tile_h", [
    (6, 7, 64, 32, 64, False, 2, None),      # K4, 98-row ghosts
    (4, 8, 16, 8, 32, True, 2, None),        # K4, proj, Cin != Cout
    (3, 14, 48, 24, 48, False, 1, 2),        # K5, seven strips
    (4, 12, 24, 40, 72, True, 2, 3),         # K5, proj, bt 2
    (64, 28, 512, 128, 512, False, 1, 14),   # K5, ResNet-50 stage 2
    (2, 6, 8, 8, 8, False, 1, 1),            # K5, 1-row strips, 8 wide
    (4, 9, 72, 40, 72, True, 2, None),       # K4, M and K off 64, proj
])
def test_fused_block_backward_takes_saved_statistics(cuda_device, n, h, cin,
                                                     cmid, cout, proj,
                                                     tile_bt, tile_h):
    """The backward from the forward's saved per-ghost statistics. Its
    guards are two: the saved statistics agree with their plain version
    (per ghost, in the kernel's layout) within chip_smoke.py's statistics
    bar, and a second call gives the same bits (fixed-order reductions, no
    float atomics). It also equals, bit for bit, the backward that
    recomputes the statistics; that one runs the forward's own launches
    into a workspace, so it is the same by construction and catches only
    nondeterminism, not a wrong saved statistic."""
    x, dy, w = _block(cuda_device, n, h, cin, cmid, cout, proj, seed=13)
    th = tile_h or h
    mod, name, tiles = (tfbt, "fused_block_train", (tile_bt,)) \
        if tile_h is None else \
        (tfbts, "fused_block_train_spatial", (tile_bt, tile_h))
    fwd, bwd = getattr(mod, f"{name}_fwd"), getattr(mod, f"{name}_bwd")
    _, _, ghost = fwd(x, w, *tiles)
    saved = bwd(x, dy, w, *tiles, ghost=ghost)
    again = bwd(x, dy, w, *tiles, ghost=ghost)
    recomputed = bwd(x, dy, w, *tiles)
    torch.cuda.synchronize()
    for other in (again, recomputed):
        assert torch.equal(saved[0], other[0])
        assert len(saved[1]) == len(other[1])
        for a, b in zip(saved[1], other[1]):
            assert torch.equal(a, b)
    plain = tfbts.ghost_stats_plain(x, w, tile_bt=tile_bt, tile_h=th)
    assert ghost.shape == plain.shape
    cm, co = cmid * (n // tile_bt) * (h // th), cout * (n // tile_bt) * \
        (h // th)
    parts = [cm] * 4 + [co] * 4
    for i, (a, b) in enumerate(zip(ghost.split(parts), plain.split(parts))):
        if i >= 6 and not proj:
            continue                     # mp, rsp: not written
        assert (a - b).abs().max().item() <= \
            1e-3 * b.abs().max().item() + 1e-5, i


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,cin,cmid,cout,proj,tile_bt,tile_h", [
    (64, 7, 2048, 512, 2048, False, 2, None),   # K4, ResNet-50 stage 4
    (64, 56, 256, 64, 256, False, 1, 14),       # K5, ResNet-50 stage 1
    (3, 9, 72, 40, 72, True, 1, 3),             # K5, odd sizes, proj
    (2, 6, 8, 8, 8, False, 2, 1),               # K5, 1-row strips
])
def test_fused_block_forward_same_bits_twice(cuda_device, n, h, cin, cmid,
                                             cout, proj, tile_bt, tile_h):
    """Two forward calls give the same bits: out, the 8 averaged
    statistics and the per-ghost ones (every sum of the warpgroup
    product's epilogue and of the ghost reduce is taken in a fixed order,
    with no float atomics)."""
    x, _, w = _block(cuda_device, n, h, cin, cmid, cout, proj, seed=17)
    mod, name, tiles = (tfbt, "fused_block_train", (tile_bt,)) \
        if tile_h is None else \
        (tfbts, "fused_block_train_spatial", (tile_bt, tile_h))
    fwd = getattr(mod, f"{name}_fwd")
    first = fwd(x, w, *tiles)
    second = fwd(x, w, *tiles)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert all(torch.equal(a, b) for a, b in zip(first[1], second[1]))
    # the per-ghost statistics; mp and rsp are not written without proj
    ghosts = (n // tile_bt) * (h // (tile_h or h))
    written = ghosts * (4 * cmid + (4 if proj else 2) * cout)
    assert torch.equal(first[2][:written], second[2][:written])


@pytest.mark.gpu
def test_fused_resnet_step_launches_k4_and_k5(cuda_device):
    """One fused ResNet-50 step at 224 px, batch 8: every stride-1 block
    runs K4 or K5 once a direction (7 + 7 and 6 + 6 launches)."""
    from kubeflow_tpu_torch.models import resnet as R
    from kubeflow_tpu_torch.runtime.recipe import make_optimizer
    from kubeflow_tpu_torch.runtime.trainstep import TrainStepBuilder
    spec = R.workload_spec(224, 1000, fused=True)
    builder = TrainStepBuilder(
        loss_fn=spec.loss_fn, device=cuda_device,
        optimizer=lambda p: make_optimizer(p, "momentum", 0.1)[0])
    state = builder.init(spec.init_fn, torch.Generator().manual_seed(0))
    batch = builder.place_batch(spec.batch_fn(
        torch.Generator().manual_seed(1), 8))
    counts = (tfbt.fused_block_train_fwd, tfbt.fused_block_train_bwd,
              tfbts.fused_block_train_spatial_fwd,
              tfbts.fused_block_train_spatial_bwd)
    before = [c.launches for c in counts]
    state, metrics = builder.build()(state, batch)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counts, before)] == [7, 7, 6, 6]
    assert np.isfinite(metrics["loss"].item())
    assert all(v.device.type == "cuda" and not v.requires_grad
               for v in state.variables["batch_stats"].values())


tfb = importlib.import_module("kubeflow_tpu_torch.ops.fused_block")


def _eval_block(cuda_device, n, h, cin, cmid, cout, proj, seed=12):
    """Folded-BN block weights of the model's kind (kernels N(0,
    1/fan_in), scales near 1) and a bf16 input, on the card."""
    g = torch.Generator(device="cpu").manual_seed(seed)

    def kernel(*s):
        return (torch.randn(s, generator=g) / np.sqrt(np.prod(s[:-1]))).to(
            cuda_device)

    def vec(c, mean=0.0):
        return (mean + 0.1 * torch.randn(c, generator=g)).to(cuda_device)

    kw = dict(wp=kernel(cin, cout), sp=vec(cout, 1.0), bp=vec(cout)) \
        if proj else {}
    w = tfb.FusedBlockWeights(
        w1=kernel(cin, cmid), s1=vec(cmid, 1.0), b1=vec(cmid),
        w2=kernel(3, 3, cmid, cmid), s2=vec(cmid, 1.0), b2=vec(cmid),
        w3=kernel(cmid, cout), s3=vec(cout, 1.0), b3=vec(cout), **kw)
    x = torch.randn((n, h, h, cin), generator=g).to(cuda_device,
                                                    torch.bfloat16)
    return x, w


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,cin,cmid,cout,proj", [
    (2, 8, 16, 8, 32, True),                 # small, projection
    (3, 5, 24, 16, 24, False),               # odd sizes, image seams
    (64, 14, 1024, 256, 1024, False),        # ResNet-50 stage 3
    # the warpgroup product's edges: 8 channels, M and K not multiples of
    # 64, W not a multiple of 8, 128-column tiles with a ragged N
    (2, 6, 8, 8, 8, False),
    (3, 9, 72, 40, 72, False),
    (1, 7, 8, 72, 200, True),
    (64, 7, 2048, 512, 2048, False),         # ResNet-50 stage 4
])
def test_fused_block_eval_kernel_matches_plain(cuda_device, n, h, cin, cmid,
                                               cout, proj):
    """K6 against its plain version on the same bf16 inputs (chip_smoke's
    bars: |d| <= 2^-6 (|ref| + 1) for all but 10^-4 of the elements, and
    at most 4% of the elements differing at all, since both round at the
    same points); one counted call."""
    x, w = _eval_block(cuda_device, n, h, cin, cmid, cout, proj)
    before = tfb.fused_bottleneck_eval.launches
    out = tfb.fused_bottleneck_eval(x, w)
    torch.cuda.synchronize()
    assert tfb.fused_bottleneck_eval.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (n, h, h, cout)
    ref = tfb.fused_bottleneck_eval_plain(x, w)
    d = (out.float() - ref.float()).abs()
    assert (d > 2.0 ** -6 * (ref.float().abs() + 1)).float().mean() <= 1e-4
    assert (d > 0).float().mean() <= 0.04
    with pytest.raises(TypeError, match="bfloat16"):
        tfb.fused_bottleneck_eval(x.float(), w)


@pytest.mark.gpu
def test_fused_eval_apply_launches_k6_13_times(cuda_device):
    """fused_eval_apply at 224 px, batch 2: every stride-1 block of
    ResNet-50 runs K6 once (13 launches), and the logits stay within 5e-2
    of the largest logit of ResNet.apply(train=False) on the same
    weights."""
    from kubeflow_tpu_torch.models import resnet as R
    model = R.resnet50(num_classes=1000)
    params, variables = model.init(torch.Generator().manual_seed(0))
    params = {k: v.to(cuda_device) for k, v in params.items()}
    stats = {k: v.to(cuda_device) for k, v in variables["batch_stats"].items()}
    x = torch.randn((2, 224, 224, 3), generator=torch.Generator(
        ).manual_seed(1)).to(cuda_device)
    before = tfb.fused_bottleneck_eval.launches
    with torch.inference_mode():
        fused = R.fused_eval_apply({"params": params, "batch_stats": stats},
                                   x)
        default = model.apply(params, stats, x, train=False)
    torch.cuda.synchronize()
    assert tfb.fused_bottleneck_eval.launches - before == 13
    assert fused.shape == (2, 1000) and torch.isfinite(fused).all()
    assert (fused - default).abs().max() <= 5e-2 * default.abs().max()


# -- the real-data path: the device prefetcher, device_normalize, LARS ---------

def _record_source(tmp_path, n=64, size=32, batch=8):
    from kubeflow_tpu_torch.data.imagenet import ImageNetSource, write_shards
    rng = np.random.default_rng(12)
    write_shards(str(tmp_path), rng.integers(0, 256, (n, size, size, 3),
                                             dtype=np.uint8),
                 rng.integers(0, 10, n), shard_records=32, num_classes=10)
    return ImageNetSource(str(tmp_path), batch, output="uint8")


def _kept(src, n, host):
    """n batches of the source, each kept aside (copied) on the host."""
    it = src.batches(seed=1)
    for _ in range(n):
        b = next(it)
        host.append({k: v.copy() for k, v in b.items()})
        yield b


def _place(dev):
    return lambda b: {k: torch.as_tensor(v).to(dev, non_blocking=True)
                      for k, v in b.items()}


@pytest.mark.gpu
def test_prefetcher_bytes_survive_a_busy_consumer(cuda_device, tmp_path):
    """Every staged batch equals its host batch byte for byte while the
    consumer's stream runs products between batches, and at most
    ``depth`` batches are on the card after each hand-out."""
    from kubeflow_tpu_torch.data.device_prefetch import DevicePrefetcher
    src = _record_source(tmp_path)
    host = []
    a = torch.randn(4096, 4096, device=cuda_device, dtype=torch.bfloat16)
    a = torch.tanh(a @ a)           # the product's workspace, before base
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    pf = DevicePrefetcher(_kept(src, 16, host), _place(cuda_device),
                          depth=2, device=cuda_device)
    try:
        for i, batch in enumerate(pf):
            nbytes = sum(v.numel() * v.element_size()
                         for v in batch.values())
            assert torch.cuda.memory_allocated() - base <= 2 * (
                nbytes + 1024)
            for _ in range(6):
                a = torch.tanh(a @ a)
            for k, v in batch.items():
                assert v.cpu().numpy().tobytes() == host[i][k].tobytes()
            del batch
        assert i == 15 and len(host) == 16
    finally:
        pf.close()
        src.close()


@pytest.mark.gpu
def test_prefetcher_frees_a_batch_under_a_pending_read(cuda_device,
                                                       tmp_path):
    """depth 1, two pinned slots: the consumer queues a read of each
    batch behind a spin on its stream and drops the batch at once, so the
    next copy runs while the read is pending. record_stream keeps the
    freed memory from the next copy; the slot's event keeps its pinned
    buffer from the next fill. Every read sees its own batch."""
    from kubeflow_tpu_torch.data.device_prefetch import DevicePrefetcher
    src = _record_source(tmp_path)
    host = []
    pf = DevicePrefetcher(_kept(src, 12, host), _place(cuda_device),
                          depth=1, device=cuda_device)
    sums = []
    try:
        for batch in pf:
            torch.cuda._sleep(20_000_000)
            sums.append(batch["images"].to(torch.int64).sum())
            del batch
        torch.cuda.synchronize()
    finally:
        pf.close()
        src.close()
    assert [int(s) for s in sums] == [
        int(h["images"].astype(np.int64).sum()) for h in host]


@pytest.mark.gpu
def test_device_normalize_on_the_card(cuda_device):
    from kubeflow_tpu_torch.data.imagenet import device_normalize
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (4, 64, 64, 3), dtype=np.uint8))
    got = device_normalize(x.to(cuda_device))
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert (got.cpu() - device_normalize(x)).abs().max().item() <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("runtime", [False, True])
@pytest.mark.parametrize("name", ["lars", "rmsprop"])
def test_lars_and_rmsprop_card_against_cpu(cuda_device, name, runtime):
    """5 steps over bottleneck-shaped tensors (a zero-init BN scale
    among them), weight decay on the kernels, each side with its own
    copy of the gradients: the card's params within 1e-5 of the largest
    CPU value of each tensor. Without the clip: the f32 global norm of
    2.1M elements sums in another order on each side (the CPU's
    reduction moves it by more than this bar), and LARS hands the
    gradient's scale straight on where its trust ratio is 1 (the
    zero-init scale), so the clip would be measured, not the chain."""
    from kubeflow_tpu_torch.runtime.recipe import make_optimizer
    shapes = [(1, 1, 256, 64), (3, 3, 64, 64), (1, 1, 64, 256), (256,),
              (256,), (64,), (1000,), (2048, 1000)]
    gen = torch.Generator().manual_seed(2)
    cpu = [torch.randn(s, generator=gen) * 0.1 for s in shapes]
    cpu[3].zero_()
    dev = [p.to(cuda_device) for p in cpu]
    kw = dict(learning_rate=0.1, schedule="cosine", total_steps=5,
              warmup_steps=2, weight_decay=1e-4, runtime_schedule=runtime,
              grad_clip=None)
    opts = [make_optimizer(ps, name, **kw)[0] for ps in (cpu, dev)]
    for step in range(5):
        grads = [torch.randn(s, generator=gen) * 1e-3 for s in shapes]
        for ps, opt in zip((cpu, dev), opts):
            for p, g in zip(ps, grads):
                p.grad = g.clone().to(p.device)
            opt.step()
    for a, b in zip(dev, cpu):
        err = (a.cpu() - b).abs().max().item()
        assert err <= 1e-5 * b.abs().max().item(), (a.shape, err)
