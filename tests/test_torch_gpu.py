"""Card-only tests of the PyTorch/CUDA port: each CUDA kernel against its
plain PyTorch version on the card, the LM served through K1, one train
step through K1, K2 and K3 (one K3 launch a step), one fused ResNet-50
step through K4 and K5,
and one fused ResNet-50 inference forward through K6; and two gloo ranks
sharing the card (sharded update) against one process, for one step of a
small LM and of one fused block; the pipelined LM's microbatch shapes,
two {pipeline 2} ranks sharing the card, the MPMD stages' launches, and
two {sequence 2} ranks' ring against the gathered sequence's K1;
kubebench's fused config through ``run_benchmark``; a worker brought up
with NCCL from the env the operator rendered into a GPU pod; and the
slice scheduler's health soak evacuating a flaky node.

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


@pytest.mark.gpu
def test_kubebench_fused_row_names_the_card(cuda_device):
    """kubebench's fused config through run_benchmark on the card, 2
    steps of ResNet-50 at 224 px and batch 8: the row names the card and
    one chip, its MFU and vs_baseline follow from its rate, and every
    stride-1 block ran K4 or K5 (7 + 7 and 6 + 6 launches a step)."""
    from kubeflow_tpu_torch.utils import chips
    from kubeflow_tpu_torch.workflows import kubebench
    counts = (tfbt.fused_block_train_fwd, tfbt.fused_block_train_bwd,
              tfbts.fused_block_train_spatial_fwd,
              tfbts.fused_block_train_spatial_bwd)
    before = [c.launches for c in counts]
    row = kubebench.run_benchmark(
        workload="resnet50", steps=2, global_batch=8, sync_every=1,
        handle_sigterm=False, workload_kwargs={"fused": True})
    assert [c.launches - b for c, b in zip(counts, before)] == \
        [14, 14, 12, 12]
    assert row["workload"] == "resnet50-fused" and row["steps"] == 2
    assert row["device_kind"] == torch.cuda.get_device_name()
    assert row["chips"] == 1 and row["examples_per_sec"] > 0
    mfu = chips.resnet50_train_mfu(row["examples_per_sec"], cuda_device)
    assert row["mfu"] == ("" if mfu is None else round(mfu, 4))
    assert row["vs_baseline"] == pytest.approx(
        row["examples_per_sec"] / chips.BASELINE_IMG_S, abs=1e-3)
    assert np.isfinite(row["metric_loss"])


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


# -- data parallel: two ranks sharing the card against one process -------------

def _dp_lm_step(rank, world, mode):
    """One sharded (or, alone, replicated) step of a 2-layer LM with
    flash attention and fused Adam on the card: the metrics, this rank's
    launches and the collectives staged through host memory."""
    from kubeflow_tpu_torch.api.trainingjob import ShardingSpec
    from kubeflow_tpu_torch.models import transformer as T
    from kubeflow_tpu_torch.parallel import collectives
    from kubeflow_tpu_torch.parallel.mesh import build_mesh
    from kubeflow_tpu_torch.runtime.recipe import make_optimizer
    from kubeflow_tpu_torch.runtime.trainstep import TrainStepBuilder
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = T.TransformerConfig(vocab_size=256, num_layers=2, embed_dim=64,
                              num_heads=4, head_dim=16, mlp_dim=128,
                              max_seq_len=96, attention="flash")
    spec = T.workload_spec(cfg)
    builder = TrainStepBuilder(
        loss_fn=spec.loss_fn, device=torch.device("cuda", 0),
        weight_update=mode, mesh=build_mesh(ShardingSpec(data=world)),
        optimizer=lambda p: make_optimizer(p, "adam", 1e-3,
                                           kernels="fused_adam")[0])
    state = builder.init(spec.init_fn, torch.Generator().manual_seed(0))
    batch = builder.place_batch(
        spec.batch_fn(torch.Generator().manual_seed(1), 4))
    counts = (tfa.flash_attention, tfa.flash_attention_bwd_dq,
              tfa.flash_attention_bwd_dkv, tfo.fused_adam)
    before = [c.launches for c in counts]
    collectives.reset_counts()
    state, m = builder.build()(state, batch)
    torch.cuda.synchronize()
    return {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
            "launches": [c.launches - b for c, b in zip(counts, before)],
            "staged": sum(collectives.host_staged.values()),
            "params": {k: p.detach().cpu().numpy()
                       for k, p in state.params.items()}}


@pytest.mark.gpu
def test_two_ranks_on_the_card_match_one_for_an_lm_step(cuda_device):
    """Two gloo ranks on the card, 2 rows each, sharded, against one
    process on the 4 rows, replicated: each rank launches K1, K2a, K2b
    once a layer and K3 once over its shards; loss within 1e-3 and grad
    norm within 1e-2, relative (chip_smoke.py phase 8's bars), the new
    params equal on both ranks; a gloo group stages its CUDA tensors
    through host memory (counted)."""
    from test_torch_dp import spawn
    one = _dp_lm_step(0, 1, "replicated")
    ranks = spawn(_dp_lm_step, 2, "sharded")
    for out in ranks:
        assert out["launches"] == [2, 2, 2, 1]
        assert out["staged"] > 0
        np.testing.assert_allclose(out["loss"], one["loss"], rtol=1e-3)
        np.testing.assert_allclose(out["grad_norm"], one["grad_norm"],
                                   rtol=1e-2)
    assert one["staged"] == 0
    for k, v in ranks[0]["params"].items():
        np.testing.assert_array_equal(v, ranks[1]["params"][k], err_msg=k)


def _dp_block_step(rank, world, rows):
    """One SGD step at lr 1 of a fused stride-1 block (14x14, 256 → 64 →
    256, K4) whose loss is the mean square of its output, on ``rows`` of
    a seeded batch of 8: the new params (their change is the gradient)
    and this rank's K4 launches. ``world`` 1 with both halves' losses
    averaged is what two ranks compute."""
    from kubeflow_tpu_torch.api.trainingjob import ShardingSpec
    from kubeflow_tpu_torch.models import resnet as R
    from kubeflow_tpu_torch.parallel.mesh import build_mesh
    from kubeflow_tpu_torch.runtime.recipe import make_optimizer
    from kubeflow_tpu_torch.runtime.trainstep import TrainStepBuilder
    params = R.random_block_params(torch.Generator().manual_seed(0), 256,
                                   64, 256, False)
    x = torch.randn(8, 14, 14, 256, generator=torch.Generator().manual_seed(
        1)).to(torch.bfloat16)

    def block_loss(p, x):
        out, _ = tfbt.fused_bottleneck_train(x.contiguous(), p, tile_bt=2)
        return out.float().square().mean()

    def loss_fn(p, variables, batch, rng):
        xs = batch["x"]
        if rows == "halves":
            return (block_loss(p, xs[:4]) + block_loss(p, xs[4:])) / 2, {}
        return block_loss(p, xs), {}

    builder = TrainStepBuilder(
        loss_fn=loss_fn, device=torch.device("cuda", 0),
        weight_update="sharded", mesh=build_mesh(ShardingSpec(data=world)),
        optimizer=lambda p: make_optimizer(p, "sgd", 1.0,
                                           grad_clip=None)[0])
    state = builder.init(lambda rng: (params, {}), None)
    counts = (tfbt.fused_block_train_fwd, tfbt.fused_block_train_bwd)
    before = [c.launches for c in counts]
    state, m = builder.build()(state, builder.place_batch({"x": x}))
    torch.cuda.synchronize()
    # numpy, not tensors: a tensor through the queue would share memory
    # with a process that exits
    return {"grads": {k: (params[k] - p.detach().cpu()).numpy()
                      for k, p in state.params.items()},
            "launches": [c.launches - b for c, b in zip(counts, before)],
            "loss": m["loss"].item()}


@pytest.mark.gpu
def test_two_ranks_on_the_card_match_one_for_a_fused_block(cuda_device):
    """The fused block over two ranks of 4 rows (each its own ghost
    tiles) against one process averaging the two halves' losses: one K4
    forward and backward a rank; the loss within 1e-5 relative and each
    gradient within 1e-3 of its norm (the same kernels on the same rows,
    the two halves' gradients summed in another order)."""
    from test_torch_dp import spawn
    one = _dp_block_step(0, 1, "halves")
    ranks = spawn(_dp_block_step, 2, "rank")
    for out in ranks:
        assert out["launches"] == [1, 1]
        np.testing.assert_allclose(out["loss"], one["loss"], rtol=1e-5)
        for k, g in one["grads"].items():
            d = np.linalg.norm(out["grads"][k] - g)
            assert d <= 1e-3 * np.linalg.norm(g), (k, d)


def _linear_loss(params, variables, batch, rng):
    y = batch["x"] @ params["w"] + params["b"]
    return torch.mean((y - batch["y"]) ** 2), {}


def _linear(seed: int = 0) -> tuple[dict, dict]:
    rs = np.random.RandomState(seed)
    return ({"w": rs.randn(6, 8).astype(np.float32),
             "b": np.zeros((8,), np.float32)},
            {"x": rs.randn(8, 6).astype(np.float32),
             "y": rs.randn(8, 8).astype(np.float32)})


@pytest.mark.gpu
def test_fused_adam_state_round_trips_on_the_card(cuda_device, tmp_path):
    """Two fused_adam steps on the card, a save (pinned host copies, the
    write on a background thread) and a restore into a template built
    from other weights: the params, K3's moments (on the card) and its
    count come back equal, and the next step — one K3 launch on each
    side — gives the same bits."""
    from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager
    from kubeflow_tpu_torch.runtime.recipe import make_optimizer
    from kubeflow_tpu_torch.runtime.trainstep import (TrainStepBuilder,
                                                      state_tree)
    params, batch = _linear()

    def fresh(seed):
        b = TrainStepBuilder(
            loss_fn=_linear_loss, device=cuda_device,
            optimizer=lambda p: make_optimizer(p, "adam", 1e-2,
                                               kernels="fused_adam")[0])
        return b, b.init(lambda rng: (_linear(seed)[0], {}), None)

    b, state = fresh(0)
    step = b.build()
    for _ in range(2):
        state, _m = step(state, b.place_batch(batch))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state, force=True)
    mgr.wait()
    b2, other = fresh(1)
    restored = mgr.restore(other)
    mgr.close()
    want, got = state_tree(state), state_tree(restored)
    assert got["opt"]["count"] == want["opt"]["count"] == {
        "schedule": 2, "inner": 2}
    for slot in ("mu", "nu"):
        for n, v in want["opt"]["slots"][slot].items():
            g = got["opt"]["slots"][slot][n]
            assert g.is_cuda and torch.equal(g, v), (slot, n)
    before = tfo.fused_adam.launches
    _s, m1 = step(state, b.place_batch(batch))
    _s, m2 = b2.build()(restored, b2.place_batch(batch))
    torch.cuda.synchronize()
    assert tfo.fused_adam.launches - before == 2
    assert m1["loss"].item() == m2["loss"].item()
    for n in state.params:
        assert torch.equal(state.params[n], restored.params[n]), n


def _poison_rank(rank, world):
    from kubeflow_tpu_torch.api.trainingjob import ShardingSpec
    from kubeflow_tpu_torch.parallel.mesh import build_mesh
    from kubeflow_tpu_torch.runtime.recipe import make_optimizer
    from kubeflow_tpu_torch.runtime.sentinel import NumericFaultHook
    from kubeflow_tpu_torch.runtime.trainstep import TrainStepBuilder
    params, batch = _linear()
    b = TrainStepBuilder(
        loss_fn=_linear_loss, device=torch.device("cuda", 0),
        weight_update="sharded", mesh=build_mesh(ShardingSpec(data=world)),
        optimizer=lambda p: make_optimizer(p, "sgd", 1e-4,
                                           grad_clip=None)[0])
    state = b.init(lambda rng: (params, {}), None)
    step = b.build()
    state, _m = step(state, b.place_batch(batch))
    w0 = state.params["w"].detach().clone()
    u0 = state.update_params["w"].detach().clone()
    NumericFaultHook("spike", 1, 8.0, None).poison(state, 1)
    blocks = bool(torch.equal(state.update_params["w"], u0 * 8.0))
    state, _m = step(state, b.place_batch(batch))
    torch.cuda.synchronize()
    return {"blocks": blocks, "cuda": state.params["w"].is_cuda,
            "ratio": float((state.params["w"] / w0).median())}


@pytest.mark.gpu
def test_poison_under_the_sharded_update_on_the_card(cuda_device):
    """Two gloo ranks on the card, the sharded update: the spike poisons
    each rank's block of the optimizer in place as well as the params,
    so after the next step's all-gather the params stay 8x (within the
    1e-4 step), not the clean blocks written back."""
    from test_torch_dp import spawn
    for out in spawn(_poison_rank, 2):
        assert out["blocks"] and out["cuda"]
        assert abs(out["ratio"] - 8.0) < 1e-2, out


# -- the serving tier past one replica (K1 on every path) ------------------

SMALL_LM = dict(vocab_size=256, num_layers=2, embed_dim=64, num_heads=4,
                head_dim=16, mlp_dim=128, max_seq_len=96)

# a server process on the small LM (the CLI's builder cut to SMALL_LM):
# serve() with the build cache from the env, then its start kind, the
# compile stats and the /metrics gauge on one line of JSON
_SERVER_CHILD = """
import json, sys, urllib.request
from kubeflow_tpu_torch.serving import http_server, servable as TS
from kubeflow_tpu_torch.runtime.compile_cache import compile_stats
real = TS._MODEL_BUILDERS["transformer_lm"]
TS._MODEL_BUILDERS["transformer_lm"] = lambda **kw: real(**{**kw, **%r})
run = http_server.serve(["--model-type", "transformer_lm", "--model-name",
                         "lm", "--attention", "flash", "--grpc-port", "0",
                         "--rest-port", "0", "--max-batch", "2"])
port = run["server"].port
text = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics").read()
run["server"].stop()
print(json.dumps({"kind": run["servable"].start_kind,
                  "stats": compile_stats(), "metrics": text.decode()}))
""" % (SMALL_LM,)


@pytest.mark.gpu
def test_cold_then_warm_server_processes(cuda_device, tmp_path):
    """Two server processes on one empty build cache: the first runs
    nvcc for K1 (cold), the second loads it (warm); /metrics agrees."""
    import json
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "KFTPU_COMPILE_CACHE_DIR": str(tmp_path / "cache"),
           "PYTHONPATH": repo}
    runs = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", _SERVER_CHILD], cwd=repo,
                             env=env, capture_output=True, text=True,
                             timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    cold, warm = runs
    assert cold["kind"] == "cold" and cold["stats"]["xla_backend_compiles"] \
        >= 1
    assert warm["kind"] == "warm" and warm["stats"]["cache_hits"] >= 1 and \
        warm["stats"]["xla_backend_compiles"] == 0
    assert 'kftpu_serving_start_kind{model="lm",kind="warm"} 1' in \
        warm["metrics"]
    assert any(f.startswith("flash_attention_fwd-")
               for f in os.listdir(tmp_path / "cache"))


def _small_servables(n):
    from kubeflow_tpu_torch.serving.servable import ModelRepository
    repo = ModelRepository()
    out = []
    for i in range(n):
        s = repo.load("lm", "transformer_lm", attention="flash", **SMALL_LM)
        s.max_batch = 4
        out.append(s)
    return out


@pytest.mark.gpu
def test_grpc_predict_launches_k1(cuda_device):
    """PredictionService on the card: K1 once per layer per forward, the
    answers equal REST's through the same MicroBatcher."""
    pytest.importorskip("grpc")
    from kubeflow_tpu_torch.serving import client
    from kubeflow_tpu_torch.serving.grpc_server import GrpcPredictServer
    from kubeflow_tpu_torch.serving.http_server import ModelServer
    (lm,) = _small_servables(1)
    server = ModelServer(host="127.0.0.1", port=0, max_batch=4)
    server.repository.add(lm)
    server.start()
    gs = GrpcPredictServer(server, host="127.0.0.1", port=0)
    gport = gs.start()
    x = np.random.default_rng(7).integers(0, 256, (3, 96)).astype(np.int32)
    try:
        launches = tfa.flash_attention.launches
        forwards = lm.metadata()["stats"]["request_count"]
        got = client.predict_grpc(f"127.0.0.1:{gport}", "lm", x,
                                  dtype="int32")["predictions"]
        forwards = lm.metadata()["stats"]["request_count"] - forwards
        assert forwards >= 1 and \
            tfa.flash_attention.launches - launches == 2 * forwards
        rest = client.predict(f"127.0.0.1:{server.port}", "lm", x,
                              dtype="int32")["predictions"]
    finally:
        gs.stop(grace=1.0)
        server.stop()
    assert got["next_token"] == rest["next_token"]
    np.testing.assert_allclose(np.asarray(got["logits"]),
                               np.asarray(rest["logits"]), rtol=0,
                               atol=1e-5 * np.abs(rest["logits"]).max())


@pytest.mark.gpu
def test_three_replica_fleet_on_the_card_survives_kill(cuda_device,
                                                       tmp_path):
    """Three small-LM replicas on the card behind a FleetRouter: one is
    killed mid-load and restarted; every client request succeeds, no
    request is answered twice, and K1 ran once per layer per forward."""
    import json
    from kubeflow_tpu_torch.cluster.chaos import ServingSoak
    replicas = _small_servables(3)
    rng = np.random.default_rng(8)
    xs = [rng.integers(0, 256, (1, 96)).astype(np.int32) for _ in range(4)]
    soak = ServingSoak(span_path=str(tmp_path / "spans.jsonl"),
                       servables=replicas, seconds=1.0, threads=4,
                       keep_responses=8, bodies=[json.dumps(
                           {"instances": x.tolist(), "dtype": "int32"}
                       ).encode() for x in xs])
    launches = tfa.flash_attention.launches
    forwards = sum(r.metadata()["stats"]["request_count"] for r in replicas)
    report = soak.run_kill()
    forwards = sum(r.metadata()["stats"]["request_count"]
                   for r in replicas) - forwards
    assert report["success_pct"] == 100.0, report["errors"]
    assert forwards >= 1 and \
        tfa.flash_attention.launches - launches == 2 * forwards
    audit = soak.audit()
    assert audit["ledger_sum_ok"] and audit["duplicate_side_effects"] == 0
    for i, out in report["samples"]:
        assert out["predictions"]["next_token"] == \
            replicas[0].predict(xs[i])["next_token"].tolist()


# -- the captured train step (runtime/trainstep.py build_compiled) ----------


def _small_lm_run(cuda_device, opt="adam", kernels="fused_adam", **kw):
    """A 2-layer LM on flash attention (head dim 64, the tensor-core K1,
    K2a, K2b), its builder, state and 6 seeded batches of 4 x 128."""
    from kubeflow_tpu_torch.models import transformer as T
    from kubeflow_tpu_torch.runtime.recipe import make_optimizer
    from kubeflow_tpu_torch.runtime.trainstep import TrainStepBuilder
    cfg = T.TransformerConfig(vocab_size=512, num_layers=2, embed_dim=128,
                              num_heads=2, head_dim=64, mlp_dim=256,
                              max_seq_len=128, attention="flash")
    spec = T.workload_spec(cfg)
    b = TrainStepBuilder(
        loss_fn=spec.loss_fn, device=cuda_device,
        optimizer=lambda p: make_optimizer(p, opt, 1e-3, kernels=kernels,
                                           total_steps=6, **kw)[0])
    gen = torch.Generator().manual_seed(1)
    batches = [b.place_batch(spec.batch_fn(gen, 4)) for _ in range(6)]
    return spec, b, batches


def _small_resnet_run(cuda_device, opt="lars", **kw):
    """Fused ResNet-50 at 64 px, batch 8 (K4 and K5 at their tiles), and
    6 seeded batches."""
    from kubeflow_tpu_torch.models import resnet as R
    from kubeflow_tpu_torch.runtime.recipe import make_optimizer
    from kubeflow_tpu_torch.runtime.trainstep import TrainStepBuilder
    spec = R.workload_spec(64, 10, fused=True)
    b = TrainStepBuilder(
        loss_fn=spec.loss_fn, device=cuda_device,
        optimizer=lambda p: make_optimizer(p, opt, 0.1, total_steps=6,
                                           **kw)[0])
    gen = torch.Generator().manual_seed(1)
    batches = [b.place_batch(spec.batch_fn(gen, 8)) for _ in range(6)]
    return spec, b, batches


def _trajectory(spec, b, batches, compiled):
    state = b.init(spec.init_fn, torch.Generator().manual_seed(0))
    step = b.build_compiled(state, batches[0]) if compiled else b.build()
    losses = []
    for batch in batches:
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    return state, [x.item() for x in losses], step


def _same_state(a, b):
    for n, p in a.params.items():
        assert torch.equal(p, b.params[n]), n
    for c, vs in a.variables.items():
        for n, v in vs.items():
            assert torch.equal(v, b.variables[c][n]), (c, n)


@pytest.mark.gpu
@pytest.mark.parametrize("model,kw", [
    ("lm", {}),
    ("resnet", dict(schedule="cosine", warmup_steps=2,
                    runtime_schedule=True)),
])
def test_captured_step_equals_eager(cuda_device, model, kw):
    """The step captured as one CUDA graph and replayed 6 times gives the
    eager step's losses, params and BatchNorm statistics bit for bit (the
    same kernels in the same order): the LM on K1, K2a, K2b and K3, the
    fused ResNet-50 on K4 and K5 with LARS under the runtime schedule."""
    run = _small_lm_run if model == "lm" else _small_resnet_run
    spec, b, batches = run(cuda_device, **kw)
    eager, le, _ = _trajectory(spec, b, batches, compiled=False)
    captured, lc, step = _trajectory(spec, b, batches, compiled=True)
    assert step.graph is not None and step.replays == 6
    assert lc == le
    _same_state(captured, eager)


@pytest.mark.gpu
@pytest.mark.parametrize("opt,kernels", [("adam", "fused_adam"),
                                         ("lars", "stock")])
def test_captured_step_follows_a_warmup_cosine_schedule(cuda_device, opt,
                                                        kernels):
    """A host warmup + cosine schedule: K3's (lr, bc1, bc2) and LARS's
    baked lr are written to the device before each replay, so the params
    after 6 replays equal the eager run's."""
    if opt == "lars":
        spec, b, batches = _small_resnet_run(
            cuda_device, "lars", schedule="cosine", warmup_steps=2)
    else:
        spec, b, batches = _small_lm_run(cuda_device, schedule="cosine",
                                         warmup_steps=2)
    eager, le, _ = _trajectory(spec, b, batches, compiled=False)
    captured, lc, _ = _trajectory(spec, b, batches, compiled=True)
    assert lc == le
    _same_state(captured, eager)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sgd", "momentum", "nesterov"])
def test_captured_sgd_follows_a_host_cosine_schedule(cuda_device, name):
    """sgd, momentum and nesterov on a host warmup + cosine schedule
    capture (runtime/recipe.py ``SGD``, lr from a device buffer written
    before each replay): the params after 6 replays equal the eager
    run's, which takes the same update with a host lr (a baked lr would
    leave it by the schedule's change)."""
    spec, b, batches = _small_lm_run(cuda_device, name, "stock",
                                     schedule="cosine", warmup_steps=2)
    eager, le, _ = _trajectory(spec, b, batches, compiled=False)
    captured, lc, step = _trajectory(spec, b, batches, compiled=True)
    assert step.graph is not None and step.replays == 6
    assert lc == le
    _same_state(captured, eager)


@pytest.mark.gpu
def test_mpmd_stage_programs_captured_equal_eager(cuda_device, tmp_path):
    """Two MPMD stages on the card at M 4 (a 2-layer stacked LM on flash
    attention and fused_adam): the three stage programs captured as CUDA
    graphs (parallel/multislice.py ``export_stages``) and replayed M
    times a step give the eager engine's losses and params bit for bit,
    and each replay adds its capture's K1/K2a/K2b launches."""
    from kubeflow_tpu_torch.models import transformer as T
    from kubeflow_tpu_torch.parallel import multislice as MS
    from kubeflow_tpu_torch.runtime.recipe import make_optimizer
    cfg = T.TransformerConfig(vocab_size=512, num_layers=2, embed_dim=128,
                              num_heads=2, head_dim=64, mlp_dim=256,
                              max_seq_len=128, attention="flash")
    init, embed_fn, block_fn, head_loss_fn = T.multislice_stage_fns(cfg)
    tokens = np.random.default_rng(3).integers(0, 512, (8, 128)).astype(
        np.int32)
    runs = []
    for captured in (False, True):
        engine = MS.MPMDPipeline(
            devices=MS.stage_devices(2, cuda_device), embed_fn=embed_fn,
            block_fn=block_fn, head_loss_fn=head_loss_fn,
            optimizer=lambda p: make_optimizer(
                p, "adam", 1e-3, kernels="fused_adam")[0],
            num_microbatches=4)
        state = engine.init(init, torch.Generator().manual_seed(0))
        batch = engine.place_batch({"tokens": tokens})
        if captured:
            engine.export_stages(str(tmp_path), state, batch,
                                 lambda s, kind: f"{s}-{kind}")
            assert all(p.graph is not None
                       for p in engine.programs.values())
            before = tfa.flash_attention_bwd_dq.launches
        losses = []
        for _ in range(3):
            state, m = engine.step(state, batch)
            losses.append(m["loss"])
        if captured:
            # 4 microbatches x (stage 0's BWD + stage 1's FWDBWD) x 1 layer
            assert tfa.flash_attention_bwd_dq.launches - before == 3 * 8
        runs.append((losses, [{n: p.detach().clone() for n, p in
                               ps.items()} for ps in state.params]))
    (le, pe), (lc, pc) = runs
    assert lc == le
    for a, b in zip(pe, pc):
        for n in a:
            assert torch.equal(a[n], b[n]), n


@pytest.mark.gpu
def test_restore_and_rollback_into_captured_storage(cuda_device, tmp_path):
    """A checkpoint restore (``load_state_tree`` through the manager) and
    an LKG rollback after a NaN poison write into the storage the graph
    reads: the replays after each retrace the steps after the saved one,
    bit for bit."""
    from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager
    from kubeflow_tpu_torch.runtime.sentinel import NumericFaultHook
    spec, b, batches = _small_resnet_run(cuda_device, "momentum")
    state = b.init(spec.init_fn, torch.Generator().manual_seed(0))
    step = b.build_compiled(state, batches[0])
    for batch in batches[:2]:
        state, _ = step(state, batch)
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=1)
    mgr.save(2, state, force=True)
    mgr.wait()
    want = []
    for batch in batches[2:4]:
        state, m = step(state, batch)
        want.append(m["loss"].item())
    restored = mgr.restore(state)
    assert restored is state and state.step == 2
    got = []
    for batch in batches[2:4]:
        state, m = step(state, batch)
        got.append(m["loss"].item())
    assert got == want
    hook = NumericFaultHook("nan", 5, 1.0, None)
    state = hook.poison(state, 5)
    state, m = step(state, batches[4])
    assert not np.isfinite(m["loss"].item())
    mgr.restore(state, max_step=2)                  # the rollback
    mgr.close()
    again = []
    for batch in batches[2:4]:
        state, m = step(state, batch)
        again.append(m["loss"].item())
    assert again == want


@pytest.mark.gpu
def test_async_save_between_replays_holds_the_saved_step(cuda_device,
                                                         tmp_path):
    """The save's host copies are queued on the step's stream before the
    next replay, which overwrites the state in place: the checkpoint
    holds the saved step's values."""
    from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager
    spec, b, batches = _small_lm_run(cuda_device)
    state = b.init(spec.init_fn, torch.Generator().manual_seed(0))
    step = b.build_compiled(state, batches[0])
    for batch in batches[:2]:
        state, _ = step(state, batch)
    want = {n: p.detach().cpu() for n, p in state.params.items()}
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=1)
    mgr.save(2, state)
    for batch in batches[2:5]:
        state, _ = step(state, batch)
    mgr.wait()
    got = mgr.read_tree(2)["params"]
    mgr.close()
    for n, v in want.items():
        assert torch.equal(got[n], v), n


@pytest.mark.gpu
def test_prefetched_batches_feed_the_captured_step(cuda_device):
    """Batches staged by the DevicePrefetcher on its side stream reach
    the graph's static buffers after its event, with no host sync: the
    losses equal the eager step's on the same host batches."""
    from kubeflow_tpu_torch.data.device_prefetch import DevicePrefetcher
    spec, b, batches = _small_lm_run(cuda_device)
    host = [{k: v.cpu() for k, v in batch.items()} for batch in batches]
    _, le, _ = _trajectory(spec, b, batches, compiled=False)
    state = b.init(spec.init_fn, torch.Generator().manual_seed(0))
    step = b.build_compiled(state, batches[0])
    feed = DevicePrefetcher(iter(host), b.place_local, depth=2,
                            device=cuda_device)
    losses = []
    for batch in feed:
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    assert [x.item() for x in losses] == le


@pytest.mark.gpu
def test_k3_device_scalars_entry_matches_plain(cuda_device):
    """K3 reading (lr, bc1, bc2) from a device buffer, launched eagerly
    and replayed from a CUDA graph with the buffer rewritten between
    replays, against the plain version with the same values: within
    1e-6."""
    rng = np.random.default_rng(23)
    n = 10_007
    p, m = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
            .to(cuda_device) for _ in range(2))
    v = torch.from_numpy(np.abs(rng.standard_normal(n)).astype(
        np.float32)).to(cuda_device)
    g = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
        cuda_device)
    norm = torch.linalg.vector_norm(g)
    ref = [x.clone() for x in (p, m, v)]
    buf = torch.zeros(3, dtype=torch.float32, device=cuda_device)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, norm=norm, max_norm=1.0)

    def launch():
        tfo.fused_adam([p], [g], [m], [v], [1e-4], scalars=buf, **kw)

    values = [(1e-3 * (c + 1), *tfo.bias_corrections(0.9, 0.999, c))
              for c in range(4)]
    tfo.write_scalars(buf, values[0])
    launch()                                    # eager, and the warm-up
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        launch()
    for lr, bc1, bc2 in values[1:]:
        tfo.write_scalars(buf, (lr, bc1, bc2))
        graph.replay()
    for lr, bc1, bc2 in values:
        tfo.fused_adam_plain(ref[0], g, ref[1], ref[2], lr=lr, wd=1e-4,
                             bc1=bc1, bc2=bc2, **kw)
    torch.cuda.synchronize()
    for got, want in zip((p, m, v), ref):
        assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["lm", "resnet"])
def test_replays_add_the_captured_launches(cuda_device, model):
    """A replay does not pass through the wrappers: the step object
    records each kernel's launches in its capture (those of one eager
    step: K1, K2a, K2b 2 each and K3 1 for the 2-layer LM; K4 13 + 13
    for ResNet-50 at 64 px, whose stage-1 and -2 strips are whole
    images) and adds them to the counters at every replay; the capture
    itself counts none."""
    from kubeflow_tpu_torch.runtime.trainstep import kernel_counters
    if model == "lm":
        spec, b, batches = _small_lm_run(cuda_device)
        want = {"flash_attention": 2, "flash_attention_bwd_dq": 2,
                "flash_attention_bwd_dkv": 2, "fused_adam": 1}
    else:
        spec, b, batches = _small_resnet_run(cuda_device, "momentum")
        want = {"fused_block_train_fwd": 13, "fused_block_train_bwd": 13}
    counters = kernel_counters()
    state = b.init(spec.init_fn, torch.Generator().manual_seed(0))
    at = {n: getattr(f, a) for n, (f, a) in counters.items()}
    b.build()(b.init(spec.init_fn, None), batches[0])   # one eager step
    assert {n: getattr(f, a) - at[n] for n, (f, a) in counters.items()
            if getattr(f, a) != at[n]} == want
    at = {n: getattr(f, a) for n, (f, a) in counters.items()}
    step = b.build_compiled(state, batches[0])
    assert step.launches == want
    # the warm-up step launched once through the wrappers, the capture
    # counted nothing
    assert {n: getattr(f, a) - at[n] for n, (f, a) in counters.items()
            if getattr(f, a) != at[n]} == want
    for batch in batches[:3]:
        state, _ = step(state, batch)
    assert {n: getattr(f, a) - at[n] for n, (f, a) in counters.items()
            if getattr(f, a) != at[n]} == {k: 4 * v for k, v in want.items()}


# -- mixture-of-experts and remat (models/moe.py, TransformerConfig.remat) ---


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_layer_on_the_card_matches_the_cpu(cuda_device, dtype):
    """The MoE layer (8 experts, top-2, the capacity of 1.25) on the card
    against the same layer on the CPU, seeded: output, aux loss and the
    gradients of router, wi, wo and x. The router is f32 on both, so the
    routing is the same; f32 within 1e-5 of each tensor's largest value,
    bf16 within 3e-2 (8 bits of mantissa, products rounded in another
    order), the aux loss within 1e-5 relative."""
    from kubeflow_tpu_torch.models.moe import MoEMLP
    rng = np.random.default_rng(12)
    b, s, m, h, e = 2, 64, 32, 64, 8
    params = {"router": rng.standard_normal((m, e)),
              "wi": rng.standard_normal((e, m, h)) / np.sqrt(m),
              "wo": rng.standard_normal((e, h, m)) / np.sqrt(h)}
    x = rng.standard_normal((b, s, m)).astype(np.float32)
    r = rng.standard_normal((b, s, m)).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda_device):
        layer = MoEMLP(e, m, h, dtype=dtype).to(dev)
        with torch.no_grad():
            for k, v in params.items():
                getattr(layer, k).copy_(torch.from_numpy(
                    v.astype(np.float32)))
        xt = torch.from_numpy(x).to(dev).requires_grad_(True)
        y, aux = layer(xt)
        (torch.sum(y.float() * torch.from_numpy(r).to(dev)) + aux).backward()
        out[str(dev)] = {"y": y.float(), "aux": aux, "x": xt.grad,
                         **{k: getattr(layer, k).grad for k in params}}
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    cpu, card = out["cpu"], out[str(cuda_device)]
    assert abs(card["aux"].item() - cpu["aux"].item()) <= \
        1e-5 * abs(cpu["aux"].item())
    for k in ("y", "x", "router", "wi", "wo"):
        want = cpu[k].float()
        err = (card[k].float().cpu() - want).abs().max().item()
        assert err <= tol * want.abs().max().item(), (k, err)


def _moe_lm_builder(cuda_device, remat):
    from kubeflow_tpu_torch.models import transformer as T
    from kubeflow_tpu_torch.runtime.recipe import make_optimizer
    from kubeflow_tpu_torch.runtime.trainstep import TrainStepBuilder
    cfg = T.TransformerConfig(vocab_size=512, num_layers=2, embed_dim=128,
                              num_heads=2, head_dim=64, mlp_dim=256,
                              max_seq_len=128, attention="flash",
                              num_experts=4, remat=remat)
    spec = T.workload_spec(cfg)
    b = TrainStepBuilder(
        loss_fn=spec.loss_fn, device=cuda_device,
        optimizer=lambda p: make_optimizer(p, "adam", 1e-3,
                                           kernels="fused_adam",
                                           total_steps=6)[0])
    gen = torch.Generator().manual_seed(1)
    batches = [b.place_batch(spec.batch_fn(gen, 4)) for _ in range(6)]
    return spec, b, batches


@pytest.mark.gpu
def test_remat_launches_k1_twice_a_layer(cuda_device):
    """Under remat the backward recomputes each block's forward: K1 runs
    twice a layer a step (2 x 2 for 2 layers), K2a and K2b once, K3
    once; the losses and params are the run's without remat, bit for bit
    (the same deterministic kernels)."""
    from kubeflow_tpu_torch.runtime.trainstep import kernel_counters
    counters = kernel_counters()
    runs = {}
    for remat in (False, True):
        spec, b, batches = _moe_lm_builder(cuda_device, remat)
        state = b.init(spec.init_fn, torch.Generator().manual_seed(0))
        step = b.build()
        at = {n: getattr(f, a) for n, (f, a) in counters.items()}
        losses = []
        for batch in batches[:3]:
            state, m = step(state, batch)
            losses.append(m["loss"].item())
        torch.cuda.synchronize()
        runs[remat] = (losses, state, {
            n: getattr(f, a) - at[n] for n, (f, a) in counters.items()
            if getattr(f, a) != at[n]})
    per = {"flash_attention": 2, "flash_attention_bwd_dq": 2,
           "flash_attention_bwd_dkv": 2, "fused_adam": 1}
    assert runs[False][2] == {k: 3 * v for k, v in per.items()}
    assert runs[True][2] == {**{k: 3 * v for k, v in per.items()},
                             "flash_attention": 12}
    assert runs[False][0] == runs[True][0]
    _same_state(runs[True][1], runs[False][1])


@pytest.mark.gpu
def test_moe_remat_step_is_captured(cuda_device):
    """The MoE + remat LM step captures as one CUDA graph (the one-hots
    by comparison, no host sync; remat without RNG state) and its 6
    replays equal the eager step bit for bit."""
    spec, b, batches = _moe_lm_builder(cuda_device, True)
    eager, le, _ = _trajectory(spec, b, batches, compiled=False)
    captured, lc, step = _trajectory(spec, b, batches, compiled=True)
    assert step.graph is not None and step.replays == 6
    assert lc == le
    _same_state(captured, eager)


# -- pipeline parallelism: the microbatch shapes, GPipe ranks, MPMD stages -----

@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 2])
def test_kernels_at_the_microbatch_shapes(cuda_device, rows):
    """K1, K2a and K2b at a microbatch of the pipelined LM (batch 8 over
    M 8 or 4: [1 or 2, 2048, 12, 64] bf16 causal, the fused-qkv slices)
    against their plain versions, one launch each."""
    g = torch.Generator(device="cpu").manual_seed(21)
    qkv = torch.randn(rows, 2048, 3, 12, 64, generator=g).to(
        cuda_device, torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    counts = (tfa.flash_attention, tfa.flash_attention_bwd_dq,
              tfa.flash_attention_bwd_dkv)
    before = [c.launches for c in counts]
    o, lse = tfa.flash_attention(q, k, v, causal=True, with_lse=True)
    do = torch.randn(rows, 2048, 12, 64, generator=g).to(cuda_device,
                                                         torch.bfloat16)
    delta = tfa.attention_delta(o, do)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    dkv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counts, before)] == [1, 1, 1]
    _check_fwd(q, k, v, o, lse, True)
    assert _close(dq, tfa.flash_attention_bwd_dq_plain(q, k, v, do, lse,
                                                       delta),
                  torch.bfloat16)
    _check_dkv(q, k, v, do, True, dkv, lse, delta)


PP_CFG = dict(vocab_size=256, num_layers=4, embed_dim=64, num_heads=4,
              head_dim=16, mlp_dim=128, max_seq_len=96, attention="flash")


def _pp_rank_step(rank, world):
    """One {pipeline world} step of the 4-layer pipelined LM (M 2, flash,
    fused Adam) on the card: the metrics, this rank's launches and its
    point-to-point calls, each staged through host memory by gloo."""
    from kubeflow_tpu_torch.api.trainingjob import ShardingSpec
    from kubeflow_tpu_torch.models import transformer as T
    from kubeflow_tpu_torch.parallel import collectives
    from kubeflow_tpu_torch.parallel.mesh import build_mesh
    from kubeflow_tpu_torch.runtime.recipe import make_optimizer
    from kubeflow_tpu_torch.runtime.trainstep import TrainStepBuilder
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = build_mesh(ShardingSpec(pipeline=world)) if world > 1 else None
    spec = T.pipelined_workload_spec(T.TransformerConfig(**PP_CFG),
                                     mesh=mesh, num_microbatches=2)
    builder = TrainStepBuilder(
        loss_fn=spec.loss_fn, device=torch.device("cuda", 0), mesh=mesh,
        rules=spec.rules, param_logical_axes=spec.param_logical_axes,
        optimizer=lambda p: make_optimizer(p, "adam", 1e-3,
                                           kernels="fused_adam")[0])
    state = builder.init(spec.init_fn, torch.Generator().manual_seed(0))
    batch = builder.place_batch(
        spec.batch_fn(torch.Generator().manual_seed(1), 4))
    counts = (tfa.flash_attention, tfa.flash_attention_bwd_dq,
              tfa.flash_attention_bwd_dkv, tfo.fused_adam)
    before = [c.launches for c in counts]
    collectives.reset_counts()
    state, m = builder.build()(state, batch)
    torch.cuda.synchronize()
    return {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
            "launches": [c.launches - b for c, b in zip(counts, before)],
            "p2p": [(collectives.calls[op], collectives.host_staged[op])
                    for op in ("send", "recv")]}


@pytest.mark.gpu
def test_gpipe_ranks_on_the_card_match_one_process(cuda_device):
    """Two gloo ranks on the card, {pipeline 2}, M 2, against one process:
    each rank launches K1, K2a and K2b M·L/S = 4 times and K3 once; loss
    within 1e-3 and grad norm within 1e-2, relative (chip_smoke.py phase
    8's bars); each rank's 2 sends and 2 receives staged through host
    memory."""
    from test_torch_dp import spawn
    one = _pp_rank_step(0, 1)
    assert one["launches"] == [4, 4, 4, 1] and one["p2p"] == [(0, 0)] * 2
    for out in spawn(_pp_rank_step, 2):
        assert out["launches"] == [4, 4, 4, 1]
        assert out["p2p"] == [(2, 2), (2, 2)]
        np.testing.assert_allclose(out["loss"], one["loss"], rtol=1e-3)
        np.testing.assert_allclose(out["grad_norm"], one["grad_norm"],
                                   rtol=1e-2)


@pytest.mark.gpu
def test_mpmd_step_launches_on_the_card(cuda_device):
    """The MPMD stages on the one card (M 4, 4 layers, 2 a stage): a step
    launches K1 3·M·L/S = 24 times (stage 0's forward and its recompute,
    stage 1's fused step), K2a and K2b M·L = 16, K3 once a stage; no
    collective; 12 transfers, the tokens as int32; the loss within 1e-3
    of the one-process pipelined step's."""
    from kubeflow_tpu_torch.models import transformer as T
    from kubeflow_tpu_torch.parallel import collectives
    from kubeflow_tpu_torch.runtime.recipe import make_optimizer
    from kubeflow_tpu_torch.runtime.trainstep import \
        MultisliceTrainStepBuilder
    cfg = T.TransformerConfig(**PP_CFG)
    spec = T.pipelined_workload_spec(cfg)
    builder = MultisliceTrainStepBuilder(
        cfg=cfg, num_slices=2, num_microbatches=4, device=cuda_device,
        optimizer=lambda p: make_optimizer(
            p, "adam", 1e-3, kernels="fused_adam")[0])
    state = builder.init(spec.init_fn, torch.Generator().manual_seed(0))
    assert all(p.is_cuda for s in state.params for p in s.values())
    batch = builder.place_batch(
        spec.batch_fn(torch.Generator().manual_seed(1), 4))
    counts = (tfa.flash_attention, tfa.flash_attention_bwd_dq,
              tfa.flash_attention_bwd_dkv, tfo.fused_adam)
    before = [c.launches for c in counts]
    collectives.reset_counts()
    state, m = builder.build()(state, batch)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counts, before)] == \
        [24, 16, 16, 2]
    assert not any(collectives.calls.values())
    rep = builder.last_report
    act = 1 * 96 * 64 * 2                 # a bf16 row of the boundary
    assert (rep.dcn_transfers, rep.dcn_bytes) == (12, 4 * (2 * act + 96 * 4))
    one = _pp_rank_step(0, 1)
    np.testing.assert_allclose(m["loss"], one["loss"], rtol=1e-3)


def _ring_rank(rank, world):
    """One {sequence world} rank on the card: the ring on its chunks of
    a seeded [2, 512, 4, 64] bf16 causal Q/K/V, and the gathered
    sequence's K1 output at its rows; its K1 launches and its hops."""
    import importlib as il
    from kubeflow_tpu_torch.api.trainingjob import ShardingSpec
    from kubeflow_tpu_torch.parallel import collectives
    from kubeflow_tpu_torch.parallel.mesh import build_mesh
    ra = il.import_module("kubeflow_tpu_torch.ops.ring_attention")
    dev = torch.device("cuda", 0)
    mesh = build_mesh(ShardingSpec(sequence=world))
    q, k, v = _qkv(2, 512, 4, 64, dev, torch.bfloat16, seed=16)
    c = 512 // world
    at = mesh.chunk_offset(c)
    mine = [t[:, at:at + c].contiguous() for t in (q, k, v)]
    before = tfa.flash_attention.launches
    collectives.reset_counts()
    with torch.no_grad():
        ring = ra.ring_attention(*mine, mesh=mesh)
    torch.cuda.synchronize()
    launches = tfa.flash_attention.launches - before
    hops = (collectives.calls["send"], collectives.calls["recv"])
    with torch.no_grad():
        whole = tfa.flash_attention(q, k, v, causal=True)[:, at:at + c]
    return {"ring": ring.float().cpu().numpy(),
            "k1": whole.float().cpu().numpy(), "launches": launches,
            "hops": hops}


@pytest.mark.gpu
def test_ring_on_the_card_matches_the_gathered_k1(cuda_device):
    """Two gloo ranks on the card, {sequence 2}: each rank's ring output
    (f32 blocks, no K1 launch, one hop each way) against the gathered
    sequence's K1 output at its rows, within one bf16 step of the value
    plus 1e-2 (chip_smoke.py phase 14c's bar)."""
    from test_torch_dp import spawn
    for out in spawn(_ring_rank, 2):
        assert out["launches"] == 0 and out["hops"] == (1, 1)
        bar = 1e-2 + 2.0 ** -7 * np.abs(out["k1"])
        assert (np.abs(out["ring"] - out["k1"]) <= bar).all()


@pytest.mark.gpu
def test_nccl_comes_up_from_a_rendered_gpu_pod(cuda_device):
    """The training-job reconciler renders an h100-1 job's pod; with its
    coordinator address pointed at 127.0.0.1 and a free port (the pod's
    DNS name resolves only in a cluster, and the rendered port is the
    reconciler's fixed COORD_PORT, which another run may hold; that is
    the only edit), initialize() brings
    up NCCL at world 1 on this card with a one-device mesh, an
    all_reduce runs, and shutdown() takes the group down (chip_smoke.py
    phase 16c)."""
    import socket

    import torch.distributed as dist

    from kubeflow_tpu_torch.cluster.fake import FakeCluster
    from kubeflow_tpu_torch.controllers.runtime import Manager
    from kubeflow_tpu_torch.controllers.tpujob import (
        COORD_PORT, TrainingJobReconciler)
    from kubeflow_tpu_torch.runtime import bootstrap
    cluster = FakeCluster()
    cluster.add_gpu_nodes("h100-1", product=torch.cuda.get_device_name())
    mgr = Manager(cluster)
    mgr.add(TrainingJobReconciler("TPUJob"))
    cluster.create({
        "apiVersion": "tpu.kubeflow.org/v1alpha1", "kind": "TPUJob",
        "metadata": {"name": "boot", "namespace": "test"},
        "spec": {"replicaSpecs": {"GPU": {
            "gpuTopology": "h100-1", "template": {"spec": {"containers": [
                {"name": "trainer", "image": "trainer:v1"}]}}}}}})
    mgr.run_pending()
    (pod,) = cluster.list("v1", "Pod", "test")
    env = {e["name"]: e["value"]
           for e in pod["spec"]["containers"][0]["env"]}
    assert pod["spec"]["containers"][0]["resources"]["limits"] == \
        {"nvidia.com/gpu": 1}
    coord = env["KFTPU_COORDINATOR_ADDRESS"]
    host, port = coord.rsplit(":", 1)
    assert port == env["MASTER_PORT"] == str(COORD_PORT)
    assert env["MASTER_ADDR"] == host
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        local = str(s.getsockname()[1])
    env = {k: v.replace(coord, f"127.0.0.1:{local}").replace(
        host, "127.0.0.1") for k, v in env.items()}
    env["MASTER_PORT"] = local
    assert env["KFTPU_COORDINATOR_ADDRESS"] == f"127.0.0.1:{local}"
    ctx = bootstrap.initialize(env, strict=True)
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        assert ctx.device.type == "cuda" and ctx.mesh.size() == 1
        assert ctx.contract.topology == "h100-1"
        x = torch.arange(8.0, device=ctx.device)
        y = x.clone()
        dist.all_reduce(y)
        torch.cuda.synchronize()
        assert torch.equal(x, y)
    finally:
        bootstrap.shutdown(ctx)
    assert not dist.is_initialized()


@pytest.mark.gpu
def test_health_soak_evacuates_the_flaky_node_on_the_card(cuda_device,
                                                          tmp_path):
    """The slice scheduler's health soak on the card (chip_smoke.py phase
    17c at the tiny LM): the chief trains through K1, K2a, K2b and K3
    (one launch a layer, and one a step), the flaky node is quarantined
    after the first crash, the gang is evacuated to pool-b within one
    rebind, and the final params are the clean run's within 1e-5."""
    from kubeflow_tpu_torch.cluster.chaos import final_params
    from kubeflow_tpu_torch.scheduler.soak import HealthSoak
    run = dict(kernel_attention="flash", kernel_optimizer="fused_adam",
               optimizer="adam")
    kernels = (tfa.flash_attention, tfa.flash_attention_bwd_dq,
               tfa.flash_attention_bwd_dkv, tfo.fused_adam)
    for k in kernels:
        k.launches = 0
    soak = HealthSoak(workdir=str(tmp_path), train_kwargs=run,
                      total_steps=6)
    report = soak.run()
    assert report["outcome"] == "succeeded", report
    assert (report["fires"], report["rebinds"], report["migrated"],
            report["flaky_quarantined"]) == (1, 1, True, True)
    launches = [k.launches for k in kernels]
    layers = launches[0] // report["executed_steps"]
    assert layers >= 1 and launches == [
        layers * report["executed_steps"]] * 3 + [report["executed_steps"]]
    clean = soak.clean_params()
    got = final_params(report["checkpoint_dir"])
    assert got.keys() == clean.keys()
    assert max(float((got[k] - clean[k]).abs().max()) for k in got) <= 1e-5


@pytest.mark.gpu
def test_control_plane_soak_trains_through_the_kernels_on_the_card(
        cuda_device, tmp_path):
    """The HA control plane's soak on the card (chip_smoke.py phase 18a at
    the tiny LM): operator and scheduler leaders killed right after a
    write lands and the apiserver partitioned while the chief trains
    through K1, K2a, K2b and K3 (one launch a layer, and one a step);
    Succeeded, every failover at least its kill, no pod created twice, no
    write from a replica that never led, and the clean run's params."""
    from kubeflow_tpu_torch.cluster.chaos import final_params
    from kubeflow_tpu_torch.scheduler.soak import ControlPlaneSoak
    run = dict(kernel_attention="flash", kernel_optimizer="fused_adam",
               optimizer="adam")
    kernels = (tfa.flash_attention, tfa.flash_attention_bwd_dq,
               tfa.flash_attention_bwd_dkv, tfo.fused_adam)
    for k in kernels:
        k.launches = 0
    soak = ControlPlaneSoak(workdir=str(tmp_path), train_kwargs=run,
                            total_steps=5, operator_kills=1,
                            scheduler_kills=1, partitions=1)
    report = soak.run()
    assert report["outcome"] == "succeeded", report
    assert report["failovers"]["operator"] >= 1
    assert report["failovers"]["scheduler"] >= 1
    assert report["partitions"] == 1 and "skipped" not in report
    assert (report["duplicate_pod_creates"],
            report["lost_annotation_writes"],
            report["never_leader_mutations"]) == (0, False, 0)
    launches = [k.launches for k in kernels]
    layers = launches[0] // report["executed_steps"]
    assert layers >= 1 and launches == [
        layers * report["executed_steps"]] * 3 + [report["executed_steps"]]
    clean = soak.clean_params()
    got = final_params(report["checkpoint_dir"])
    assert got.keys() == clean.keys()
    assert max(float((got[k] - clean[k]).abs().max()) for k in got) == 0.0


@pytest.mark.gpu
def test_split_brain_drill_fences_the_deposed_leader_on_the_card(
        cuda_device):
    """The split-brain drill on the card's machine (chip_smoke.py phase
    18b): the partitioned leader demotes, its write is fenced and never
    lands, and no pod is created twice."""
    from kubeflow_tpu_torch.scheduler.soak import split_brain_drill
    report = split_brain_drill(0.4)
    assert report["stolen_by_standby"] and report["old_leader_demoted"]
    assert report["fenced_write_rejected"]
    assert report["old_leader_writes_after_steal"] == 0
    assert not report["zombie_write_landed"]
    assert report["doubled_pod_creates"] == 0
