"""PyTorch port on the card: each hand-written CUDA kernel against its
plain version on CUDA tensors, and the launch counters. Marked ``gpu``;
every test skips (with its reason) where no CUDA device is present. Run on
a machine with an NVIDIA H100:

    python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances as in chip_smoke.py: fp32 2e-5 (rca_fused) and 1e-5 (mha, with
and without dropout);
the backward kernels 5e-5 (1 + |x|) in fp32 (the JAX package's backward
bar), and one bf16 ulp + 2e-3 of the tensor's largest |x| for bf16
gradients."""

import types

import pytest
import torch

from garbage_classification_rca_tpu_torch.kernels import mha_fused, rca_fused
from garbage_classification_rca_tpu_torch.ops.attention import AttentionUnit

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        yield torch.device("cuda")


@pytest.mark.parametrize("b", [13, 128])
@pytest.mark.parametrize("reverse", [False, True])
def test_rca_fused_kernel_matches_plain(cuda, b, reverse):
    g = torch.Generator().manual_seed(b)
    p = types.SimpleNamespace(**{
        n: AttentionUnit(*geo, generator=g).to(cuda)
        for n, geo in zip(rca_fused.UNITS, rca_fused._GEOM)})
    t = torch.randn((b, 16, 48), generator=g).to(cuda)
    i = torch.randn((b, 16, 80), generator=g).to(cuda)
    before = rca_fused.rca_fused.launches
    got = rca_fused.rca_fused(p, t, i, reverse=reverse)
    torch.cuda.synchronize()
    assert rca_fused.rca_fused.launches == before + 1
    want = rca_fused.rca_fused_reference(p, t, i, reverse=reverse)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,n,causal", [(128, 64, False), (4, 512, False),
                                        (3, 100, True)])
def test_mha_kernel_matches_plain(cuda, b, n, causal):
    g = torch.Generator().manual_seed(n)
    q, k, v = (torch.randn((b, n, 768), generator=g).to(cuda)
               for _ in range(3))
    lens = torch.randint(1, n + 1, (b,), generator=g)
    m = (torch.arange(n)[None] < lens[:, None]).to(torch.int32).to(cuda)
    before = mha_fused.mha.launches
    got = mha_fused.mha(q, k, v, heads=12, mask=m, causal=causal)
    torch.cuda.synchronize()
    assert mha_fused.mha.launches == before + 1
    want = mha_fused.mha_reference(q, k, v, heads=12, mask=m, causal=causal)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _grad_close(got, want, dtype):
    g, w = got.float(), want.float()
    if dtype == torch.float32:
        tol = 5e-5 * (1.0 + w.abs())
    else:
        e = torch.floor(torch.log2(torch.maximum(g.abs(), w.abs())
                                   .clamp_min(2.0 ** -126)))
        tol = torch.pow(2.0, e - 7) + 2e-3 * float(w.abs().max())
    assert bool(((g - w).abs() <= tol).all()), float((g - w).abs().max())


@pytest.mark.parametrize("b", [13, 16])
@pytest.mark.parametrize("i_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_rca_fused_bwd_kernel_matches_plain(cuda, b, i_dtype, reverse):
    g = torch.Generator().manual_seed(b + 100)
    p = types.SimpleNamespace(**{
        n: AttentionUnit(*geo, generator=g).to(cuda)
        for n, geo in zip(rca_fused.UNITS, rca_fused._GEOM)})
    t = torch.randn((b, 16, 48), generator=g).to(cuda)
    i = torch.randn((b, 16, 80), generator=g).to(cuda, i_dtype)
    gt, gi = (torch.randn((b, 16, 48), generator=g).to(cuda)
              for _ in range(2))
    before = rca_fused.rca_fused_bwd.launches
    got = rca_fused.rca_fused_bwd(p, t, i, gt, gi, reverse=reverse)
    torch.cuda.synchronize()
    assert rca_fused.rca_fused_bwd.launches == before + 1
    want = rca_fused.rca_fused_bwd_reference(p, t, i, gt, gi,
                                             reverse=reverse)
    assert got[1].dtype == i_dtype
    _grad_close(got[0], want[0], torch.float32)
    _grad_close(got[1], want[1], i_dtype)
    for x, y in zip(got[2], want[2]):
        _grad_close(x, y, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,causal", [(16, 64, False), (4, 512, False),
                                        (3, 100, True)])
def test_mha_train_kernels_match_plain(cuda, b, n, causal, dtype):
    g = torch.Generator().manual_seed(n + 7)
    q, k, v, do = (torch.randn((b, n, 768), generator=g).to(cuda, dtype)
                   for _ in range(4))
    lens = torch.randint(1, n + 1, (b,), generator=g)
    m = (torch.arange(n)[None] < lens[:, None]).to(torch.int32).to(cuda)
    before = (mha_fused.mha_fwd_lse.launches,
              mha_fused.mha_flash_bwd.launches)
    o, lse = mha_fused.mha_fwd_lse(q, k, v, heads=12, mask=m, causal=causal)
    grads = mha_fused.mha_flash_bwd(q, k, v, o, do, lse, heads=12, mask=m,
                                    causal=causal)
    torch.cuda.synchronize()
    assert (mha_fused.mha_fwd_lse.launches,
            mha_fused.mha_flash_bwd.launches) == (before[0] + 1,
                                                  before[1] + 1)
    o_w, lse_w = mha_fused.mha_fwd_lse_reference(q, k, v, heads=12, mask=m,
                                                 causal=causal)
    torch.testing.assert_close(lse, lse_w, rtol=1e-5, atol=1e-5)
    if dtype == torch.float32:
        torch.testing.assert_close(o, o_w, rtol=1e-5, atol=1e-5)
    else:
        _grad_close(o, o_w, dtype)
    want = mha_fused.mha_flash_bwd_reference(q, k, v, o, do, lse, heads=12,
                                             mask=m, causal=causal)
    for x, y in zip(grads, want):
        _grad_close(x, y, dtype)


def test_train_wrappers_launch_their_kernels(cuda):
    """Under autograd the training wrappers launch K1 + K3 and K4a + K4b."""
    g = torch.Generator().manual_seed(3)
    p = types.SimpleNamespace(**{
        n: AttentionUnit(*geo, generator=g).to(cuda)
        for n, geo in zip(rca_fused.UNITS, rca_fused._GEOM)})
    t = torch.randn((4, 16, 48), generator=g).to(cuda).requires_grad_()
    i = torch.randn((4, 16, 80), generator=g).to(cuda, torch.bfloat16)
    q = torch.randn((2, 64, 768), generator=g).to(cuda).requires_grad_()
    counts = lambda: (rca_fused.rca_fused.launches,
                      rca_fused.rca_fused_bwd.launches,
                      mha_fused.mha_fwd_lse.launches,
                      mha_fused.mha_flash_bwd.launches)
    before = counts()
    with torch.enable_grad():
        ti, it = rca_fused.rca_fused_trainable(p, t, i.requires_grad_(),
                                               reverse=True)
        o = mha_fused.mha_flash_train(q, q, q, heads=12)
        (ti.sum() + it.sum() + o.sum()).backward()
    torch.cuda.synchronize()
    assert counts() == tuple(c + 1 for c in before)
    assert t.grad is not None and i.grad.dtype == torch.bfloat16
    assert p.rca_it.k.w.grad is not None and q.grad is not None


@pytest.mark.parametrize("shape,heads,dtype", [
    ((2, 64, 768), 12, torch.float16), ((2, 513, 768), 12, torch.float32),
    ((2, 8, 96), 2, torch.float32)])
def test_flash_train_raises_on_cuda_misfit(cuda, shape, heads, dtype):
    """On the card a shape or dtype the flash kernels do not take raises;
    only CPU tensors go through the plain version."""
    q = torch.zeros(shape, dtype=dtype, device=cuda, requires_grad=True)
    before = mha_fused.mha_fwd_lse.launches
    with torch.enable_grad(), pytest.raises(ValueError):
        mha_fused.mha_flash_train(q, q, q, heads=heads)
    assert mha_fused.mha_fwd_lse.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,masked,causal,p", [
    (16, 64, True, False, 0.1), (3, 197, False, False, 0.1),
    (5, 50, True, True, 0.5), (2, 512, True, False, 0.1)])
def test_mha_dropout_kernels_match_plain(cuda, b, n, masked, causal, p,
                                         dtype):
    """K7a / K7b against their plain versions on the same keep mask, with a
    fully masked sample and a fully dropped row."""
    from garbage_classification_rca_tpu_torch.nn.core import Key

    g = torch.Generator().manual_seed(n + 11)
    q, k, v, do = (torch.randn((b, n, 768), generator=g).to(cuda, dtype)
                   for _ in range(4))
    m = None
    if masked:
        lens = torch.randint(1, n + 1, (b,), generator=g)
        m = (torch.arange(n)[None] < lens[:, None]).to(torch.int32)
        m[-1] = 0
        m = m.to(cuda)
    dm = mha_fused.drop_keep_mask(Key(n), p, b, 12, n, cuda)
    assert torch.equal(dm, mha_fused.drop_keep_mask(Key(n), p, b, 12, n,
                                                    cuda))
    dm[0, 0, 1] = 0
    before = (mha_fused.mha_fwd_lse_drop.launches,
              mha_fused.mha_flash_bwd_drop.launches)
    kw = dict(heads=12, keep=1.0 - p, mask=m, causal=causal)
    o, lse = mha_fused.mha_fwd_lse_drop(q, k, v, dm, **kw)
    grads = mha_fused.mha_flash_bwd_drop(q, k, v, o, do, lse, dm, **kw)
    torch.cuda.synchronize()
    assert (mha_fused.mha_fwd_lse_drop.launches,
            mha_fused.mha_flash_bwd_drop.launches) == (before[0] + 1,
                                                       before[1] + 1)
    o_w, lse_w = mha_fused.mha_fwd_lse_drop_reference(q, k, v, dm, **kw)
    torch.testing.assert_close(lse, lse_w, rtol=1e-5, atol=1e-5)
    if dtype == torch.float32:
        torch.testing.assert_close(o, o_w, rtol=1e-5, atol=1e-5)
    else:
        _grad_close(o, o_w, dtype)
    want = mha_fused.mha_flash_bwd_drop_reference(q, k, v, o, do, lse, dm,
                                                  **kw)
    for x, y in zip(grads, want):
        assert bool(torch.isfinite(x).all())
        _grad_close(x, y, dtype)


def test_dropout_train_wrapper_launches_and_raises_on_cuda_misfit(cuda):
    from garbage_classification_rca_tpu_torch.nn.core import Key

    g = torch.Generator().manual_seed(5)
    q = torch.randn((2, 64, 768), generator=g).to(cuda).requires_grad_()
    counts = lambda: (mha_fused.mha_fwd_lse_drop.launches,
                      mha_fused.mha_flash_bwd_drop.launches,
                      mha_fused.mha_fwd_lse.launches)
    before = counts()
    with torch.enable_grad():
        mha_fused.mha_flash_train_dropout(q, q, q, heads=12, key=Key(1),
                                          p=0.1).sum().backward()
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 1, before[2])
    assert bool(torch.isfinite(q.grad).all())
    for shape, heads, dtype in (((2, 64, 768), 12, torch.float16),
                                ((2, 513, 768), 12, torch.float32),
                                ((2, 8, 96), 2, torch.float32)):
        x = torch.zeros(shape, dtype=dtype, device=cuda, requires_grad=True)
        with torch.enable_grad(), pytest.raises(ValueError):
            mha_fused.mha_flash_train_dropout(x, x, x, heads=heads,
                                              key=Key(1), p=0.1)
    assert counts()[0] == before[0] + 1


# ---------------------------------------------------------------------------
# the fused transformer blocks (csrc/transformer_block.cu)
# ---------------------------------------------------------------------------


def _block_inputs(b, n, d, ffn, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=1.0: (torch.randn(s, generator=g) * scale)
    w = lambda *s: r(*s, scale=s[0] ** -0.5).to(device, dtype)
    vec = lambda k: r(k, scale=0.1).to(device, dtype)
    x = r(b, n, d).to(device, dtype)
    ls = (1.0 + r(d, scale=0.1)).to(device, dtype)
    lb = vec(d)
    attn = (w(d, 3 * d), vec(3 * d), w(d, d), vec(d))
    mlp = (w(d, ffn), vec(ffn), w(ffn, d), vec(d))
    lens = torch.randint(1, n + 1, (b,), generator=g)
    m = (torch.arange(n)[None] < lens[:, None]).to(torch.int32)
    m[0] = 0                                  # a fully masked row
    return x, ls, lb, attn, mlp, m.to(device)


def _block_close(got, want, dtype):
    """fp32: |d| <= 2e-5 + 2e-5 |x| (summation order only). bf16: one ulp
    of the value + 1e-2 of the tensor's largest |x| (a q/k/v, weight or
    hidden element rounded to the neighbouring bf16 value moves the sums
    it enters)."""
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all())
    if dtype == torch.float32:
        tol = 2e-5 + 2e-5 * w.abs()
    else:
        e = torch.floor(torch.log2(torch.maximum(g.abs(), w.abs())
                                   .clamp_min(2.0 ** -126)))
        tol = torch.pow(2.0, e - 7) + 1e-2 * float(w.abs().max())
    assert bool(((g - w).abs() <= tol).all()), float((g - w).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,d,heads,ffn", [
    (5, 64, 768, 12, 3072), (3, 17, 128, 2, 272), (2, 197, 768, 12, 3072),
    (2, 50, 1024, 16, 4096)])
def test_transformer_block_kernels_match_plain(cuda, b, n, d, heads, ffn,
                                               dtype):
    from garbage_classification_rca_tpu_torch.kernels import (
        transformer_block as tb)

    x, ls, lb, attn, mlp, m = _block_inputs(b, n, d, ffn, dtype, cuda,
                                            n + d)
    fns = (tb.postnorm_attn_block, tb.postnorm_mlp_block, tb.attn_block,
           tb.mlp_block)
    before = [f.launches for f in fns]
    got = [tb.postnorm_attn_block(x, m, *attn, ls, lb, heads=heads),
           tb.postnorm_mlp_block(x, *mlp, ls, lb),
           tb.attn_block(x, ls, lb, *attn, heads=heads),
           tb.mlp_block(x, ls, lb, *mlp),
           tb.mlp_block(x, ls, lb, *mlp, act="relu")]
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [c + k for c, k in
                                         zip(before, (1, 1, 1, 2))]
    want = [tb.postnorm_attn_block_reference(x, m, *attn, ls, lb,
                                             heads=heads),
            tb.postnorm_mlp_block_reference(x, *mlp, ls, lb),
            tb.attn_block_reference(x, ls, lb, *attn, heads=heads),
            tb.mlp_block_reference(x, ls, lb, *mlp),
            tb.mlp_block_reference(x, ls, lb, *mlp, act="relu")]
    for a, c in zip(got, want):
        _block_close(a, c, dtype)


def test_transformer_blocks_raise_on_cuda_misfit(cuda):
    """On the card a shape the kernels do not take raises; so does a call
    that would need a gradient (the kernels are forward only)."""
    from garbage_classification_rca_tpu_torch.kernels import (
        transformer_block as tb)

    x, ls, lb, attn, mlp, m = _block_inputs(2, 16, 96, 64, torch.float32,
                                            cuda, 0)
    with pytest.raises(ValueError, match="head dim"):
        tb.attn_block(x, ls, lb, *attn, heads=3)          # head dim 32
    x, ls, lb, attn, mlp, m = _block_inputs(1, 225, 128, 64, torch.float32,
                                            cuda, 0)
    with pytest.raises(ValueError, match="N <= 224"):
        tb.postnorm_attn_block(x, m, *attn, ls, lb, heads=2)
    x, ls, lb, attn, mlp, m = _block_inputs(1, 8, 128, 64, torch.float32,
                                            cuda, 0)
    with torch.enable_grad(), pytest.raises(RuntimeError,
                                            match="forward-only"):
        tb.mlp_block(x.requires_grad_(), ls, lb, *mlp)
