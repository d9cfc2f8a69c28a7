"""PyTorch port on the card: each hand-written CUDA kernel against its
plain version on CUDA tensors, and the launch counters. Marked ``gpu``;
every test skips (with its reason) where no CUDA device is present. Run on
a machine with an NVIDIA H100:

    python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances as in chip_smoke.py: fp32 2e-5 (rca_fused) and 1e-5 (mha, with
and without dropout);
the backward kernels 5e-5 (1 + |x|) in fp32 (the JAX package's backward
bar), and one bf16 ulp + 2e-3 of the tensor's largest |x| for bf16
gradients. The flash pair's tensor-core route sums S in another order
than the plain version: its bf16 output is held to one ulp + the larger of
1e-3 and one weight's rounding move (``_out_close``), and at N = 1, where
dQ and dK are zero in exact arithmetic, to the rounding of the two dot
products they come from (``_single_key_close``). K2's tensor-core route
(bf16, head dim 64, N <= 256; head dims 88 / 80, N <= 272 / 256, with K4a
at 80) is held to ``mha_reference`` the same way, and the tensor-core K4b
at head dim 80 to the bf16 gradient bar as at 64;
the fp32 training pair's 3xTF32 route (K4a / K7a and K4b / K7b at head
dim 64, N <= 64) to the fp32 bars (1e-5 + 1e-5 |x| forward, 5e-5 (1 + |x|)
backward), its outputs bit-identical over two runs. K1's and K3's staged
routes are held to their bars and, with ``torch.equal``, to their
per-sample routes."""

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


# (t, i, weights) dtypes: fp32, bf16 (the eval path), the train mix, and
# the train mix with bf16 weights
RCA_FWD_DTYPES = {"fp32": (torch.float32,) * 3, "bf16": (torch.bfloat16,) * 3,
                  "train": (torch.float32, torch.bfloat16, torch.float32),
                  "bf16_weights": (torch.float32, torch.bfloat16,
                                   torch.bfloat16)}


@pytest.mark.parametrize("b", [1, 13, 16, 128])
@pytest.mark.parametrize("dtypes", list(RCA_FWD_DTYPES))
@pytest.mark.parametrize("reverse", [False, True])
def test_rca_fused_routes_bit_identical(cuda, b, dtypes, reverse):
    """K1's staged route (the default) against the plain version at its
    bars (fp32 2e-5 (1 + |x|); bf16 outputs one ulp + 1e-5), and against
    the per-sample route (the first version) bit for bit; each call counts one
    launch of its own route."""
    t_dt, i_dt, w_dt = RCA_FWD_DTYPES[dtypes]
    g = torch.Generator().manual_seed(b + 300)
    p = types.SimpleNamespace(**{
        n: AttentionUnit(*geo, generator=g).to(cuda, w_dt)
        for n, geo in zip(rca_fused.UNITS, rca_fused._GEOM)})
    t = torch.randn((b, 16, 48), generator=g).to(cuda, t_dt)
    i = torch.randn((b, 16, 80), generator=g).to(cuda, i_dt)
    before = dict(rca_fused.rca_fused.route_launches)
    got = rca_fused.rca_fused(p, t, i, reverse=reverse)
    assert rca_fused.rca_fused.route_launches == {
        "staged": before["staged"] + 1, "per_sample": before["per_sample"]}
    old = rca_fused.rca_fused(p, t, i, reverse=reverse, route="per_sample")
    torch.cuda.synchronize()
    assert rca_fused.rca_fused.route_launches == {
        "staged": before["staged"] + 1,
        "per_sample": before["per_sample"] + 1}
    want = rca_fused.rca_fused_reference(p, t, i, reverse=reverse)
    for x, y, z in zip(got, old, want):
        assert x.dtype == t_dt and torch.equal(x, y)
        if t_dt == torch.float32:
            torch.testing.assert_close(x, z, rtol=2e-5, atol=2e-5)
        else:
            e = torch.floor(torch.log2(torch.maximum(
                x.float().abs(), z.float().abs()).clamp_min(2.0 ** -126)))
            tol = torch.pow(2.0, e - 7) + 1e-5
            assert bool(((x.float() - z.float()).abs() <= tol).all())


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


# K2 at the VLM's head dims, the eval forward only: EVA ViT-g (16 heads of
# 88, N 257, no mask) and OPT-2.7B (32 heads of 80, N 132, causal with a
# left-pad key mask; sample 0 all pad, sample 1 one valid key)
VLM_SHAPES = {"eva": (3, 257, 1408, 16, False), "opt": (3, 132, 2560, 32, True)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(VLM_SHAPES))
def test_mha_kernel_at_vlm_head_dims_matches_plain(cuda, name, dtype):
    """The CUDA-core K2 (fp32's route, bf16's on request): fp32 |d| <=
    1e-5 + 1e-5 |x|; bf16 one ulp + 1e-3; one launch on the CUDA-core
    route; the flash pair refuses head dim 88 (EVA never trains; OPT's 80
    is held below). bf16's default route, the tensor cores, is held in
    ``test_mha_tc_route_at_vlm_head_dims_matches_plain``."""
    b, n, d, heads, causal = VLM_SHAPES[name]
    g = torch.Generator().manual_seed(n)
    q, k, v = (torch.randn((b, n, d), generator=g).to(cuda, dtype)
               for _ in range(3))
    m = None
    if causal:
        pad = torch.tensor([n, n - 1, 40])[:, None]      # left pads a row
        m = (torch.arange(n)[None] >= pad).to(torch.int32).to(cuda)
    before = dict(mha_fused.mha.route_launches)
    got = mha_fused.mha(q, k, v, heads=heads, mask=m, causal=causal,
                        route="cuda_core")
    torch.cuda.synchronize()
    assert mha_fused.mha.route_launches == {
        **before, "cuda_core": before["cuda_core"] + 1}
    want = mha_fused.mha_reference(q, k, v, heads=heads, mask=m,
                                   causal=causal)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        g_, w_ = got.float(), want.float()
        e = torch.floor(torch.log2(torch.maximum(g_.abs(), w_.abs())
                                   .clamp_min(2.0 ** -126)))
        assert bool(((g_ - w_).abs() <= torch.pow(2.0, e - 7) + 1e-3).all())
    if d // heads == 88:
        with pytest.raises(ValueError, match="head dim"):
            mha_fused.mha_fwd_lse(q, k, v, heads=heads, mask=m,
                                  causal=causal)


@pytest.mark.parametrize("n", [136, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_pair_at_head_dim_80_matches_plain(cuda, dtype, n):
    """K4a / K4b at OPT-2.7B's LoRA training shape (32 heads of 80, N 136
    = 32 query tokens + 100 prompt + 4 label tokens, causal with a
    left-pad key mask; sample 0 all pad, sample 1 one valid key) and at
    N = 1, on the CUDA cores (fp32's plan, bf16's on request): out / lse
    at the forward bars, dQ / dK / dV at the backward bars (bf16 dQ / dK
    at N = 1, zero in exact arithmetic, at ``_single_key_close``'s); one
    launch of each. bf16's default pair, the tensor cores, is held in
    ``test_flash_pair_tc_forward_at_head_dim_80_matches_plain`` and
    ``test_flash_pair_tc_backward_at_head_dim_80_matches_plain``."""
    b, d, heads = 3, 2560, 32
    g = torch.Generator().manual_seed(80 + n)
    q, k, v, do = (torch.randn((b, n, d), generator=g).to(cuda, dtype)
                   for _ in range(4))
    pad = torch.tensor([n, n - 1, min(40, n - 1)])[:, None]
    m = (torch.arange(n)[None] >= pad).to(torch.int32).to(cuda)
    kw = dict(heads=heads, mask=m, causal=True)
    plan = mha_fused.flash_plan(q.shape, heads, dtype, route="cuda_core")
    assert (plan.route, plan.bwd_route) == ("cuda_core", "cuda_core")
    assert mha_fused.flash_plan(q.shape, heads, dtype).bwd_route == (
        "tc" if dtype == torch.bfloat16 else "cuda_core")
    f0 = dict(mha_fused.mha_fwd_lse.route_launches)
    b0 = dict(mha_fused.mha_flash_bwd.route_launches)
    o, lse = mha_fused.launch_fwd_lse(plan, q, k, v, **kw)
    grads = mha_fused.launch_flash_bwd(plan, q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert mha_fused.mha_fwd_lse.route_launches == {
        **f0, "cuda_core": f0["cuda_core"] + 1}
    assert mha_fused.mha_flash_bwd.route_launches == {
        **b0, "cuda_core": b0["cuda_core"] + 1}
    o_w, lse_w = mha_fused.mha_fwd_lse_reference(q, k, v, **kw)
    torch.testing.assert_close(lse, lse_w, rtol=1e-5, atol=1e-5)
    if dtype == torch.float32:
        torch.testing.assert_close(o, o_w, rtol=1e-5, atol=1e-5)
    else:
        g_, w_ = o.float(), o_w.float()
        e = torch.floor(torch.log2(torch.maximum(g_.abs(), w_.abs())
                                   .clamp_min(2.0 ** -126)))
        assert bool(((g_ - w_).abs() <= torch.pow(2.0, e - 7) + 1e-3).all())
    want = mha_fused.mha_flash_bwd_reference(q, k, v, o, do, lse, **kw)
    if n == 1 and dtype == torch.bfloat16:
        # dQ / dK are zero in exact arithmetic: rounding noise of two dots
        _single_key_close(grads, q, k, v, do, heads)
        grads, want = grads[2:], want[2:]
    for x, y in zip(grads, want):
        _grad_close(x, y, dtype)


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


@pytest.mark.parametrize("b,w_dtype", [(1, torch.float32),
                                       (13, torch.float32),
                                       (16, torch.float32),
                                       (64, torch.float32),
                                       (16, torch.bfloat16)])
@pytest.mark.parametrize("i_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_rca_fused_bwd_routes_bit_identical(cuda, b, w_dtype, i_dtype,
                                            reverse):
    """K3's staged route (the default) against the plain version at the
    backward bars, and against the per-sample route bit for bit: both
    compute every output by the same chain of fp32 operations."""
    g = torch.Generator().manual_seed(b + 200)
    p = types.SimpleNamespace(**{
        n: AttentionUnit(*geo, generator=g).to(cuda, w_dtype)
        for n, geo in zip(rca_fused.UNITS, rca_fused._GEOM)})
    t = torch.randn((b, 16, 48), generator=g).to(cuda)
    i = torch.randn((b, 16, 80), generator=g).to(cuda, i_dtype)
    gt, gi = (torch.randn((b, 16, 48), generator=g).to(cuda)
              for _ in range(2))
    before = dict(rca_fused.rca_fused_bwd.route_launches)
    got = rca_fused.rca_fused_bwd(p, t, i, gt, gi, reverse=reverse)
    old = rca_fused.rca_fused_bwd(p, t, i, gt, gi, reverse=reverse,
                                  route="per_sample")
    torch.cuda.synchronize()
    assert rca_fused.rca_fused_bwd.route_launches == {
        "staged": before["staged"] + 1,
        "per_sample": before["per_sample"] + 1}
    want = rca_fused.rca_fused_bwd_reference(p, t, i, gt, gi,
                                             reverse=reverse)
    _grad_close(got[0], want[0], torch.float32)
    _grad_close(got[1], want[1], i_dtype)
    for x, y in zip(got[2], want[2]):
        _grad_close(x, y, torch.float32)
    for x, y in zip(got[:2] + tuple(got[2]), old[:2] + tuple(old[2])):
        assert torch.equal(x, y)


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
    """Under autograd the training wrappers launch K1 + K3 (both on their
    staged routes) and K4a + K4b."""
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
    routes = (dict(rca_fused.rca_fused.route_launches),
              dict(rca_fused.rca_fused_bwd.route_launches))
    with torch.enable_grad():
        ti, it = rca_fused.rca_fused_trainable(p, t, i.requires_grad_(),
                                               reverse=True)
        o = mha_fused.mha_flash_train(q, q, q, heads=12)
        (ti.sum() + it.sum() + o.sum()).backward()
    torch.cuda.synchronize()
    assert counts() == tuple(c + 1 for c in before)
    for fn, was in zip((rca_fused.rca_fused, rca_fused.rca_fused_bwd),
                       routes):
        assert fn.route_launches == {"staged": was["staged"] + 1,
                                     "per_sample": was["per_sample"]}
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


@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("post", [True, False])
@pytest.mark.parametrize("b,n,d,ffn", [
    (5, 64, 768, 3072),       # BERT family, 320 rows: 2.5 row tiles
    (2, 197, 768, 3072),      # ViT-B/16, 394 rows
    (64, 197, 768, 3072),     # ViT-B/16 eval batch: blocks walk several tiles
    (1, 197, 1024, 4096),     # ViT-L/16, 197 rows
    (3, 17, 768, 3072),       # 51 rows, one partial tile
    (3, 17, 128, 272)])       # widths that are no multiple of a tile
def test_mlp_blocks_tensor_core_route_matches_plain(cuda, b, n, d, ffn, post,
                                                    act):
    """The bf16 MLP blocks on the tensor cores (LayerNorm row kernel + two
    wgmma GEMMs) against their plain versions; one launch counted per
    call."""
    from garbage_classification_rca_tpu_torch.kernels import (
        transformer_block as tb)

    x, ls, lb, attn, mlp, m = _block_inputs(b, n, d, ffn, torch.bfloat16,
                                            cuda, 7 * n + d)
    fn = tb.postnorm_mlp_block if post else tb.mlp_block
    before = fn.launches
    if post:
        got = fn(x, *mlp, ls, lb, act=act)
        want = tb.postnorm_mlp_block_reference(x, *mlp, ls, lb, act=act)
    else:
        got = fn(x, ls, lb, *mlp, act=act)
        want = tb.mlp_block_reference(x, ls, lb, *mlp, act=act)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert tb.mlp_plan(b * n, d, ffn, x.dtype, post).route == "tensor_cores"
    _block_close(got, want, torch.bfloat16)


def test_mlp_entry_refuses_a_plan_of_the_other_route(cuda):
    """The CUDA entry launches the GEMMs the wrapper's plan gives: a fp32
    call that brings a tensor-core plan, or a bf16 one without it, is
    refused before anything is launched."""
    import ctypes

    from garbage_classification_rca_tpu_torch.kernels import (
        _build, transformer_block as tb)

    fn = _build.library("transformer_block").tb_mlp_block
    fn.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float] + [
        ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for dtype, plan in ((torch.float32, ((256, 4), (256, 4))),
                        (torch.bfloat16, ((0, 0), (0, 0)))):
        x, ls, lb, attn, mlp, m = _block_inputs(2, 8, 128, 256, dtype, cuda,
                                                0)
        w1, b1, w2, b2 = mlp
        ls, lb, b1, b2 = (v.float() for v in (ls, lb, b1, b2))
        hidden = torch.empty(16, 256, device=cuda, dtype=torch.bfloat16)
        y = torch.empty_like(x)
        err = fn(x.data_ptr(), ls.data_ptr(), lb.data_ptr(), w1.data_ptr(),
                 b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), y.data_ptr(),
                 hidden.data_ptr(), None, 16, 128, 256, 1e-6, 1, 0,
                 tb._DTYPES[dtype], *plan[0], *plan[1],
                 torch.cuda.current_stream().cuda_stream)
        assert err != 0, dtype


def test_mlp_blocks_raise_on_bf16_misfit(cuda):
    """A bf16 call the tensor-core route refuses raises on the card: widths
    that are no multiple of 16, an x that is not 16-byte aligned. Nothing
    falls back to the plain version or to the fp32 body."""
    from garbage_classification_rca_tpu_torch.kernels import (
        transformer_block as tb)

    x, ls, lb, attn, mlp, m = _block_inputs(2, 8, 128, 264, torch.bfloat16,
                                            cuda, 0)
    before = tb.mlp_block.launches
    with pytest.raises(ValueError, match="multiples of 16"):
        tb.mlp_block(x, ls, lb, *mlp)
    x, ls, lb, attn, mlp, m = _block_inputs(2, 8, 128, 256, torch.bfloat16,
                                            cuda, 0)
    shifted = torch.empty(x.numel() + 4, device=cuda,
                          dtype=torch.bfloat16)[4:].view_as(x)
    shifted.copy_(x)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tb.mlp_block(shifted, ls, lb, *mlp)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tb.postnorm_mlp_block(shifted, *mlp, ls, lb)
    assert tb.mlp_block.launches == before


@pytest.mark.parametrize("post", [True, False])
@pytest.mark.parametrize("b,n,d,heads", [
    (5, 64, 768, 12),         # BERT family, 320 rows
    (64, 197, 768, 12),       # ViT-B/16 eval batch: 768 core blocks
    (2, 197, 1024, 16),       # ViT-L/16
    (3, 17, 768, 12),         # 51 rows, pad keys in the core's one tile
    (3, 17, 128, 2),          # a width of two heads
    (2, 1, 128, 2)])          # one token
def test_attn_blocks_tensor_core_route_matches_plain(cuda, b, n, d, heads,
                                                     post):
    """The bf16 attention blocks on the tensor cores (LayerNorm rows, the
    QKV GEMM, the per-head core, the out-projection GEMM) against their
    plain versions, post-norm with key lengths and a fully masked sample;
    one launch counted on the "tensor_cores" route."""
    from garbage_classification_rca_tpu_torch.kernels import (
        transformer_block as tb)

    x, ls, lb, attn, mlp, m = _block_inputs(b, n, d, 64, torch.bfloat16,
                                            cuda, 5 * n + d)
    fn = tb.postnorm_attn_block if post else tb.attn_block
    before = dict(fn.route_launches)
    if post:
        got = fn(x, m, *attn, ls, lb, heads=heads)
        want = tb.postnorm_attn_block_reference(x, m, *attn, ls, lb,
                                                heads=heads)
    else:
        got = fn(x, ls, lb, *attn, heads=heads)
        want = tb.attn_block_reference(x, ls, lb, *attn, heads=heads)
    torch.cuda.synchronize()
    assert fn.route_launches == {**before,
                                 "tensor_cores": before["tensor_cores"] + 1}
    _block_close(got, want, torch.bfloat16)


@pytest.mark.parametrize("post", [True, False])
def test_attn_blocks_cuda_core_route_on_request(cuda, post):
    """route="cuda_cores" runs the CUDA-core body in bf16 (the A/B of the
    two routes), counted on its route; both routes meet the plain
    version's bar on the same inputs."""
    from garbage_classification_rca_tpu_torch.kernels import (
        transformer_block as tb)

    x, ls, lb, attn, mlp, m = _block_inputs(4, 64, 768, 64, torch.bfloat16,
                                            cuda, 11)
    fn = tb.postnorm_attn_block if post else tb.attn_block
    args = (x, m, *attn, ls, lb) if post else (x, ls, lb, *attn)
    ref = (tb.postnorm_attn_block_reference if post
           else tb.attn_block_reference)(*args, heads=12)
    before = dict(fn.route_launches)
    old = fn(*args, heads=12, route="cuda_cores")
    new = fn(*args, heads=12)
    torch.cuda.synchronize()
    assert fn.route_launches == {
        "cuda_cores": before["cuda_cores"] + 1,
        "tensor_cores": before["tensor_cores"] + 1}
    _block_close(old, ref, torch.bfloat16)
    _block_close(new, ref, torch.bfloat16)


def test_attn_entry_refuses_another_plan(cuda):
    """The CUDA entry launches the plan it is given: a fp32 call with the
    tensor-core route, a core plan of another N, or a CUDA-core call that
    brings plan numbers is refused before anything is launched."""
    import ctypes

    from garbage_classification_rca_tpu_torch.kernels import (
        _build, transformer_block as tb)

    fn = _build.library("transformer_block").tb_attn_block
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 + [
        ctypes.c_float] + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    plan = tb.attn_plan((2, 17, 128), 2, torch.bfloat16, True)
    np_, (gx, gy, _), smem = plan.core
    good = (*plan.gemms[0], *plan.gemms[1], np_, gx, gy, smem)
    bad_np = (*plan.gemms[0], *plan.gemms[1], np_ + 16, gx, gy, smem)
    for dtype, route, numbers in ((torch.float32, 1, good),
                                  (torch.bfloat16, 1, bad_np),
                                  (torch.bfloat16, 0, good)):
        x, ls, lb, attn, mlp, m = _block_inputs(2, 17, 128, 64, dtype, cuda,
                                                0)
        wqkv, bqkv, wout, bout = attn
        ls, lb, bqkv, bout = (t.float() for t in (ls, lb, bqkv, bout))
        ws = [torch.empty(34, 128, device=cuda, dtype=torch.bfloat16)
              for _ in range(4)]
        y = torch.zeros_like(x)
        err = fn(x.data_ptr(), m.data_ptr(), ls.data_ptr(), lb.data_ptr(),
                 wqkv.data_ptr(), bqkv.data_ptr(), wout.data_ptr(),
                 bout.data_ptr(), y.data_ptr(), ws[3].data_ptr(),
                 *(w.data_ptr() for w in ws[:3]), None, 2, 17, 128, 2, 1e-12,
                 1, tb._DTYPES[dtype], route, *numbers,
                 torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err != 0, (dtype, route)
        assert not bool(y.any())


def test_attn_blocks_raise_on_bf16_misfit(cuda):
    """A bf16 call the tensor-core route refuses raises on the card (an x
    that is not 16-byte aligned; the route asked for in fp32); nothing
    falls back to the CUDA-core body or to the plain version."""
    from garbage_classification_rca_tpu_torch.kernels import (
        transformer_block as tb)

    x, ls, lb, attn, mlp, m = _block_inputs(2, 8, 128, 64, torch.bfloat16,
                                            cuda, 0)
    shifted = torch.empty(x.numel() + 4, device=cuda,
                          dtype=torch.bfloat16)[4:].view_as(x)
    shifted.copy_(x)
    before = (dict(tb.attn_block.route_launches),
              dict(tb.postnorm_attn_block.route_launches))
    with pytest.raises(ValueError, match="16-byte aligned"):
        tb.attn_block(shifted, ls, lb, *attn, heads=2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tb.postnorm_attn_block(shifted, m, *attn, ls, lb, heads=2)
    x, ls, lb, attn, mlp, m = _block_inputs(2, 8, 128, 64, torch.float32,
                                            cuda, 0)
    with pytest.raises(ValueError, match="tensor-core attention route"):
        tb.attn_block(x, ls, lb, *attn, heads=2, route="tensor_cores")
    assert (tb.attn_block.route_launches,
            tb.postnorm_attn_block.route_launches) == before


# the flash pair's tensor-core route (flash_plan "tc": bf16, head dim 64,
# N <= 256), held to the plain pair with the bf16 limits above

def _tc_inputs(b, n, d, seed, cuda):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn((b, n, d), generator=g).to(cuda,
                                                          torch.bfloat16)
                   for _ in range(4))
    lens = torch.randint(1, n + 1, (b,), generator=g)
    m = (torch.arange(n)[None] < lens[:, None]).to(torch.int32)
    m[-1] = 0                                   # a fully masked sample
    return q, k, v, do, m.to(cuda)


def _bf16_ulp(x):
    return torch.pow(2.0, torch.floor(torch.log2(
        x.abs().clamp_min(2.0 ** -126))) - 7)


def _out_close(o, o_w, q, k, v, heads, m, causal):
    """The bf16 forward output: one ulp + the larger of 1e-3 and ulp(w)
    max|v| for the row's largest softmax weight w. S is summed on the
    tensor cores in another order than in the plain version, so a weight
    near a bf16 rounding boundary may round the other way and move the
    output by its ulp times |v|: under 1e-3 where the weights are small,
    more in a causal row with few keys."""
    b, n, d = q.shape
    s = mha_fused._scores(q, k, heads, 1.0 / (d // heads) ** 0.5, m, causal)
    w_max = torch.softmax(s, -1).amax(-1).clamp(max=1 - 2.0 ** -9)
    flip = _bf16_ulp(w_max) * mha_fused._heads(
        v, heads).abs().amax(dim=(2, 3))[:, :, None]
    flip = flip.transpose(1, 2).repeat_interleave(d // heads, dim=2)
    g, w = o.float(), o_w.float()
    tol = _bf16_ulp(torch.maximum(g.abs(), w.abs())) + flip.clamp_min(1e-3)
    assert bool(((g - w).abs() <= tol).all()), float((g - w).abs().max())


def _single_key_close(grads, q, k, v, do, heads):
    """N = 1: dS = W (dP - Delta) with W = 1 and O = V is zero in exact
    arithmetic, so dQ and dK are rounding noise of the two fp32 dot
    products dP = dO . v and Delta = dO . O (each within dh 2^-23
    sum |dO v|), times |k| or |q| and the scale."""
    dh = q.shape[2] // heads
    dots = (mha_fused._heads(do, heads) * mha_fused._heads(v, heads)).abs()
    ds = 2 * dh * 2.0 ** -23 * dots.sum(-1, keepdim=True)
    for g, x in zip(grads[:2], (k, q)):
        tol = mha_fused._merge(ds * mha_fused._heads(x, heads).abs()
                               / dh ** 0.5, torch.float32)
        assert bool((g.float().abs() <= tol).all())


@pytest.mark.parametrize("masked,causal", [(False, False), (True, False),
                                           (False, True), (True, True)])
@pytest.mark.parametrize("n", [1, 17, 64, 65, 128, 197, 256])
def test_flash_tc_route_matches_plain(cuda, n, masked, causal):
    q, k, v, do, m = _tc_inputs(3, n, 256, n, cuda)
    m = m if masked else None
    plan = mha_fused.flash_plan(q.shape, 4, q.dtype)
    assert plan.route == "tc" and plan.np == -(-n // 16) * 16
    before = (dict(mha_fused.mha_fwd_lse.route_launches),
              dict(mha_fused.mha_flash_bwd.route_launches))
    o, lse = mha_fused.mha_fwd_lse(q, k, v, heads=4, mask=m, causal=causal)
    grads = mha_fused.mha_flash_bwd(q, k, v, o, do, lse, heads=4, mask=m,
                                    causal=causal)
    torch.cuda.synchronize()
    for fn, was in zip((mha_fused.mha_fwd_lse, mha_fused.mha_flash_bwd),
                       before):
        assert fn.route_launches == {**was, "tc": was["tc"] + 1}
    o_w, lse_w = mha_fused.mha_fwd_lse_reference(q, k, v, heads=4, mask=m,
                                                 causal=causal)
    torch.testing.assert_close(lse, lse_w, rtol=1e-5, atol=1e-5)
    _out_close(o, o_w, q, k, v, 4, m, causal)
    want = mha_fused.mha_flash_bwd_reference(q, k, v, o, do, lse, heads=4,
                                             mask=m, causal=causal)
    for j, (x, y) in enumerate(zip(grads, want)):
        assert bool(torch.isfinite(x).all())
        if n > 1 or j == 2:
            _grad_close(x, y, torch.bfloat16)
    if n == 1:
        _single_key_close(grads, q, k, v, do, 4)


def test_flash_tc_route_is_deterministic_and_beside_the_old_route(cuda):
    """The same inputs give bit-identical gradients on two runs; the
    CUDA-core route on the same bf16 inputs agrees within the bf16 limits;
    fp32 goes to the CUDA-core route."""
    q, k, v, do, m = _tc_inputs(8, 197, 768, 5, cuda)
    tc = mha_fused.flash_plan(q.shape, 12, q.dtype)
    old = mha_fused.flash_plan(q.shape, 12, q.dtype, route="cuda_core")
    runs = []
    for plan in (tc, tc, old):
        o, lse = mha_fused.launch_fwd_lse(plan, q, k, v, heads=12, mask=m)
        runs.append((o, lse) + mha_fused.launch_flash_bwd(
            plan, q, k, v, o, do, lse, heads=12, mask=m))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(runs[0], runs[1]))
    for x, y in zip(runs[0][2:], runs[2][2:]):
        _grad_close(x, y, torch.bfloat16)
    before = dict(mha_fused.mha_fwd_lse.route_launches)
    mha_fused.mha_fwd_lse(q.float(), k.float(), v.float(), heads=12)
    assert mha_fused.mha_fwd_lse.route_launches == {
        **before, "cuda_core": before["cuda_core"] + 1}


def test_flash_tc_entry_refuses_another_plan(cuda):
    """The C entry launches the plan it is given or none: a plan of
    another shape raises, and nothing is counted."""
    import dataclasses

    q, k, v, do, _ = _tc_inputs(2, 100, 256, 9, cuda)
    plan = mha_fused.flash_plan(q.shape, 4, q.dtype)
    before = dict(mha_fused.mha_fwd_lse.route_launches)
    for bad in (dataclasses.replace(plan, smem_fwd=plan.smem_fwd + 16),
                dataclasses.replace(plan, np=plan.np + 16),
                mha_fused.flash_plan((2, 200, 256), 4, q.dtype)):
        with pytest.raises(RuntimeError):
            mha_fused.launch_fwd_lse(bad, q, k, v, heads=4)
    assert mha_fused.mha_fwd_lse.route_launches == before
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:]
    shifted = shifted.view(q.shape).copy_(q)      # contiguous, 2 bytes off
    with pytest.raises(ValueError, match="aligned"):
        mha_fused.launch_fwd_lse(plan, shifted, k, v, heads=4)


# K2's tensor-core route (flash_plan's forward "tc": bf16, head dim 64,
# N <= 256), held to mha_reference with the bf16 limits above

@pytest.mark.parametrize("masked,causal", [(False, False), (True, False),
                                           (False, True), (True, True)])
@pytest.mark.parametrize("n", [1, 17, 64, 65, 197, 256])
def test_mha_tc_route_matches_plain(cuda, n, masked, causal):
    q, k, v, _, m = _tc_inputs(3, n, 256, n + 1, cuda)
    m = m if masked else None
    plan = mha_fused.flash_plan(q.shape, 4, q.dtype)
    assert plan.route == "tc"
    before = dict(mha_fused.mha.route_launches)
    o = mha_fused.mha(q, k, v, heads=4, mask=m, causal=causal)
    again = mha_fused.mha(q, k, v, heads=4, mask=m, causal=causal)
    torch.cuda.synchronize()
    assert mha_fused.mha.route_launches == {**before,
                                            "tc": before["tc"] + 2}
    assert torch.equal(o, again)
    want = mha_fused.mha_reference(q, k, v, heads=4, mask=m, causal=causal)
    assert bool(torch.isfinite(o.float()).all())
    _out_close(o, want, q, k, v, 4, m, causal)


def test_mha_tc_route_at_the_eval_shape_and_beside_the_old_route(cuda):
    """bf16 128 x 64 x 768 key-masked (the MM-RCA eval's DistilBERT):
    bit-identical over two runs and within one weight's rounding move of
    the plain version (``_out_close``: S summed on the tensor cores in
    another order can round a weight the other way); the CUDA-core route
    on the same inputs within one ulp + 1e-3; fp32 and N > 256 go to the
    CUDA cores."""
    q, k, v, _, m = _tc_inputs(128, 64, 768, 21, cuda)
    before = dict(mha_fused.mha.route_launches)
    runs = [mha_fused.mha(q, k, v, heads=12, mask=m) for _ in range(2)]
    old = mha_fused.mha(q, k, v, heads=12, mask=m, route="cuda_core")
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    want = mha_fused.mha_reference(q, k, v, heads=12, mask=m)
    _out_close(runs[0], want, q, k, v, 12, m, False)
    g, w = old.float(), want.float()
    tol = _bf16_ulp(torch.maximum(g.abs(), w.abs())) + 1e-3
    assert bool(((g - w).abs() <= tol).all())
    mha_fused.mha(q.float(), k.float(), v.float(), heads=12, mask=m)
    x = torch.randn((2, 300, 768), device=cuda).to(torch.bfloat16)
    mha_fused.mha(x, x, x, heads=12)
    assert mha_fused.mha.route_launches == {
        "tc": before["tc"] + 2, "cuda_core": before["cuda_core"] + 3}


def test_mha_tc_entry_refuses_another_plan(cuda):
    """mha_forward_tc launches the plan it is given or none: a plan of
    another shape raises, and nothing is counted."""
    import dataclasses

    q, k, v, _, _ = _tc_inputs(2, 100, 256, 9, cuda)
    plan = mha_fused.flash_plan(q.shape, 4, q.dtype)
    before = dict(mha_fused.mha.route_launches)
    for bad in (dataclasses.replace(plan, smem_fwd=plan.smem_fwd + 16),
                dataclasses.replace(plan, np=plan.np + 16),
                dataclasses.replace(plan, grid_fwd=(4, 3, 1)),
                mha_fused.flash_plan((2, 200, 256), 4, q.dtype)):
        with pytest.raises(RuntimeError):
            mha_fused.launch_mha(bad, q, k, v, heads=4)
    assert mha_fused.mha.route_launches == before


# the tensor-core forward at head dims 88 (EVA ViT-g) and 80 (OPT-2.7B):
# K2 and K4a on ftc::wide_kernel, held to the plain version with
# _out_close (one ulp + one weight's rounding move) and lse at 1e-5

def _vlm_edge_mask(n, cuda):
    """Left pads a row: sample 0 all pad, sample 1 one valid key (the
    last), sample 2 its first min(100, n - 1) keys; with causal, the rows
    before a sample's first valid key attend no key at or before the
    diagonal and spread over all N keys."""
    pad = torch.tensor([n, n - 1, min(100, n - 1)])[:, None]
    return (torch.arange(n)[None] >= pad).to(torch.int32).to(cuda)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("length", ["path", "one"])
@pytest.mark.parametrize("name", sorted(VLM_SHAPES))
def test_mha_tc_route_at_vlm_head_dims_matches_plain(cuda, name, length,
                                                     masked):
    """K2's default bf16 route at 16 heads of 88 (EVA, N 257) and 32 of 80
    (OPT, causal, N 132) and at N = 1, unmasked and with
    ``_vlm_edge_mask``; bit-identical over two runs, beside the CUDA-core
    route on the same inputs (held to the same bar), each launch on its
    route's counter."""
    b, n, d, heads, causal = VLM_SHAPES[name]
    n = n if length == "path" else 1
    g = torch.Generator().manual_seed(17 + n)
    q, k, v = (torch.randn((b, n, d), generator=g).to(cuda, torch.bfloat16)
               for _ in range(3))
    m = _vlm_edge_mask(n, cuda) if masked else None
    plan = mha_fused.mha_plan(q.shape, heads, q.dtype)
    assert (plan.route, plan.grid_fwd) == ("tc", (-(-n // 64), heads, b))
    before = dict(mha_fused.mha.route_launches)
    runs = [mha_fused.mha(q, k, v, heads=heads, mask=m, causal=causal)
            for _ in range(2)]
    old = mha_fused.mha(q, k, v, heads=heads, mask=m, causal=causal,
                        route="cuda_core")
    torch.cuda.synchronize()
    assert mha_fused.mha.route_launches == {
        "tc": before["tc"] + 2, "cuda_core": before["cuda_core"] + 1}
    assert torch.equal(runs[0], runs[1])
    assert bool(torch.isfinite(runs[0].float()).all())
    want = mha_fused.mha_reference(q, k, v, heads=heads, mask=m,
                                   causal=causal)
    _out_close(runs[0], want, q, k, v, heads, m, causal)
    _out_close(old, want, q, k, v, heads, m, causal)


@pytest.mark.parametrize("n", [136, 65, 1])
def test_flash_pair_tc_forward_at_head_dim_80_matches_plain(cuda, n):
    """K4a's default bf16 route at head dim 80 (OPT-2.7B's LoRA shape, 32
    heads, causal, ``_vlm_edge_mask``): the tensor-core forward, lse within
    1e-5 + 1e-5 |x| and the output at ``_out_close``, bit-identical over
    two runs; K4b on the CUDA cores (``bwd_route="cuda_core"``) from its
    out and lse at the backward bars (``_single_key_close`` at N = 1); one
    launch on each route."""
    b, d, heads = 3, 2560, 32
    g = torch.Generator().manual_seed(800 + n)
    q, k, v, do = (torch.randn((b, n, d), generator=g).to(cuda,
                                                          torch.bfloat16)
                   for _ in range(4))
    m = _vlm_edge_mask(n, cuda)
    kw = dict(heads=heads, mask=m, causal=True)
    plan = mha_fused.flash_plan(q.shape, heads, q.dtype, route="tc",
                                bwd_route="cuda_core")
    assert (plan.route, plan.bwd_route) == ("tc", "cuda_core")
    f0 = dict(mha_fused.mha_fwd_lse.route_launches)
    b0 = dict(mha_fused.mha_flash_bwd.route_launches)
    o, lse = mha_fused.mha_fwd_lse(q, k, v, **kw)
    again = mha_fused.launch_fwd_lse(plan, q, k, v, **kw)
    grads = mha_fused.launch_flash_bwd(plan, q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert mha_fused.mha_fwd_lse.route_launches == {**f0, "tc": f0["tc"] + 2}
    assert mha_fused.mha_flash_bwd.route_launches == {
        **b0, "cuda_core": b0["cuda_core"] + 1}
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    o_w, lse_w = mha_fused.mha_fwd_lse_reference(q, k, v, **kw)
    torch.testing.assert_close(lse, lse_w, rtol=1e-5, atol=1e-5)
    _out_close(o, o_w, q, k, v, heads, m, True)
    want = mha_fused.mha_flash_bwd_reference(q, k, v, o, do, lse, **kw)
    if n == 1:
        _single_key_close(grads, q, k, v, do, heads)
        grads, want = grads[2:], want[2:]
    for x, y in zip(grads, want):
        _grad_close(x, y, torch.bfloat16)


@pytest.mark.parametrize("case,n", [("path", 136), ("edge", 136),
                                    ("edge", 65), ("edge", 1)])
def test_flash_pair_tc_backward_at_head_dim_80_matches_plain(cuda, case, n):
    """K4b's default bf16 route at head dim 80 (OPT-2.7B's LoRA shape, 32
    heads, causal): the tensor-core backward (``dq_wide_kernel`` /
    ``dkdv_wide_kernel``) from the default forward's out and lse, held to
    the plain backward at the head-dim-64 tensor-core K4b's bars
    (``_grad_close``; ``_single_key_close`` for dQ / dK at N = 1),
    bit-identical over two runs, one launch on the "tc" counter each. The
    masks: the path's left pads; ``_vlm_edge_mask`` (an all-pad sample, a
    one-key sample and a sample whose first 100 keys, or all but its last
    at N = 65, are pads: its rows before the first key read every key
    tile)."""
    b, d, heads = 3, 2560, 32
    g = torch.Generator().manual_seed(1800 + n)
    q, k, v, do = (torch.randn((b, n, d), generator=g).to(cuda,
                                                          torch.bfloat16)
                   for _ in range(4))
    m = _vlm_edge_mask(n, cuda) if case == "edge" else (
        torch.arange(n)[None] >= torch.tensor([0, 17, 40])[:, None]).to(
        torch.int32).to(cuda)
    kw = dict(heads=heads, mask=m, causal=True)
    plan = mha_fused.flash_plan(q.shape, heads, q.dtype)
    assert (plan.route, plan.bwd_route) == ("tc", "tc")
    assert plan.grid_dq == plan.grid_dkdv == (-(-n // 64), heads, b)
    o, lse = mha_fused.mha_fwd_lse(q, k, v, **kw)
    b0 = dict(mha_fused.mha_flash_bwd.route_launches)
    grads = mha_fused.mha_flash_bwd(q, k, v, o, do, lse, **kw)
    again = mha_fused.launch_flash_bwd(plan, q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert mha_fused.mha_flash_bwd.route_launches == {**b0,
                                                      "tc": b0["tc"] + 2}
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    assert all(bool(torch.isfinite(x.float()).all()) for x in grads)
    want = mha_fused.mha_flash_bwd_reference(q, k, v, o, do, lse, **kw)
    if n == 1:
        _single_key_close(grads, q, k, v, do, heads)
        grads, want = grads[2:], want[2:]
    for x, y in zip(grads, want):
        _grad_close(x, y, torch.bfloat16)


def test_wide_tc_backward_entry_refuses_another_plan(cuda):
    """At head dim 80 the backward's C entry launches the plan it is given
    or none: another grid or shared memory of either kernel, another np or
    a plan of another length raises, and nothing is counted."""
    import dataclasses

    g = torch.Generator().manual_seed(6)
    q = torch.randn((2, 100, 2560), generator=g).to(cuda, torch.bfloat16)
    o, lse = mha_fused.mha_fwd_lse(q, q, q, heads=32)
    plan = mha_fused.flash_plan(q.shape, 32, q.dtype)
    before = dict(mha_fused.mha_flash_bwd.route_launches)
    for bad in (dataclasses.replace(plan, smem_dq=plan.smem_dq + 16),
                dataclasses.replace(plan, smem_dkdv=plan.smem_dkdv - 16),
                dataclasses.replace(plan, np=plan.np + 16),
                dataclasses.replace(plan, grid_dq=(32, 2, 1)),
                dataclasses.replace(plan, grid_dkdv=(3, 32, 2)),
                mha_fused.flash_plan((2, 200, 2560), 32, q.dtype)):
        with pytest.raises(RuntimeError):
            mha_fused.launch_flash_bwd(bad, q, q, q, o, q, lse, heads=32)
    assert mha_fused.mha_flash_bwd.route_launches == before


def test_wide_tc_entry_refuses_another_plan(cuda):
    """At head dims 80 / 88 the C entries launch the plan they are given or
    none: another grid, shared memory or np, a plan of another length, or
    the lse forward at 88 raises, and nothing is counted."""
    import dataclasses

    g = torch.Generator().manual_seed(5)
    q = torch.randn((2, 100, 1408), generator=g).to(cuda, torch.bfloat16)
    plan = mha_fused.mha_plan(q.shape, 16, q.dtype)
    before = (dict(mha_fused.mha.route_launches),
              dict(mha_fused.mha_fwd_lse.route_launches))
    for bad in (dataclasses.replace(plan, smem_fwd=plan.smem_fwd + 16),
                dataclasses.replace(plan, np=plan.np + 16),
                dataclasses.replace(plan, grid_fwd=(16, 2, 1)),
                mha_fused.mha_plan((2, 200, 1408), 16, q.dtype)):
        with pytest.raises(RuntimeError):
            mha_fused.launch_mha(bad, q, q, q, heads=16)
    with pytest.raises(ValueError, match="head dims"):
        mha_fused.launch_fwd_lse(plan, q, q, q, heads=16)
    assert (mha_fused.mha.route_launches,
            mha_fused.mha_fwd_lse.route_launches) == before


# the fp32 backward's 3xTF32 route (flash_plan's backward "tc32": head dim
# 64, N <= 64, K4b and K7b), held to the plain pair at the fp32 bar

def _fp32_inputs(b, n, d, seed, cuda, fully_masked=True):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn((b, n, d), generator=g).to(cuda)
                   for _ in range(4))
    lens = torch.randint(1, n + 1, (b,), generator=g)
    m = (torch.arange(n)[None] < lens[:, None]).to(torch.int32)
    if fully_masked:
        m[-1] = 0
    return q, k, v, do, m.to(cuda)


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("masked,causal", [(False, False), (True, False),
                                           (False, True), (True, True)])
@pytest.mark.parametrize("n", [1, 17, 64])
def test_fp32_backward_tc32_route_matches_plain(cuda, n, masked, causal, p):
    """K4b (p 0) and K7b on the fused 3xTF32 kernel: within 5e-5 (1 + |x|)
    of the plain pair, bit-identical over two runs, counted on its route."""
    from garbage_classification_rca_tpu_torch.nn.core import Key

    q, k, v, do, m = _fp32_inputs(3, n, 256, 40 + n, cuda)
    m = m if masked else None
    kw = dict(heads=4, mask=m, causal=causal)
    if p:
        dm = mha_fused.drop_keep_mask(Key(n), p, 3, 4, n, cuda)
        dm[0, 0, 0] = 0                               # a fully dropped row
        o, lse = mha_fused.mha_fwd_lse_drop(q, k, v, dm, keep=1.0 - p, **kw)
        fn = mha_fused.mha_flash_bwd_drop
        call = lambda: fn(q, k, v, o, do, lse, dm, keep=1.0 - p, **kw)
        want = mha_fused.mha_flash_bwd_drop_reference(
            q, k, v, o, do, lse, dm, keep=1.0 - p, **kw)
    else:
        o, lse = mha_fused.mha_fwd_lse(q, k, v, **kw)
        fn = mha_fused.mha_flash_bwd
        call = lambda: fn(q, k, v, o, do, lse, **kw)
        want = mha_fused.mha_flash_bwd_reference(q, k, v, o, do, lse, **kw)
    assert mha_fused.flash_plan(q.shape, 4, q.dtype,
                                dropout=bool(p)).bwd_route == "tc32"
    before = dict(fn.route_launches)
    grads, again = call(), call()
    torch.cuda.synchronize()
    assert fn.route_launches == {**before, "tc32": before["tc32"] + 2}
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    for x, y in zip(grads, want):
        assert bool(torch.isfinite(x).all())
        _grad_close(x, y, torch.float32)


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_fp32_backward_tc32_at_the_train_shapes_and_beside_the_old_route(
        cuda, p):
    """128 x 64 x 768 (the text trainer's DistilBERT) with p 0.1, and
    16 x 64 x 768 without dropout (the MM-RCA trainer's): the fused kernel
    and the CUDA-core pair on the same inputs, each within the fp32 bar of
    the plain pair; N = 65 goes to the CUDA cores."""
    from garbage_classification_rca_tpu_torch.nn.core import Key

    b = 128 if p else 16
    q, k, v, do, m = _fp32_inputs(b, 64, 768, 77, cuda, fully_masked=False)
    new = mha_fused.flash_plan(q.shape, 12, q.dtype, dropout=bool(p))
    old = mha_fused.flash_plan(q.shape, 12, q.dtype, dropout=bool(p),
                               route="cuda_core")
    assert (new.bwd_route, old.bwd_route) == ("tc32", "cuda_core")
    if p:
        dm = mha_fused.drop_keep_mask(Key(3), p, b, 12, 64, cuda)
        o, lse = mha_fused.mha_fwd_lse_drop(q, k, v, dm, heads=12,
                                            keep=1.0 - p, mask=m)
        runs = [mha_fused.launch_flash_bwd_drop(
            plan, q, k, v, o, do, lse, dm, heads=12, keep=1.0 - p, mask=m)
            for plan in (new, old)]
        want = mha_fused.mha_flash_bwd_drop_reference(
            q, k, v, o, do, lse, dm, heads=12, keep=1.0 - p, mask=m)
    else:
        o, lse = mha_fused.mha_fwd_lse(q, k, v, heads=12, mask=m)
        runs = [mha_fused.launch_flash_bwd(plan, q, k, v, o, do, lse,
                                           heads=12, mask=m)
                for plan in (new, old)]
        want = mha_fused.mha_flash_bwd_reference(q, k, v, o, do, lse,
                                                 heads=12, mask=m)
    torch.cuda.synchronize()
    for grads in runs:
        for x, y in zip(grads, want):
            _grad_close(x, y, torch.float32)
    q, k, v, do, _ = _fp32_inputs(2, 65, 768, 78, cuda)
    o, lse = mha_fused.mha_fwd_lse(q, k, v, heads=12)
    before = dict(mha_fused.mha_flash_bwd.route_launches)
    mha_fused.mha_flash_bwd(q, k, v, o, do, lse, heads=12)
    assert mha_fused.mha_flash_bwd.route_launches == {
        **before, "cuda_core": before["cuda_core"] + 1}


def test_fp32_backward_tc32_entry_refuses_another_plan(cuda):
    """mha_flash_backward_tc32 launches the plan it is given or none; the
    dropout backward has no bf16 tensor-core route."""
    import dataclasses

    from garbage_classification_rca_tpu_torch.nn.core import Key

    q, k, v, do, _ = _fp32_inputs(2, 40, 256, 9, cuda)
    o, lse = mha_fused.mha_fwd_lse(q, k, v, heads=4)
    plan = mha_fused.flash_plan(q.shape, 4, q.dtype)
    dm = mha_fused.drop_keep_mask(Key(2), 0.1, 2, 4, 40, cuda)
    before = (dict(mha_fused.mha_flash_bwd.route_launches),
              dict(mha_fused.mha_flash_bwd_drop.route_launches))
    for bad in (dataclasses.replace(plan, smem_dq=plan.smem_dq - 16),
                dataclasses.replace(plan, grid_dq=(4, 1, 1)),
                dataclasses.replace(plan, grid_dq=(2, 2, 1))):
        with pytest.raises(RuntimeError):
            mha_fused.launch_flash_bwd(bad, q, k, v, o, do, lse, heads=4)
        with pytest.raises(RuntimeError):
            mha_fused.launch_flash_bwd_drop(bad, q, k, v, o, do, lse, dm,
                                            heads=4, keep=0.9)
    # a plan of a longer N (the route's limit is 64)
    x, _, _, _, _ = _fp32_inputs(2, 65, 256, 10, cuda)
    bad = dataclasses.replace(mha_fused.flash_plan(x.shape, 4, x.dtype),
                              bwd_route="tc32", grid_dq=(4, 2, 1),
                              smem_dq=mha_fused.TC32_SMEM)
    xo, xl = mha_fused.mha_fwd_lse(x, x, x, heads=4)
    with pytest.raises(RuntimeError):
        mha_fused.launch_flash_bwd(bad, x, x, x, xo, x, xl, heads=4)
    with pytest.raises(ValueError, match="no 'tc' route"):
        mha_fused.launch_flash_bwd_drop(
            dataclasses.replace(plan, bwd_route="tc"), q, k, v, o, do, lse,
            dm, heads=4, keep=0.9)
    assert (mha_fused.mha_flash_bwd.route_launches,
            mha_fused.mha_flash_bwd_drop.route_launches) == before


# the fp32 training forward's 3xTF32 route (flash_plan's "tc32" forward:
# head dim 64, N <= 64, K4a and K7a), held to the plain forward at the fp32
# bar 1e-5 + 1e-5 |x| on out and lse

def _fwd_close(got, want):
    for x, y in zip(got, want):
        assert bool(torch.isfinite(x).all())
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("masked,causal", [(False, False), (True, False),
                                           (False, True)])
@pytest.mark.parametrize("n", [1, 17, 63, 64])
def test_fp32_forward_tc32_route_matches_plain(cuda, n, masked, causal, p):
    """K7a, and K4a (p 0) asked for the route, on the 3xTF32 forward: out
    and lse within the fp32 bar of the plain forward (a fully masked sample
    where masked, a fully dropped row with dropout), bit-identical over two
    runs, counted on its route."""
    from garbage_classification_rca_tpu_torch.nn.core import Key

    q, k, v, _, m = _fp32_inputs(3, n, 256, 60 + n, cuda)
    kw = dict(heads=4, mask=m if masked else None, causal=causal)
    if p:
        dm = mha_fused.drop_keep_mask(Key(n + 1), p, 3, 4, n, cuda)
        dm[0, 0, 0] = 0                               # a fully dropped row
        fn = mha_fused.mha_fwd_lse_drop
        want = mha_fused.mha_fwd_lse_drop_reference(q, k, v, dm,
                                                    keep=1.0 - p, **kw)
    else:
        fn = mha_fused.mha_fwd_lse
        want = mha_fused.mha_fwd_lse_reference(q, k, v, **kw)
    plan = mha_fused.flash_plan(q.shape, 4, q.dtype, route="tc32",
                                dropout=bool(p))
    if p:
        assert mha_fused.flash_plan(q.shape, 4, q.dtype,
                                    dropout=True).route == "tc32"
        call = lambda: mha_fused.launch_fwd_lse_drop(plan, q, k, v, dm,
                                                     keep=1.0 - p, **kw)
    else:                                 # K4a: "tc32" on request
        call = lambda: mha_fused.launch_fwd_lse(plan, q, k, v, **kw)
    before = dict(fn.route_launches)
    got, again = call(), call()
    torch.cuda.synchronize()
    assert fn.route_launches == {**before, "tc32": before["tc32"] + 2}
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    _fwd_close(got, want)
    if p:
        assert bool((got[0][0, 0, :64] == 0).all())


@pytest.mark.parametrize("b,p", [(128, 0.1), (16, 0.0), (128, 0.0)])
def test_fp32_forward_tc32_at_the_train_shapes_and_beside_the_old_route(
        cuda, b, p):
    """128 x 64 x 768 with p 0.1 (the text trainer's DistilBERT with
    --hf_internal_dropout), 16 x 64 x 768 (the MM-RCA trainer's) and
    128 x 64 x 768 without dropout: the 3xTF32 forward and the CUDA-core
    forward on the same inputs, each within the fp32 bar of the plain
    forward; N = 65 goes to the CUDA cores."""
    from garbage_classification_rca_tpu_torch.nn.core import Key

    q, k, v, _, m = _fp32_inputs(b, 64, 768, 79, cuda, fully_masked=False)
    new, old = (mha_fused.flash_plan(q.shape, 12, q.dtype, route=r,
                                     dropout=bool(p))
                for r in ("tc32", "cuda_core"))
    # the default: K7a on 3xTF32, K4a on the CUDA cores
    assert mha_fused.flash_plan(q.shape, 12, q.dtype,
                                dropout=bool(p)).route == (
        "tc32" if p else "cuda_core")
    if p:
        dm = mha_fused.drop_keep_mask(Key(4), p, b, 12, 64, cuda)
        runs = [mha_fused.launch_fwd_lse_drop(plan, q, k, v, dm, heads=12,
                                              keep=1.0 - p, mask=m)
                for plan in (new, old)]
        want = mha_fused.mha_fwd_lse_drop_reference(q, k, v, dm, heads=12,
                                                    keep=1.0 - p, mask=m)
    else:
        runs = [mha_fused.launch_fwd_lse(plan, q, k, v, heads=12, mask=m)
                for plan in (new, old)]
        want = mha_fused.mha_fwd_lse_reference(q, k, v, heads=12, mask=m)
    torch.cuda.synchronize()
    for got in runs:
        _fwd_close(got, want)
    q, k, v, _, _ = _fp32_inputs(2, 65, 768, 80, cuda)
    before = dict(mha_fused.mha_fwd_lse.route_launches)
    mha_fused.mha_fwd_lse(q, k, v, heads=12)
    assert mha_fused.mha_fwd_lse.route_launches == {
        **before, "cuda_core": before["cuda_core"] + 1}


def test_fp32_forward_tc32_entry_refuses_another_plan(cuda):
    """mha_forward_lse_tc32 launches the plan it is given or none; neither
    forward route gives way to the other."""
    import dataclasses

    from garbage_classification_rca_tpu_torch.nn.core import Key

    q, k, v, _, _ = _fp32_inputs(2, 40, 256, 11, cuda)
    plan = mha_fused.flash_plan(q.shape, 4, q.dtype, route="tc32")
    dm = mha_fused.drop_keep_mask(Key(2), 0.1, 2, 4, 40, cuda)
    before = (dict(mha_fused.mha_fwd_lse.route_launches),
              dict(mha_fused.mha_fwd_lse_drop.route_launches))
    for bad in (dataclasses.replace(plan, smem_fwd=plan.smem_fwd - 16),
                dataclasses.replace(plan, smem_fwd=mha_fused.TC32_SMEM),
                dataclasses.replace(plan, grid_fwd=(4, 1, 1)),
                dataclasses.replace(plan, grid_fwd=(2, 2, 1))):
        with pytest.raises(RuntimeError, match="tc32 route"):
            mha_fused.launch_fwd_lse(bad, q, k, v, heads=4)
        with pytest.raises(RuntimeError, match="tc32 route"):
            mha_fused.launch_fwd_lse_drop(bad, q, k, v, dm, heads=4,
                                          keep=0.9)
    # a plan of a longer N (the route's limit is 64), and head dim 32
    x, _, _, _, _ = _fp32_inputs(2, 65, 256, 12, cuda)
    bad = dataclasses.replace(
        mha_fused.flash_plan(x.shape, 4, x.dtype), route="tc32",
        grid_fwd=(4, 2, 1), smem_fwd=mha_fused.TC32_FWD_SMEM)
    with pytest.raises(RuntimeError):
        mha_fused.launch_fwd_lse(bad, x, x, x, heads=4)
    with pytest.raises(RuntimeError):
        mha_fused.launch_fwd_lse(dataclasses.replace(plan, grid_fwd=(8, 2, 1)),
                                 q, k, v, heads=8)
    with pytest.raises(ValueError, match="no 'tc' route"):
        mha_fused.launch_fwd_lse_drop(dataclasses.replace(plan, route="tc"),
                                      q, k, v, dm, heads=4, keep=0.9)
    with pytest.raises(ValueError, match="no 'tc32' route"):
        mha_fused.launch_mha(plan, q, k, v, heads=4)
    assert (mha_fused.mha_fwd_lse.route_launches,
            mha_fused.mha_fwd_lse_drop.route_launches) == before


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_flash_train_autograd_on_the_default_routes_matches_plain(cuda, p):
    """``mha_flash_train`` / ``mha_flash_train_dropout`` at 8 x 64 x 768
    on their default routes (with dropout both kernels on 3xTF32; without,
    the CUDA-core forward and the 3xTF32 backward) under autograd against
    autograd of the plain forward on the same keep mask, one launch of
    each on its route.
    No sample is fully masked here: the flash backward, as the JAX pair's,
    recomputes W = exp(S - lse), and for such a row lse = -1e30 + log N
    rounds to -1e30, so W is 1 where autograd of the plain forward has
    1 / N (the kernels are held to the plain pair there, above)."""
    from garbage_classification_rca_tpu_torch.nn.core import Key

    q, k, v, do, m = _fp32_inputs(8, 64, 768, 81, cuda, fully_masked=False)
    fwd, bwd = ((mha_fused.mha_fwd_lse_drop, mha_fused.mha_flash_bwd_drop)
                if p else (mha_fused.mha_fwd_lse, mha_fused.mha_flash_bwd))
    route = "tc32" if p else "cuda_core"
    before = (fwd.route_launches[route], bwd.route_launches["tc32"])

    def grads(fn):
        x = [t.clone().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            (fn(*x) * do).sum().backward()
        return [t.grad for t in x]

    if p:
        key = Key(6)
        got = grads(lambda a, b, c: mha_fused.mha_flash_train_dropout(
            a, b, c, heads=12, key=key, p=p, mask=m))
        dm = mha_fused.drop_keep_mask(key, p, 8, 12, 64, cuda)
        want = grads(lambda a, b, c: mha_fused.mha_fwd_lse_drop_reference(
            a, b, c, dm, heads=12, keep=1.0 - p, mask=m)[0])
    else:
        got = grads(lambda a, b, c: mha_fused.mha_flash_train(
            a, b, c, heads=12, mask=m))
        want = grads(lambda a, b, c: mha_fused.mha_reference(
            a, b, c, heads=12, mask=m))
    torch.cuda.synchronize()
    assert (fwd.route_launches[route], bwd.route_launches["tc32"]) == (
        before[0] + 1, before[1] + 1)
    for x, y in zip(got, want):
        assert bool(torch.isfinite(x).all())
        _grad_close(x, y, torch.float32)
