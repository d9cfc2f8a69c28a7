"""PyTorch port, the routes of K2 (``mha``, the eval attention) and of the
fp32 flash pair (K4a ``mha_fwd_lse`` / K4b ``mha_flash_bwd`` and K7a
``mha_fwd_lse_drop`` / K7b ``mha_flash_bwd_drop``) on the card, and the
numerics they rest on (CPU tensors; the kernels themselves run on the card:
``tests/test_torch_gpu.py``):

  * ``flash_plan``'s forward route, which ``mha`` takes: the tensor cores
    ("tc") for bf16 at head dim 64 and 1 <= N <= 256, the CUDA cores for
    fp32, N 257 .. 512 and head dims 32 / 128;
  * its backward route: one fused kernel on 3xTF32 tensor-core products
    ("tc32") for fp32 at head dim 64 and N <= 64, with or without dropout,
    a block per (head, sample) whose shared memory lets two blocks share
    an SM; longer N, other head dims and bf16 dropout stay on the CUDA
    cores; route requests for the A/B, and refusals;
  * the fp32 training forward's route: K7a (with dropout) takes "tc32" at
    the same shapes, one kernel per (head, sample) on 3xTF32 products whose
    shared memory lets three blocks share an SM; K4a (without) keeps the
    CUDA cores and takes "tc32" on request;
  * ``mha_reference`` (what ``mha`` runs on the CPU and what the card's
    kernels are held to) against the Pallas ``mha`` in interpret mode at
    the tensor-core route's lengths, key-masked, causal and with a fully
    masked sample: within one bf16 ulp + 1e-3 (both sides round the
    weights to bf16 at the same point and sum in another order);
  * the numerical design of the "tc32" kernel: each product taken as
    3xTF32 (each fp32 operand split into hi = tf32(x), lo = tf32(x - hi),
    rounded to nearest with ties away from zero as ``cvt.rna.tf32.f32``
    does, and lo.hi + hi.lo + hi.hi summed in fp32), emulated in torch at
    the plain pair's arithmetic, lands within the fp32 backward bar
    5e-5 (1 + |x|) of the Pallas ``_mha_flash_bwd_drop`` /
    ``_mha_flash_bwd`` (interpret) at 64 x 64 x 768, p 0.1; one TF32 pass
    (hi.hi alone) does not. (A fully masked sample under causal masking is
    held to the port's plain pair: the Pallas kernels add the causal mask
    as a bias there, ``tests/test_torch_mha_tc.py``.) The forward in the
    kernel's own order (``_mm_k8``: one fp32 accumulator, each k8 step
    adding lo.hi, hi.lo, hi.hi, modelled as exact 8-term sums rounded to
    nearest; wld V over each 32-key half, the halves added) lands within
    the fp32 forward bar 1e-5 + 1e-5 |x| of the Pallas ``_mha_fwd_lse`` /
    ``_mha_fwd_lse_drop`` (interpret) at N = 64, also where |S| reaches
    30; one TF32 pass does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.kernels import mha_fused as jmha
from garbage_classification_rca_tpu_torch.kernels import mha_fused as K
from garbage_classification_rca_tpu_torch.kernels.transformer_block import (
    MAX_SMEM)

torch.set_num_threads(2)

BF16, FP32 = torch.bfloat16, torch.float32
TC_NS = [1, 17, 64, 65, 197, 256]


@pytest.mark.parametrize("n", TC_NS)
def test_mha_route_is_the_tensor_cores_for_bf16_head_dim_64(n):
    plan = K.flash_plan((128, n, 768), 12, BF16)
    assert plan.route == "tc" and plan.np == -(-n // 16) * 16
    assert plan.grid_fwd == (12, 128, 1)
    assert 0 < plan.smem_fwd <= MAX_SMEM
    # the forward the eval kernel launches is the training forward's plan
    assert plan.smem_fwd == 3 * -(-n // 64) * 8192 + 256 * 4 + 16 + 1024


@pytest.mark.parametrize("shape,heads,dtype", [
    ((128, 64, 768), 12, FP32),               # fp32 keeps its 1e-5 bar
    ((8, 197, 768), 12, FP32),
    ((4, 257, 768), 12, BF16),
    ((4, 512, 768), 12, BF16),                # MAX_N, --seq_len=512
    ((16, 64, 768), 24, BF16),                # head dim 32
    ((16, 64, 768), 6, BF16)])                # head dim 128
def test_mha_route_is_the_cuda_cores_for_the_rest(shape, heads, dtype):
    b, n, d = shape
    plan = K.flash_plan(shape, heads, dtype)
    assert plan.route == "cuda_core" and plan.grid_fwd == (-(-n // 32),
                                                           heads, b)
    with pytest.raises(ValueError):
        K.flash_plan(shape, heads, dtype, route="tc")


def test_mha_on_cpu_runs_the_plain_version_on_any_route():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 17, 128)).astype(
        np.float32)).to(BF16) for _ in range(3))
    want = K.mha_reference(q, k, v, heads=2)
    for route in (None, "tc", "cuda_core"):
        assert torch.equal(K.mha(q, k, v, heads=2, route=route), want)
    assert K.mha.launches == 0
    assert K.mha.route_launches == {"tc": 0, "cuda_core": 0}
    plan = K.flash_plan(q.shape, 2, BF16)
    with pytest.raises(ValueError):
        K.launch_mha(plan, q, k, v, heads=2)


@pytest.mark.parametrize("n", [1, 17, 63, 64])
@pytest.mark.parametrize("dropout", [False, True])
def test_fp32_backward_route_is_the_fused_3xtf32_kernel(n, dropout):
    plan = K.flash_plan((128, n, 768), 12, FP32, dropout=dropout)
    # the dropout pair's forward takes the 3xTF32 forward too; without
    # dropout the forward keeps the CUDA cores unless asked
    assert (plan.route, plan.bwd_route) == (
        "tc32" if dropout else "cuda_core", "tc32")
    # one block per (head, sample), one kernel: no dK / dV grid
    assert plan.grid_dq == (12, 128, 1) and plan.grid_dkdv == (0, 0, 0)
    assert plan.smem_dq == K.TC32_SMEM and plan.smem_dkdv == 0
    # Q, K, V, dO, wld and dS at stride 68 floats, three [64] fp32 rows,
    # the mask's 64 rows of 68 bytes; two blocks to an SM
    assert K.TC32_SMEM == 6 * 64 * 68 * 4 + 3 * 64 * 4 + 64 * 68
    assert 2 * plan.smem_dq <= MAX_SMEM


@pytest.mark.parametrize("shape,heads,dtype,dropout", [
    ((128, 65, 768), 12, FP32, False),        # past the route's N limit
    ((4, 512, 768), 12, FP32, True),
    ((16, 64, 768), 24, FP32, False),         # head dim 32
    ((16, 64, 768), 6, FP32, True),           # head dim 128
    ((128, 64, 768), 12, BF16, True)])        # bf16 with dropout
def test_fp32_backward_route_limits(shape, heads, dtype, dropout):
    plan = K.flash_plan(shape, heads, dtype, dropout=dropout)
    assert (plan.route, plan.bwd_route) == ("cuda_core", "cuda_core")
    with pytest.raises(ValueError):
        K.flash_plan(shape, heads, dtype, bwd_route="tc32", dropout=dropout)


def test_backward_route_requests():
    shape = (16, 64, 768)
    # one route asked for the pair: the all-CUDA-core plan, the A/B's old
    # side
    old = K.flash_plan(shape, 12, FP32, route="cuda_core")
    assert (old.route, old.bwd_route) == ("cuda_core", "cuda_core")
    assert K.flash_plan(shape, 12, FP32, bwd_route="cuda_core").bwd_route \
        == "cuda_core"
    assert K.flash_plan(shape, 12, FP32, route="cuda_core",
                        bwd_route="tc32").bwd_route == "tc32"
    # bf16: the pair on the tensor cores; tc32 is fp32 only, "tc" bf16 only
    assert K.flash_plan(shape, 12, BF16).bwd_route == "tc"
    for dtype, bwd in ((BF16, "tc32"), (FP32, "tc")):
        with pytest.raises(ValueError):
            K.flash_plan(shape, 12, dtype, bwd_route=bwd)
    with pytest.raises(ValueError):
        K.flash_plan(shape, 12, BF16, route="tc", dropout=True)
    with pytest.raises(ValueError):
        K.flash_plan(shape, 12, FP32, bwd_route="mma")


def test_backward_launch_helpers_refuse_cpu_tensors():
    q = torch.zeros((2, 64, 128))
    lse = torch.zeros((2, 2, 64))
    dm = torch.ones((2, 2, 64, 64), dtype=torch.uint8)
    plan = K.flash_plan(q.shape, 2, FP32, dropout=True)
    with pytest.raises(ValueError):
        K.launch_flash_bwd(plan, q, q, q, q, q, lse, heads=2)
    with pytest.raises(ValueError):
        K.launch_flash_bwd_drop(plan, q, q, q, q, q, lse, dm, heads=2,
                                keep=0.9)
    assert K.mha_flash_bwd.route_launches == {"tc": 0, "tc32": 0,
                                              "cuda_core": 0}
    assert K.mha_flash_bwd_drop.route_launches == {"tc32": 0,
                                                   "cuda_core": 0}


@pytest.mark.parametrize("n", [1, 17, 64])
@pytest.mark.parametrize("dropout", [False, True])
def test_fp32_forward_route_is_the_3xtf32_kernel(n, dropout):
    # K7a by default, K4a on request (its default stays the CUDA cores)
    default = K.flash_plan((128, n, 768), 12, FP32, dropout=dropout)
    assert default.route == ("tc32" if dropout else "cuda_core")
    plan = K.flash_plan((128, n, 768), 12, FP32, dropout=dropout,
                        route=None if dropout else "tc32")
    assert (plan.route, plan.bwd_route, plan.np) == ("tc32", "tc32", n)
    # one block per (head, sample) on both sides
    assert plan.grid_fwd == plan.grid_dq == (12, 128, 1)
    assert plan.smem_fwd == K.TC32_FWD_SMEM
    # Q, K and V at stride 68 floats, five [64] fp32 rows (the key bias,
    # each key half's row max and sum), the mask's 64 rows of 68 bytes:
    # three blocks to an SM, with the 1 KB the SM keeps for each
    assert K.TC32_FWD_SMEM == 3 * 64 * 68 * 4 + 5 * 64 * 4 + 64 * 68
    assert 3 * (plan.smem_fwd + 1024) <= 228 * 1024
    assert plan.smem_fwd <= MAX_SMEM


@pytest.mark.parametrize("shape,heads,dtype,dropout", [
    ((128, 65, 768), 12, FP32, False),        # past the route's N limit
    ((4, 512, 768), 12, FP32, True),
    ((16, 64, 768), 24, FP32, True),          # head dim 32
    ((16, 64, 768), 6, FP32, False),          # head dim 128
    ((128, 64, 768), 12, BF16, True),         # bf16 with dropout
    ((128, 64, 768), 12, BF16, False)])       # bf16: the "tc" route
def test_fp32_forward_route_limits(shape, heads, dtype, dropout):
    plan = K.flash_plan(shape, heads, dtype, dropout=dropout)
    assert plan.route != "tc32"
    with pytest.raises(ValueError):
        K.flash_plan(shape, heads, dtype, route="tc32", dropout=dropout)


def test_fp32_forward_route_requests():
    shape = (16, 64, 768)
    # the A/B's old side: both kernels on the CUDA cores
    old = K.flash_plan(shape, 12, FP32, route="cuda_core", dropout=True)
    assert (old.route, old.bwd_route) == ("cuda_core", "cuda_core")
    assert old.grid_fwd == (2, 12, 16)
    # the old forward beside the new backward, and the new forward asked
    # for by name, which brings the backward's along
    mixed = K.flash_plan(shape, 12, FP32, route="cuda_core",
                         bwd_route="tc32", dropout=True)
    assert (mixed.route, mixed.bwd_route) == ("cuda_core", "tc32")
    new = K.flash_plan(shape, 12, FP32, route="tc32", dropout=True)
    assert (new.route, new.bwd_route) == ("tc32", "tc32")
    # K4a's 3xTF32 forward on request, beside either backward
    asked = K.flash_plan(shape, 12, FP32, route="tc32")
    assert (asked.route, asked.bwd_route) == ("tc32", "tc32")
    assert asked.grid_fwd == (12, 16, 1)
    assert K.flash_plan(shape, 12, FP32, route="tc32",
                        bwd_route="cuda_core").bwd_route == "cuda_core"
    with pytest.raises(ValueError):
        K.flash_plan(shape, 12, BF16, route="tc32")


def test_forward_launch_helpers_refuse_cpu_tensors():
    q = torch.zeros((2, 64, 128))
    dm = torch.ones((2, 2, 64, 64), dtype=torch.uint8)
    plan = K.flash_plan(q.shape, 2, FP32, dropout=True)
    assert plan.route == "tc32"
    with pytest.raises(ValueError):
        K.launch_fwd_lse(plan, q, q, q, heads=2)
    with pytest.raises(ValueError):
        K.launch_fwd_lse_drop(plan, q, q, q, dm, heads=2, keep=0.9)
    # CPU tensors take the plain versions on every route
    o, lse = K.mha_fwd_lse_drop(q, q, q, dm, heads=2, keep=0.9)
    want = K.mha_fwd_lse_drop_reference(q, q, q, dm, heads=2, keep=0.9)
    assert torch.equal(o, want[0]) and torch.equal(lse, want[1])
    assert K.mha_fwd_lse.route_launches == {"tc": 0, "tc32": 0,
                                            "cuda_core": 0}
    assert K.mha_fwd_lse_drop.route_launches == {"tc32": 0, "cuda_core": 0}
    assert K.mha_fwd_lse_drop.launches == 0


def _inputs(b, n, d, seed, fully_masked=False):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(b, n, d)).astype(np.float32)
                   for _ in range(4))
    lens = rng.integers(1, n + 1, b)
    lens[0] = n
    if fully_masked:
        lens[-1] = 0
    mask = (np.arange(n)[None, :] < lens[:, None]).astype(np.int32)
    return q, k, v, do, mask


def _bf16_close(got, want):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.maximum(np.abs(g),
                                                         np.abs(w)),
                                              2.0 ** -126))) - 7)
    assert np.all(np.abs(g - w) <= ulp + 1e-3), float(np.abs(g - w).max())


@pytest.mark.parametrize("masked,causal,fully_masked", [
    (False, False, False), (True, False, True), (False, True, False),
    (True, True, True)])
@pytest.mark.parametrize("n", TC_NS)
def test_mha_reference_matches_jax_mha_at_tc_lengths(n, masked, causal,
                                                     fully_masked):
    b, d, heads = 3, 128, 2
    q, k, v, _, m = _inputs(b, n, d, 7 * n + causal, fully_masked)
    jm = jnp.asarray(m) if masked else None
    tm = torch.from_numpy(m) if masked else None
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(BF16) for a in (q, k, v))
    got = K.mha(tq, tk, tv, heads=heads, mask=tm, causal=causal)
    assert got.dtype == BF16 and tuple(got.shape) == (b, n, d)
    want = jmha.mha(jq, jk, jv, heads=heads, mask=jm, causal=causal,
                    interpret=True)
    if masked and causal and fully_masked:
        # the Pallas kernel adds the causal mask as a bias (-2e30 past the
        # diagonal) and spreads a fully masked row over the keys up to it;
        # the JAX mha_reference (where) and the port spread it over all N
        _bf16_close(got[:-1], want[:-1])
        _bf16_close(got[-1:], jmha.mha_reference(
            jq[-1:], jk[-1:], jv[-1:], heads=heads, mask=jm[-1:],
            causal=True))
    else:
        _bf16_close(got, want)


def _tf32(x):
    """x rounded to TF32 (10 explicit mantissa bits) to nearest, ties away
    from zero, as cvt.rna.tf32.f32 does: add half of the dropped bits'
    weight to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b the way the "tc32" kernel takes its products: each operand
    split into hi = tf32(x), lo = tf32(x - hi), and lo.hi + hi.lo + hi.hi
    summed in fp32 (lo.lo left out)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _mm_tf32(a, b):
    """One TF32 pass: hi.hi alone."""
    return _tf32(a) @ _tf32(b)


def _bwd_emulated(mm, q, k, v, o, do, lse, dm, *, heads, keep, mask,
                  causal):
    """``mha_flash_bwd_drop_reference`` (``mha_flash_bwd_reference`` when
    `dm` is None) in fp32 with its five products taken by `mm`."""
    b, n, d = q.shape
    scale = 1.0 / np.sqrt(d // heads)
    qh, kh, vh, doh, oh = (K._heads(a, heads) for a in (q, k, v, do, o))
    s = mm(qh, kh.transpose(-1, -2)) * scale
    if mask is not None:
        s = s + ((mask.float() - 1.0) * -K.NEG)[:, None, None, :]
    if causal:
        tri = torch.ones((n, n), dtype=torch.bool).tril()
        s = torch.where(tri, s, torch.full_like(s, K.NEG))
    w = torch.exp(s - lse[..., None])
    wld = w if dm is None else K._apply_keep(w, dm, keep)
    dv = mm(wld.transpose(-1, -2), doh)
    dp = mm(doh, vh.transpose(-1, -2))
    dw = dp if dm is None else torch.where(dm != 0, dp / keep,
                                           torch.zeros_like(dp))
    ds = w * (dw - (doh * oh).sum(-1, keepdim=True))
    dq = mm(ds, kh) * scale
    dk = mm(ds.transpose(-1, -2), qh) * scale
    return tuple(K._merge(x, FP32) for x in (dq, dk, dv))


def _fp32_bar_excess(got, want):
    """max of |d| / (5e-5 (1 + |x|)): at most 1 within the bar."""
    g, w = got.numpy(), np.asarray(want)
    return float((np.abs(g - w) / (5e-5 * (1.0 + np.abs(w)))).max())


@pytest.mark.parametrize("masked,causal,p", [
    (True, False, 0.1), (True, True, 0.1), (False, False, 0.1),
    (True, False, 0.0)])
def test_3xtf32_products_hold_the_fp32_bar_against_jax(masked, causal, p):
    """64 x 64 x 768 (12 heads of 64), a fully masked sample; p 0.1 on the
    JAX keep mask (p 0: the plain pair ``_mha_flash_bwd``), the forward's
    out and lse from the Pallas forward, fed to both sides."""
    b, n, d, heads = 64, 64, 768, 12
    q, k, v, do, m = _inputs(b, n, d, 31 + causal, fully_masked=masked)
    jm = jnp.asarray(m) if masked else None
    tm = torch.from_numpy(m) if masked else None
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    kw = dict(heads=heads, scale=float(1.0 / np.sqrt(d // heads)), mask=jm,
              causal=causal, interpret=True)
    if p:
        jdm = jmha._drop_keep_mask(jax.random.PRNGKey(5), p, b, heads, n)
        jo, jl = jmha._mha_fwd_lse_drop(jq, jk, jv, jdm, keep=1.0 - p, **kw)
        want = jmha._mha_flash_bwd_drop(jq, jk, jv, jo, jdo, jl, jdm,
                                        keep=1.0 - p, **kw)
        dm = torch.from_numpy(np.array(jdm))
    else:
        jo, jl = jmha._mha_fwd_lse(jq, jk, jv, **kw)
        want = jmha._mha_flash_bwd(jq, jk, jv, jo, jdo, jl, **kw)
        dm = None
    to, tl, tdo = (torch.from_numpy(np.array(a)) for a in (jo, jl, jdo))
    args = [torch.from_numpy(a) for a in (q, k, v)] + [to, tdo, tl, dm]
    opts = dict(heads=heads, keep=1.0 - p, mask=tm, causal=causal)
    got = _bwd_emulated(_mm_3xtf32, *args, **opts)
    one_pass = _bwd_emulated(_mm_tf32, *args, **opts)
    rows = slice(None)
    if masked and causal:
        # the fully masked sample: the Pallas kernels add the causal mask
        # as a bias (-2e30 past the diagonal), the port's pair uses where
        # (the JAX mha_reference); that sample is held to the port's plain
        # backward
        rows = slice(0, b - 1)
        plain = (K.mha_flash_bwd_drop_reference(*args, **opts) if p else
                 K.mha_flash_bwd_reference(*args[:6], heads=heads, mask=tm,
                                           causal=causal))
        for g3, w in zip(got, plain):
            assert _fp32_bar_excess(g3[-1:], w[-1:]) <= 1.0
    for g3, g1, w in zip(got, one_pass, want):
        assert g3.dtype == FP32 and bool(torch.isfinite(g3).all())
        assert _fp32_bar_excess(g3[rows], w[rows]) <= 1.0
        assert _fp32_bar_excess(g1[rows], w[rows]) > 1.0
    # the split is exact: hi + lo carries x to within a TF32 ulp of lo
    x = torch.from_numpy(q)
    hi = _tf32(x)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert float((x - hi - _tf32(x - hi)).abs().max()) <= 2.0 ** -21 * float(
        x.abs().max())


def _mm_k8(a, b, halves=1):
    """a @ b the way the "tc32" kernels' mma.sync chains take it: the depth
    cut into `halves` equal parts, each summed in one fp32 accumulator per
    output to which every k8 step adds lo.hi, then hi.lo, then hi.hi (each
    8-term sum exact, in fp64, rounded to nearest once into the
    accumulator), the parts' sums then added in order."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    depth = a.shape[-1] // halves
    out = None
    for h0 in range(0, a.shape[-1], depth):
        acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=FP32)
        for k0 in range(h0, h0 + depth, 8):
            k = slice(k0, k0 + 8)
            for x, y in ((al, bh), (ah, bl), (ah, bh)):
                acc = (acc.double() + x[..., k].double()
                       @ y[..., k, :].double()).float()
        out = acc if out is None else out + acc
    return out


def _fwd_emulated(mm_s, mm_o, q, k, v, dm, *, heads, keep, mask, causal):
    """``mha_fwd_lse_drop_reference`` (``mha_fwd_lse_reference`` when `dm`
    is None) in fp32 with S = Q K^T taken by `mm_s` and wld V by `mm_o`:
    (out, lse)."""
    b, n, d = q.shape
    scale = 1.0 / np.sqrt(d // heads)
    qh, kh, vh = (K._heads(a, heads) for a in (q, k, v))
    s = mm_s(qh, kh.transpose(-1, -2)) * scale
    if mask is not None:
        s = s + ((mask.float() - 1.0) * -K.NEG)[:, None, None, :]
    if causal:
        tri = torch.ones((n, n), dtype=torch.bool).tril()
        s = torch.where(tri, s, torch.full_like(s, K.NEG))
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    ssum = e.sum(-1, keepdim=True)
    wld = e / ssum
    if dm is not None:
        wld = K._apply_keep(wld, dm, keep)
    out = K._merge(mm_o(wld, vh), FP32)
    return out, (m + torch.log(ssum))[..., 0]


def _fwd_bar_excess(got, want):
    """max of |d| / (1e-5 + 1e-5 |x|): at most 1 within the bar."""
    g, w = got.numpy(), np.asarray(want)
    return float((np.abs(g - w) / (1e-5 + 1e-5 * np.abs(w))).max())


@pytest.mark.parametrize("masked,causal,p,amp", [
    (True, False, 0.1, 1.0), (True, True, 0.1, 1.0), (False, False, 0.1, 1.0),
    (True, False, 0.0, 1.0), (False, True, 0.0, 1.0),
    (True, False, 0.1, 2.4)])         # scores up to |S| = 30
def test_3xtf32_forward_holds_the_fp32_bar_against_jax(masked, causal, p,
                                                       amp):
    """32 x 64 x 768 (12 heads of 64), a fully masked sample where masked;
    p 0.1 on the JAX keep mask (p 0: ``_mha_fwd_lse``). q and k scaled by
    `amp`: at 2.4 the largest |S| is about 30, as in a trained encoder's
    sharper heads, where the bar is tightest."""
    b, n, d, heads = 32, 64, 768, 12
    q, k, v, _, m = _inputs(b, n, d, 31 + causal, fully_masked=masked)
    q, k = q * np.float32(amp), k * np.float32(amp)
    jm = jnp.asarray(m) if masked else None
    tm = torch.from_numpy(m) if masked else None
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    kw = dict(heads=heads, scale=float(1.0 / np.sqrt(d // heads)), mask=jm,
              causal=causal, interpret=True)
    if p:
        jdm = jmha._drop_keep_mask(jax.random.PRNGKey(5), p, b, heads, n)
        want = jmha._mha_fwd_lse_drop(jq, jk, jv, jdm, keep=1.0 - p, **kw)
        dm = torch.from_numpy(np.array(jdm))
    else:
        want = jmha._mha_fwd_lse(jq, jk, jv, **kw)
        dm = None
    args = [torch.from_numpy(a) for a in (q, k, v)] + [dm]
    opts = dict(heads=heads, keep=1.0 - p, mask=tm, causal=causal)
    s_max = float((K._heads(args[0], heads) @ K._heads(
        args[1], heads).transpose(-1, -2)).abs().max()) / 8.0
    assert s_max > 29.0 if amp > 1.0 else s_max < 8.0
    got = _fwd_emulated(_mm_k8, lambda a, b: _mm_k8(a, b, halves=2), *args,
                        **opts)
    one_pass = _fwd_emulated(_mm_tf32, _mm_tf32, *args, **opts)
    rows = slice(None)
    if masked and causal:
        # the fully masked sample: the Pallas kernel adds the causal mask
        # as a bias, the port's forward uses where; held to the port's
        # plain forward
        rows = slice(0, b - 1)
        plain = (K.mha_fwd_lse_drop_reference(*args, **opts) if p else
                 K.mha_fwd_lse_reference(*args[:3], heads=heads, mask=tm,
                                         causal=causal))
        for g3, w in zip(got, plain):
            assert _fwd_bar_excess(g3[-1:], w[-1:]) <= 1.0
    for g3, g1, w in zip(got, one_pass, want):
        assert g3.dtype == FP32 and bool(torch.isfinite(g3).all())
        assert _fwd_bar_excess(g3[rows], w[rows]) <= 1.0
        assert _fwd_bar_excess(g1[rows], w[rows]) > 1.0
