"""PyTorch port, the attention blocks K5a / K6a on the tensor-core route:
the host-side launch plan that ``kernels/transformer_block.py`` hands the
CUDA entry (route by dtype, workspaces, the QKV and out-projection GEMMs'
tile widths and grids, the per-head core's NP / grid / shared memory), the
fit rule at every registered model's eval widths, and the plain bf16 blocks
— the kernels' oracle on the card — against the JAX Pallas functions in
interpret mode at head dim 64 over 3 x 17 and 3 x 64 tokens.

Tolerance (bf16, as in ``tests/test_torch_blocks.py``): one bf16 ulp of the
value + 1e-2 of the tensor's largest |y|; the two frameworks sum in
different orders and a q / k / v or softmax weight that rounds to the
neighbouring bf16 value moves the sums it enters.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.kernels import transformer_block as jtb
from garbage_classification_rca_tpu_torch.kernels import mha_fused
from garbage_classification_rca_tpu_torch.kernels import (
    transformer_block as ttb)
from garbage_classification_rca_tpu_torch.models.registry import (
    get_image_model, get_text_model)

torch.set_num_threads(2)

# (b, n, d, heads) -> (QKV GEMM, out GEMM) as (tile width, grid) on 132 SMs:
# BERT-base 256 x 64 tokens (16,384 rows), ViT-B/16 64 x 197 (12,608),
# ViT-L/16 64 x 197 x 1024, and the odd 3 x 17 rows at both widths (fewer
# tiles than SMs: one block per tile)
PLANS = {
    (256, 64, 768, 12): ((256, 132), (256, 132)),
    (64, 197, 768, 12): ((192, 132), (192, 132)),
    (64, 197, 1024, 16): ((256, 132), (256, 132)),
    (3, 17, 768, 12): ((192, 12), (192, 4)),
    (3, 17, 1024, 16): ((192, 16), (192, 6)),
}


@pytest.mark.parametrize("post", [True, False])
@pytest.mark.parametrize("b,n,d,heads", list(PLANS), ids=str)
def test_tensor_core_plan(b, n, d, heads, post):
    """bf16: q, k, v and the heads' output att in [rows, D] workspaces,
    pre-norm also the LayerNorm output; the two GEMMs' (width, grid) as
    ``_gemm_launch`` gives them; the core's NP / grid / shared memory those
    of ``flash_plan(..., route="tc")``'s forward, which the CUDA entry
    checks and launches as they are."""
    plan = ttb.attn_plan((b, n, d), heads, torch.bfloat16, post)
    rows = b * n
    assert plan.route == "tensor_cores"
    ws = {k: (rows, d) for k in ("q", "k", "v", "att")}
    if not post:
        ws["normed"] = (rows, d)
    assert plan.workspaces == ws
    assert plan.gemms == PLANS[(b, n, d, heads)]
    assert plan.gemms == (ttb._gemm_launch(rows, 3 * d, ttb.H100_SMS),
                          ttb._gemm_launch(rows, d, ttb.H100_SMS))
    fp = mha_fused.flash_plan((b, n, d), heads, torch.bfloat16, route="tc")
    assert plan.core == (fp.np, fp.grid_fwd, fp.smem_fwd)
    np_, grid, smem = plan.core
    nt = -(-n // 64)
    assert np_ == -(-n // 16) * 16 and grid == (heads, b, 1)
    # ftc::fwd_smem: K, V and Q tiles, per-key floats, two mbarriers, 1 KB
    assert smem == 3 * nt * 64 * 64 * 2 + 256 * 4 + 2 * 8 + 1024
    for (bn, g), width in zip(plan.gemms, (3 * d, d)):
        assert g == min(-(-width // bn) * -(-rows // ttb.TC_BM),
                        ttb.H100_SMS)


@pytest.mark.parametrize("post", [True, False])
@pytest.mark.parametrize("shape", [(256, 64, 768), (64, 197, 768), (3, 17, 768)],
                         ids=str)
def test_fp32_stays_on_the_cuda_core_body(shape, post):
    """fp32 keeps the CUDA-core body: no workspace, no GEMM or core plan
    (the CUDA entry refuses a CUDA-core call that brings one); asking for
    the tensor cores in fp32 raises; bf16 takes the CUDA-core body only
    when asked for."""
    plan = ttb.attn_plan(shape, 12, torch.float32, post)
    assert plan == ttb.AttnPlan("cuda_cores", {}, (), ())
    with pytest.raises(ValueError, match="tensor-core attention route"):
        ttb.attn_plan(shape, 12, torch.float32, post, route="tensor_cores")
    assert ttb.attn_plan(shape, 12, torch.bfloat16, post,
                         route="cuda_cores") == plan
    with pytest.raises(ValueError, match="unknown route"):
        ttb.attn_plan(shape, 12, torch.bfloat16, post, route="tc")


@pytest.mark.parametrize("shape,heads", [
    ((2, 225, 128), 2),        # N past the fit rule
    ((2, 17, 96), 3),          # head dim 32
    ((65536, 1, 64), 1),       # B past the core's grid
])
def test_bf16_misfit_raises(shape, heads):
    """A bf16 shape the tensor-core route refuses raises; no plan sends it
    to the CUDA-core body."""
    with pytest.raises(ValueError, match="tensor-core attention route"):
        ttb.attn_plan(shape, heads, torch.bfloat16, True)


def _attn_calls(model, run):
    """(x shape, heads, dtype, post-norm) of every attention-block call the
    model makes in `run` (on the CPU the wrappers run the plain versions)."""
    calls = []
    saved = ttb.postnorm_attn_block, ttb.attn_block

    def post(x, mask, *a, heads, **kw):
        calls.append((tuple(x.shape), heads, x.dtype, True))
        return saved[0](x, mask, *a, heads=heads, **kw)

    def pre(x, *a, heads, **kw):
        calls.append((tuple(x.shape), heads, x.dtype, False))
        return saved[1](x, *a, heads=heads, **kw)

    ttb.postnorm_attn_block, ttb.attn_block = post, pre
    try:
        with torch.no_grad():
            run(model)
    finally:
        ttb.postnorm_attn_block, ttb.attn_block = saved
    return calls


@pytest.mark.parametrize("kind,name,width", [
    ("text", "distilbert", (64, 768, 12)),
    ("text", "bert", (64, 768, 12)),
    ("text", "roberta", (64, 768, 12)),
    ("image", "transformer_B16", (197, 768, 12)),
    ("image", "transformer_L16", (197, 1024, 16)),
])
def test_every_registered_model_takes_the_tensor_core_route(kind, name,
                                                            width):
    """No model's routing changes: a one-layer bf16 build of every
    registered model calls its attention block at its eval widths (64
    tokens of text, 197 of a 224 px image), which the bf16 plan puts on
    the tensor cores and the fp32 plan on the CUDA-core body."""
    mdef = (get_text_model if kind == "text" else get_image_model)(name)
    model = mdef.build(4, layers=1, generator=torch.Generator().manual_seed(
        0)).to(torch.bfloat16).eval()
    if kind == "text":
        ids = torch.randint(5, 1000, (2, 64), generator=torch.Generator()
                            .manual_seed(1))
        run = lambda m: m(ids, torch.ones_like(ids, dtype=torch.int32))
    else:
        img = torch.randn((2, 224, 224, 3)).to(torch.bfloat16)   # NHWC
        run = lambda m: m(img)
    calls = _attn_calls(model, run)
    n, d, heads = width
    assert calls == [((2, n, d), heads, torch.bfloat16, kind == "text")]
    for dtype, route in ((torch.bfloat16, "tensor_cores"),
                         (torch.float32, "cuda_cores")):
        assert ttb.attn_fits(n, d, heads, dtype)
        for b in (2, 64, 256):
            assert ttb.attn_plan((b, n, d), heads, dtype,
                                 kind == "text").route == route


def _inputs(seed, b=3, n=17, d=128):
    rng = np.random.default_rng(seed)
    bf = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(
        np.float32).astype(ml_dtypes.bfloat16)
    f32 = lambda *s, loc=0.0: (loc + rng.normal(size=s) * 0.1).astype(
        np.float32)
    lens = rng.integers(1, n + 1, b)
    mask = (np.arange(n)[None, :] < lens[:, None]).astype(np.int32)
    mask[-1] = 0                     # a sample whose keys are all masked
    return dict(x=bf(b, n, d), wqkv=bf(d, 3 * d, scale=d ** -0.5),
                bqkv=f32(3 * d), wout=bf(d, d, scale=d ** -0.5), bout=f32(d),
                ls=f32(d, loc=1.0), lb=f32(d), mask=mask)


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _close(got, want):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape and np.isfinite(g).all()
    mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), 2.0 ** -126)
    tol = 2.0 ** (np.floor(np.log2(mag)) - 7) + 1e-2 * np.abs(w).max()
    assert (np.abs(g - w) <= tol).all(), float(np.abs(g - w).max())


@pytest.mark.parametrize("n", [17, 64])
@pytest.mark.parametrize("post", [True, False])
def test_plain_bf16_blocks_match_jax_pallas(post, n):
    """The plain versions the card's tensor-core route is held to, in bf16,
    against the Pallas bodies (interpret mode) at head dim 64 (two heads):
    post-norm with key lengths and one fully masked sample, which attends
    uniformly; pre-norm unmasked."""
    a = _inputs(11 + 2 * post + n, n=n)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    t = {k: _t(v) for k, v in a.items()}
    with torch.no_grad():
        if post:
            want = jtb.postnorm_attn_block(
                j["x"], j["mask"], j["wqkv"], j["bqkv"], j["wout"],
                j["bout"], j["ls"], j["lb"], heads=2, eps=1e-12, tile=1,
                interpret=True)
            got = ttb.postnorm_attn_block(
                t["x"], t["mask"], t["wqkv"], t["bqkv"], t["wout"],
                t["bout"], t["ls"], t["lb"], heads=2)
        else:
            want = jtb.attn_block(j["x"], j["ls"], j["lb"], j["wqkv"],
                                  j["bqkv"], j["wout"], j["bout"], heads=2,
                                  tile=1, interpret=True)
            got = ttb.attn_block(t["x"], t["ls"], t["lb"], t["wqkv"],
                                 t["bqkv"], t["wout"], t["bout"], heads=2)
    assert got.dtype == torch.bfloat16
    _close(got, want)
    if post:                         # the fully masked sample: finite
        assert bool(torch.isfinite(got[-1].float()).all())
