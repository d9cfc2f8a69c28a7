"""PyTorch port, the MLP blocks K5b / K6b on the tensor-core route: the
host-side launch plan that ``kernels/transformer_block.py`` hands the CUDA
entry (route by dtype, workspaces, the GEMMs' tile widths and grids), the
fit rule at every registered model's widths, and the plain bf16 blocks — the
kernels' oracle on the card — against the JAX Pallas functions in interpret
mode at D = 64, FFN = 256 over 51 rows.

Tolerance (bf16, as in ``tests/test_torch_blocks.py``): one bf16 ulp of the
value + 1e-2 of the tensor's largest |y|; the two frameworks sum in
different orders and a hidden element that rounds to the neighbouring bf16
value moves the sums it enters.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.kernels import transformer_block as jtb
from garbage_classification_rca_tpu_torch.kernels import (
    transformer_block as ttb)
from garbage_classification_rca_tpu_torch.models.registry import (
    get_image_model, get_text_model)

torch.set_num_threads(2)

# (rows, d, ffn) -> (GEMM1, GEMM2) as (tile width, grid) on 132 SMs:
# BERT-base 256 x 64 tokens, ViT-B/16 64 x 197, ViT-L/16 64 x 197, and the
# odd 3 x 17 rows (fewer tiles than SMs: one block per tile)
PLANS = {
    (16384, 768, 3072): ((256, 132), (256, 132)),
    (12608, 768, 3072): ((256, 132), (192, 132)),
    (12608, 1024, 4096): ((256, 132), (256, 132)),
    (51, 768, 3072): ((192, 16), (192, 4)),
    (51, 1024, 4096): ((192, 22), (192, 6)),
}


@pytest.mark.parametrize("post", [True, False])
@pytest.mark.parametrize("rows,d,ffn", list(PLANS), ids=str)
def test_tensor_core_plan(rows, d, ffn, post):
    """bf16: the hidden in a [rows, FFN] workspace, pre-norm also the
    LayerNorm output in a [rows, D] one; the two GEMMs' tile widths and
    persistent grids, which the wrapper passes to the CUDA entry as they
    are."""
    plan = ttb.mlp_plan(rows, d, ffn, torch.bfloat16, post)
    assert plan.route == "tensor_cores"
    assert plan.gemms == PLANS[(rows, d, ffn)]
    ws = {"hidden": (rows, ffn)}
    if not post:
        ws["normed"] = (rows, d)
    assert plan.workspaces == ws
    # a grid never exceeds the tiles it walks, nor the SMs
    for (bn, grid), n in zip(plan.gemms, (ffn, d)):
        tiles = -(-n // bn) * -(-rows // ttb.TC_BM)
        assert grid == min(tiles, ttb.H100_SMS)


@pytest.mark.parametrize("rows,ffn,want", [
    (16384, 3072, 256),      # ties of waves x width go to the wider tile
    (12608, 768, 192),       # 396 tiles = 3 full waves, against 297 in 3
    (12608, 1024, 256),
    (51, 272, 192),          # one wave either way: the narrower tile
])
def test_tile_width_rule(rows, ffn, want):
    assert ttb._gemm_launch(rows, ffn, ttb.H100_SMS)[0] == want


@pytest.mark.parametrize("rows", [16384, 12608, 51])
def test_fp32_stays_on_the_cuda_core_body(rows):
    """fp32 keeps the one-kernel body with the hidden in shared memory: no
    workspace, no GEMM launch (the CUDA entry refuses a fp32 call that
    brings one)."""
    for ffn, post in ((3072, True), (6720, False)):
        plan = ttb.mlp_plan(rows, 768, ffn, torch.float32, post)
        assert plan == ttb.MlpPlan("cuda_cores", {}, ())


def _mlp_widths(model):
    return {(m.fc1.w.shape[1], m.fc1.w.shape[0])
            for m in model.modules() if hasattr(m, "fc1")}


@pytest.mark.parametrize("kind,name,widths", [
    ("text", "distilbert", {(768, 3072)}),
    ("text", "bert", {(768, 3072)}),
    ("text", "roberta", {(768, 3072)}),
    ("image", "transformer_B16", {(768, 3072)}),
    ("image", "transformer_L16", {(1024, 4096)}),
])
def test_every_registered_width_fits_both_routes(kind, name, widths):
    """No model's route changes: the MLP widths of every registered model
    (read from a one-layer build) fit the bf16 and the fp32 route."""
    mdef = (get_text_model if kind == "text" else get_image_model)(name)
    with torch.device("meta"):
        model = mdef.build(4, layers=1)
    assert _mlp_widths(model) == widths
    for d, ffn in widths:
        for dtype in (torch.bfloat16, torch.float32):
            assert ttb.mlp_fits(d, ffn, dtype)
            assert ttb.mlp_plan(16384, d, ffn, dtype, True).route == (
                "tensor_cores" if dtype == torch.bfloat16 else "cuda_cores")


def _inputs(seed, rows=(3, 17), d=64, ffn=256):
    rng = np.random.default_rng(seed)
    bf = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(
        np.float32).astype(ml_dtypes.bfloat16)
    f32 = lambda *s, loc=0.0: (loc + rng.normal(size=s) * 0.1).astype(
        np.float32)
    return dict(x=bf(*rows, d), w1=bf(d, ffn, scale=d ** -0.5), b1=f32(ffn),
                w2=bf(ffn, d, scale=ffn ** -0.5), b2=f32(d),
                ls=f32(d, loc=1.0), lb=f32(d))


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


@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("post", [True, False])
def test_plain_bf16_blocks_match_jax_pallas(post, act):
    """The plain versions the card's kernels are held to, in bf16, against
    the Pallas bodies (interpret mode): 51 rows, no tile divides them."""
    a = _inputs(7 + 2 * post + (act == "relu"))
    j = {k: jnp.asarray(v) for k, v in a.items()}
    t = {k: _t(v) for k, v in a.items()}
    with torch.no_grad():
        if post:
            want = jtb.postnorm_mlp_block(
                j["x"], j["w1"], j["b1"], j["w2"], j["b2"], j["ls"], j["lb"],
                eps=1e-12, act=act, tile=2, interpret=True)
            got = ttb.postnorm_mlp_block(t["x"], t["w1"], t["b1"], t["w2"],
                                         t["b2"], t["ls"], t["lb"], act=act)
        else:
            want = jtb.mlp_block(j["x"], j["ls"], j["lb"], j["w1"], j["b1"],
                                 j["w2"], j["b2"], act=act, tile=2,
                                 interpret=True)
            got = ttb.mlp_block(t["x"], t["ls"], t["lb"], t["w1"], t["b1"],
                                t["w2"], t["b2"], act=act)
    assert got.dtype == torch.bfloat16
    _close(got, want)
