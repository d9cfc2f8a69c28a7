"""PyTorch port, the fused transformer blocks (K5a, K5b, K6a, K6b): the
plain versions of ``kernels/transformer_block.py`` (the CPU path and every
kernel's oracle) against the JAX package's Pallas functions in interpret
mode and against its unfused graphs, on the same numpy inputs; the fit
rules; and the routing of the post-norm layer.

Tolerances. fp32: |d| <= 2e-5 + 2e-5 |y| (summation order; the Pallas body's
polynomial erf differs from the exact one by <= 1.5e-7 |hidden|). bf16: one
bf16 ulp of the value + 1e-2 of the tensor's largest |y| (the two
frameworks accumulate in different orders, and a q / k / v / hidden element
that rounds to the neighbouring bf16 value moves the sums it enters).
Seen over these cases: fp32 1.9e-6; bf16 3.9e-2, one ulp of an output
between 4 and 8 (the pre-norm outputs x + out reach that size).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.kernels import transformer_block as jtb
from garbage_classification_rca_tpu.models.text import (
    encoder_common as jenc)
from garbage_classification_rca_tpu_torch.kernels import (
    transformer_block as ttb)
from garbage_classification_rca_tpu_torch.models.text import (
    encoder_common as tenc)

torch.set_num_threads(2)

# (b, n, d, heads, ffn): an odd N with a batch no tile divides, N = 1, and
# the kernels' head dim 64
SHAPES = [(3, 17, 32, 4, 64), (5, 9, 128, 2, 80), (2, 1, 64, 1, 48)]
DTYPES = ["float32", "bfloat16"]


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _inputs(shape, dtype, seed):
    b, n, d, heads, ffn = shape
    rng = np.random.default_rng(seed)
    npdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    r = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(
        np.float32).astype(npdt)
    a = dict(
        x=r(b, n, d), ls=(1.0 + rng.normal(size=d) * 0.1).astype(np.float32),
        lb=(rng.normal(size=d) * 0.1).astype(np.float32),
        wqkv=r(d, 3 * d, scale=0.1), bqkv=r(3 * d, scale=0.1),
        wout=r(d, d, scale=0.1), bout=r(d, scale=0.1),
        w1=r(d, ffn, scale=0.1), b1=r(ffn, scale=0.1),
        w2=r(ffn, d, scale=0.1), b2=r(d, scale=0.1))
    lens = rng.integers(1, n + 1, b)
    mask = (np.arange(n)[None, :] < lens[:, None]).astype(np.int32)
    mask[-1] = 0                          # a row whose keys are all masked
    a["mask"] = mask
    return a


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _close(got: torch.Tensor, want, dtype):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape and np.isfinite(g).all()
    d = np.abs(g - w)
    if dtype == "float32":
        tol = 2e-5 + 2e-5 * np.abs(w)
    else:
        mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), 2.0 ** -126)
        tol = 2.0 ** (np.floor(np.log2(mag)) - 7) + 1e-2 * np.abs(w).max()
    assert (d <= tol).all(), (float(d.max()), float(np.abs(w).max()))
    return float(d.max())


def _jax_unfused_postnorm_layer(a, heads, eps):
    """The JAX unfused eval layer; mask=None keeps every fused branch off
    and the additive bias carries the key mask."""
    j = jnp.asarray
    d = a["x"].shape[-1]
    p = {"q": {"w": j(a["wqkv"][:, :d]), "b": j(a["bqkv"][:d])},
         "k": {"w": j(a["wqkv"][:, d:2 * d]), "b": j(a["bqkv"][d:2 * d])},
         "v": {"w": j(a["wqkv"][:, 2 * d:]), "b": j(a["bqkv"][2 * d:])},
         "out": {"w": j(a["wout"]), "b": j(a["bout"])},
         "ln_att": {"scale": j(a["ls"]), "bias": j(a["lb"])},
         "fc1": {"w": j(a["w1"]), "b": j(a["b1"])},
         "fc2": {"w": j(a["w2"]), "b": j(a["b2"])},
         "ln_ffn": {"scale": j(a["ls"]), "bias": j(a["lb"])}}
    return jenc.postnorm_layer(p, j(a["x"]), jenc.attention_bias(j(a["mask"])),
                               heads, eps, mask=None)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_postnorm_attn_block_matches_jax_pallas(shape, dtype):
    a = _inputs(shape, dtype, 1)
    heads = shape[3]
    j = jnp.asarray
    want = jtb.postnorm_attn_block(
        j(a["x"]), j(a["mask"]), j(a["wqkv"]), j(a["bqkv"]), j(a["wout"]),
        j(a["bout"]), j(a["ls"]), j(a["lb"]), heads=heads, eps=1e-12,
        tile=2, interpret=True)
    got = ttb.postnorm_attn_block(
        _t(a["x"]), _t(a["mask"]), _t(a["wqkv"]), _t(a["bqkv"]),
        _t(a["wout"]), _t(a["bout"]), _t(a["ls"]), _t(a["lb"]), heads=heads)
    _close(got, want, dtype)
    # the fully masked row attends uniformly: finite, no NaN
    assert bool(torch.isfinite(got[-1]).all())


@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_postnorm_mlp_block_matches_jax_pallas(shape, dtype, act):
    a = _inputs(shape, dtype, 2)
    j = jnp.asarray
    want = jtb.postnorm_mlp_block(
        j(a["x"]), j(a["w1"]), j(a["b1"]), j(a["w2"]), j(a["b2"]),
        j(a["ls"]), j(a["lb"]), eps=1e-12, act=act, tile=2, interpret=True)
    got = ttb.postnorm_mlp_block(
        _t(a["x"]), _t(a["w1"]), _t(a["b1"]), _t(a["w2"]), _t(a["b2"]),
        _t(a["ls"]), _t(a["lb"]), act=act)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_postnorm_pair_matches_jax_unfused_layer(shape, dtype):
    a = _inputs(shape, dtype, 3)
    heads = shape[3]
    want = _jax_unfused_postnorm_layer(a, heads, 1e-12)
    h = ttb.postnorm_attn_block(
        _t(a["x"]), _t(a["mask"]), _t(a["wqkv"]), _t(a["bqkv"]),
        _t(a["wout"]), _t(a["bout"]), _t(a["ls"]), _t(a["lb"]), heads=heads)
    got = ttb.postnorm_mlp_block(
        h, _t(a["w1"]), _t(a["b1"]), _t(a["w2"]), _t(a["b2"]), _t(a["ls"]),
        _t(a["lb"]))
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_attn_block_matches_jax_pallas_and_reference(shape, dtype):
    a = _inputs(shape, dtype, 4)
    heads = shape[3]
    j = jnp.asarray
    args = (j(a["x"]), j(a["ls"]), j(a["lb"]), j(a["wqkv"]), j(a["bqkv"]),
            j(a["wout"]), j(a["bout"]))
    got = ttb.attn_block(
        _t(a["x"]), _t(a["ls"]), _t(a["lb"]), _t(a["wqkv"]), _t(a["bqkv"]),
        _t(a["wout"]), _t(a["bout"]), heads=heads)
    _close(got, jtb.attn_block(*args, heads=heads, tile=2, interpret=True),
           dtype)
    _close(got, jtb.attn_block_reference(*args, heads=heads), dtype)


@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_mlp_block_matches_jax_pallas_and_reference(shape, dtype, act):
    a = _inputs(shape, dtype, 5)
    j = jnp.asarray
    args = (j(a["x"]), j(a["ls"]), j(a["lb"]), j(a["w1"]), j(a["b1"]),
            j(a["w2"]), j(a["b2"]))
    got = ttb.mlp_block(
        _t(a["x"]), _t(a["ls"]), _t(a["lb"]), _t(a["w1"]), _t(a["b1"]),
        _t(a["w2"]), _t(a["b2"]), act=act)
    _close(got, jtb.mlp_block(*args, act=act, tile=2, interpret=True), dtype)
    _close(got, jtb.mlp_block_reference(*args, act=act), dtype)


def test_wrappers_check_their_arguments():
    a = _inputs((2, 5, 64, 1, 32), "float32", 6)
    x, ls, lb = _t(a["x"]), _t(a["ls"]), _t(a["lb"])
    attn = [_t(a[k]) for k in ("wqkv", "bqkv", "wout", "bout")]
    mlp = [_t(a[k]) for k in ("w1", "b1", "w2", "b2")]
    with pytest.raises(TypeError, match="weight"):
        ttb.attn_block(x, ls, lb, attn[0].t(), *attn[1:], heads=1)
    with pytest.raises(TypeError, match="weight"):
        ttb.mlp_block(x.to(torch.bfloat16), ls, lb, *mlp)    # fp32 weights
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ttb.mlp_block(x.double(), ls, lb, *mlp)
    with pytest.raises(TypeError, match="mask"):
        ttb.postnorm_attn_block(x, _t(a["mask"]).long(), *attn, ls, lb,
                                heads=1)
    with pytest.raises(ValueError, match="divisible"):
        ttb.attn_block(x, ls, lb, *attn, heads=3)
    with pytest.raises(ValueError, match="act"):
        ttb.mlp_block(x, ls, lb, *mlp, act="tanh")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ttb.mlp_block(x.to("meta"), *[t.to("meta") for t in (ls, lb, *mlp)])
    # no launch is counted on the CPU
    assert ttb.attn_block.launches == ttb.mlp_block.launches == 0
    assert ttb.postnorm_attn_block.launches == 0
    assert ttb.postnorm_mlp_block.launches == 0


@pytest.mark.parametrize("n,d,heads,ffn,dtype,attn,mlp", [
    (64, 768, 12, 3072, torch.bfloat16, True, True),     # BERT family
    (64, 768, 12, 3072, torch.float32, True, True),
    (197, 768, 12, 3072, torch.bfloat16, True, True),    # ViT-B/16
    (197, 1024, 16, 4096, torch.bfloat16, True, True),   # ViT-L/16
    (197, 1024, 16, 4096, torch.float32, True, True),
    (224, 768, 12, 3072, torch.float32, True, True),
    (225, 768, 12, 3072, torch.bfloat16, False, True),   # too many tokens
    (512, 768, 12, 3072, torch.bfloat16, False, True),
    (64, 768, 8, 3072, torch.bfloat16, False, True),     # head dim 96
    (64, 768, 12, 3072, torch.float16, False, False),
    (64, 768, 12, 13456, torch.float32, True, False),    # hidden too wide
    (64, 768, 12, 3000, torch.bfloat16, True, False),    # not a multiple of 16
    # bf16 keeps the hidden in device memory: no limit on FFN; fp32 keeps
    # 8 rows of it in shared memory: FFN <= 6,720
    (64, 768, 12, 13456, torch.bfloat16, True, True),
    (64, 768, 12, 6720, torch.float32, True, True),
    (64, 768, 12, 6736, torch.float32, True, False),
])
def test_fit_rules(n, d, heads, ffn, dtype, attn, mlp):
    assert ttb.attn_fits(n, d, heads, dtype) is attn
    assert ttb.mlp_fits(d, ffn, dtype) is mlp
    assert ttb.blocks_fit(n, d, ffn, heads, dtype) is (attn and mlp)


def _spy(monkeypatch):
    calls = {"attn": 0, "mlp": 0, "mha": 0, "flash": 0}

    def count(key, fn):
        def spy(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return spy

    monkeypatch.setattr(tenc.transformer_block, "postnorm_attn_block",
                        count("attn", ttb.postnorm_attn_block))
    monkeypatch.setattr(tenc.transformer_block, "postnorm_mlp_block",
                        count("mlp", ttb.postnorm_mlp_block))
    monkeypatch.setattr(tenc, "mha", count("mha", tenc.mha))
    monkeypatch.setattr(tenc, "mha_flash_train",
                        count("flash", tenc.mha_flash_train))
    return calls


@pytest.mark.parametrize("n,heads,dtype,kw,want", [
    (16, 2, torch.float32, {}, "fused"),
    (16, 2, torch.bfloat16, {}, "fused"),
    (225, 2, torch.float32, {}, "mha"),                  # over 224 tokens
    (16, 4, torch.float32, {}, "mha"),                   # head dim 32
    (16, 2, torch.float32, {"fused_blocks": False}, "mha"),
    (16, 2, torch.float32, {"train": True}, "flash"),
])
def test_postnorm_layer_routing(monkeypatch, n, heads, dtype, kw, want):
    """A call-count spy: the fused pair where the fit rule says, the mha
    kernel's route elsewhere; and both routes compute the same layer."""
    calls = _spy(monkeypatch)
    layer = tenc.PostNormLayer(128, 96, 1e-12,
                               generator=torch.Generator().manual_seed(0)
                               ).to(dtype)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, n, 128), generator=g).to(dtype)
    mask = torch.ones((2, n), dtype=torch.int32)
    mask[1, n // 2:] = 0
    got = tenc.postnorm_layer(layer, x, mask, heads, **kw)
    fused = want == "fused"
    assert calls == {"attn": int(fused), "mlp": int(fused),
                     "mha": int(want == "mha"),
                     "flash": int(want == "flash")}
    other = tenc.postnorm_layer(layer, x, mask, heads, fused_blocks=not fused)
    _close(got, other.float().numpy(),
           "float32" if dtype == torch.float32 else "bfloat16")


def test_packed_weights_are_built_once_and_follow_the_parameters():
    layer = tenc.PostNormLayer(64, 32, 1e-12,
                               generator=torch.Generator().manual_seed(0))
    attn, mlp = layer.packed()
    assert layer.packed()[0][0] is attn[0]            # not rebuilt per call
    assert tuple(attn[0].shape) == (64, 192)          # [D, 3D], input-major
    torch.testing.assert_close(attn[0][:, 64:128], layer.k.w.t())
    torch.testing.assert_close(mlp[0], layer.fc1.w.t())
    with torch.no_grad():
        layer.k.w.mul_(2.0)                           # a load writes in place
    torch.testing.assert_close(layer.packed()[0][0][:, 64:128], layer.k.w.t())
    layer.to(torch.bfloat16)                          # the CLI's cast
    assert layer.packed()[0][0].dtype == torch.bfloat16
    assert layer.packed()[0][1].dtype == torch.float32      # biases fp32
    assert "_packed" not in layer.state_dict()


def test_fusion_tower_never_takes_the_fused_blocks(monkeypatch):
    """The MM-RCA text tower stays on the mha kernel's route (the JAX
    package's ``fused_blocks=False``), at a shape the fused pair takes."""
    from garbage_classification_rca_tpu_torch.models.fusion import (
        multimodal as tmm)
    from garbage_classification_rca_tpu_torch.models.image import (
        efficientnet_common as teff)
    from garbage_classification_rca_tpu_torch.models.text import distilbert

    calls = _spy(monkeypatch)
    short = teff.EffNetConfig(
        stages=(("fused", 1, 3, 1, 8, 8, 1), ("fused", 4, 3, 2, 8, 16, 1),
                ("fused", 4, 3, 2, 16, 16, 1), ("mb", 4, 3, 2, 16, 24, 1),
                ("mb", 6, 3, 1, 24, 24, 1), ("mb", 6, 3, 2, 24, 32, 1),
                ("mb", 6, 3, 1, 32, 40, 1)),
        stem_out=8, head_out=1280, bn_eps=1e-3)
    g = torch.Generator().manual_seed(0)
    model = tmm.FusionModel(tmm.FusionConfig(reverse=True), text_layers=2,
                            image_cfg=short, generator=g).eval()
    ids = torch.randint(5, 3000, (2, 16), generator=g, dtype=torch.int32)
    mask = torch.ones((2, 16), dtype=torch.int32)
    assert ttb.blocks_fit(16, 768, 3072, 12, torch.float32)
    logits = model(ids, mask, torch.randn((2, 64, 64, 3), generator=g))
    assert tuple(logits.shape) == (2, 4)
    assert calls == {"attn": 0, "mlp": 0, "mha": 2, "flash": 0}
    distilbert.encode(model.text, ids, mask)          # the stand-alone tower
    assert calls == {"attn": 2, "mlp": 2, "mha": 2, "flash": 0}
