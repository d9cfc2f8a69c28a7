"""PyTorch port, the BLIP-2 / Q-Former eval slice, against the JAX package
on the same weights and inputs (numpy, from seeds):

  * K2 at the VLM's head dims: the port's ``mha`` (its plain version on the
    CPU) against the JAX Pallas ``mha`` in interpret mode at head dim 88
    (EVA ViT-g: N 257, no mask) and 80 (OPT-2.7B: N 132, causal with a
    left-pad key mask), 2 heads, fp32 1e-5;
  * the EVA tower, the Q-Former, the OPT decoder with LoRA on,
    ``next_token_logits`` and ``qformer_cls_feature`` on a narrow
    configuration that keeps head dims 88 and 80 (vision 176 / 2 heads,
    OPT 160 / 2 heads, 2 layers each), the JAX ``init`` trees carried
    across by ``from_jax.load_blip2_tree``, against the JAX graph
    (``GC_RCA_FUSED_ATTN`` unset: the JAX layers' einsum attention), fp32,
    within 1e-4 of the largest |output|;
  * ``convert_torch`` of a ``transformers`` ``Blip2ForConditionalGeneration``
    built here at that configuration, plain and peft-wrapped: the same trees
    as the JAX converter, every checkpoint key read, and the port's
    next-token logits against HF's; ``chip_smoke``'s HF writer (the
    ``.pth`` of its CLI drive) reads back through the converter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.checkpoint.torch_convert import (
    TrackingDict)
from garbage_classification_rca_tpu.kernels.mha_fused import mha as jax_mha
from garbage_classification_rca_tpu.kernels.mha_fused import (
    mha_reference as jax_mha_reference)
from garbage_classification_rca_tpu.models.vlm import blip2 as jblip2
from garbage_classification_rca_tpu.models.vlm import (
    blip2_vision as jvision)
from garbage_classification_rca_tpu.models.vlm import opt as jopt
from garbage_classification_rca_tpu.models.vlm import qformer as jqf
from garbage_classification_rca_tpu_torch.checkpoint.from_jax import (
    load_blip2_tree)
from garbage_classification_rca_tpu_torch.kernels import mha_fused as K
from garbage_classification_rca_tpu_torch.kernels.transformer_block import (
    MAX_SMEM)
from garbage_classification_rca_tpu_torch.models.vlm import blip2
from garbage_classification_rca_tpu_torch.models.vlm import (
    blip2_vision as tvision)
from garbage_classification_rca_tpu_torch.models.vlm import opt as topt
from garbage_classification_rca_tpu_torch.models.vlm import qformer as tqf

torch.set_num_threads(2)

RTOL = 1e-4                 # of the largest |output|, fp32
NQ = 8                      # query tokens of the narrow configuration
L = 24                      # prompt tokens


@pytest.fixture(autouse=True)
def _no_grad(monkeypatch):
    monkeypatch.delenv("GC_RCA_FUSED_ATTN", raising=False)
    with torch.no_grad():
        yield


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), err


# ---------------------------------------------------------------------------
# K2 at head dims 88 and 80
# ---------------------------------------------------------------------------


def _left_pad_mask(n, pads):
    return (np.arange(n)[None, :] >= np.asarray(pads)[:, None]).astype(
        np.int32)


@pytest.mark.parametrize("name", ["eva", "opt"])
def test_k2_plain_matches_pallas_at_vlm_head_dims(name):
    """Rows with no attendable key at or before the diagonal (a left-padded
    causal row whose keys up to it are all pads) are left out of the
    Pallas comparison: the Pallas body adds the causal bias to the key
    bias, so such a row spreads its weights over the keys up to the
    diagonal only, where the port's kernel and plain version (and the JAX
    ``mha_reference``, held on every row below) spread them over all N
    keys. Those rows are pad positions that no valid query reads."""
    rng = np.random.default_rng(88 if name == "eva" else 80)
    if name == "eva":
        b, n, heads, dh, causal = 2, 257, 2, 88, False
        m = None
    else:
        b, n, heads, dh, causal = 3, 132, 2, 80, True
        m = _left_pad_mask(n, [0, 40, n - 1])
    q, k, v = (rng.normal(size=(b, n, heads * dh)).astype(np.float32)
               for _ in range(3))
    got = K.mha(*(torch.from_numpy(a) for a in (q, k, v)), heads=heads,
                mask=None if m is None else torch.from_numpy(m),
                causal=causal).numpy()
    jargs = dict(heads=heads, mask=None if m is None else jnp.asarray(m),
                 causal=causal)
    want = np.asarray(jax_mha(*(jnp.asarray(a) for a in (q, k, v)),
                              interpret=True, **jargs))
    ref = np.asarray(jax_mha_reference(*(jnp.asarray(a) for a in (q, k, v)),
                                       **jargs))
    rows = np.ones((b, n), bool) if m is None else m.astype(bool)
    assert rows.sum() < b * n or m is None
    np.testing.assert_allclose(got[rows], want[rows], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert K.mha.launches == 0        # CPU tensors: the plain version


@pytest.mark.parametrize("shape,heads", [((16, 257, 1408), 16),
                                         ((16, 132, 2560), 32)])
def test_mha_plan_takes_vlm_head_dims_for_the_eval_forward_only(shape,
                                                                heads):
    """``mha_plan`` sends bf16 at head dims 88 / 80 to the tensor-core
    forward (a block per (64-row query tile, head, sample), np = N rounded
    up to 16, ``ftc::wide_smem``'s shared memory: K then V and the query
    tile at 12 KB a 64-row tile of 96 columns) and fp32, or any dtype with
    ``route="cuda_core"``, to the CUDA-core forward (67,072 bytes at N
    257), in both cases with no backward. ``flash_plan`` refuses 88 for
    both training pairs and 80 for the dropout pair; the flash pair
    without dropout takes 80 in bf16 as ("tc", "tc"): the forward and the
    backward on the tensor cores (OPT-2.7B's LoRA training:
    ``tests/test_torch_vlm_train.py``), in fp32 on the CUDA cores. Another
    head dim still raises."""
    b, n, d = shape
    dh = d // heads
    tiles = -(-n // 64)
    plan = K.mha_plan(shape, heads, torch.bfloat16)
    assert (plan.route, plan.bwd_route, plan.np) == ("tc", "none",
                                                    -(-n // 16) * 16)
    assert plan.grid_fwd == (tiles, heads, b)
    assert plan.smem_fwd == (tiles + 1) * 64 * 96 * 2 + 272 * 4 + 32 + 1024
    # three blocks to an SM (ftc::wide_kernel's launch bounds): the SM's
    # 228 KB, 1 KB of it reserved a block
    assert plan.smem_fwd <= MAX_SMEM
    assert 3 * (plan.smem_fwd + 1024) <= 228 * 1024
    assert K.mha_plan(shape, heads, torch.bfloat16, route="tc") == plan
    for dtype, route in ((torch.float32, None), (torch.float32, "cuda_core"),
                         (torch.bfloat16, "cuda_core")):
        plan = K.mha_plan(shape, heads, dtype, route=route)
        assert (plan.route, plan.bwd_route, plan.grid_fwd, plan.np) == (
            "cuda_core", "none", (-(-n // 32), heads, b), n)
        assert plan.smem_fwd == 4 * (96 * (dh + 1) + 32 * n)
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="head dims"):
            K.flash_plan(shape, heads, dtype, dropout=True)
        if dh == 88:
            with pytest.raises(ValueError, match="head dims"):
                K.flash_plan(shape, heads, dtype)
        else:
            plan = K.flash_plan(shape, heads, dtype)
            assert (plan.route, plan.bwd_route) == (
                ("tc", "tc") if dtype == torch.bfloat16
                else ("cuda_core", "cuda_core"))
        with pytest.raises(ValueError, match="tensor-core route"):
            K.mha_plan(shape, heads, torch.float32, route="tc")
        with pytest.raises(ValueError):
            K.mha_plan(shape, heads, dtype, route="tc32")
    assert K.mha_plan((16, 257, 1408), 16, torch.float32).smem_fwd == 67072
    with pytest.raises(ValueError, match="head dims"):
        K.mha_plan((2, 8, 96), 1, torch.float32)
    assert K.mha_plan((2, 64, 768), 12, torch.bfloat16) == K.flash_plan(
        (2, 64, 768), 12, torch.bfloat16)


# ---------------------------------------------------------------------------
# the towers on the JAX trees
# ---------------------------------------------------------------------------

JCFG = jblip2.Blip2Config(
    vision=jvision.VisionConfig(layers=2, hidden=176, heads=2, ffn=96),
    qformer=jqf.QFormerConfig(layers=2, hidden=48, heads=4, ffn=64,
                              n_query=NQ, cross_frequency=2,
                              vision_hidden=176),
    opt=jopt.OPTConfig(layers=2, hidden=160, heads=2, ffn=96, vocab=300,
                       max_pos=128),
    lora_r=4, lora_alpha=8)
TCFG = blip2.Blip2Config(
    vision=tvision.VisionConfig(layers=2, hidden=176, heads=2, ffn=96),
    qformer=tqf.QFormerConfig(layers=2, hidden=48, heads=4, ffn=64,
                              n_query=NQ, cross_frequency=2,
                              vision_hidden=176),
    opt=topt.OPTConfig(layers=2, hidden=160, heads=2, ffn=96, vocab=300,
                       max_pos=128),
    lora_r=4, lora_alpha=8)


def _np_tree(t, rng):
    """The tree as fp32 numpy; LayerNorms moved off (1, 0) so that their
    parameters count."""
    t = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)

    def walk(x):
        if isinstance(x, dict):
            if set(x) == {"scale", "bias"}:
                return {"scale": x["scale"] + rng.normal(
                            0, 0.1, x["scale"].shape).astype(np.float32),
                        "bias": rng.normal(0, 0.1, x["bias"].shape
                                           ).astype(np.float32)}
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        return x

    return walk(t)


@pytest.fixture(scope="module")
def trees():
    """(params, lora, classifier) of the JAX inits, B of the adapters
    drawn non-zero so that they change the output."""
    rng = np.random.default_rng(5)
    params = _np_tree(jblip2.init(jax.random.PRNGKey(0), JCFG), rng)
    lora = _np_tree(jblip2.init_lora(jax.random.PRNGKey(1), JCFG), rng)
    for layer in lora.values():
        for pair in layer.values():
            pair["b"] = rng.normal(0, 0.05, pair["b"].shape).astype(
                np.float32)
    clf = _np_tree({"classifier": jblip2.init_classifier(
        jax.random.PRNGKey(2), JCFG)}, rng)
    return params, lora, clf


@pytest.fixture(scope="module")
def port_model(trees):
    params, lora, clf = trees
    model = blip2.build_model(TCFG, "cpu", lora=True, classifier=True)
    return load_blip2_tree(model, params, lora, clf)


def _inputs(seed=3, b=3):
    rng = np.random.default_rng(seed)
    pix = rng.normal(size=(b, 224, 224, 3)).astype(np.float32)
    ids = rng.integers(4, 300, (b, L)).astype(np.int32)
    mask = _left_pad_mask(L, [0, 9, L - 2])[:b]
    return pix, ids * mask + (1 - mask), mask


def test_port_configs_keep_the_vlm_head_dims():
    assert TCFG.vision.hidden // TCFG.vision.heads == 88
    assert TCFG.opt.hidden // TCFG.opt.heads == 80
    assert TCFG.vision.tokens == 257


def test_eva_tower_matches_jax(trees, port_model):
    params, _, _ = trees
    pix, _, _ = _inputs()
    want = jvision.encode(params["vision"], jnp.asarray(pix), JCFG.vision)
    _close(port_model.vision(torch.from_numpy(pix)).numpy(), want)


def test_qformer_matches_jax(trees, port_model):
    params, _, _ = trees
    img = np.random.default_rng(4).normal(size=(3, 257, 176)).astype(
        np.float32)
    want = jqf.encode(params["qformer"], jnp.asarray(img), JCFG.qformer)
    _close(port_model.qformer(torch.from_numpy(img)).numpy(), want)


@pytest.mark.parametrize("with_lora", [True, False])
def test_opt_decoder_matches_jax(trees, port_model, with_lora):
    """The decoder over left-padded rows (one nearly all pad), the adapters
    on or off; every position compared (the pad rows too: both sides
    spread a row without an attendable key over all keys)."""
    params, lora, _ = trees
    rng = np.random.default_rng(6)
    n = NQ + L
    embeds = rng.normal(size=(3, n, 160)).astype(np.float32)
    mask = _left_pad_mask(n, [0, 12, n - 1])
    want = jopt.decode_hidden(params["opt"], jnp.asarray(embeds),
                              jnp.asarray(mask), JCFG.opt,
                              lora=lora if with_lora else None,
                              lora_scale=JCFG.lora_scale)
    got = topt.decode_hidden(port_model.opt, torch.from_numpy(embeds),
                             torch.from_numpy(mask),
                             lora=port_model.lora if with_lora else None,
                             lora_scale=TCFG.lora_scale)
    _close(got.numpy(), want)
    assert TCFG.lora_scale == JCFG.lora_scale


def test_next_token_logits_and_qformer_feature_match_jax(trees, port_model):
    params, lora, clf = trees
    pix, ids, mask = _inputs()
    want = jblip2.next_token_logits(params, jnp.asarray(pix),
                                    jnp.asarray(ids), jnp.asarray(mask),
                                    JCFG, lora=lora)
    got = blip2.next_token_logits(port_model, torch.from_numpy(pix),
                                  torch.from_numpy(ids),
                                  torch.from_numpy(mask))
    _close(got.numpy(), want)
    assert np.array_equal(got.numpy().argmax(-1),
                          np.asarray(want).argmax(-1))
    feat = blip2.qformer_cls_feature(port_model, torch.from_numpy(pix))
    want_f = jblip2.qformer_cls_feature(params, jnp.asarray(pix), JCFG)
    _close(feat.numpy(), want_f)
    from garbage_classification_rca_tpu.nn import core as jnn

    _close(port_model.classifier(feat).numpy(),
           jnn.linear(clf["classifier"], want_f))


def test_last_valid_index_is_pad_side_agnostic():
    m = np.array([[0, 0, 1, 1, 1], [1, 1, 1, 0, 0], [0, 0, 0, 0, 0]],
                 np.int32)
    got = blip2._last_valid_index(torch.from_numpy(m)).numpy()
    assert got.tolist() == np.asarray(
        jblip2._last_valid_index(jnp.asarray(m))).tolist() == [4, 2, 0]


def test_cast_keeps_layernorms_and_classifier_fp32(trees):
    params, lora, clf = trees
    model = load_blip2_tree(
        blip2.build_model(TCFG, "cpu", lora=True, classifier=True),
        params, lora, clf).cast_(torch.bfloat16)
    assert model.opt.layers[0].q.w.dtype == torch.bfloat16
    assert model.lora["0"].q.a.dtype == torch.bfloat16
    assert model.opt.final_ln.scale.dtype == torch.float32
    assert model.classifier.w.dtype == torch.float32
    with pytest.raises(ValueError, match="no 'lora'"):
        load_blip2_tree(blip2.build_model(TCFG, "cpu", lora=False),
                        params, lora)


# ---------------------------------------------------------------------------
# the HF-layout converter
# ---------------------------------------------------------------------------


def _hf_model(seed=0):
    """A tiny ``Blip2ForConditionalGeneration`` at the narrow configuration,
    every tensor drawn from a numpy seed (LayerNorm weights near 1)."""
    from transformers import (Blip2Config, Blip2ForConditionalGeneration,
                              Blip2QFormerConfig, Blip2VisionConfig,
                              OPTConfig)

    hf = Blip2Config(
        vision_config=Blip2VisionConfig(
            hidden_size=176, intermediate_size=96, num_hidden_layers=2,
            num_attention_heads=2, image_size=224, patch_size=14).to_dict(),
        qformer_config=Blip2QFormerConfig(
            hidden_size=48, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, encoder_hidden_size=176,
            cross_attention_frequency=2).to_dict(),
        text_config=OPTConfig(
            hidden_size=160, num_hidden_layers=2, num_attention_heads=2,
            ffn_dim=96, vocab_size=300, max_position_embeddings=128,
            word_embed_proj_dim=160).to_dict(),
        num_query_tokens=NQ)
    tm = Blip2ForConditionalGeneration(hf).eval()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in tm.named_parameters():
            a = rng.normal(0, 0.05, tuple(p.shape)).astype(np.float32)
            if "norm" in name.lower() and name.endswith("weight"):
                a += 1.0
            p.copy_(torch.from_numpy(a))
    return tm


def _peft(tm):
    """The reference's LoRA wrap (blip_2_training.py:210-217) at r 4,
    B drawn non-zero."""
    from peft import LoraConfig, get_peft_model

    pm = get_peft_model(tm, LoraConfig(r=4, lora_alpha=8, lora_dropout=0.05,
                                       bias="none",
                                       target_modules=["q_proj", "k_proj"]))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for n, p in pm.named_parameters():
            if "lora_B" in n:
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    return pm.eval()


def _sd(module):
    return {k: v.detach().cpu().numpy() for k, v in
            module.state_dict().items()}


def _same_tree(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same_tree(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{where}.{i}")
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b)), where


@pytest.mark.parametrize("peft", [False, True], ids=["plain", "peft"])
def test_convert_torch_matches_jax_and_reads_every_key(peft):
    tm = _hf_model()
    if peft:
        tm = _peft(tm)
    td = TrackingDict(_sd(tm))
    params, lora = blip2.convert_torch(td, TCFG)
    td.audit()                              # every key read, peft's too
    jparams, jlora = jblip2.convert_torch(_sd(tm), JCFG)
    _same_tree(params, jax.tree_util.tree_map(np.asarray, jparams))
    if peft:
        assert sorted(lora) == ["0", "1"] and lora["0"]["q"]["a"].shape == (
            160, 4)
        _same_tree(lora, jax.tree_util.tree_map(np.asarray, jlora))
    else:
        assert lora is None and jlora is None
    # the port's next-token logits against HF's own forward (the query
    # embeddings scattered into leading image placeholders, as 4.5x does)
    model = load_blip2_tree(blip2.build_model(TCFG, "cpu", lora=peft),
                            params, lora)
    rng = np.random.default_rng(7)
    pix = rng.normal(size=(2, 3, 224, 224)).astype(np.float32)
    ids = rng.integers(4, 300, (2, 9)).astype(np.int32)
    hf = tm.base_model.model if peft else tm
    hf.config.image_token_id = 3
    ph = np.full((2, NQ), 3, np.int64)
    with torch.no_grad():
        out = tm(pixel_values=torch.from_numpy(pix),
                 input_ids=torch.from_numpy(np.concatenate([ph, ids], 1)),
                 attention_mask=torch.ones(2, NQ + 9, dtype=torch.long))
    got = blip2.next_token_logits(
        model, torch.from_numpy(pix.transpose(0, 2, 3, 1)),
        torch.from_numpy(ids), torch.ones(2, 9, dtype=torch.int32))
    _close(got.numpy(), out.logits[:, -1].numpy(), rtol=2e-4)


def test_chip_smoke_hf_writer_round_trips(port_model):
    """``chip_smoke.blip2_hf_state_dict`` (the ``.pth`` phase 12 hands the
    CLIs) reads back through ``convert_torch``, every key read, into the
    same weights at bf16 precision, the adapters with them."""
    import chip_smoke

    sd = {k: v.float().numpy() for k, v in
          chip_smoke.blip2_hf_state_dict(port_model).items()}
    td = TrackingDict(sd)
    params, lora = blip2.convert_torch(td, TCFG)
    td.audit()
    back = load_blip2_tree(blip2.build_model(TCFG, "cpu", lora=True),
                           params, lora)
    for (name, a), (_, b) in zip(back.named_parameters(),
                                 port_model.named_parameters()):
        assert torch.equal(a, b.to(torch.bfloat16).float()), name
