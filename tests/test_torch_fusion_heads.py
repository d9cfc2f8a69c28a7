"""PyTorch port, the late-fusion family: JAX ``multimodal.forward(...,
eval_mode=True)`` against the port's forward for every (strategy, tower)
pair the JAX package runs, on the same weights (drawn by JAX, every head,
loaded through ``checkpoint/from_jax``) and the same inputs.

fp32, batch 6, 64x64 images, seq 16 with padded rows, the short 7-stage
EfficientNet table with the real 1280-d head (set on the JAX side through
``effv2.CONFIGS``; no JAX file changes); DistilBERT / BERT cut to 2 layers,
BART-large at full width with 2 + 2 layers and a 1000-token vocabulary.
Logits agree within rtol = atol = 1e-4 and the argmax is equal. Also:
one BERT-tower case with the JAX kernels on (interpret mode); the
hierarchical head on a depth-1 table with the real stage-3 / stage-6
widths at 480x480 (4 text layers: it taps hidden states 2 and 4); CLIP's
pad hack at batch 8; modality removal; the reference all-heads state dict
through both ``convert_torch``s, leaf by leaf; the refusals; and the
hierarchical head's flatten order against the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.models.fusion import multimodal as jmm
from garbage_classification_rca_tpu.models.image import efficientnet_common as jeff
from garbage_classification_rca_tpu.models.image import efficientnet_v2 as jeffv2
from garbage_classification_rca_tpu.models.text import bart as jbart
from garbage_classification_rca_tpu.models.text import bert as jbert
from garbage_classification_rca_tpu.models.text import distilbert as jdistil
from garbage_classification_rca_tpu.nn import core as jnn
from garbage_classification_rca_tpu_torch.models.fusion import multimodal as tmm
from garbage_classification_rca_tpu_torch.models.image import efficientnet_common as teff
from garbage_classification_rca_tpu_torch.models.text import bart as tbart
from garbage_classification_rca_tpu_torch.nn import core as tcore

torch.set_num_threads(2)


def _tables(stages, stem):
    j = jeff.EffNetConfig(stages=stages, stem_out=stem, head_out=1280,
                          bn_eps=1e-3)
    return j, teff.EffNetConfig(stages=stages, stem_out=stem, head_out=1280,
                                bn_eps=1e-3)


SHORT, SHORT_T = _tables(
    (("fused", 1, 3, 1, 8, 8, 1), ("fused", 4, 3, 2, 8, 16, 1),
     ("fused", 4, 3, 2, 16, 16, 1), ("mb", 4, 3, 2, 16, 24, 1),
     ("mb", 6, 3, 1, 24, 24, 1), ("mb", 6, 3, 2, 24, 32, 1),
     ("mb", 6, 3, 1, 32, 40, 1)), 8)
# EfficientNetV2-M at depth 1: stage 3 is 160 wide at 30x30, stage 6 512
# wide at 15x15 for a 480x480 input, the shapes the hierarchical head pools
DEPTH1, DEPTH1_T = _tables(
    tuple(s[:6] + (1,) for s in jeffv2.CONFIGS["eff_v2_medium"].stages), 24)
TOL = dict(rtol=1e-4, atol=1e-4)
B, N = 6, 16
BART_VOCAB = 1000
TOWERS = ("distilbert", "bert", "bart")
PAIRS = [(s, t) for s in ("gated", "classic", "normalized", "clip")
         for t in TOWERS] + [(s, t) for s in ("MM_RCA", "bimodal")
                             for t in ("distilbert", "bert")]


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _random_bn(p, s, rng):
    """Random BN scale / bias / statistics, so that folding and the
    running statistics matter."""
    if isinstance(p, dict) and "bn" in p:
        c = p["bn"]["scale"].shape
        p["bn"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        p["bn"]["bias"] = rng.uniform(-0.2, 0.2, c).astype(np.float32)
        s["bn"]["mean"] = rng.normal(0, 0.2, c).astype(np.float32)
        s["bn"]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    if isinstance(p, dict):
        for k in p:
            if isinstance(s, dict) and k in s:
                _random_bn(p[k], s[k], rng)
    elif isinstance(p, list):
        for a, b in zip(p, s):
            _random_bn(a, b, rng)


def _jax_tree(cfg, table, layers, seed):
    """Every head's weights from the JAX ``init``, as numpy, on `table`
    with a `layers`-deep tower."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jeffv2.CONFIGS, "eff_v2_medium", table)
        for mod in (jdistil, jbert, jbart):
            mp.setattr(mod, "LAYERS", layers)
        mp.setattr(jbart, "VOCAB", BART_VOCAB)
        params, state = jmm.init(jax.random.PRNGKey(seed), cfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    _random_bn(params["image"], state["image"], np.random.default_rng(seed))
    return params, state


@pytest.fixture(scope="module")
def trees():
    """{tower: (params, state)} on the short table, 2 layers."""
    return {t: _jax_tree(jmm.FusionConfig(text_model_name=t, batch_size=B),
                         SHORT, 2, i + 1) for i, t in enumerate(TOWERS)}


def _batch(tower, b=B, hw=64, seed=3):
    rng = np.random.default_rng(seed)
    lens = np.array([N, 9, 4, N, 12, 2, 7, 16][:b])[:, None]
    mask = (np.arange(N)[None, :] < lens).astype(np.int32)
    hi = BART_VOCAB if tower == "bart" else 30000
    ids = rng.integers(3, hi, (b, N)).astype(np.int32) * mask
    images = rng.normal(size=(b, hw, hw, 3)).astype(np.float32)
    return ids, mask, images


def _jax_logits(cfg, params, state, batch, table=SHORT, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jeffv2.CONFIGS, "eff_v2_medium", table)
        out, _ = jmm.forward(
            cfg, jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, state),
            tuple(jnp.asarray(a) for a in batch), train=False,
            eval_mode=True, **kw)
    return np.asarray(out)


def _port_config(cfg):
    return tmm.FusionConfig(**{f.name: getattr(cfg, f.name)
                               for f in dataclasses.fields(tmm.FusionConfig)})


def _port_logits(cfg, params, state, batch, table=SHORT_T, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbart, "VOCAB", BART_VOCAB)
        model = tmm.load_fusion_model(params, state, _port_config(cfg),
                                      device="cpu", image_cfg=table)
    ids, mask, images = (torch.from_numpy(a) for a in batch)
    return model(ids, mask, images, **kw).numpy()


def _check(got, want, rows):
    assert got.shape == want.shape == (rows, 4)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("strategy,tower", PAIRS)
def test_strategy_matches_jax(trees, strategy, tower):
    params, state = trees[tower]
    cfg = jmm.FusionConfig(strategy=strategy, text_model_name=tower,
                           reverse=True, batch_size=B)
    batch = _batch(tower)
    _check(_port_logits(cfg, params, state, batch),
           _jax_logits(cfg, params, state, batch), B)


def test_bert_tower_matches_jax_kernels(trees, monkeypatch):
    """The JAX side's BERT tower on its Pallas ``mha`` kernel (interpret
    mode), the MM-RCA block on its ``rca_fused`` kernel."""
    monkeypatch.setenv("GC_RCA_FUSED_ATTN", "1")
    params, state = trees["bert"]
    cfg = jmm.FusionConfig(strategy="MM_RCA", text_model_name="bert",
                           reverse=True, batch_size=B, use_pallas_rca=True)
    batch = _batch("bert")
    _check(_port_logits(cfg, params, state, batch),
           _jax_logits(cfg, params, state, batch), B)


@pytest.mark.parametrize("tower", ["distilbert", "bert"])
def test_hierarchical_matches_jax_at_480(tower):
    cfg = jmm.FusionConfig(strategy="hierarchical", text_model_name=tower,
                           batch_size=2)
    params, state = _jax_tree(cfg, DEPTH1, 4, 7)
    batch = _batch(tower, b=2, hw=480, seed=8)
    _check(_port_logits(cfg, params, state, batch, table=DEPTH1_T),
           _jax_logits(cfg, params, state, batch, table=DEPTH1), 2)


def test_clip_pad_hack_at_batch_8(trees):
    """``batch_size=16`` and a batch of 8: the trans_conv hack, [8, 4]."""
    params, state = trees["distilbert"]
    params = dict(params)
    rng = np.random.default_rng(9)
    params["clip_fc"] = {"w": rng.normal(0, 0.2, (16, 4)).astype(np.float32),
                         "b": rng.normal(0, 0.2, 4).astype(np.float32)}
    params["trans_conv"] = {
        "w": rng.normal(0, 0.3, (8, 8, 2)).astype(np.float32),
        "b": rng.normal(0, 0.3, 8).astype(np.float32)}
    cfg = jmm.FusionConfig(strategy="clip", batch_size=16)
    batch = _batch("distilbert", b=8)
    _check(_port_logits(cfg, params, state, batch),
           _jax_logits(cfg, params, state, batch), 8)
    with pytest.raises(ValueError, match="pad hack needs batch 8"):
        _port_logits(cfg, params, state, _batch("distilbert", b=5))


@pytest.mark.parametrize("drop", ["remove_image", "remove_text"])
def test_modality_removal_matches_jax(trees, drop):
    params, state = trees["distilbert"]
    cfg = jmm.FusionConfig(strategy="gated", batch_size=B)
    batch = _batch("distilbert")
    _check(_port_logits(cfg, params, state, batch, **{drop: True}),
           _jax_logits(cfg, params, state, batch, **{drop: True}), B)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{path}.{key}" if path else key)
                .items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{path}.{i}").items()}
    return {path: np.asarray(tree)}


def _hf_tower(tower):
    import transformers as tf

    if tower == "distilbert":
        return tf.DistilBertModel(tf.DistilBertConfig(n_layers=2))
    if tower == "bert":
        return tf.BertModel(tf.BertConfig(num_hidden_layers=2))
    return tf.BartModel(tf.BartConfig(
        vocab_size=BART_VOCAB, d_model=64, encoder_layers=2,
        decoder_layers=2, encoder_attention_heads=4,
        decoder_attention_heads=4, encoder_ffn_dim=128, decoder_ffn_dim=128,
        max_position_embeddings=64))


@pytest.mark.parametrize("tower", TOWERS)
def test_all_heads_checkpoint_converts_like_jax(tower, monkeypatch):
    """FusionRef's state dict (every head, the reference's key names)
    through the JAX and the port ``convert_torch``: the same tree."""
    from garbage_classification_rca_tpu.checkpoint.torch_convert import (
        numpy_state_dict)
    from tests.torch_refs import fusion_ref

    stages = tuple(s[:6] + (1,) for s in fusion_ref.V2_M_STAGES)
    jtab, ttab = _tables(stages, 24)
    monkeypatch.setattr(fusion_ref, "V2_M_STAGES", list(stages))
    torch.manual_seed(0)
    ref = fusion_ref.FusionRef(_hf_tower(tower), batch_size=16,
                               features_only=True, cross_attention_only=True)
    sd = numpy_state_dict(ref)
    monkeypatch.setitem(jeffv2.CONFIGS, "eff_v2_medium", jtab)
    for mod in (jdistil, jbert, jbart):
        monkeypatch.setattr(mod, "LAYERS", 2)
    cfg = jmm.FusionConfig(strategy="gated", text_model_name=tower)
    want = _flat(jmm.convert_torch(sd, cfg))
    got = _flat(tmm.convert_torch(sd, _port_config(cfg), image_cfg=ttab))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


def _refusal(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_refusals_match_jax():
    hier = jmm.FusionConfig(strategy="hierarchical", text_model_name="bart")
    assert _refusal(lambda: tmm.FusionModel(_port_config(hier))) == \
        _refusal(lambda: jmm.build_fusion(hier))
    # the JAX package refuses MM-RCA with BART at the first forward
    rca = jmm.FusionConfig(strategy="MM_RCA", text_model_name="bart")
    assert _refusal(lambda: tmm.FusionModel(_port_config(rca))) == \
        _refusal(lambda: jmm._fwd_mm_rca(rca, *(None,) * 8))
    bim = tmm.FusionConfig(strategy="bimodal", text_model_name="bart")
    assert "768" in _refusal(lambda: tmm.FusionModel(bim))
    for bad in (jmm.FusionConfig(strategy="nope"),
                jmm.FusionConfig(text_model_name="roberta")):
        _refusal(lambda: tmm.FusionModel(_port_config(bad)))


def test_hierarchical_flattens_pooled_maps_like_jax_not_the_reference():
    """The pooled stage maps enter ``hier_img`` in (h, w, c) order, as the
    JAX package flattens its NHWC maps; the reference flattens NCHW, (c,
    h, w), and ``convert_torch`` does not permute the rows of
    ``final_hierarchical_image``. On a map that is not spatially uniform
    the two orders differ: a defect of the JAX package, which the port
    follows."""
    rng = np.random.default_rng(11)
    s3 = rng.normal(size=(2, 30, 30, 160)).astype(np.float32)   # NHWC
    got = tcore.avg_pool(torch.from_numpy(s3), 7, 7).reshape(2, -1).numpy()
    want = np.asarray(jnn.avg_pool(jnp.asarray(s3), 7, 7)).reshape(2, -1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ref = torch.nn.AvgPool2d(7, 7)(torch.from_numpy(s3).permute(0, 3, 1, 2))
    ref_flat = ref.flatten(1).numpy()                           # (c, h, w)
    assert not np.allclose(got, ref_flat, atol=1e-3)
    np.testing.assert_allclose(
        got, ref.permute(0, 2, 3, 1).reshape(2, -1).numpy(), rtol=1e-6,
        atol=1e-6)
