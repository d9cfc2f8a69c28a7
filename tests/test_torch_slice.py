"""PyTorch port, the MM-RCA eval slice as a whole: JAX
``multimodal.forward(MM_RCA, reverse, eval_mode=True)`` against the port's
forward on the same weights (drawn by JAX, loaded through
``checkpoint/from_jax``) and the same inputs.

fp32, batch 3, 64x64 images, seq 16 with padded rows, DistilBERT cut to 2
layers, and a short 7-stage EfficientNet table with the real 1280-d head
(set on the JAX side through ``effv2.CONFIGS``; no JAX file changes).
Logits agree within 1e-4 and the argmax is equal — once against the JAX
plain path and once with the JAX kernels on (Pallas ``rca_fused`` and
``mha`` in interpret mode)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.models.fusion import multimodal as jmm
from garbage_classification_rca_tpu.models.image import efficientnet_common as jeff
from garbage_classification_rca_tpu.models.image import efficientnet_v2 as jeffv2
from garbage_classification_rca_tpu.nn.fold import fold_batchnorm as jfold
from garbage_classification_rca_tpu_torch.models.fusion import multimodal as tmm
from garbage_classification_rca_tpu_torch.models.image import efficientnet_common as teff
from garbage_classification_rca_tpu_torch.nn.fold import fold_batchnorm as tfold

torch.set_num_threads(2)

SHORT = jeff.EffNetConfig(
    stages=(("fused", 1, 3, 1, 8, 8, 1), ("fused", 4, 3, 2, 8, 16, 1),
            ("fused", 4, 3, 2, 16, 16, 1), ("mb", 4, 3, 2, 16, 24, 1),
            ("mb", 6, 3, 1, 24, 24, 1), ("mb", 6, 3, 2, 24, 32, 1),
            ("mb", 6, 3, 1, 32, 40, 1)),
    stem_out=8, head_out=1280, bn_eps=1e-3)
SHORT_T = teff.EffNetConfig(stages=SHORT.stages, stem_out=SHORT.stem_out,
                            head_out=SHORT.head_out, bn_eps=SHORT.bn_eps)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _random_bn(params, state, rng):
    def walk(p, s):
        if isinstance(p, dict) and "bn" in p:
            c = p["bn"]["scale"].shape
            p["bn"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            p["bn"]["bias"] = rng.uniform(-0.2, 0.2, c).astype(np.float32)
            s["bn"]["mean"] = rng.normal(0, 0.2, c).astype(np.float32)
            s["bn"]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        if isinstance(p, dict):
            for k in p:
                if isinstance(s, dict) and k in s:
                    walk(p[k], s[k])
        elif isinstance(p, list):
            for a, b in zip(p, s):
                walk(a, b)

    walk(params, state)


@pytest.fixture(scope="module")
def setup():
    """JAX weights (every head), numpy inputs; effv2's medium table is the
    short one for the whole module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jeffv2.CONFIGS, "eff_v2_medium", SHORT)
        cfg = jmm.FusionConfig(strategy="MM_RCA", reverse=True,
                               features_only=True, cross_attention_only=True)
        params, state = jmm.init(jax.random.PRNGKey(1), cfg)
        params = jax.tree_util.tree_map(np.asarray, params)
        state = jax.tree_util.tree_map(np.asarray, state)
        params["text"]["layers"] = params["text"]["layers"][:2]
        rng = np.random.default_rng(2)
        _random_bn(params["image"], state["image"], rng)
        for u in ("sa_txt", "sa_img", "rca_ti", "rca_it"):
            params[u]["norm"]["scale"] = rng.uniform(0.5, 1.5, params[u][
                "norm"]["scale"].shape).astype(np.float32)
        lens = np.array([[16], [9], [4]])
        mask = (np.arange(16)[None, :] < lens).astype(np.int32)
        ids = rng.integers(1000, 30000, (3, 16)).astype(np.int32) * mask
        images = rng.normal(size=(3, 64, 64, 3)).astype(np.float32)
        yield params, state, (ids, mask, images)


def _jax_logits(cfg, params, state, batch, **kw):
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jax.tree_util.tree_map(jnp.asarray, state)
    out, _ = jmm.forward(cfg, jp, js, tuple(jnp.asarray(a) for a in batch),
                         train=False, eval_mode=True, **kw)
    return np.asarray(out)


def _port_logits(cfg, params, state, batch, fold=False, **kw):
    tcfg = tmm.FusionConfig(**{f.name: getattr(cfg, f.name)
                               for f in dataclasses.fields(tmm.FusionConfig)})
    model = tmm.load_fusion_model(params, state, tcfg, device="cpu",
                                  image_cfg=SHORT_T)
    if fold:
        tfold(model.image, SHORT.bn_eps)
    ids, mask, images = (torch.from_numpy(a) for a in batch)
    return model(ids, mask, images, **kw).numpy()


def _check(got, want):
    assert got.shape == want.shape == (3, 4)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("head,fold", [
    ("everything", False), ("everything", True),
    ("features_only", False), ("cross_attention_only", False)])
def test_slice_matches_jax(setup, monkeypatch, head, fold):
    monkeypatch.setitem(jeffv2.CONFIGS, "eff_v2_medium", SHORT)
    params, state, batch = setup
    cfg = jmm.FusionConfig(strategy="MM_RCA", reverse=True,
                           features_only=head == "features_only",
                           cross_attention_only=head == "cross_attention_only")
    jparams, jstate = params, state
    if fold:
        jparams = dict(params)
        jparams["image"], jstate = jfold(params["image"], state["image"],
                                         SHORT.bn_eps)
        jstate = {"image": jstate}
    want = _jax_logits(cfg, jparams, jstate, batch)
    _check(_port_logits(cfg, params, state, batch, fold=fold), want)


def test_slice_matches_jax_kernels(setup, monkeypatch):
    """The JAX side on its Pallas kernels (interpret mode)."""
    monkeypatch.setitem(jeffv2.CONFIGS, "eff_v2_medium", SHORT)
    monkeypatch.setenv("GC_RCA_FUSED_ATTN", "1")
    params, state, batch = setup
    cfg = jmm.FusionConfig(strategy="MM_RCA", reverse=True,
                           use_pallas_rca=True)
    want = _jax_logits(cfg, params, state, batch)
    _check(_port_logits(cfg, params, state, batch), want)


@pytest.mark.parametrize("drop", ["remove_image", "remove_text"])
def test_slice_eval_modality_removal_matches_jax(setup, monkeypatch, drop):
    monkeypatch.setitem(jeffv2.CONFIGS, "eff_v2_medium", SHORT)
    params, state, batch = setup
    cfg = jmm.FusionConfig(strategy="MM_RCA", reverse=True)
    want = _jax_logits(cfg, params, state, batch, **{drop: True})
    _check(_port_logits(cfg, params, state, batch, **{drop: True}), want)


@pytest.mark.parametrize("strategy,text,train", [
    ("MM_RCA", "bart", False), ("bimodal", "bart", False),
    ("hierarchical", "bart", True)])
def test_unported_configurations_raise(strategy, text, train):
    """What still raises: the pairs the JAX package refuses or cannot run
    (MM-RCA and bimodal need a 768-d tower, BART gives 1024; hierarchical
    needs per-layer hidden states, which BART does not give), in eval and
    in train mode."""
    cfg = tmm.FusionConfig(strategy=strategy, text_model_name=text)
    if train:
        from garbage_classification_rca_tpu_torch.nn.core import Key

        with pytest.raises(ValueError, match="per-layer hidden states"):
            tmm.forward(cfg, None, (None, None, None), train=True,
                        key=Key(0))
    else:
        with pytest.raises(ValueError, match="768-d text tower"):
            tmm.FusionModel(cfg)
    with pytest.raises(ValueError, match="unknown"):
        tmm.FusionModel(tmm.FusionConfig(strategy="nope"))
