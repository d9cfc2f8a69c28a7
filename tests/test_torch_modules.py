"""PyTorch port, per-module parity with the JAX package at fp32: the
``nn.core`` primitives, BatchNorm folding, the EfficientNetV2 extractor and
the DistilBERT encoder. Weights are drawn on the JAX side, converted to
numpy and loaded through ``checkpoint/from_jax.load_jax_tree``.

Tolerances: elementwise primitives 1e-6; LayerNorm / folding 1e-5; whole
towers 1e-4 (fp32, summation order differs between XLA:CPU and torch)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.models.image import efficientnet_common as jeff
from garbage_classification_rca_tpu.models.image import efficientnet_v2 as jeffv2
from garbage_classification_rca_tpu.models.text import distilbert as jdistil
from garbage_classification_rca_tpu.nn import core as jcore
from garbage_classification_rca_tpu.nn.fold import fold_batchnorm as jfold
from garbage_classification_rca_tpu_torch.checkpoint.from_jax import load_jax_tree
from garbage_classification_rca_tpu_torch.models.image import efficientnet_common as teff
from garbage_classification_rca_tpu_torch.models.image import efficientnet_v2 as teffv2
from garbage_classification_rca_tpu_torch.models.text import distilbert as tdistil
from garbage_classification_rca_tpu_torch.nn import core as tcore
from garbage_classification_rca_tpu_torch.nn.fold import fold_batchnorm as tfold

torch.set_num_threads(2)

# a 7-stage table at narrow widths: stages[3] and stages[6] exist, both
# block types and the SE squeeze rule are exercised
SMALL = jeff.EffNetConfig(
    stages=(("fused", 1, 3, 1, 8, 8, 2), ("fused", 4, 3, 2, 8, 16, 1),
            ("fused", 4, 3, 2, 16, 16, 1), ("mb", 4, 3, 2, 16, 24, 2),
            ("mb", 6, 3, 1, 24, 24, 1), ("mb", 6, 3, 2, 24, 32, 1),
            ("mb", 6, 3, 1, 32, 40, 1)),
    stem_out=8, head_out=64, bn_eps=1e-3)
SMALL_T = teff.EffNetConfig(stages=SMALL.stages, stem_out=SMALL.stem_out,
                            head_out=SMALL.head_out, bn_eps=SMALL.bn_eps)


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_bn(params, state, seed):
    """Non-trivial BN affine + running stats on a JAX EffNet tree."""
    rng = np.random.default_rng(seed)

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
    return params, state


@pytest.fixture(scope="module")
def effnet():
    params, state = jeff.init(jax.random.PRNGKey(3), SMALL)
    params, state = _random_bn(np_tree(params), np_tree(state), 5)
    model, skipped = load_jax_tree(teff.EffNet(SMALL_T), params, state,
                                   allow_skipped=("classifier",))
    assert skipped == ["classifier"]
    return params, state, model.eval()


# ---------------------------------------------------------------------------
# nn.core
# ---------------------------------------------------------------------------


def test_layernorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(2.0, 3.0, (4, 7, 33)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 33).astype(np.float32)
    bias = rng.normal(size=33).astype(np.float32)
    for eps in (1e-5, 1e-12):
        want = jcore.layernorm({"scale": jnp.asarray(scale),
                                "bias": jnp.asarray(bias)},
                               jnp.asarray(x), eps=eps)
        got = tcore.layernorm(torch.from_numpy(x), torch.from_numpy(scale),
                              torch.from_numpy(bias), eps)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_l2_normalize_matches_jax_with_a_zero_row():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 48)).astype(np.float32)
    x[2] = 0.0
    want = jcore.l2_normalize(jnp.asarray(x), axis=1, eps=1e-12)
    got = tcore.l2_normalize(torch.from_numpy(x), dim=1, eps=1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert np.all(got.numpy()[2] == 0.0)
    nz = np.delete(x, 2, axis=0)
    np.testing.assert_allclose(
        tcore.l2_normalize(torch.from_numpy(nz), dim=1).numpy(),
        np.asarray(jcore.l2_normalize(jnp.asarray(nz), axis=1)), atol=1e-6)


def test_activations_and_pooling_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 6, 7)).astype(np.float32)    # NHWC
    t = torch.from_numpy(x)
    np.testing.assert_allclose(tcore.gelu(t).numpy(),
                               np.asarray(jcore.gelu(jnp.asarray(x))),
                               atol=1e-6)
    np.testing.assert_allclose(tcore.silu(t).numpy(),
                               np.asarray(jcore.silu(jnp.asarray(x))),
                               atol=1e-6)
    np.testing.assert_allclose(
        tcore.global_avg_pool(t.permute(0, 3, 1, 2)).numpy(),
        np.asarray(jcore.global_avg_pool(jnp.asarray(x))), atol=1e-6)
    w = rng.normal(size=(11, 7)).astype(np.float32)
    ids = np.array([[0, 3, 10], [5, 5, 1]], np.int32)
    np.testing.assert_allclose(
        tcore.embedding(torch.from_numpy(w), torch.from_numpy(ids)).numpy(),
        np.asarray(jcore.embedding({"w": jnp.asarray(w)}, jnp.asarray(ids))))


def test_bn_fold_matches_jax(effnet):
    params, state, _ = effnet
    jp, _ = jfold(params, state, SMALL.bn_eps)
    model, _ = load_jax_tree(teff.EffNet(SMALL_T), params, state,
                             allow_skipped=("classifier",))
    tfold(model, SMALL.bn_eps)
    pairs = [(jp["stem"], model.stem)]
    for si in (0, 3):   # a fused block and an MBConv block (expand/dw/project)
        blk, tblk = jp["stages"][si][0], model.stages[si][0]
        for name in ("single", "expand", "dw", "project"):
            if name in blk:
                pairs.append((blk[name], getattr(tblk, name)))
    for jcna, tcna in pairs:
        assert tcna.bn is None and "bn" not in jcna
        np.testing.assert_allclose(
            tcna.conv.w.numpy(),
            np.asarray(jcna["conv"]["w"]).transpose(3, 2, 0, 1),
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tcna.conv.b.numpy(),
                                   np.asarray(jcna["conv"]["b"]),
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# towers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("folded", [False, True])
def test_effnet_extractor_features_match_jax(effnet, folded):
    params, state, _ = effnet
    x = np.random.default_rng(4).normal(size=(2, 40, 40, 3)).astype(np.float32)
    model, _ = load_jax_tree(teff.EffNet(SMALL_T), params, state,
                             allow_skipped=("classifier",))
    if folded:
        params, state = jfold(params, state, SMALL.bn_eps)
        tfold(model, SMALL.bn_eps)
    j3, j6, jp, _ = jeffv2.extractor_features(params, state, jnp.asarray(x),
                                              SMALL)
    t3, t6, tp = teffv2.extractor_features(model.eval(), torch.from_numpy(x),
                                           SMALL_T)
    assert t3.shape == j3.shape and t6.shape == j6.shape
    for got, want in ((t3, j3), (t6, j6), (tp, jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


def test_distilbert_encode_matches_jax():
    params = np_tree(jdistil.init_encoder(jax.random.PRNGKey(8)))
    params["layers"] = params["layers"][:2]
    rng = np.random.default_rng(9)
    for lp in params["layers"]:
        for ln in ("ln_att", "ln_ffn"):
            lp[ln]["scale"] = rng.uniform(0.5, 1.5, 768).astype(np.float32)
            lp[ln]["bias"] = rng.normal(0, 0.1, 768).astype(np.float32)
    ids = rng.integers(0, jdistil.VOCAB, (3, 16)).astype(np.int32)
    mask = (np.arange(16)[None, :] < np.array([[16], [9], [4]])).astype(
        np.int32)
    ids = ids * mask
    want = jdistil.encode(jax.tree_util.tree_map(jnp.asarray, params),
                          jnp.asarray(ids), jnp.asarray(mask),
                          fused_blocks=False)
    model, _ = load_jax_tree(tdistil.DistilBertEncoder(layers=2), params)
    got = tdistil.encode(model, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_from_jax_rejects_mismatches(effnet):
    params, state, _ = effnet
    with pytest.raises(ValueError, match="no slot"):
        load_jax_tree(teff.EffNet(SMALL_T), params, state, allow_skipped=())
    with pytest.raises(ValueError, match="not in the tree"):
        load_jax_tree(teff.EffNet(SMALL_T), params, allow_skipped=(
            "classifier",))
    bad = dict(params, stem={"conv": {"w": np.zeros((3, 3, 3, 9),
                                                     np.float32)},
                             "bn": params["stem"]["bn"]})
    with pytest.raises(ValueError, match="shape"):
        load_jax_tree(teff.EffNet(SMALL_T), bad, state,
                      allow_skipped=("classifier",))
