"""PyTorch port, MobileBERT (uncased): the classifier against the JAX
package's ``models/text/mobilebert.py`` on the CPU.

Full width (hidden 512, embedding 128, bottleneck 128, 4 heads, FFN 512,
three stacked FFNs), 2 layers, a 1000-token vocabulary (the JAX module's
``LAYERS`` / ``VOCAB`` and the port's ``VOCAB`` patched for the test; no
JAX file changes). Reference-layout state dicts synthesized with numpy,
with and without the wrapper's ``model.`` and with and without the
pooler's dense (``classifier_activation``), go through both converters to
the same tree; the port builds the model with the pooler exactly where the
tree has one, from a tree and from a BEST file. The rows: one full to L,
one of a single token, one all pad (every key masked: uniform weights, no
NaN), one half full; the trigram embedding's zero padding reads across the
mask. fp32 logits within rtol = atol = 1e-4 of the JAX ``apply`` with the
argmax equal; bf16 within 3e-2 of max |logit|; the HF-internal dropout
(the attention probabilities only: L sites) on one shared numpy mask
stream; one train step against the JAX ``make_train_step``, head only
and all trainable, and with the internal dropout.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.models.text import mobilebert as jmb
from garbage_classification_rca_tpu.nn import core as jcore
from garbage_classification_rca_tpu.train import loop as jloop
from garbage_classification_rca_tpu_torch.cli import main_text as port_text
from garbage_classification_rca_tpu_torch.models.registry import (
    get_text_model)
from garbage_classification_rca_tpu_torch.models.text import mobilebert as tmb
from garbage_classification_rca_tpu_torch.nn import core as tcore
from garbage_classification_rca_tpu_torch.nn.core import Key
from garbage_classification_rca_tpu_torch.train import loop as tloop
from tests.test_torch_bart import _same_tree
from tests.test_torch_hf_dropout import MaskStream, StreamDrop, TorchStreamKeys
from tests.test_torch_unimodal_train import (_assert_step, _flatten,
                                             _jax_step, _np_tree as _np,
                                             _port_step, _text_inputs)

torch.set_num_threads(2)

VOCAB, LAYERS, N = 1000, 2, 16
TOL = dict(rtol=1e-4, atol=1e-4)


def mobilebert_state_dict(seed, *, layers=LAYERS, vocab=VOCAB, num_classes=4,
                          wrapped=True, pooler=False):
    """A reference MobileBERT classifier state dict, numpy, seeded (HF
    Linear weights [out, in] at std 0.03, near HF's init range of 0.02;
    NoNorm weight / bias near 1 / 0). With no normalization in the model,
    unit-gain Linears put both the port's and the JAX package's bf16
    logits up to 4.6% of max |logit| from the fp32 ones."""
    rng = np.random.default_rng(seed)
    h, e, i_, f = tmb.HIDDEN, tmb.EMB, tmb.INTRA, tmb.FFN

    def w(*shape, s=0.05):
        return rng.normal(0.0, s, shape).astype(np.float32)

    sd = {}

    def lin(name, d_in, d_out):
        sd[name + ".weight"] = w(d_out, d_in, s=0.03)
        sd[name + ".bias"] = w(d_out, s=0.02)

    def norm(name, d):
        sd[name + ".weight"] = 1.0 + w(d, s=0.1)
        sd[name + ".bias"] = w(d, s=0.05)

    pre = "mobilebert.embeddings."
    sd[pre + "word_embeddings.weight"] = w(vocab, e, s=0.5)
    sd[pre + "position_embeddings.weight"] = w(tmb.MAX_POS, h, s=0.2)
    sd[pre + "token_type_embeddings.weight"] = w(2, h, s=0.2)
    lin(pre + "embedding_transformation", 3 * e, h)
    norm(pre + "LayerNorm", h)
    for n in range(layers):
        pre = f"mobilebert.encoder.layer.{n}."
        lin(pre + "attention.self.query", i_, i_)
        lin(pre + "attention.self.key", i_, i_)
        lin(pre + "attention.self.value", h, i_)
        lin(pre + "attention.output.dense", i_, i_)
        norm(pre + "attention.output.LayerNorm", i_)
        lin(pre + "intermediate.dense", i_, f)
        lin(pre + "output.dense", f, i_)
        norm(pre + "output.LayerNorm", i_)
        lin(pre + "output.bottleneck.dense", i_, h)
        norm(pre + "output.bottleneck.LayerNorm", h)
        lin(pre + "bottleneck.input.dense", h, i_)
        norm(pre + "bottleneck.input.LayerNorm", i_)
        lin(pre + "bottleneck.attention.dense", h, i_)
        norm(pre + "bottleneck.attention.LayerNorm", i_)
        for j in range(tmb.N_FFN):
            lin(pre + f"ffn.{j}.intermediate.dense", i_, f)
            lin(pre + f"ffn.{j}.output.dense", f, i_)
            norm(pre + f"ffn.{j}.output.LayerNorm", i_)
    if pooler:
        lin("mobilebert.pooler.dense", h, h)
    lin("classifier", h, num_classes)
    return {("model." + k if wrapped else k): v for k, v in sd.items()}


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    for mod in (jmb, tmb):
        monkeypatch.setattr(mod, "VOCAB", VOCAB)
    monkeypatch.setattr(jmb, "LAYERS", LAYERS)


def _jp(t, dtype=jnp.float32):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), t)


@pytest.fixture(scope="module")
def trees():
    """{pooler: JAX-converted tree}."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmb, "LAYERS", LAYERS)
        return {p: _np(jmb.convert_torch(mobilebert_state_dict(
            1, pooler=p))[0]) for p in (False, True)}


def _rows(seed=0):
    """Full to L; one token; all pad; half full. Pad id 0, as the
    WordPiece tokenizer's."""
    rng = np.random.default_rng(seed)
    lens = np.array([N, 1, 0, N // 2])
    mask = (np.arange(N)[None, :] < lens[:, None]).astype(np.int32)
    ids = (rng.integers(5, VOCAB, (4, N)) * mask).astype(np.int32)
    return ids, mask


@pytest.mark.parametrize("pooler", [False, True], ids=["no_pooler", "pooler"])
@pytest.mark.parametrize("wrapped", [True, False], ids=["model.", "bare"])
def test_converter_matches_jax(wrapped, pooler):
    sd = mobilebert_state_dict(2, wrapped=wrapped, pooler=pooler)
    want, _ = jmb.convert_torch(dict(sd))
    got, state = get_text_model("mobilebert").convert_torch(sd)
    assert state == {} and ("pooler" in got) == pooler
    _same_tree(got, _np(want))
    one, _ = get_text_model("mobilebert").convert_torch(sd, n_layers=1)
    assert len(one["layers"]) == 1
    with pytest.raises(ValueError, match="class-count"):
        get_text_model("mobilebert").convert_torch(sd, num_classes=5)


@pytest.mark.parametrize("pooler", [False, True], ids=["no_pooler", "pooler"])
def test_fp32_logits_match_jax(trees, pooler):
    tree = trees[pooler]
    model = get_text_model("mobile_bert").load_tree(tree, device="cpu")
    assert len(model.layers) == LAYERS
    assert (model.pooler is not None) == pooler
    ids, mask = _rows()
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    want = np.asarray(jax.jit(lambda p, i, m: jmb.apply(p, {}, (i, m))[0])(
        _jp(tree), jnp.asarray(ids), jnp.asarray(mask)))
    assert got.shape == want.shape == (4, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_bf16_logits_match_jax(trees):
    tree = trees[False]
    model = get_text_model("mobilebert").load_tree(tree, device="cpu").to(
        torch.bfloat16)
    ids, mask = _rows(seed=1)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).float()
    want, _ = jmb.apply(_jp(tree, jnp.bfloat16), {},
                        (jnp.asarray(ids), jnp.asarray(mask)))
    want = np.asarray(want, np.float32)
    assert np.isfinite(got.numpy()).all()
    assert np.abs(got.numpy() - want).max() <= 3e-2 * np.abs(want).max()


def test_best_file_builds_the_pooler(trees, tmp_path, monkeypatch):
    """A BEST file of the trainer rebuilds the model with the pooler
    exactly where the saved one had it."""
    from garbage_classification_rca_tpu_torch.cli import load_unimodal_model
    from garbage_classification_rca_tpu_torch.config import args_parser
    from garbage_classification_rca_tpu_torch.train.engine import save_best

    monkeypatch.chdir(tmp_path)
    ids, mask = (torch.from_numpy(a) for a in _rows(seed=2))
    for pooler in (False, True):
        mdef = get_text_model("mobilebert")
        model = mdef.load_tree(trees[pooler], device="cpu")
        path = save_best(model, model_name=f"mb{pooler}", epoch=0,
                         val_acc=0.0, args=args_parser([]), fine_tuning=False)
        back = load_unimodal_model(mdef, path, "--text_model=mobilebert",
                                   "cpu")
        assert (back.pooler is not None) == pooler
        with torch.no_grad():
            assert torch.equal(back(ids, mask), model(ids, mask))


def test_dropout_sites_match_jax(trees, monkeypatch):
    """``apply(train=True, hf_internal_dropout=True)`` on both sides, the
    head's dropout at its default 0.0 (no draw): L sites, each the
    attention probabilities [B, 4, L, L] at p = 0.1."""
    ids, mask = _rows(seed=3)
    js, ts = MaskStream(53), MaskStream(53)
    monkeypatch.setattr(jcore, "HFDropout", lambda rng: StreamDrop(js))
    monkeypatch.setattr(tcore, "HFDropout", lambda key: TorchStreamKeys(ts))
    want, _ = jmb.apply(_jp(trees[True]), {},
                        (jnp.asarray(ids), jnp.asarray(mask)), train=True,
                        rng=jax.random.PRNGKey(0), hf_internal_dropout=True)
    model = get_text_model("mobilebert").load_tree(trees[True], device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                    train=True, key=Key(3), hf_internal_dropout=True)
    assert ts.log == js.log, f"port {ts.log}\n jax {js.log}"
    assert ts.log == [(4 * tmb.HEADS * N * N, 0.1)] * LAYERS
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_classifier_keys_follow_jax_order(trees):
    """Flag on: ``key, k_int = key.split(2)``, the sites on k_int, the
    head dropout on the rest; flag off: the head on the unsplit key."""
    model = get_text_model("mobilebert").load_tree(trees[False], device="cpu")
    ids, mask = (torch.from_numpy(a) for a in _rows(seed=4))
    key = Key(9)

    def by_hand(k, drop):
        pooled = tmb.encode(model, ids, mask, drop)[:, 0]
        return model.classifier(tcore.dropout(pooled, 0.5,
                                              k.generator("cpu")))

    with torch.no_grad():
        ev = model(ids, mask)
        assert torch.equal(model(ids, mask, train=True, key=key), ev)
        off = model(ids, mask, train=True, key=key, drop_ratio=0.5)
        assert torch.equal(off, by_hand(key, None))
        on = model(ids, mask, train=True, key=key, drop_ratio=0.5,
                   hf_internal_dropout=True)
        k_rest, k_int = key.split(2)
        assert torch.equal(on, by_hand(k_rest, tcore.HFDropout(k_int)))
        assert not torch.allclose(on, off)


def _stack():
    ids, mask = _rows(seed=5)
    ids2, mask2 = _rows(seed=6)
    return {"input_ids": np.stack([ids, ids2]),
            "attention_mask": np.stack([mask, mask2]),
            "label": np.array([[0, 1, 2, 3], [3, 2, 1, 0]], np.int32),
            "valid": np.array([[1, 1, 1, 1], [1, 1, 0, 0]], np.int32)}


@pytest.mark.parametrize("head_only", [True, False])
def test_train_step_matches_jax(trees, head_only):
    tree, stack = trees[False], _stack()
    jmask = (jloop.head_only_mask(tree, ("classifier",)) if head_only
             else jloop.all_trainable_mask(tree))
    want = _jax_step(jmb.apply, tree, stack, jmask, _text_inputs)
    model = get_text_model("mobilebert").load_tree(tree, device="cpu")
    tmask = (tloop.head_only_mask(model,
                                  port_text.head_keys_for("mobilebert"))
             if head_only else tloop.all_trainable_mask(model))
    assert {k: bool(v) for k, v in _flatten(jmask).items()} == tmask
    got = _port_step(model, stack, tmask, _text_inputs,
                     port_text.train_forward(model, False))
    _assert_step(got, want)
    before = _flatten(tree)
    moved = {k for k, v in got[4].items() if not np.array_equal(v, before[k])}
    if head_only:
        assert moved == {"classifier.w", "classifier.b"}
    else:
        assert {"layers.0.att.v.w", "word_emb.w", "classifier.w"} <= moved


def test_train_step_with_internal_dropout_matches_jax(trees, monkeypatch):
    stack = {k: v[:1] for k, v in _stack().items()}
    js, ts = MaskStream(47), MaskStream(47)
    monkeypatch.setattr(jcore, "HFDropout", lambda rng: StreamDrop(js))
    monkeypatch.setattr(tcore, "HFDropout", lambda key: TorchStreamKeys(ts))
    tree = trees[True]
    want = _jax_step(functools.partial(jmb.apply, hf_internal_dropout=True),
                     tree, stack, jloop.all_trainable_mask(tree),
                     _text_inputs)
    model = get_text_model("mobilebert").load_tree(tree, device="cpu")
    got = _port_step(model, stack, None, _text_inputs,
                     port_text.train_forward(model, True))
    assert ts.log == js.log and len(ts.log) == LAYERS
    _assert_step(got, want)
