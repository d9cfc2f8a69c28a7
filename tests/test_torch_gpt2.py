"""PyTorch port, GPT-2 (small): the classifier against the JAX package's
``models/text/gpt2.py`` on the CPU.

Full width (d 768, 12 heads, FFN 3072), 2 layers, a 1000-token vocabulary
with the pad (= eos) at its last id, as 50256 is GPT-2's (the JAX module's
``LAYERS`` / ``VOCAB`` / ``PAD_ID`` and the port's ``VOCAB`` / ``PAD_ID``
are patched together for the test, since the pooling reads ``PAD_ID``; no
JAX file changes). A reference-layout state dict synthesized with numpy,
with and without the wrapper's ``model.``, goes through both converters to
the same tree. The rows hit the JAX module's traps: one full to L, one in
the hash tokenizer's layout (eos, words, eos, pad: the pooled token is
counted from the ids, so it is the last word but one), one of a single
token, an all-pad row (every key masked: uniform weights, no NaN) and a
lone eos. fp32 logits within rtol = atol = 1e-4 of the JAX ``apply`` with
the argmax equal; bf16 within 3e-2 of max |logit|; the HF-internal
dropout sites (``--hf_internal_dropout``) on one shared numpy mask stream
(``tests/test_torch_hf_dropout.py``): equal logs, 1 + 3 L sites; one
train step against the JAX ``make_train_step``, head only and all
trainable, at the bar of ``tests/test_torch_unimodal_train.py``; and the
text trainer's head dropout per model.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.models.text import gpt2 as jgpt2
from garbage_classification_rca_tpu.nn import core as jcore
from garbage_classification_rca_tpu.train import loop as jloop
from garbage_classification_rca_tpu_torch.cli import main_text as port_text
from garbage_classification_rca_tpu_torch.models.registry import (
    get_text_model)
from garbage_classification_rca_tpu_torch.models.text import gpt2 as tgpt2
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
PAD = VOCAB - 1
TOL = dict(rtol=1e-4, atol=1e-4)


def gpt2_state_dict(seed, *, layers=LAYERS, vocab=VOCAB, num_classes=4,
                    wrapped=True):
    """A reference GPT-2 classifier state dict (HF's Conv1D weights [in,
    out], a bias-free ``score``), numpy, seeded; under ``model.`` when
    `wrapped` (the reference's wrapper)."""
    rng = np.random.default_rng(seed)
    d, f = tgpt2.HIDDEN, tgpt2.FFN

    def w(*shape, s=0.02):
        return rng.normal(0.0, s, shape).astype(np.float32)

    sd = {"transformer.wte.weight": w(vocab, d),
          "transformer.wpe.weight": w(tgpt2.MAX_POS, d, s=0.01),
          "transformer.ln_f.weight": 1.0 + w(d, s=0.1),
          "transformer.ln_f.bias": w(d),
          "score.weight": w(num_classes, d, s=0.05)}
    for i in range(layers):
        pre = f"transformer.h.{i}."
        for ln in ("ln_1", "ln_2"):
            sd[pre + ln + ".weight"] = 1.0 + w(d, s=0.1)
            sd[pre + ln + ".bias"] = w(d)
        for name, (a, b) in (("attn.c_attn", (d, 3 * d)),
                             ("attn.c_proj", (d, d)),
                             ("mlp.c_fc", (d, f)), ("mlp.c_proj", (f, d))):
            sd[pre + name + ".weight"] = w(a, b)
            sd[pre + name + ".bias"] = w(b)
    return {("model." + k if wrapped else k): v for k, v in sd.items()}


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    for mod in (jgpt2, tgpt2):
        monkeypatch.setattr(mod, "VOCAB", VOCAB)
        monkeypatch.setattr(mod, "PAD_ID", PAD)
    monkeypatch.setattr(jgpt2, "LAYERS", LAYERS)


@pytest.fixture(scope="module")
def tree():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgpt2, "LAYERS", LAYERS)
        params, _ = jgpt2.convert_torch(gpt2_state_dict(1))
    return _np(params)


def _jp(t, dtype=jnp.float32):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), t)


def _rows(seed=0):
    """Full to L; eos + 5 words + eos then pad (the hash tokenizer's
    layout); one token; all pad with a zero mask; a lone eos."""
    rng = np.random.default_rng(seed)
    ids = np.full((5, N), PAD, np.int32)
    mask = np.zeros((5, N), np.int32)
    ids[0], mask[0] = rng.integers(0, PAD, N), 1
    ids[1, 1:6], mask[1, :7] = rng.integers(0, PAD, 5), 1
    ids[2, 0], mask[2, 0] = rng.integers(0, PAD), 1
    mask[4, 0] = 1
    return ids, mask


@pytest.mark.parametrize("wrapped", [True, False], ids=["model.", "bare"])
def test_converter_matches_jax(wrapped):
    sd = gpt2_state_dict(2, wrapped=wrapped)
    want, _ = jgpt2.convert_torch(dict(sd))
    got, state = get_text_model("gpt2").convert_torch(sd)
    assert state == {}
    _same_tree(got, _np(want))
    assert got["layers"][0]["c_attn"]["w"].shape == (768, 3 * 768)
    assert got["score"]["w"].shape == (768, 4) and "b" not in got["score"]
    with pytest.raises(ValueError, match="class-count"):
        get_text_model("gpt2").convert_torch(sd, num_classes=5)


def test_fp32_logits_match_jax(tree):
    model = get_text_model("gpt2").load_tree(tree, device="cpu")
    assert len(model.layers) == LAYERS and model.score.b is None
    ids, mask = _rows()
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    want = np.asarray(jax.jit(lambda p, i, m: jgpt2.apply(p, {}, (i, m))[0])(
        _jp(tree), jnp.asarray(ids), jnp.asarray(mask)))
    assert got.shape == want.shape == (5, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_pooling_reads_the_ids_and_clips():
    ids, mask = _rows()
    h = torch.arange(5 * N, dtype=torch.float32).reshape(5, N, 1)
    model = torch.nn.Module()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tgpt2, "encode", lambda m, i, a, d=None: h)
        got = tgpt2.pooled_feature(model, torch.from_numpy(ids),
                                   torch.from_numpy(mask))
    # full row: L - 1; hash layout: 5 non-pad ids -> position 4 (the last
    # word but one); one token: 0; all pad and a lone eos: clipped to 0
    assert got[:, 0].tolist() == [N - 1, N + 4, 2 * N, 3 * N, 4 * N]


def test_bf16_logits_match_jax(tree):
    model = get_text_model("gpt2").load_tree(tree, device="cpu").to(
        torch.bfloat16)
    ids, mask = _rows(seed=1)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).float()
    want, _ = jgpt2.apply(_jp(tree, jnp.bfloat16), {},
                          (jnp.asarray(ids), jnp.asarray(mask)))
    want = np.asarray(want, np.float32)
    assert np.isfinite(got.numpy()).all()
    assert np.abs(got.numpy() - want).max() <= 3e-2 * np.abs(want).max()


def test_dropout_sites_match_jax(tree, monkeypatch):
    """``apply(train=True, hf_internal_dropout=True)`` on both sides: the
    port's ``HFDropout`` comes from the key folded with 0x4F02, the JAX
    one from the rng folded so; both read one mask stream."""
    ids, mask = _rows(seed=2)
    js, ts = MaskStream(51), MaskStream(51)
    folded = []
    monkeypatch.setattr(jcore, "HFDropout", lambda rng: StreamDrop(js))

    def port_drop(key):
        folded.append(key.seed)
        return TorchStreamKeys(ts)

    monkeypatch.setattr(tcore, "HFDropout", port_drop)
    want, _ = jgpt2.apply(_jp(tree), {}, (jnp.asarray(ids), jnp.asarray(mask)),
                          train=True, rng=jax.random.PRNGKey(0),
                          hf_internal_dropout=True)
    model = get_text_model("gpt2").load_tree(tree, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                    train=True, key=Key(3), hf_internal_dropout=True)
    assert ts.log == js.log, f"port {ts.log}\n jax {js.log}"
    assert len(ts.log) == 1 + 3 * LAYERS
    assert ts.log[1] == (5 * tgpt2.HEADS * N * N, 0.1)    # attention probs
    assert folded == [Key(3).fold_in(0x4F02).seed]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_train_mode_without_the_flag_draws_nothing(tree):
    model = get_text_model("gpt2").load_tree(tree, device="cpu")
    ids, mask = (torch.from_numpy(a) for a in _rows(seed=3))
    with torch.no_grad():
        ev = model(ids, mask)
        assert torch.equal(model(ids, mask, train=True, key=Key(1),
                                 drop_ratio=0.6), ev)
        assert torch.equal(model(ids, mask, key=Key(1),
                                 hf_internal_dropout=True), ev)
        on = model(ids, mask, train=True, key=Key(1), hf_internal_dropout=True)
        assert not torch.allclose(on, ev)
        assert torch.equal(on, model(ids, mask, train=True, key=Key(1),
                                     hf_internal_dropout=True))


def _stack():
    ids, mask = _rows(seed=4)
    ids2, mask2 = _rows(seed=5)
    return {"input_ids": np.stack([ids, ids2]),
            "attention_mask": np.stack([mask, mask2]),
            "label": np.array([[0, 1, 2, 3, 1], [3, 2, 1, 0, 0]], np.int32),
            "valid": np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0]], np.int32)}


@pytest.mark.parametrize("head_only", [True, False])
def test_train_step_matches_jax(tree, head_only):
    stack = _stack()
    jmask = (jloop.head_only_mask(tree, ("score",)) if head_only
             else jloop.all_trainable_mask(tree))
    want = _jax_step(jgpt2.apply, tree, stack, jmask, _text_inputs)
    model = get_text_model("gpt2").load_tree(tree, device="cpu")
    tmask = (tloop.head_only_mask(model, port_text.head_keys_for("gpt2"))
             if head_only else tloop.all_trainable_mask(model))
    assert {k: bool(v) for k, v in _flatten(jmask).items()} == tmask
    got = _port_step(model, stack, tmask, _text_inputs,
                     port_text.train_forward(model, False))
    _assert_step(got, want)
    before = _flatten(tree)
    moved = {k for k, v in got[4].items() if not np.array_equal(v, before[k])}
    if head_only:
        assert moved == {"score.w"}
    else:
        assert {"layers.0.c_attn.w", "wte.w", "score.w"} <= moved


def test_train_step_with_internal_dropout_matches_jax(tree, monkeypatch):
    stack = {k: v[:1] for k, v in _stack().items()}
    js, ts = MaskStream(43), MaskStream(43)
    monkeypatch.setattr(jcore, "HFDropout", lambda rng: StreamDrop(js))
    monkeypatch.setattr(tcore, "HFDropout", lambda key: TorchStreamKeys(ts))
    want = _jax_step(functools.partial(jgpt2.apply, hf_internal_dropout=True),
                     tree, stack, jloop.all_trainable_mask(tree),
                     _text_inputs)
    model = get_text_model("gpt2").load_tree(tree, device="cpu")
    got = _port_step(model, stack, None, _text_inputs,
                     port_text.train_forward(model, True))
    assert ts.log == js.log and len(ts.log) == 1 + 3 * LAYERS
    _assert_step(got, want)


@pytest.mark.parametrize("name,want", [
    ("distilbert", [0.6]), ("bert", [0.6]), ("roberta", [0.6]),
    ("bart", [0.6, 0.6]), ("gpt2", []), ("mobilebert", [0.0]),
    ("mobile_bert", [0.0])])
def test_main_text_takes_each_models_head_dropout(name, want, monkeypatch):
    """The text trainer binds no ratio: each model's own default, as the
    JAX trainer's ``apply`` calls: 0.6 for the BERT family and BART (its
    two head sites), none for GPT-2, 0.0 for MobileBERT."""
    from garbage_classification_rca_tpu_torch.models.text import bart as tbart

    monkeypatch.setattr(tbart, "VOCAB", VOCAB)
    rates = []
    dropout = tcore.dropout
    monkeypatch.setattr(tcore, "dropout", lambda x, rate, generator: (
        rates.append(rate), dropout(x, rate, generator))[1])
    model = get_text_model(name).build(4, layers=1)
    ids = torch.randint(3, 300, (2, 8), dtype=torch.int32)
    with torch.no_grad():
        port_text.train_forward(model, False)(
            ids, torch.ones_like(ids), train=True, key=Key(0))
    assert rates == want
