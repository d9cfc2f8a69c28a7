"""PyTorch port, BART-large in training, against the JAX package on the
CPU: full width (d 1024, 16 heads, FFN 4096), 2 + 2 layers, a 1000-token
vocabulary (the JAX module's ``LAYERS`` / ``VOCAB`` and the port's
``VOCAB`` patched for the test; no JAX file changes).

  * one SGD train step of gated, classic, normalized and clip on the BART
    tower, with the phase-1 mask and all trainable (the BART third of
    ``tests/test_torch_fusion_train.py``, which says how);
  * the HF model's own dropout sites (``--hf_internal_dropout``): the JAX
    ``encode_decoder`` on a ``StreamDrop`` and the port's on a
    ``TorchStreamKeys`` over one shared numpy mask stream
    (``tests/test_torch_hf_dropout.py``): equal logs, 1 + 4 L encoder and
    1 + 6 L decoder sites, decoder states within 1e-4;
  * ``BartClassifier`` in train mode: its two head sites (and, with the
    flag, the model's sites before them) against the JAX ``apply`` on the
    same stream, logits within 1e-4; its keys split in the JAX ``apply``'s
    order;
  * ``cli.main_text --text_model=bart`` against the JAX CLI for 1 + 1
    epochs on the ``tiny_dataset`` tree with the BPE fixture vocabulary,
    from one synthesized ``BartForSequenceClassification`` ``.pth``, head
    dropout off: per-epoch ``avg_loss`` within 1e-4 and equal val
    accuracies; its BEST file evaluates in ``cli.test_text`` to
    ``best_val_acc``.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.models.text import bart as jbart
from garbage_classification_rca_tpu.nn import core as jcore
from garbage_classification_rca_tpu_torch.cli import main_text as port_text
from garbage_classification_rca_tpu_torch.cli import test_text as port_test_text
from garbage_classification_rca_tpu_torch.models.registry import (
    get_text_model)
from garbage_classification_rca_tpu_torch.models.text import bart as tbart
from garbage_classification_rca_tpu_torch.nn import core as tcore
from garbage_classification_rca_tpu_torch.nn.core import HFDropout, Key
from tests.test_torch_fusion_train import (BART_VOCAB, STRATEGIES_BY_TOWER,
                                           check_train_step)
from tests.test_torch_hf_dropout import MaskStream, StreamDrop, TorchStreamKeys
from tests.test_torch_unimodal_train import (  # noqa: F401 — fixture
    _assert_rows, _run, train_tree)
from tests.test_torch_resume import (  # noqa: F401 — fixture
    _drop_checkpoints)

torch.set_num_threads(2)

LAYERS, N = 2, 16
BPE = os.path.join(os.path.dirname(__file__), "fixtures", "vocab", "bpe")
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("trainable", [False, True], ids=["phase1", "all"])
@pytest.mark.parametrize("strategy", STRATEGIES_BY_TOWER["bart"])
def test_bart_train_step_matches_jax(strategy, trainable):
    check_train_step(strategy, "bart", trainable)


@pytest.fixture(scope="module")
def bart_tree():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbart, "LAYERS", LAYERS)
        mp.setattr(jbart, "VOCAB", BART_VOCAB)
        params, _ = jbart.init(jax.random.PRNGKey(11))
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


def _classifier(tree):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbart, "VOCAB", BART_VOCAB)
        return get_text_model("bart").load_tree(tree, {}, device="cpu")


def _batch():
    """Rows of 16, 11 and 6 tokens ending in eos, pad (1) after."""
    rng = np.random.default_rng(3)
    lens = np.array([N, 11, 6])
    ids = rng.integers(3, BART_VOCAB, (3, N)).astype(np.int32)
    mask = (np.arange(N)[None, :] < lens[:, None]).astype(np.int32)
    ids[mask == 0] = tbart.PAD_ID
    ids[np.arange(3), lens - 1] = tbart.EOS_ID
    return ids, mask


def test_encoder_decoder_sites_match_jax(bart_tree):
    ids, mask = _batch()
    js, ts = MaskStream(61), MaskStream(61)
    want = np.asarray(jbart.encode_decoder(
        jax.tree_util.tree_map(jnp.asarray, bart_tree), jnp.asarray(ids),
        jnp.asarray(mask), drop=StreamDrop(js)))
    model = _classifier(bart_tree)
    with torch.no_grad():
        got = tbart.encode_decoder(model, torch.from_numpy(ids),
                                   torch.from_numpy(mask),
                                   TorchStreamKeys(ts)).numpy()
    assert ts.log == js.log, f"port {ts.log}\n jax {js.log}"
    assert len(ts.log) == (1 + 4 * LAYERS) + (1 + 6 * LAYERS)
    assert ts.log[1] == (3 * tbart.HEADS * N * N, 0.1)   # attention probs
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("flag", [False, True], ids=["head", "with_hf"])
def test_classifier_train_sites_match_jax(bart_tree, flag, monkeypatch):
    ids, mask = _batch()
    js, ts = MaskStream(71), MaskStream(71)
    monkeypatch.setattr(jcore, "dropout", lambda key, x, rate, train: (
        StreamDrop(js)(x, rate) if train else x))
    monkeypatch.setattr(jcore, "HFDropout", lambda rng: StreamDrop(js))
    apply = jax.jit(lambda p, i, m: jbart.apply(
        p, {}, (i, m), train=True, rng=jax.random.PRNGKey(0),
        drop_ratio=0.6, hf_internal_dropout=flag)[0])
    want = np.asarray(apply(jax.tree_util.tree_map(jnp.asarray, bart_tree),
                            jnp.asarray(ids), jnp.asarray(mask)))
    model = _classifier(bart_tree)
    monkeypatch.setattr(tcore, "dropout", lambda x, rate, generator: (
        x if generator is None else TorchStreamKeys(ts)(x, rate)))
    monkeypatch.setattr(tcore, "HFDropout", lambda key: TorchStreamKeys(ts))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                    train=True, key=Key(0), drop_ratio=0.6,
                    hf_internal_dropout=flag).numpy()
    assert ts.log == js.log, f"port {ts.log}\n jax {js.log}"
    model_sites = (2 + 10 * LAYERS) if flag else 0
    assert len(ts.log) == model_sites + 2
    assert ts.log[-2:] == [(3 * tbart.HIDDEN, 0.6)] * 2
    np.testing.assert_allclose(got, want, **TOL)


def test_classifier_keys_follow_jax_order(bart_tree):
    """Flag on: ``key, k_int = key.split(2)``, the model's sites on k_int,
    then the two head sites on ``key.split(2)``; flag off: the head sites
    on the unsplit key's halves. Eval and train without a key draw
    nothing."""
    model = _classifier(bart_tree)
    ids, mask = (torch.from_numpy(a) for a in _batch())
    key = Key(9)

    def by_hand(k, drop):
        k1, k2 = k.split(2)
        h = tcore.dropout(tbart.eos_pooled(model, ids, mask, drop), 0.6,
                          k1.generator("cpu"))
        h = tcore.dropout(torch.tanh(model.head_dense(h)), 0.6,
                          k2.generator("cpu"))
        return model.head_out(h)

    with torch.no_grad():
        ev = model(ids, mask)
        assert torch.equal(model(ids, mask, train=True), ev)
        assert torch.equal(model(ids, mask, key=key,
                                 hf_internal_dropout=True), ev)
        off = model(ids, mask, train=True, key=key)
        assert torch.equal(off, by_hand(key, None))
        on = model(ids, mask, train=True, key=key, hf_internal_dropout=True)
        k_rest, k_int = key.split(2)
        assert torch.equal(on, by_hand(k_rest, HFDropout(k_int)))
        assert not torch.allclose(on, off)
        assert torch.equal(on, model(ids, mask, train=True, key=key,
                                     hf_internal_dropout=True))


def _bart_ckpt(path):
    from transformers import BartConfig, BartForSequenceClassification

    torch.manual_seed(12)
    model = BartForSequenceClassification(BartConfig(
        vocab_size=BART_VOCAB, encoder_layers=LAYERS, decoder_layers=LAYERS,
        num_labels=4))
    torch.save(model.state_dict(), path)
    return str(path)


def test_main_text_bart_matches_jax_cli(train_tree, tmp_path, monkeypatch):
    from garbage_classification_rca_tpu.checkpoint.torch_convert import (
        load_torch_state_dict)
    from garbage_classification_rca_tpu.cli import main_text as jax_cli

    ckpt = _bart_ckpt(tmp_path / "bart_cls.pth")
    monkeypatch.setattr(jbart, "LAYERS", LAYERS)
    monkeypatch.setattr(jbart, "VOCAB", BART_VOCAB)
    monkeypatch.setattr(tbart, "VOCAB", BART_VOCAB)
    # the JAX trainer starts from its own init and drops the head's input
    # and hidden at 0.6: give it the checkpoint's tree and no head dropout
    monkeypatch.setattr(jbart, "init", lambda key, num_classes=4, **kw: (
        jbart.convert_torch(load_torch_state_dict(ckpt), num_classes)))
    monkeypatch.setattr(jbart, "apply", functools.partial(
        jbart.apply, drop_ratio=0.0))
    argv = [f"--dataset_folder_name={train_tree}", "--text_model=bart",
            "--epochs=1", "--ft_epochs=1", "--batch_size=4",
            "--batch_size_FT=4", "--acc_steps=2", "--acc_steps_FT=2",
            "--opt=sgd", "--lr=0.01", "--reg=0.03", "--fraction_lr=3",
            "--balance_weights", "--label_smoothing=0.1", "--seq_len=16",
            "--data_workers=2", f"--vocab_dir={BPE}"]
    _, want = _run(jax_cli.main, argv, tmp_path / "jax", monkeypatch)
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    monkeypatch.setattr(port_text, "train_forward", lambda m, flag: (
        functools.partial(m, drop_ratio=0.0, hf_internal_dropout=flag)))
    best, got = _run(port_text.main, argv + [f"--model_path={ckpt}"],
                     tmp_path / "port", monkeypatch)
    _assert_rows(got, want)
    payload = torch.load(best.best_path, weights_only=True)
    assert payload["meta"]["layers"] == LAYERS
    acc = port_test_text.main([
        "--text_model=bart", f"--model_path={best.best_path}",
        f"--dataset_folder_name={train_tree}_Val", "--seq_len=16",
        f"--vocab_dir={BPE}", "--compute_dtype=float32",
        "--eval_batch_size=8"])
    assert acc == pytest.approx(best.best_val_acc)
