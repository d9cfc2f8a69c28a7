"""PyTorch port, BART-large: the classifier and the bare encoder-decoder
against the JAX package's ``models/text/bart.py`` and HF transformers.

Full width (d 1024, 16 heads, FFN 4096), 2 + 2 layers, a 1000-token
vocabulary (the JAX module's ``LAYERS`` / ``VOCAB`` and the port's
``VOCAB`` are patched for the test; no JAX file changes). A synthesized
``BartForSequenceClassification`` state dict and a bare ``BartModel`` one
go through both converters to the same tree; rows padded to 16 tokens,
pooled at the last eos (one or two eos a row). fp32 logits within
rtol = atol = 1e-4 of the JAX ``apply`` with the argmax equal, and of HF's;
bf16 within 3e-2 (the bar of the JAX package's own bf16 tower tests).
Then ``cli.test_text --text_model=bart`` writes the same report CSV as the
JAX CLI on the ``tiny_dataset`` fixture.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.models.text import bart as jbart
from garbage_classification_rca_tpu_torch.checkpoint.torch_convert import (
    load_torch_state_dict)
from garbage_classification_rca_tpu_torch.cli import test_text as port_cli
from garbage_classification_rca_tpu_torch.models.registry import (
    get_text_model)
from garbage_classification_rca_tpu_torch.models.text import bart as tbart

torch.set_num_threads(2)

VOCAB, LAYERS, N = 1000, 2, 16
BPE = os.path.join(os.path.dirname(__file__), "fixtures", "vocab", "bpe")
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    monkeypatch.setattr(jbart, "LAYERS", LAYERS)
    monkeypatch.setattr(jbart, "VOCAB", VOCAB)
    monkeypatch.setattr(tbart, "VOCAB", VOCAB)
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def hf(tmp_path_factory):
    """(HF classifier, its .pth path)."""
    from transformers import BartConfig, BartForSequenceClassification

    torch.manual_seed(4)
    model = BartForSequenceClassification(BartConfig(
        vocab_size=VOCAB, encoder_layers=LAYERS, decoder_layers=LAYERS,
        num_labels=4)).eval()
    path = tmp_path_factory.mktemp("bart") / "bart_cls.pth"
    torch.save(model.state_dict(), path)
    return model, path


def _batch(n_eos, seed=0):
    """Rows of 16, 11 and 6 tokens: random ids, eos at the row's end (and
    one more inside with ``n_eos=2``), pad (1) after."""
    rng = np.random.default_rng(seed)
    lens = np.array([N, 11, 6])
    ids = rng.integers(3, VOCAB, (3, N)).astype(np.int32)
    mask = (np.arange(N)[None, :] < lens[:, None]).astype(np.int32)
    ids[mask == 0] = tbart.PAD_ID
    ids[np.arange(3), lens - 1] = tbart.EOS_ID
    if n_eos == 2:
        ids[np.arange(3), lens // 2] = tbart.EOS_ID
    return ids, mask


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _same_tree(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), path
        for k in b:
            _same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}.{i}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), path)


@pytest.mark.parametrize("n_eos", [1, 2])
def test_classifier_matches_jax_and_hf(hf, n_eos):
    model_hf, path = hf
    sd = load_torch_state_dict(str(path))
    want_tree, _ = jbart.convert_torch(dict(sd), num_classes=4)
    mdef = get_text_model("bart")
    tree, state = mdef.convert_torch(sd, num_classes=4)
    _same_tree(tree, _np(want_tree))
    with pytest.raises(ValueError, match="class-count"):
        mdef.convert_torch(sd, num_classes=5)
    model = mdef.load_tree(tree, state, device="cpu")
    assert len(model.enc_layers) == len(model.dec_layers) == LAYERS

    ids, mask = _batch(n_eos)
    got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    want, _ = jbart.apply(jax.tree_util.tree_map(jnp.asarray, want_tree), {},
                          (jnp.asarray(ids), jnp.asarray(mask)))
    want = np.asarray(want)
    assert got.shape == want.shape == (3, 4)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
    ref = model_hf(input_ids=torch.from_numpy(ids).long(),
                   attention_mask=torch.from_numpy(mask).long()).logits
    np.testing.assert_allclose(got, ref.numpy(), **TOL)


def test_bf16_classifier_matches_jax(hf):
    sd = load_torch_state_dict(str(hf[1]))
    tree, _ = get_text_model("bart").convert_torch(sd)
    model = get_text_model("bart").load_tree(tree, device="cpu").to(
        torch.bfloat16)
    ids, mask = _batch(1, seed=1)
    got = model(torch.from_numpy(ids), torch.from_numpy(mask)).float()
    p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    want, _ = jbart.apply(p, {}, (jnp.asarray(ids), jnp.asarray(mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)


def test_bare_model_converts_and_encodes_like_jax(hf):
    """The fusion towers' layout: a bare BartModel under ``text_model.``,
    its decoder states against the JAX ``encode_decoder`` and HF's."""
    bare = hf[0].model
    sd = {"text_model." + k: v.detach().numpy()
          for k, v in bare.state_dict().items()}
    want_tree, _ = jbart.convert_torch(dict(sd))
    tree, _ = tbart.convert_torch(sd)
    assert "head_dense" not in tree
    _same_tree(tree, _np(want_tree))
    model = tbart.BartModel(LAYERS)
    from garbage_classification_rca_tpu_torch.checkpoint.from_jax import (
        load_jax_tree)

    load_jax_tree(model, tree, allow_skipped=())
    ids, mask = _batch(1, seed=2)
    got = tbart.encode_decoder(model, torch.from_numpy(ids),
                               torch.from_numpy(mask)).numpy()
    want = np.asarray(jbart.encode_decoder(
        jax.tree_util.tree_map(jnp.asarray, want_tree), jnp.asarray(ids),
        jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, **TOL)
    ref = bare(input_ids=torch.from_numpy(ids).long(),
               attention_mask=torch.from_numpy(mask).long())[0]
    np.testing.assert_allclose(got, ref.numpy(), **TOL)


def _csv(root):
    csvs = glob.glob(os.path.join(root, "**", "*.csv"), recursive=True)
    assert len(csvs) == 1, csvs
    with open(csvs[0], "rb") as f:
        return os.path.basename(csvs[0]), f.read()


def test_port_cli_report_matches_jax_cli(hf, tiny_dataset, tmp_path,
                                         monkeypatch):
    from garbage_classification_rca_tpu.cli import test_text as jax_cli

    argv = ["--text_model=bart", f"--model_path={hf[1]}",
            f"--dataset_folder_name={tiny_dataset}", f"--vocab_dir={BPE}",
            "--compute_dtype=float32"]
    got = {}
    for side, main in (("jax", jax_cli.main), ("port", port_cli.main)):
        if side == "port":
            monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        main(argv)
        got[side] = _csv(str(d / "test_set_reports"))
    assert got["port"] == got["jax"]
    assert got["port"][0].startswith("text_model_bart_report_test_set_acc_")
