"""PyTorch port, ``cli.main_text`` on GPT-2 and MobileBERT against the JAX
CLI for 1 + 1 epochs on the ``tiny_dataset`` tree (``GC_RCA_PLATFORM=cpu``
for the port), in the pattern of ``tests/test_torch_unimodal_train.py``.

Both trainers start from one synthesized reference-layout ``.pth`` (2
layers, full width, a 1000-token vocabulary; GPT-2 on the BPE fixture
vocabulary, whose pad is id 0, so both modules' ``PAD_ID`` is patched to
it; MobileBERT on the WordPiece one): the JAX trainer through its
``init`` patched to convert the file, the port through ``--model_path``.
Neither side binds a head-dropout ratio (GPT-2 has none, MobileBERT's is
0.0), so both runs are deterministic: per-epoch ``avg_loss`` within 1e-4,
equal val accuracies and lr, norms within 1e-3. Phase 1 (``--tl``) trains
``score`` / ``classifier`` only; under the reference spelling
``mobile_bert`` it trains nothing on either side (the JAX CLI's head keys
fall back to ``("head",)``). The port's BEST file evaluates in
``cli.test_text`` to ``best_val_acc``, and ``--hf_internal_dropout`` runs
both phases and moves the loss.
"""

import os

import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.models.text import gpt2 as jgpt2
from garbage_classification_rca_tpu.models.text import mobilebert as jmb
from garbage_classification_rca_tpu_torch.cli import main_text as port_text
from garbage_classification_rca_tpu_torch.cli import test_text as port_test
from garbage_classification_rca_tpu_torch.models.text import gpt2 as tgpt2
from garbage_classification_rca_tpu_torch.models.text import mobilebert as tmb
from tests.test_torch_gpt2 import gpt2_state_dict
from tests.test_torch_mobilebert_port import mobilebert_state_dict
from tests.test_torch_unimodal_train import (  # noqa: F401 — fixture
    _assert_rows, _run, train_tree)
from tests.test_torch_resume import (  # noqa: F401 — fixture
    _drop_checkpoints)

torch.set_num_threads(2)

LAYERS, VOCAB = 2, 1000
VOCABS = os.path.join(os.path.dirname(__file__), "fixtures", "vocab")
JAX_MODS = {"gpt2": jgpt2, "mobilebert": jmb, "mobile_bert": jmb}


def _ckpt(name, path):
    sd = (gpt2_state_dict(21) if name == "gpt2"
          else mobilebert_state_dict(22, pooler=name == "mobilebert"))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return str(path)


def _argv(base, name):
    vocab = os.path.join(VOCABS, "bpe" if name == "gpt2" else "wordpiece")
    return [f"--dataset_folder_name={base}", f"--text_model={name}",
            "--epochs=1", "--ft_epochs=1", "--batch_size=4",
            "--batch_size_FT=4", "--acc_steps=2", "--acc_steps_FT=2",
            "--opt=sgd", "--lr=0.01", "--reg=0.03", "--fraction_lr=3",
            "--balance_weights", "--label_smoothing=0.1", "--seq_len=16",
            "--data_workers=2", f"--vocab_dir={vocab}"]


@pytest.mark.parametrize("name", ["gpt2", "mobilebert", "mobile_bert"])
def test_main_text_matches_jax_cli(name, train_tree, tmp_path, monkeypatch):
    from garbage_classification_rca_tpu.checkpoint.torch_convert import (
        load_torch_state_dict)
    from garbage_classification_rca_tpu.cli import main_text as jax_cli

    jmod = JAX_MODS[name]
    ckpt = _ckpt(name, tmp_path / f"{name}.pth")
    monkeypatch.setattr(jmod, "LAYERS", LAYERS)
    for mod in (jgpt2, tgpt2):
        monkeypatch.setattr(mod, "PAD_ID", 0)      # the BPE fixture's pad
    monkeypatch.setattr(tgpt2, "VOCAB", VOCAB)
    monkeypatch.setattr(tmb, "VOCAB", VOCAB)
    monkeypatch.setattr(jmod, "init", lambda key, num_classes=4, **kw: (
        jmod.convert_torch(load_torch_state_dict(ckpt), num_classes)))
    argv = _argv(train_tree, name)
    _, want = _run(jax_cli.main, argv, tmp_path / "jax", monkeypatch)
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    before = torch.load(ckpt, weights_only=True)
    best, got = _run(port_text.main, argv + [f"--model_path={ckpt}",
                                             "--ft_epochs=0"],
                     tmp_path / "phase1", monkeypatch)
    state = torch.load(best.best_path, weights_only=True)["state_dict"]
    if name == "gpt2":       # HF's Conv1D holds [in, out]
        head, body = "score.w", "layers.0.c_attn.w"
        head_src = before["model.score.weight"]
        body_src = before["model.transformer.h.0.attn.c_attn.weight"].t()
    else:
        head, body = "classifier.w", "layers.0.att.v.w"
        head_src = before["model.classifier.weight"]
        body_src = before["model.mobilebert.encoder.layer.0.attention."
                          "self.value.weight"]
    # phase 1 leaves the body as it was; the head moved but under the
    # reference spelling, whose phase 1 trains nothing
    assert torch.equal(state[body], body_src)
    assert torch.equal(state[head], head_src) == (name == "mobile_bert")

    best, got = _run(port_text.main, argv + [f"--model_path={ckpt}"],
                     tmp_path / "port", monkeypatch)
    _assert_rows(got, want)
    payload = torch.load(best.best_path, weights_only=True)
    assert payload["meta"]["layers"] == LAYERS
    acc = port_test.main([
        f"--text_model={name}", f"--model_path={best.best_path}",
        f"--dataset_folder_name={train_tree}_Val", "--seq_len=16",
        argv[-1], "--compute_dtype=float32", "--eval_batch_size=8"])
    assert acc == pytest.approx(best.best_val_acc)

    _, on = _run(port_text.main, argv + [f"--model_path={ckpt}",
                                         "--hf_internal_dropout"],
                 tmp_path / "hf", monkeypatch)
    assert [r["phase"] for r in on] == ["train", "fine_tune"]
    assert all(np.isfinite(r["avg_loss"]) for r in on)
    assert [r["avg_loss"] for r in on] != [r["avg_loss"] for r in got]
