"""PyTorch port, ``cli.main_both`` with the strategies and towers beside
MM-RCA on DistilBERT, against the JAX package's ``cli.main_both``: the
pattern of ``tests/test_torch_train_cli.py`` (both CLIs in this process on
the CPU, one synthesized reference-layout all-heads ``.pth`` from
``tests/torch_refs/fusion_ref.FusionRef``, the same 4-class JPEG tree at
``GC_RCA_MM_IMAGE_SIZE=64``, the short EfficientNet table, 2 text layers,
1 + 1 epochs of the MM_RCA.sh recipe with the random sites off, fp32).

  * ``--late_fusion=clip --batch_size=8`` on DistilBERT: the CLIP head is
    a Linear of width 8; the 12-sample train split ends in a padded
    batch, which takes part in the similarity matrix as in the JAX
    package, and validation runs at exactly 8;
  * ``--late_fusion=MM_RCA --text_model=bert``.

Per epoch the avg_loss agrees within 1e-4 and the three val accuracies are
equal; the port's BEST file then evaluates in the port's ``cli.test_both``
to the same accuracy.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu_torch.cli import main_both as port_cli
from garbage_classification_rca_tpu_torch.cli import test_both as port_test
from garbage_classification_rca_tpu_torch.models.image import efficientnet_v2 as teffv2
from tests.test_torch_train_cli import STAGES, VOCAB, _run, _tree
from tests.test_torch_resume import (  # noqa: F401 — fixture
    _drop_checkpoints)

torch.set_num_threads(2)

CASES = [("clip", "distilbert", 8), ("MM_RCA", "bert", 4)]


def _ckpt(path, strategy, tower, batch):
    import transformers as tf
    from tests.torch_refs import fusion_ref

    enc = (tf.DistilBertModel(tf.DistilBertConfig(n_layers=2))
           if tower == "distilbert"
           else tf.BertModel(tf.BertConfig(num_hidden_layers=2)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fusion_ref, "V2_M_STAGES", [list(s) for s in STAGES])
        torch.manual_seed(0)
        ref = fusion_ref.FusionRef(enc, batch_size=batch, reverse=True)
    torch.save(ref.state_dict(), path)
    return str(path)


@pytest.mark.parametrize("strategy,tower,batch", CASES)
def test_port_trainer_matches_jax_trainer(strategy, tower, batch, tmp_path,
                                          monkeypatch):
    from garbage_classification_rca_tpu import native
    from garbage_classification_rca_tpu.cli import main_both as jax_cli
    from garbage_classification_rca_tpu.models.image import efficientnet_v2 as jeffv2
    from garbage_classification_rca_tpu.models.text import bert as jbert
    from garbage_classification_rca_tpu.models.text import distilbert as jdistil

    base = tmp_path / "data" / "garbage"
    base.parent.mkdir()
    _tree(base, np.random.default_rng(0))
    ckpt = _ckpt(tmp_path / "fusion.pth", strategy, tower, batch)
    monkeypatch.setenv("GC_RCA_MM_IMAGE_SIZE", "64")
    # the JAX batcher on its PIL + cv2 route, the one the port copies
    monkeypatch.setattr(native, "pad_resize_batch", lambda *a, **k: None)
    monkeypatch.setattr(native, "decode_enabled", lambda: False)
    for cfgs in (jeffv2.CONFIGS, teffv2.CONFIGS):
        monkeypatch.setitem(cfgs, "eff_v2_medium", dataclasses.replace(
            cfgs["eff_v2_medium"], stages=STAGES, sd_prob=0.0))
    for mod in (jdistil, jbert):
        monkeypatch.setattr(mod, "LAYERS", 2)
    argv = [f"--dataset_folder_name={base}", f"--late_fusion={strategy}",
            "--ft_epochs=1", "--epochs=1", "--prob_aug=0.0",
            "--acc_steps=2", "--acc_steps_FT=2", "--opt=sgd",
            f"--text_model={tower}", "--fraction_lr=3",
            "--image_text_dropout=0.0", "--balance_weights", "--reg=0.03",
            "--lr=0.0016", "--reverse", "--model_dropout=0.0",
            f"--batch_size={batch}", f"--batch_size_FT={batch}",
            "--compute_dtype=float32", "--seq_len=16", "--data_workers=2",
            f"--vocab_dir={VOCAB}", f"--model_path={ckpt}"]
    _, want = _run(jax_cli.main, argv, tmp_path / "jax", monkeypatch)
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    best, got = _run(port_cli.main, argv, tmp_path / "port", monkeypatch)
    assert [r["phase"] for r in got] == [r["phase"] for r in want] == [
        "train", "fine_tune"]
    for g, w in zip(got, want):
        assert abs(g["avg_loss"] - w["avg_loss"]) <= 1e-4, (g, w)
        for k in ("val_acc", "val_acc_image_only", "val_acc_text_only"):
            assert g[k] == w[k], (k, g, w)
        assert g["lr"] == pytest.approx(w["lr"])
    assert os.path.isfile(best.best_path)
    assert os.path.basename(os.path.dirname(best.best_path)) == \
        f"{strategy}_{tower}"
    acc = port_test.main([f"--late_fusion={strategy}", "--reverse",
                          f"--text_model={tower}", f"--batch_size={batch}",
                          f"--model_path={best.best_path}",
                          f"--dataset_folder_name={base}_Val",
                          f"--vocab_dir={VOCAB}", "--compute_dtype=float32",
                          "--seq_len=16", "--eval_batch_size=8",
                          "--data_workers=2"])
    assert acc == pytest.approx(best.best_val_acc)
