"""PyTorch port, the trainer end to end: the port's ``cli.main_both`` against
the JAX package's ``cli.main_both``, both run in this process on the CPU
(``GC_RCA_PLATFORM=cpu`` for the port), from one synthesized reference-layout
all-heads ``.pth`` that both load (the torch replica
``tests/torch_refs/fusion_ref.FusionRef``), on the same 4-class
``_Train`` / ``_Val`` JPEG tree at ``GC_RCA_MM_IMAGE_SIZE=64``.

The MM_RCA.sh recipe (SGD lr 0.0016, reg 0.03, class weights, acc_steps,
fraction_lr 3) for 1 + 1 epochs with the random sites off (--prob_aug=0,
--model_dropout=0, --image_text_dropout=0, stochastic depth 0) and fp32
compute, on a short EfficientNet table and a 2-layer DistilBERT (set on
both sides through their config tables; no file of the JAX package
changes). Per epoch the avg_loss agrees within 1e-4 and the three val
accuracies are equal; the port's BEST checkpoint then evaluates in the
port's ``cli.test_both`` to the same accuracy.
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu_torch.cli import main_both as port_cli
from garbage_classification_rca_tpu_torch.cli import test_both as port_test
from garbage_classification_rca_tpu_torch.models.image import efficientnet_v2 as teffv2
from tests.test_torch_resume import (  # noqa: F401 — fixture
    _drop_checkpoints)

torch.set_num_threads(2)

VOCAB = os.path.join(os.path.dirname(__file__), "fixtures", "vocab",
                     "wordpiece")
STAGES = (("fused", 1, 3, 1, 24, 24, 1), ("fused", 4, 3, 2, 24, 16, 1),
          ("fused", 4, 3, 2, 16, 16, 1), ("mb", 4, 3, 2, 16, 24, 1),
          ("mb", 6, 3, 1, 24, 24, 2), ("mb", 6, 3, 2, 24, 32, 1),
          ("mb", 6, 3, 1, 32, 40, 1))


def _tree(root, rng):
    names = {"black": "coffee_cup", "blue": "water_bottle",
             "green": "banana_peel", "ttr": "battery_pack"}
    from PIL import Image

    for split, n in (("_Train", 3), ("_Val", 2)):
        for cls, stem in names.items():
            d = root.parent / (root.name + split) / cls
            d.mkdir(parents=True)
            for j in range(n):
                hw = (int(rng.integers(40, 90)), int(rng.integers(40, 90)), 3)
                Image.fromarray(rng.integers(0, 255, hw, dtype=np.uint8)).save(
                    d / f"{stem}_{j}.jpg")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """(dataset base path, all-heads .pth) with the short image table."""
    from transformers import DistilBertConfig, DistilBertModel
    from tests.torch_refs import fusion_ref

    base = tmp_path_factory.mktemp("data") / "garbage"
    _tree(base, np.random.default_rng(0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fusion_ref, "V2_M_STAGES", [list(s) for s in STAGES])
        torch.manual_seed(0)
        ref = fusion_ref.FusionRef(DistilBertModel(DistilBertConfig(
            n_layers=2)), batch_size=16, reverse=True)
    ckpt = tmp_path_factory.mktemp("ckpt") / "mm_rca.pth"
    torch.save(ref.state_dict(), ckpt)
    return base, ckpt


def _argv(base, ckpt):
    return [f"--dataset_folder_name={base}", "--late_fusion=MM_RCA",
            "--ft_epochs=1", "--epochs=1", "--prob_aug=0.0",
            "--acc_steps=2", "--acc_steps_FT=2", "--opt=sgd",
            "--text_model=distilbert", "--fraction_lr=3",
            "--image_text_dropout=0.0", "--balance_weights", "--reg=0.03",
            "--lr=0.0016", "--reverse", "--model_dropout=0.0",
            "--batch_size=4", "--batch_size_FT=4", "--compute_dtype=float32",
            "--seq_len=16", "--data_workers=2", f"--vocab_dir={VOCAB}",
            f"--model_path={ckpt}"]


def _run(main, argv, d, monkeypatch):
    d.mkdir()
    monkeypatch.chdir(d)
    best = main(argv)
    rows = [json.loads(line) for f in glob.glob(str(d / "runs" / "*.jsonl"))
            for line in open(f)]
    return best, sorted(rows, key=lambda r: r["phase"] != "train")


def test_port_trainer_matches_jax_trainer(inputs, tmp_path, monkeypatch):
    from garbage_classification_rca_tpu import native
    from garbage_classification_rca_tpu.cli import main_both as jax_cli
    from garbage_classification_rca_tpu.models.image import efficientnet_v2 as jeffv2
    from garbage_classification_rca_tpu.models.text import distilbert as jdistil

    base, ckpt = inputs
    monkeypatch.setenv("GC_RCA_MM_IMAGE_SIZE", "64")
    # the JAX batcher on its PIL + cv2 route, the one the port copies
    monkeypatch.setattr(native, "pad_resize_batch", lambda *a, **k: None)
    monkeypatch.setattr(native, "decode_enabled", lambda: False)
    jcfg = jeffv2.CONFIGS["eff_v2_medium"]
    monkeypatch.setitem(jeffv2.CONFIGS, "eff_v2_medium", dataclasses.replace(
        jcfg, stages=STAGES, sd_prob=0.0))
    monkeypatch.setattr(jdistil, "LAYERS", 2)
    tcfg = teffv2.CONFIGS["eff_v2_medium"]
    monkeypatch.setitem(teffv2.CONFIGS, "eff_v2_medium", dataclasses.replace(
        tcfg, stages=STAGES, sd_prob=0.0))

    _, want = _run(jax_cli.main, _argv(base, ckpt), tmp_path / "jax",
                   monkeypatch)
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    best, got = _run(port_cli.main, _argv(base, ckpt), tmp_path / "port",
                     monkeypatch)
    assert [r["phase"] for r in got] == [r["phase"] for r in want] == [
        "train", "fine_tune"]
    for g, w in zip(got, want):
        assert abs(g["avg_loss"] - w["avg_loss"]) <= 1e-4, (g, w)
        for k in ("val_acc", "val_acc_image_only", "val_acc_text_only"):
            assert g[k] == w[k], (k, g, w)
        assert g["lr"] == pytest.approx(w["lr"])
    # the BEST checkpoint of the port's trainer, in the port's test CLI
    assert os.path.isfile(best.best_path)
    acc = port_test.main(["--late_fusion=MM_RCA", "--reverse",
                          f"--model_path={best.best_path}",
                          f"--dataset_folder_name={base}_Val",
                          f"--vocab_dir={VOCAB}", "--compute_dtype=float32",
                          "--seq_len=16", "--eval_batch_size=8",
                          "--data_workers=2"])
    assert acc == pytest.approx(best.best_val_acc)


@pytest.mark.parametrize("flag,exc,match", [
    ("--wandb", NotImplementedError, "wandb"),
    # --fsdp and data:N run (tests/test_torch_fsdp.py): data:N outside an
    # N-rank world exits naming the launcher; the other axes stay item 7
    ("--fsdp --mesh_shape=data:2", SystemExit, "torchrun --nproc_per_node=2"),
    ("--mesh_shape=data:2", SystemExit, "torchrun --nproc_per_node=2"),
    ("--mesh_shape=data:1,model:2", NotImplementedError, "item 7"),
    ("--mesh_shape=pipe:2", NotImplementedError, "item 7"),
    # the pairs the JAX package refuses, with its messages
    ("--late_fusion=hierarchical --text_model=bart", ValueError,
     "hierarchical fusion needs per-layer hidden states"),
    ("--text_model=bart", ValueError, "MM_RCA requires a 768-d text tower")])
def test_unported_train_flags_raise(monkeypatch, flag, exc, match):
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    with pytest.raises(exc, match=match):
        port_cli.main(["--late_fusion=MM_RCA", "--dataset_folder_name=x"]
                      + flag.split())


def test_trainer_exits_like_the_reference_and_needs_cuda(monkeypatch):
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    with pytest.raises(SystemExit) as e:
        port_cli.main(["--late_fusion=nope"])
    assert e.value.code == 1
    with pytest.raises(SystemExit) as e:
        port_cli.main(["--late_fusion=MM_RCA", "--opt=rmsprop"])
    assert e.value.code == 1
    monkeypatch.delenv("GC_RCA_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main(["--late_fusion=MM_RCA", "--dataset_folder_name=x"])
