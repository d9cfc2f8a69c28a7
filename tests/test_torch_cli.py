"""PyTorch port, the test CLI end to end: ``cli.test_both`` on the
``tiny_dataset`` fixture (``GC_RCA_PLATFORM=cpu``, fp32) with a
reference-layout all-heads checkpoint synthesized from the torch replica
``tests/torch_refs/fusion_ref.FusionRef``. Its report CSV must be
byte-identical to the one computed from FusionRef's own predictions on the
same padded batches (MM_RCA, gated, clip at ``--batch_size=16``, bimodal;
and, in the slow twin, to the JAX CLI's CSV)."""

import glob
import os

import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu_torch.cli import test_both as port_cli

torch.set_num_threads(2)

VOCAB = os.path.join(os.path.dirname(__file__), "fixtures", "vocab",
                     "wordpiece")


def _csv_bytes(root):
    csvs = glob.glob(os.path.join(root, "**", "*.csv"), recursive=True)
    assert len(csvs) == 1, csvs
    with open(csvs[0], "rb") as f:
        return os.path.basename(csvs[0]), f.read()


def _pil_route(monkeypatch):
    """Pin the JAX package's batcher to its PIL + cv2 route (its fallback
    without the optional native library), the route the port copies, so
    both sides see byte-identical images."""
    from garbage_classification_rca_tpu import native

    monkeypatch.setattr(native, "pad_resize_batch", lambda *a, **k: None)
    monkeypatch.setattr(native, "decode_enabled", lambda: False)


def _run_cli(main, argv, tmp_path, monkeypatch, sub):
    d = tmp_path / sub
    d.mkdir(exist_ok=True)
    monkeypatch.chdir(d)
    main(argv)
    monkeypatch.chdir(tmp_path)
    return _csv_bytes(str(d / "test_set_reports"))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """FusionRef at full width (EffNetV2-M, 6-layer DistilBERT), every head
    in the state dict, forward on the final_with_everything head."""
    from transformers import DistilBertConfig, DistilBertModel
    from tests.torch_refs.fusion_ref import FusionRef

    torch.manual_seed(0)
    ref = FusionRef(DistilBertModel(DistilBertConfig()), batch_size=16,
                    reverse=True, features_only=True,
                    cross_attention_only=True).eval()
    ref.features_only = ref.cross_attention_only = False
    ckpt = tmp_path_factory.mktemp("ckpt") / "mm_rca.pth"
    torch.save(ref.state_dict(), ckpt)
    return ref, ckpt


def _argv(ckpt, dataset, strategy="MM_RCA"):
    return [f"--late_fusion={strategy}", "--reverse",
            "--text_model=distilbert", f"--model_path={ckpt}",
            f"--dataset_folder_name={dataset}", f"--vocab_dir={VOCAB}",
            "--compute_dtype=float32", "--eval_batch_size=8",
            "--batch_size=16", "--data_workers=2"]


@pytest.mark.parametrize("strategy", ["MM_RCA", "gated", "clip", "bimodal"])
def test_port_cli_report_matches_fusion_ref(checkpoint, tiny_dataset,
                                            tmp_path, monkeypatch, strategy):
    """CLIP evaluates at --batch_size (16: one batch, 12 samples and 4
    padding rows); bimodal's GRUs scan the rows of each padded batch of
    8."""
    from garbage_classification_rca_tpu.data.images import (IMAGENET_MEAN,
                                                            IMAGENET_STD)
    from garbage_classification_rca_tpu.data.manifest import build_manifest
    from garbage_classification_rca_tpu.data.pipeline import ImageTextBatcher
    from garbage_classification_rca_tpu.data.tokenizer import get_tokenizer
    from garbage_classification_rca_tpu.eval.report import (
        generate_report_and_image)

    ref, ckpt = checkpoint
    _pil_route(monkeypatch)
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    name, got = _run_cli(port_cli.main, _argv(ckpt, tiny_dataset, strategy),
                         tmp_path, monkeypatch, "port")
    batch_size = 16 if strategy == "clip" else 8

    b = ImageTextBatcher(build_manifest(str(tiny_dataset)), (480, 480),
                         tokenizer=get_tokenizer("distilbert",
                                                 vocab_dir=VOCAB),
                         seq_len=64, workers=2)
    preds, labels = [], []
    for batch in b.iter_batches(batch_size):
        x = (batch["image"].astype(np.float32) / 255.0 - IMAGENET_MEAN) \
            / IMAGENET_STD
        with torch.no_grad():
            logits = ref(torch.tensor(batch["input_ids"].astype(np.int64)),
                         torch.tensor(batch["attention_mask"].astype(
                             np.int64)),
                         torch.tensor(x.transpose(0, 3, 1, 2)),
                         strategy=strategy)
        valid = batch["valid"].astype(bool)
        preds.append(logits.numpy().argmax(-1)[valid])
        labels.append(batch["label"][valid])
    b.close()
    labels, preds = np.concatenate(labels), np.concatenate(preds)
    acc = 100.0 * float((labels == preds).mean())
    out = tmp_path / "ref" / strategy
    generate_report_and_image(labels, preds, acc, str(out), strategy,
                              kind="both")
    assert (name, got) == _csv_bytes(str(tmp_path / "ref"))


@pytest.mark.slow
def test_port_cli_report_matches_jax_cli(checkpoint, tiny_dataset, tmp_path,
                                         monkeypatch):
    from garbage_classification_rca_tpu.cli import test_both as jax_cli

    _, ckpt = checkpoint
    _pil_route(monkeypatch)
    want = _run_cli(jax_cli.main, _argv(ckpt, tiny_dataset), tmp_path,
                    monkeypatch, "jax")
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    got = _run_cli(port_cli.main, _argv(ckpt, tiny_dataset), tmp_path,
                   monkeypatch, "port")
    assert got == want


def test_port_cli_exits_like_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    with pytest.raises(SystemExit) as e:
        port_cli.main([])                        # no --model_path
    assert e.value.code == 0
    with pytest.raises(SystemExit) as e:
        port_cli.main(["--model_path=x.pth", "--late_fusion=nope"])
    assert e.value.code == 1
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node=2"):
        port_cli.main(["--model_path=x.pth", "--mesh_shape=data:2"])
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 7"):
        port_cli.main(["--model_path=x.pth", "--mesh_shape=data:1,model:2"])
    with pytest.raises(ValueError, match="per-layer hidden states"):
        port_cli.main(["--model_path=x.pth", "--late_fusion=hierarchical",
                       "--text_model=bart"])
