"""PyTorch port, the BLIP-2 / Q-Former eval CLIs against the JAX package's
on the ``tiny_dataset`` fixture (``GC_RCA_TINY_BLIP2=1``, the CPU):

  * ``cli.blip2_test`` (1-token constrained decode) and ``cli.qformer_test``
    (the reference two-file layout) write report CSVs byte-identical to the
    JAX CLIs' from the same ``.pth`` files: an HF
    ``Blip2ForConditionalGeneration`` at the tiny geometry, peft-wrapped
    with B drawn non-zero, saved under ``model_state_dict``, and a
    ``MultimodalClassifier`` state dict. fp32 compute (``--compute_dtype``),
    so that no bf16 rounding of either framework decides an argmax;
  * the flags of the paths the port does not run yet raise, each as its
    message says (ROADMAP.md queue 1 item 7), and the Q-Former
    classifier file's diagnostics match the JAX CLI's.
"""

import glob
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

BPE = os.path.join(os.path.dirname(__file__), "fixtures", "vocab", "bpe")


@pytest.fixture(autouse=True)
def _tiny(monkeypatch):
    monkeypatch.setenv("GC_RCA_TINY_BLIP2", "1")
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    monkeypatch.delenv("GC_RCA_FUSED_ATTN", raising=False)


class MultimodalClassifier(torch.nn.Module):     # q_former_training.py:24-31
    def __init__(self, hidden=32):
        super().__init__()
        self.classifier = torch.nn.Linear(hidden, 4)


def _port_batch(path, dataset, with_lora):
    """The port's fp32 model from `path` and the whole dataset as one
    batch (CPU)."""
    from garbage_classification_rca_tpu_torch.cli import blip2_common as bc
    from garbage_classification_rca_tpu_torch.cli.blip2_train import (
        answer_first_token_table)
    from garbage_classification_rca_tpu_torch.config import args_parser
    from garbage_classification_rca_tpu_torch.data.manifest import (
        build_manifest)

    args = args_parser([f"--model_path={path}", f"--vocab_dir={BPE}"])
    cfg, model, tok = bc.build_blip2(args, "cpu", torch.float32,
                                     with_lora=with_lora)
    m = build_manifest(str(dataset))
    b = bc.Blip2Batcher(m, tok, workers=2)
    batch = b.make_batch(np.arange(len(m)), len(m))
    aft = answer_first_token_table(b, m.classes)
    b.close()
    x = bc.normalize_clip(torch.from_numpy(batch["image"]), torch.float32)
    return model, x, batch, aft


@pytest.fixture(scope="module")
def files(tmp_path_factory, tiny_dataset):
    """(blip2 .pth, classifier .pth) at GC_RCA_TINY_BLIP2's geometry.

    Random weights give every sample nearly the same class logits, so both
    files are centred on the fixture's samples: the OPT final LayerNorm's
    bias moves by the least-norm delta that zeroes each answer token's mean
    logit (the bias reaches the logits only through the tied lm head), and
    the classifier's bias is minus its mean logit. Each argmax then
    follows the sample, and the CSVs compare predictions that differ."""
    from peft import LoraConfig, get_peft_model
    from transformers import (Blip2Config, Blip2ForConditionalGeneration,
                              Blip2QFormerConfig, Blip2VisionConfig,
                              OPTConfig)

    hf = Blip2Config(
        vision_config=Blip2VisionConfig(
            hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, image_size=224, patch_size=14).to_dict(),
        qformer_config=Blip2QFormerConfig(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, encoder_hidden_size=64,
            cross_attention_frequency=2).to_dict(),
        text_config=OPTConfig(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            ffn_dim=128, vocab_size=50272, max_position_embeddings=256,
            word_embed_proj_dim=64).to_dict(),
        num_query_tokens=8)
    tm = Blip2ForConditionalGeneration(hf).eval()
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, p in tm.named_parameters():
            a = rng.normal(0, 0.1, tuple(p.shape)).astype(np.float32)
            if "norm" in name.lower() and name.endswith("weight"):
                a += 1.0
            p.copy_(torch.from_numpy(a))
    pm = get_peft_model(tm, LoraConfig(r=4, lora_alpha=8, lora_dropout=0.05,
                                       bias="none",
                                       target_modules=["q_proj", "k_proj"]))
    with torch.no_grad():
        for n, p in pm.named_parameters():
            if "lora_B" in n:
                p.copy_(torch.from_numpy(rng.normal(
                    0, 0.1, tuple(p.shape)).astype(np.float32)))
    d = tmp_path_factory.mktemp("vlm_ckpt")
    blip = d / "BLIP2_epoch_1_acc_0.5.pth"
    torch.save({"model_state_dict": pm.state_dict()}, blip)

    from garbage_classification_rca_tpu_torch.models.vlm import blip2

    mp = pytest.MonkeyPatch()
    mp.setenv("GC_RCA_TINY_BLIP2", "1")
    model, x, batch, aft = _port_batch(blip, tiny_dataset, True)
    with torch.no_grad():
        ids, mask = (torch.from_numpy(batch[k])
                     for k in ("input_ids", "attention_mask"))
        z = blip2.next_token_logits(model, x, ids, mask)[:, aft]
        e = model.opt.embed_tokens.w[aft].double()            # [4, H]
        delta = torch.linalg.lstsq(e, -z.double().mean(0))[0]
        tm.language_model.model.decoder.final_layer_norm.bias += \
            delta.float()
        assert len(set((z - z.mean(0)).argmax(1).tolist())) > 1
    torch.save({"model_state_dict": pm.state_dict()}, blip)

    model, x, _, _ = _port_batch(blip, tiny_dataset, False)
    torch.manual_seed(2)
    head = MultimodalClassifier()
    with torch.no_grad():
        logits = head.classifier(blip2.qformer_cls_feature(model, x))
        head.classifier.bias -= logits.mean(0)
        assert len(set((logits - logits.mean(0)).argmax(1).tolist())) > 1
    mp.undo()
    clf = d / "Classifier_epoch_1_acc_0.5.pth"
    torch.save(head.state_dict(), clf)
    return str(blip), str(clf)


def _csv(root):
    csvs = glob.glob(os.path.join(root, "**", "*.csv"), recursive=True)
    assert len(csvs) == 1, csvs
    with open(csvs[0], "rb") as f:
        return os.path.relpath(csvs[0], root), f.read()


def _run(main, argv, tmp_path, monkeypatch, sub):
    d = tmp_path / sub
    d.mkdir()
    monkeypatch.chdir(d)
    acc = main(argv)
    monkeypatch.chdir(tmp_path)
    return acc, _csv(str(d / "test_set_reports"))


@pytest.mark.parametrize("cli", ["blip2_test", "qformer_test"])
def test_vlm_cli_report_matches_jax(cli, files, tiny_dataset, tmp_path,
                                    monkeypatch):
    import importlib

    from garbage_classification_rca_tpu_torch.config import args_parser

    jmain = importlib.import_module(
        f"garbage_classification_rca_tpu.cli.{cli}").main
    tmod = importlib.import_module(
        f"garbage_classification_rca_tpu_torch.cli.{cli}")
    blip, clf = files
    argv = [f"--dataset_folder_name={tiny_dataset}", f"--vocab_dir={BPE}",
            f"--model_path={blip}", "--compute_dtype=float32",
            "--eval_batch_size=5", "--data_workers=2"]
    if cli == "qformer_test":
        argv.append(f"--classifier_weights={clf}")
    acc_j, want = _run(jmain, argv, tmp_path, monkeypatch, "jax")
    acc_t, got = _run(tmod.main, argv, tmp_path, monkeypatch, "port")
    assert acc_t == acc_j
    preds = tmod.evaluate(args_parser(argv))[2]
    assert len(preds) == 12 and len(set(preds.tolist())) > 1
    assert got == want                    # file name and bytes
    kind = "blip2" if cli == "blip2_test" else "qformer"
    assert got[0].startswith(os.path.join(kind, f"{kind}_model_{kind}"))


def _port(cli):
    import importlib

    return importlib.import_module(
        f"garbage_classification_rca_tpu_torch.cli.{cli}").main


@pytest.mark.parametrize("flag,match", [
    ("--max_new_tokens=3", "item 6"),
    ("--gen_temperature=0.7", "item 6"),
    ("--int8_weights", "item 6"),
    ("--kv_cache_dtype=int8", "item 6"),
    ("--mesh_shape=data:2", "item 7"),
    ("--mesh_shape=data:1,pipe:2", "item 7"),
])
def test_blip2_test_refuses_unported_flags(flag, match, tiny_dataset):
    """Meshes raise (item 7). The serving flags (item 6) run since the
    generate path was ported (``tests/test_torch_serve_cli.py`` drives
    them); beside a pipe mesh, the JAX CLI's ``pp_generate``, they raise
    as item 7."""
    argv = [f"--dataset_folder_name={tiny_dataset}", flag]
    if match == "item 6":
        argv.append("--mesh_shape=data:1,pipe:2")
        match = "item 7"
    with pytest.raises(NotImplementedError, match=match):
        _port("blip2_test")(argv)


def test_vlm_clis_refuse_orbax_dirs_multihost_and_training(
        tiny_dataset, tmp_path, monkeypatch):
    base = [f"--dataset_folder_name={tiny_dataset}"]
    for cli in ("blip2_test", "qformer_test"):
        with pytest.raises(SystemExit, match="orbax"):
            _port(cli)(base + [f"--model_path={tmp_path}"])
    with pytest.raises(SystemExit, match="orbax"):
        _port("qformer_test")(base + [f"--classifier_weights={tmp_path}"])
    for cli in ("blip2_train", "qformer_train"):
        with pytest.raises(NotImplementedError, match="mesh_shape"):
            _port(cli)(base + ["--mesh_shape=data:1,pipe:2"])
    monkeypatch.setenv("GC_RCA_MULTIHOST", "1")
    for cli in ("qformer_test", "blip2_train", "qformer_train"):
        with pytest.raises(NotImplementedError, match="multi-host"):
            _port(cli)(base)


@pytest.mark.parametrize("bad,match", [
    (lambda: torch.nn.Linear(32, 4), "does not look like a "
                                     "MultimodalClassifier"),
    (lambda: MultimodalClassifier(768), r"expects Linear\(32, 4\)")])
def test_qformer_test_classifier_diagnostics(bad, match, tiny_dataset,
                                             tmp_path):
    path = tmp_path / "clf.pth"
    torch.save(bad().state_dict(), path)
    with pytest.raises(SystemExit, match=match):
        _port("qformer_test")([f"--dataset_folder_name={tiny_dataset}",
                               f"--classifier_weights={path}",
                               f"--vocab_dir={BPE}"])


def test_vlm_clis_raise_without_cuda(tiny_dataset, monkeypatch):
    monkeypatch.delenv("GC_RCA_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cli in ("blip2_test", "qformer_test"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _port(cli)([f"--dataset_folder_name={tiny_dataset}"])
