"""PyTorch port, the VLM trainers' CLIs on the ``tiny_dataset`` fixture
(``GC_RCA_TINY_BLIP2=1``, the CPU, fp32), against the JAX package:

  * ``cli.blip2_train.main`` (2 epochs) and ``cli.qformer_train.main`` (1
    epoch) from an HF ``Blip2ForConditionalGeneration`` ``.pth`` at the
    tiny geometry, peft-wrapped with B drawn non-zero: each logged epoch
    loss equals the mean over the same shuffled windows of the JAX step
    functions (``make_lora_train_step``, ``qformer_train.make_steps``) on
    the same file, within 1e-5 relative; at ``--batch_size=2`` the
    epoch's 6 microbatches are one trailing partial window of acc 8;
  * each BEST file is written and read back: ``cli.blip2_test
    --model_path=<BEST>`` runs on its adapters, ``cli.qformer_test
    --classifier_weights=<BEST>`` on its classifier;
  * ``--hf_internal_dropout`` reaches the loss and repeats from a seed;
  * the flags of the paths the port does not run yet raise, each as its
    message says, and without ``GC_RCA_PLATFORM=cpu`` and CUDA the
    trainers raise.
"""

import glob
import json
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
    for flag in ("GC_RCA_FUSED_ATTN", "GC_RCA_FLASH_BWD", "GC_RCA_MULTIHOST"):
        monkeypatch.delenv(flag, raising=False)


@pytest.fixture(scope="module")
def blip(tmp_path_factory):
    """An HF BLIP-2 at GC_RCA_TINY_BLIP2's geometry, random N(0, 0.1)
    weights, peft LoRA r 4 on q / k with B drawn non-zero, saved under
    ``model_state_dict``."""
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
    rng = np.random.default_rng(1)
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
    path = tmp_path_factory.mktemp("vlm_train") / "BLIP2.pth"
    torch.save({"model_state_dict": pm.state_dict()}, path)
    return str(path)


@pytest.fixture
def tree(tiny_dataset, tmp_path):
    base = tmp_path / "ds"
    os.symlink(tiny_dataset, f"{base}_Train")
    os.symlink(tiny_dataset, f"{base}_Val")
    return str(base)


def _port(cli):
    import importlib

    return importlib.import_module(
        f"garbage_classification_rca_tpu_torch.cli.{cli}")


def _run(main, argv, d, monkeypatch):
    """main(argv) in directory `d`: (its result, the logged epoch losses,
    the BEST files it wrote)."""
    d.mkdir(exist_ok=True)
    monkeypatch.chdir(d)
    out = main(argv)
    monkeypatch.chdir(d.parent)
    losses = [json.loads(line)["avg_loss"]
              for p in sorted(glob.glob(str(d / "runs" / "*.jsonl")))
              for line in open(p)]
    return out, losses, sorted(glob.glob(str(d / "model_weights" / "*" /
                                              "BEST_*")))


def _jax_epoch_losses(argv, epochs, make):
    """The JAX step functions over the trainer's shuffled windows (seed +
    epoch), built by ``make(cfg, params, lora) -> (trainable, opt_state,
    step)``: the mean window loss of each epoch."""
    import jax

    from garbage_classification_rca_tpu.cli import blip2_common as jbc
    from garbage_classification_rca_tpu.config import args_parser
    from garbage_classification_rca_tpu.data.manifest import build_manifest

    args = args_parser(argv)
    cfg, params, lora, tok = jbc.build_blip2(args)
    trainable, state, step = make(cfg, params, lora)
    b = jbc.Blip2Batcher(build_manifest(args.dataset_folder_name + "_Train"),
                         tok, workers=2)
    out = []
    for epoch in range(epochs):
        losses = []
        for win in jbc.iter_accum_windows(b, args.batch_size, 8,
                                          shuffle=True,
                                          seed=args.seed + epoch):
            trainable, state, loss = step(trainable, state, win,
                                          jax.random.PRNGKey(0))
            losses.append(float(loss))
        out.append(float(np.mean(losses)))
    b.close()
    return out


def test_blip2_train_cli_matches_jax_and_its_best_file_loads(
        blip, tree, tiny_dataset, tmp_path, monkeypatch):
    import jax.numpy as jnp

    from garbage_classification_rca_tpu.cli import blip2_train as jtrain
    from garbage_classification_rca_tpu_torch.cli import blip2_common as tbc
    from garbage_classification_rca_tpu_torch.config import args_parser
    from garbage_classification_rca_tpu_torch.train.engine import (
        load_checkpoint)

    argv = [f"--dataset_folder_name={tree}", f"--vocab_dir={BPE}",
            f"--model_path={blip}", "--batch_size=2", "--epochs=2",
            "--compute_dtype=float32", "--data_workers=2"]
    best, losses, files = _run(_port("blip2_train").main, argv,
                               tmp_path / "port", monkeypatch)

    def make(cfg, params, lora):
        opt, step = jtrain.make_lora_train_step(cfg, params,
                                                compute_dtype=jnp.float32)
        return lora, opt.init(lora), step

    want = _jax_epoch_losses(argv, 2, make)
    assert len(losses) == 2 and losses[0] != losses[1]
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    # the BEST file: the adapters alone, read back by cli.blip2_test
    assert len(files) == 1 and best.best_path == files[0]
    assert "/blip2_lora/BEST_model_blip2_lora_epoch_" in files[0]
    payload = load_checkpoint(files[0])
    assert sorted(payload["state_dict"]) == sorted(
        f"{i}.{n}.{ab}" for i in "01" for n in "qk" for ab in "ab")
    test_argv = [f"--dataset_folder_name={tiny_dataset}",
                 f"--vocab_dir={BPE}", f"--model_path={files[0]}",
                 "--compute_dtype=float32", "--eval_batch_size=6",
                 "--data_workers=2"]
    _, model, _ = tbc.build_blip2(args_parser(test_argv), "cpu",
                                  torch.float32)
    for k, v in payload["state_dict"].items():
        assert torch.equal(model.lora.state_dict()[k], v), k
    monkeypatch.chdir(tmp_path)
    acc = _port("blip2_test").main(test_argv)
    assert 0.0 <= acc <= 100.0
    assert glob.glob(str(tmp_path / "test_set_reports" / "blip2" / "*.csv"))


def test_qformer_train_cli_matches_jax_and_its_best_file_loads(
        blip, tree, tiny_dataset, tmp_path, monkeypatch):
    import jax.numpy as jnp

    from garbage_classification_rca_tpu.cli import qformer_train as jqtrain
    from garbage_classification_rca_tpu_torch.config import args_parser
    from garbage_classification_rca_tpu_torch.models.vlm import blip2
    from garbage_classification_rca_tpu_torch.nn import core
    from garbage_classification_rca_tpu_torch.train.engine import (
        load_checkpoint)

    argv = [f"--dataset_folder_name={tree}", f"--vocab_dir={BPE}",
            f"--model_path={blip}", "--batch_size=2", "--epochs=1",
            "--compute_dtype=float32", "--data_workers=2"]
    best, losses, files = _run(_port("qformer_train").main, argv,
                               tmp_path / "port", monkeypatch)

    def make(cfg, params, lora):
        # the classifier the port draws from --seed + 2, in the JAX layout
        clf = blip2.init_classifier_(core.Linear(cfg.qformer.hidden, 4),
                                     args_parser(argv).seed + 2)
        trainable = {"classifier": {"w": jnp.asarray(clf.w.detach().numpy().T),
                                    "b": jnp.asarray(clf.b.detach().numpy())}}
        opt, step, _ = jqtrain.make_steps(cfg, params,
                                          compute_dtype=jnp.float32)
        return trainable, opt.init(trainable), step

    want = _jax_epoch_losses(argv, 1, make)
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    # the BEST file: the classifier alone, read back by cli.qformer_test
    assert len(files) == 1 and best.best_path == files[0]
    assert "/qformer_classifier/BEST_model_qformer_classifier_" in files[0]
    assert sorted(load_checkpoint(files[0])["state_dict"]) == ["b", "w"]
    monkeypatch.chdir(tmp_path)
    acc = _port("qformer_test").main([
        f"--dataset_folder_name={tiny_dataset}", f"--vocab_dir={BPE}",
        f"--model_path={blip}", f"--classifier_weights={files[0]}",
        "--compute_dtype=float32", "--eval_batch_size=6",
        "--data_workers=2"])
    assert 0.0 <= acc <= 100.0
    assert glob.glob(str(tmp_path / "test_set_reports" / "qformer" /
                         "*.csv"))


def test_vlm_trainers_hf_internal_dropout_reaches_the_loss(
        blip, tree, tmp_path, monkeypatch):
    """The flag's loss differs from the loss without it and repeats from
    the same --seed (the keys are derived from it)."""
    base = [f"--dataset_folder_name={tree}", f"--vocab_dir={BPE}",
            f"--model_path={blip}", "--batch_size=3", "--epochs=1",
            "--compute_dtype=float32", "--data_workers=2"]
    for cli in ("blip2_train", "qformer_train"):
        main = _port(cli).main
        off = _run(main, base, tmp_path / f"{cli}_off", monkeypatch)[1]
        on = [_run(main, base + ["--hf_internal_dropout"],
                   tmp_path / f"{cli}_on{i}", monkeypatch)[1]
              for i in range(2)]
        assert len(off) == 1 and np.isfinite(off[0])
        assert on[0] == on[1] and on[0] != off, cli


@pytest.mark.parametrize("cli", ["blip2_train", "qformer_train"])
@pytest.mark.parametrize("flag,match", [
    ("--wandb", "--wandb"), ("--fsdp", "--fsdp"),
    ("--mesh_shape=data:2", "one device")])
def test_vlm_trainers_refuse_unported_flags(cli, flag, match, tree):
    with pytest.raises(NotImplementedError, match=match):
        _port(cli).main([f"--dataset_folder_name={tree}", flag])


def test_vlm_trainers_raise_without_cuda(tree, monkeypatch):
    monkeypatch.delenv("GC_RCA_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cli in ("blip2_train", "qformer_train"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _port(cli).main([f"--dataset_folder_name={tree}"])
