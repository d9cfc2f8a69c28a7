"""PyTorch port, the unimodal trainers: ``cli.main_text`` and
``cli.main_image`` and the train step under them, against the JAX package on
the CPU (``GC_RCA_PLATFORM=cpu`` for the port).

  * one optimizer step of the text trainer's step (DistilBERT, 2 layers,
    full width, SGD with weight decay, class weights, label smoothing; two
    microbatches, the second with a padded tail, and a third fully padded)
    against the JAX ``make_train_step`` from the same tree, with the
    head-only mask and all trainable, ``drop_ratio = 0``: loss, norms and
    every updated parameter within 5e-5 (the bar of
    ``tests/test_torch_train_step.py``);
  * the same with ``hf_internal_dropout``: both sides' ``HFDropout`` made a
    reader of one shared numpy mask stream (the port's attention site
    through ``mha_flash_train_dropout``, the JAX side's on its plain
    graph);
  * one step of the ViT step (2 layers, 32 x 32 input, fp32);
  * the CLIs for 1 + 1 epochs on the ``tiny_dataset`` tree with the random
    sites off, from one synthesized reference-layout ``.pth``: per-epoch
    ``avg_loss`` within 1e-4, equal val accuracies and lr; the BEST file
    evaluates in the port's test CLI to ``best_val_acc``;
  * ``--hf_internal_dropout``: ``main_text`` runs and its same-seed loss
    differs from the flag-off run; ``main_both`` runs an epoch;
    ``main_image`` exits with the JAX message; the flags of paths not
    ported raise.
"""

import dataclasses
import functools
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.data.images import (
    normalize_on_device as jnormalize)
from garbage_classification_rca_tpu.models.image import vit as jvit
from garbage_classification_rca_tpu.models.text import distilbert as jdistil
from garbage_classification_rca_tpu.nn import core as jcore
from garbage_classification_rca_tpu.train import loop as jloop
from garbage_classification_rca_tpu.train.optim import make_optimizer
from garbage_classification_rca_tpu_torch.checkpoint.from_jax import (
    export_jax_tree)
from garbage_classification_rca_tpu_torch.cli import main_both as port_both
from garbage_classification_rca_tpu_torch.cli import main_image as port_image
from garbage_classification_rca_tpu_torch.cli import main_text as port_text
from garbage_classification_rca_tpu_torch.cli import test_image as port_test_image
from garbage_classification_rca_tpu_torch.cli import test_text as port_test_text
from garbage_classification_rca_tpu_torch.data.images import normalize_on_device
from garbage_classification_rca_tpu_torch.models.image import (
    efficientnet_v2 as teffv2)
from garbage_classification_rca_tpu_torch.models.image import vit as tvit
from garbage_classification_rca_tpu_torch.models.registry import (
    get_text_model)
from garbage_classification_rca_tpu_torch.nn import core as tcore
from garbage_classification_rca_tpu_torch.nn.core import Key
from garbage_classification_rca_tpu_torch.train import loop as tloop
from garbage_classification_rca_tpu_torch.train.optim import make_optimizer as \
    make_torch_optimizer
from tests.test_torch_hf_dropout import MaskStream, StreamDrop, TorchStreamKeys
from tests.torch_refs.vit_ref import VisionTransformerRef
from tests.test_torch_resume import (  # noqa: F401 — fixture
    _drop_checkpoints)

torch.set_num_threads(2)

VOCABS = os.path.join(os.path.dirname(__file__), "fixtures", "vocab")
CLASS_WEIGHTS = [0.8, 1.25, 1.0, 1.1]
LR, REG, SMOOTH = 0.05, 0.03, 0.1
TOL = dict(rtol=5e-5, atol=5e-5)
N_LAYERS = 2


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for j, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{j}."))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _np_tree(t):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)


@pytest.fixture(scope="module")
def text_setup():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdistil, "LAYERS", N_LAYERS)
        params, _ = jdistil.init(jax.random.PRNGKey(6))
    params = _np_tree(params)
    rng = np.random.default_rng(5)
    acc, b, n = 3, 3, 12
    lens = rng.integers(3, n + 1, (acc, b))
    mask = (np.arange(n)[None, None, :] < lens[..., None]).astype(np.int32)
    stack = {
        "input_ids": (rng.integers(1000, 30000, (acc, b, n)) * mask).astype(
            np.int32),
        "attention_mask": mask,
        "label": rng.integers(0, 4, (acc, b)).astype(np.int32),
        "valid": np.array([[1, 1, 1], [1, 1, 0], [0, 0, 0]], np.int32)}
    return params, stack


def _jax_step(apply_fn, params, stack, mask, batch_to_inputs):
    opt = make_optimizer("sgd", LR, REG, mask)
    step = jloop.make_train_step(
        apply_fn, opt, class_weights=CLASS_WEIGHTS, label_smoothing=SMOOTH,
        compute_dtype=jnp.float32, batch_to_inputs=batch_to_inputs,
        log_norms=True)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    new_p, _, _, loss, losses, norms = step(
        jp, {}, opt.init(jp), {k: jnp.asarray(v) for k, v in stack.items()},
        jax.random.PRNGKey(0))
    return (float(loss), np.asarray(losses), float(norms["grad_norm"]),
            float(norms["param_norm"]), _flatten(new_p))


def _port_step(model, stack, mask, batch_to_inputs, forward=None):
    opt = make_torch_optimizer("sgd", model.named_parameters(), LR, REG, mask)
    step = tloop.make_train_step(
        model, opt, batch_to_inputs=batch_to_inputs, forward=forward,
        class_weights=torch.tensor(CLASS_WEIGHTS), label_smoothing=SMOOTH)
    loss, losses, norms = step({k: torch.from_numpy(v)
                                for k, v in stack.items()}, Key(0))
    return (loss.item(), losses.numpy(), norms["grad_norm"].item(),
            norms["param_norm"].item(), export_jax_tree(model))


def _assert_step(got, want):
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g, w, **TOL)
    assert set(got[4]) == set(want[4])
    for k, v in got[4].items():
        np.testing.assert_allclose(v, want[4][k], err_msg=k, **TOL)


def _text_inputs(mb, *_):
    return (mb["input_ids"], mb["attention_mask"])


@pytest.mark.parametrize("head_only", [True, False])
def test_text_train_step_matches_jax(text_setup, head_only):
    params, stack = text_setup
    apply_fn = functools.partial(jdistil.apply, drop_ratio=0.0)
    jmask = (jloop.head_only_mask(params, ("head",)) if head_only
             else jloop.all_trainable_mask(params))
    want = _jax_step(apply_fn, params, stack, jmask, _text_inputs)
    model = get_text_model("distilbert").load_tree(params, {}, device="cpu")
    tmask = (tloop.head_only_mask(model, port_text.head_keys_for(
        "distilbert")) if head_only else tloop.all_trainable_mask(model))
    assert {k: bool(v) for k, v in _flatten(jmask).items()} == {
        k: v for k, v in tmask.items()}
    got = _port_step(model, stack, tmask, _text_inputs,
                     functools.partial(model, drop_ratio=0.0))
    _assert_step(got, want)
    assert got[1][2] == 0.0                       # the padded microbatch
    before = _flatten(params)
    moved = {k for k, v in got[4].items() if not np.array_equal(v, before[k])}
    if head_only:                                 # the encoder kept its weights
        assert moved == {"head.w", "head.b"}
    else:
        assert "encoder.layers.0.q.w" in moved and "head.w" in moved


def test_text_train_step_with_internal_dropout_matches_jax(text_setup,
                                                           monkeypatch):
    """One microbatch (the JAX step traces its scan body once, so a host
    stream gives every microbatch of a stack the same masks)."""
    params, stack = text_setup
    stack = {k: v[:1] for k, v in stack.items()}
    js, ts = MaskStream(41), MaskStream(41)
    monkeypatch.setattr(jcore, "HFDropout", lambda rng: StreamDrop(js))
    monkeypatch.setattr(tcore, "HFDropout", lambda key: TorchStreamKeys(ts))
    want = _jax_step(
        functools.partial(jdistil.apply, drop_ratio=0.0,
                          hf_internal_dropout=True),
        params, stack, jloop.all_trainable_mask(params), _text_inputs)
    model = get_text_model("distilbert").load_tree(params, {}, device="cpu")
    got = _port_step(model, stack, None, _text_inputs, functools.partial(
        model, drop_ratio=0.0, hf_internal_dropout=True))
    assert ts.log == js.log and len(ts.log) == 1 + 2 * N_LAYERS
    _assert_step(got, want)


def test_vit_train_step_matches_jax():
    jcfg = jvit.ViTConfig(image_size=32, layers=N_LAYERS)
    params, _ = jvit.init(jax.random.PRNGKey(8), jcfg)
    params = _np_tree(params)
    rng = np.random.default_rng(9)
    params["class_token"] = rng.normal(0, 0.02, (1, 1, 768)).astype(
        np.float32)
    stack = {"image": rng.integers(0, 256, (2, 3, 32, 32, 3), dtype=np.uint8),
             "label": rng.integers(0, 4, (2, 3)).astype(np.int32),
             "valid": np.array([[1, 1, 1], [1, 0, 0]], np.int32)}
    want = _jax_step(functools.partial(jvit.apply, cfg=jcfg), params, stack,
                     None, lambda mb: jnormalize(mb["image"],
                                                 dtype=jnp.float32))
    model = tvit.ViT(tvit.ViTConfig(image_size=32, layers=N_LAYERS))
    from garbage_classification_rca_tpu_torch.checkpoint.from_jax import (
        load_jax_tree)

    load_jax_tree(model, params, None, allow_skipped=())
    got = _port_step(model, stack, None, lambda mb, key: (
        normalize_on_device(mb["image"], dtype=torch.float32),))
    _assert_step(got, want)


def test_masks_follow_the_top_level_key():
    model = get_text_model("bert").build(4, layers=1)
    m = tloop.head_only_mask(model)
    assert m["head.w"] and m["head.b"] and not m["encoder.word_emb.w"]
    assert sum(m.values()) == 2 and all(tloop.all_trainable_mask(model)
                                        .values())
    vit = tvit.ViT(tvit.ViTConfig(image_size=32, layers=1))
    m = tloop.head_only_mask(vit, port_image.head_keys_for("transformer_B16"))
    assert [k for k, v in m.items() if v] == ["head.w", "head.b"]
    assert port_image.head_keys_for("mb") == ("fc2",)
    assert port_text.head_keys_for("gpt2") == ("score",)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


@pytest.fixture()
def train_tree(tiny_dataset, tmp_path):
    base = tmp_path / "ds"
    os.symlink(tiny_dataset, f"{base}_Train")
    os.symlink(tiny_dataset, f"{base}_Val")
    return str(base)


def _run(main, argv, d, monkeypatch):
    d.mkdir()
    monkeypatch.chdir(d)
    best = main(argv)
    rows = [json.loads(line) for f in glob.glob(str(d / "runs" / "*.jsonl"))
            for line in open(f)]
    return best, sorted(rows, key=lambda r: r["phase"] != "train")


def _assert_rows(got, want):
    assert [r["phase"] for r in got] == [r["phase"] for r in want] == [
        "train", "fine_tune"]
    for g, w in zip(got, want):
        assert abs(g["avg_loss"] - w["avg_loss"]) <= 1e-4, (g, w)
        assert g["val_acc"] == w["val_acc"], (g, w)
        assert g["lr"] == pytest.approx(w["lr"])
        for k in ("grad_norm_mean", "grad_norm_last", "param_global_norm"):
            assert g[k] == pytest.approx(w[k], rel=1e-3), (k, g, w)


def _text_ckpt(path, name="distilbert"):
    import transformers as tf

    torch.manual_seed(7)
    enc = {"distilbert": lambda: tf.DistilBertModel(tf.DistilBertConfig(
               n_layers=N_LAYERS)),
           "bert": lambda: tf.BertModel(tf.BertConfig(
               num_hidden_layers=N_LAYERS)),
           "roberta": lambda: tf.RobertaModel(tf.RobertaConfig(
               vocab_size=50265, max_position_embeddings=514,
               type_vocab_size=1, num_hidden_layers=N_LAYERS, pad_token_id=1,
               layer_norm_eps=1e-12))}[name]()
    head = torch.nn.Linear(768, 4)
    sd = {"model." + k: v for k, v in enc.state_dict().items()}
    sd["out.weight"], sd["out.bias"] = head.weight.detach(), head.bias.detach()
    torch.save(sd, path)
    return str(path)


def _text_argv(base, name="distilbert"):
    vocab = os.path.join(VOCABS, "bpe" if name == "roberta" else "wordpiece")
    return [f"--dataset_folder_name={base}", f"--text_model={name}",
            "--epochs=1", "--ft_epochs=1", "--batch_size=4",
            "--batch_size_FT=4", "--acc_steps=2", "--acc_steps_FT=2",
            "--opt=sgd", "--lr=0.01", "--reg=0.03", "--fraction_lr=3",
            "--balance_weights", "--label_smoothing=0.1", "--seq_len=16",
            "--data_workers=2", f"--vocab_dir={vocab}"]


def test_main_text_matches_jax_cli(train_tree, tmp_path, monkeypatch):
    from garbage_classification_rca_tpu.checkpoint.torch_convert import (
        load_torch_state_dict)
    from garbage_classification_rca_tpu.cli import main_text as jax_cli

    ckpt = _text_ckpt(tmp_path / "distilbert_cls.pth")
    monkeypatch.setattr(jdistil, "LAYERS", N_LAYERS)
    # the JAX trainer starts from its own init and drops the pooled feature
    # at 0.6: give it the checkpoint's tree and no head dropout
    monkeypatch.setattr(jdistil, "init", lambda key, num_classes=4, **kw: (
        jdistil.convert_torch(load_torch_state_dict(ckpt), num_classes)))
    monkeypatch.setattr(jdistil, "apply", functools.partial(
        jdistil.apply, drop_ratio=0.0))
    _, want = _run(jax_cli.main, _text_argv(train_tree), tmp_path / "jax",
                   monkeypatch)
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    monkeypatch.setattr(port_text, "train_forward", lambda m, flag: (
        functools.partial(m, drop_ratio=0.0, hf_internal_dropout=flag)))
    best, got = _run(port_text.main, _text_argv(train_tree)
                     + [f"--model_path={ckpt}"], tmp_path / "port",
                     monkeypatch)
    _assert_rows(got, want)
    assert os.path.isfile(best.best_path)
    acc = port_test_text.main([
        "--text_model=distilbert", f"--model_path={best.best_path}",
        f"--dataset_folder_name={train_tree}_Val", "--seq_len=16",
        f"--vocab_dir={os.path.join(VOCABS, 'wordpiece')}",
        "--compute_dtype=float32", "--eval_batch_size=8"])
    assert acc == pytest.approx(best.best_val_acc)


@pytest.mark.parametrize("name", ["bert", "roberta"])
@pytest.mark.parametrize("flag", [[], ["--hf_internal_dropout"]],
                         ids=["plain", "hf_internal_dropout"])
def test_main_text_runs_bert_and_roberta(name, flag, train_tree, tmp_path,
                                         monkeypatch):
    """From a reference-layout .pth, all trainable in phase 1 (--no-tl),
    with and without the internal dropout; the BEST file loads in
    ``cli.test_text``."""
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    ckpt = _text_ckpt(tmp_path / f"{name}.pth", name)
    argv = _text_argv(train_tree, name) + [f"--model_path={ckpt}", "--no-tl",
                                           "--ft_epochs=0"] + flag
    best, rows = _run(port_text.main, argv, tmp_path / "run", monkeypatch)
    assert [r["phase"] for r in rows] == ["train"]
    assert np.isfinite(rows[0]["avg_loss"]) and rows[0]["grad_norm_mean"] > 0
    payload = torch.load(best.best_path, weights_only=True)
    assert payload["meta"]["layers"] == N_LAYERS
    vocab = os.path.join(VOCABS, "bpe" if name == "roberta" else "wordpiece")
    acc = port_test_text.evaluate(port_test_text.args_parser([
        f"--text_model={name}", f"--model_path={best.best_path}",
        f"--dataset_folder_name={train_tree}_Val", "--seq_len=16",
        f"--vocab_dir={vocab}", "--compute_dtype=float32"]))[0]
    assert acc == pytest.approx(best.best_val_acc)


def test_main_text_internal_dropout_changes_the_loss(train_tree, tmp_path,
                                                     monkeypatch):
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    ckpt = _text_ckpt(tmp_path / "d.pth")
    argv = _text_argv(train_tree) + [f"--model_path={ckpt}", "--ft_epochs=0",
                                     "--use_synonyms", "--prob_aug_text=1.0"]
    _, off = _run(port_text.main, argv, tmp_path / "off", monkeypatch)
    _, off2 = _run(port_text.main, argv, tmp_path / "off2", monkeypatch)
    best, on = _run(port_text.main, argv + ["--hf_internal_dropout"],
                    tmp_path / "on", monkeypatch)
    assert off[0]["avg_loss"] == off2[0]["avg_loss"]      # same seed
    assert on[0]["avg_loss"] != off[0]["avg_loss"]
    assert np.isfinite(on[0]["avg_loss"]) and on[0]["param_global_norm"] > 0
    assert 0.0 <= best.best_val_acc <= 100.0


def _vit_ckpt(path, name):
    cfg = tvit.CONFIGS[name]
    torch.manual_seed(5)
    ref = VisionTransformerRef(image_size=224, d=cfg.hidden, heads=cfg.heads,
                               mlp=cfg.mlp, layers=N_LAYERS)
    with torch.no_grad():
        ref.class_token.normal_(0.0, 0.02)
    torch.save(ref.state_dict(), path)
    return str(path)


def _image_argv(base, name, ckpt):
    return [f"--dataset_folder_name={base}", f"--image_model={name}",
            "--epochs=1", "--ft_epochs=1", "--batch_size=4",
            "--batch_size_FT=4", "--acc_steps=2", "--acc_steps_FT=2",
            "--opt=sgd", "--lr=0.01", "--reg=0.03", "--fraction_lr=3",
            "--balance_weights", "--prob_aug=0.0", "--compute_dtype=float32",
            "--data_workers=2", f"--model_path={ckpt}"]


def _small_vit(monkeypatch, name):
    kw = dict(layers=N_LAYERS)
    monkeypatch.setitem(jvit.CONFIGS, name,
                        dataclasses.replace(jvit.CONFIGS[name], **kw))
    monkeypatch.setitem(tvit.CONFIGS, name,
                        dataclasses.replace(tvit.CONFIGS[name], **kw))


def test_main_image_matches_jax_cli(train_tree, tmp_path, monkeypatch):
    from garbage_classification_rca_tpu import native
    from garbage_classification_rca_tpu.cli import main_image as jax_cli

    # the JAX batcher on its PIL + cv2 route, the one the port copies
    monkeypatch.setattr(native, "pad_resize_batch", lambda *a, **k: None)
    monkeypatch.setattr(native, "decode_enabled", lambda: False)
    name = "transformer_B16"
    _small_vit(monkeypatch, name)
    ckpt = _vit_ckpt(tmp_path / "vit.pth", name)
    argv = _image_argv(train_tree, name, ckpt)
    _, want = _run(jax_cli.main, argv, tmp_path / "jax", monkeypatch)
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    best, got = _run(port_image.main, argv, tmp_path / "port", monkeypatch)
    _assert_rows(got, want)
    acc = port_test_image.main([
        f"--image_model={name}", f"--model_path={best.best_path}",
        f"--dataset_folder_name={train_tree}_Val", "--compute_dtype=float32",
        "--eval_batch_size=8", "--data_workers=2"])
    assert acc == pytest.approx(best.best_val_acc)


def test_main_image_runs_vit_l16_with_augmentation(train_tree, tmp_path,
                                                   monkeypatch):
    """ViT-L/16 widths, bf16 images over fp32 masters, augmentation on."""
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    name = "transformer_L16"
    _small_vit(monkeypatch, name)
    ckpt = _vit_ckpt(tmp_path / "vit_l.pth", name)
    argv = [a for a in _image_argv(train_tree, name, ckpt)
            if not a.startswith(("--prob_aug", "--compute_dtype",
                                 "--ft_epochs"))]
    best, rows = _run(port_image.main, argv + ["--prob_aug=1.0",
                                               "--ft_epochs=0"],
                      tmp_path / "run", monkeypatch)
    assert [r["phase"] for r in rows] == ["train"]
    assert np.isfinite(rows[0]["avg_loss"])
    sd = torch.load(best.best_path, weights_only=True)["state_dict"]
    assert sd["layers.1.qkv.w"].dtype == torch.float32    # fp32 masters
    assert tuple(sd["layers.1.qkv.w"].shape) == (3 * 1024, 1024)


def test_main_both_runs_with_internal_dropout(tmp_path, monkeypatch):
    from tests.test_torch_train_cli import STAGES, _tree

    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    monkeypatch.setenv("GC_RCA_MM_IMAGE_SIZE", "64")
    tcfg = teffv2.CONFIGS["eff_v2_medium"]
    monkeypatch.setitem(teffv2.CONFIGS, "eff_v2_medium", dataclasses.replace(
        tcfg, stages=STAGES))
    base = tmp_path / "garbage"
    _tree(base, np.random.default_rng(1))
    argv = [f"--dataset_folder_name={base}", "--late_fusion=MM_RCA",
            "--reverse", "--epochs=1", "--ft_epochs=0", "--batch_size=4",
            "--acc_steps=2", "--seq_len=16", "--data_workers=2",
            f"--vocab_dir={os.path.join(VOCABS, 'wordpiece')}",
            "--image_text_dropout=0.0"]
    _, off = _run(port_both.main, argv, tmp_path / "off", monkeypatch)
    best, on = _run(port_both.main, argv + ["--hf_internal_dropout"],
                    tmp_path / "on", monkeypatch)
    assert np.isfinite(on[0]["avg_loss"])
    assert on[0]["avg_loss"] != off[0]["avg_loss"]
    assert os.path.isfile(best.best_path)


def test_main_image_refuses_the_text_flag(monkeypatch):
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    with pytest.raises(SystemExit, match="no effect on image-only training"):
        port_image.main(["--image_model=transformer_B16",
                         "--hf_internal_dropout"])


@pytest.mark.parametrize("main,flags,exc,match", [
    (port_text.main, ["--wandb"], NotImplementedError, "wandb"),
    (port_text.main, ["--fsdp"], NotImplementedError, "fsdp"),
    (port_text.main, ["--mesh_shape=data:2"], NotImplementedError,
     "mesh_shape"),
    (port_text.main, ["--text_model=nope"], SystemExit, "1"),
    (port_text.main, ["--opt=rmsprop"], SystemExit, "1"),
    (port_image.main, ["--image_model=transformer_B16", "--wandb"],
     NotImplementedError, "wandb"),
    (port_image.main, ["--image_model=transformer_B16",
                       "--calculate_dataset_stats"], NotImplementedError,
     "calculate_mean_std"),
    (port_image.main, ["--image_model=nope"], SystemExit, "1"),
    (port_image.main, ["--opt=rmsprop"], SystemExit, "1"),
])
def test_unported_flags_and_clean_exits(monkeypatch, main, flags, exc, match):
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    with pytest.raises(exc, match=match):
        main(["--dataset_folder_name=x"] + flags)


def test_llm_backend_raises_and_trainers_need_cuda(train_tree, monkeypatch):
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    monkeypatch.setenv("GC_RCA_LLM_PATH", "/nonexistent/llama")
    # a missing model directory raises, as from_pretrained does in the
    # JAX package
    with pytest.raises(FileNotFoundError, match="/nonexistent/llama"):
        port_text.main(_text_argv(train_tree) + ["--use_synonyms"])
    monkeypatch.delenv("GC_RCA_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (port_text.main, port_image.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--dataset_folder_name=x",
                  "--image_model=transformer_B16"])
