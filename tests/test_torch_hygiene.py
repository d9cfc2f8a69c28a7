"""PyTorch port, package rules and host copies: the port imports neither
jax nor the JAX package; its entry points raise without CUDA unless the
caller asks for the CPU; its own copies of the host modules (config,
tokenizer, manifest, batcher, normalization, synonymizer) behave exactly
like the JAX package's originals."""

import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu import config as jconfig
from garbage_classification_rca_tpu.data import images as jimages
from garbage_classification_rca_tpu.data import manifest as jmanifest
from garbage_classification_rca_tpu.data import pipeline as jpipeline
from garbage_classification_rca_tpu.data import tokenizer as jtokenizer
from garbage_classification_rca_tpu_torch import config as tconfig
from garbage_classification_rca_tpu_torch import device as tdevice
from garbage_classification_rca_tpu_torch.data import images as timages
from garbage_classification_rca_tpu_torch.data import manifest as tmanifest
from garbage_classification_rca_tpu_torch.data import pipeline as tpipeline
from garbage_classification_rca_tpu_torch.data import tokenizer as ttokenizer
from garbage_classification_rca_tpu_torch.kernels import (mha_fused, rca_fused,
                                                          transformer_block)
from garbage_classification_rca_tpu_torch.models.fusion import multimodal as tmm

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
VOCAB = ROOT / "tests" / "fixtures" / "vocab" / "wordpiece"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
before = set(sys.modules)
import garbage_classification_rca_tpu_torch as pkg
import chip_smoke
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
new = set(sys.modules) - before
bad = sorted(m for m in new if m.split(".")[0] in ("jax", "jaxlib",
             "garbage_classification_rca_tpu"))
print(len(names))
print(bad)
print(sorted(names))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    n, bad, names = out.stdout.strip().splitlines()[-3:]
    assert int(n) >= 30          # every module of the port was imported
    assert bad == "[]", bad
    pkg = "garbage_classification_rca_tpu_torch."
    for mod in ("kernels.transformer_block", "models.text.bert",
                "models.text.roberta", "models.image.vit", "models.registry",
                "cli.test_text", "cli.test_image", "utils.dtype",
                "cli.main_text", "cli.main_image", "data.synonymize",
                "models.text.bart", "models.vlm.prompts",
                "models.vlm.blip2_vision", "models.vlm.qformer",
                "models.vlm.opt", "models.vlm.blip2", "cli.blip2_common",
                "cli.blip2_train", "cli.blip2_test", "cli.qformer_train",
                "cli.qformer_test", "models.text.gpt2",
                "models.text.mobilebert", "models.image.shufflenet_v2",
                "models.image.resnet", "models.image.mobilenet_v3",
                "models.image.convnext", "models.image.efficientnet_common",
                "train.engine", "train.optim", "cli.main_both",
                "nn.core", "ops.sampling", "ops.quant", "serving.engine",
                "cli.serve", "checkpoint.hf_dir", "data.chat_template",
                "data.tokenizer", "models.text.llama", "parallel.mesh",
                "parallel.multihost", "parallel.fsdp", "parallel.tp",
                "parallel.sp"):
        assert f"'{pkg}{mod}'" in names, mod


def test_parallel_package_imports_neither_jax_nor_the_jax_package():
    """``parallel/`` ports the JAX package's ``parallel/`` modules of the
    same names: its sources import torch, never jax or the JAX package,
    not even lazily inside a function."""
    import ast

    files = sorted((ROOT / "garbage_classification_rca_tpu_torch" /
                    "parallel").glob("*.py"))
    assert {f.name for f in files} >= {"__init__.py", "mesh.py",
                                       "multihost.py", "fsdp.py", "tp.py",
                                       "sp.py"}
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib",
                                   "garbage_classification_rca_tpu"), (f, n)


def test_mesh_axis_names_are_the_jax_ones():
    """The port's own copies of the JAX package's axis names."""
    from garbage_classification_rca_tpu.parallel import mesh as jmesh
    from garbage_classification_rca_tpu.parallel import sp as jsp
    from garbage_classification_rca_tpu_torch.parallel import mesh as tmesh
    from garbage_classification_rca_tpu_torch.parallel import sp as tsp
    from garbage_classification_rca_tpu_torch.parallel import tp as ttp

    assert (tmesh.DATA_AXIS, tmesh.MODEL_AXIS, tmesh.SEQ_AXIS) == (
        jmesh.DATA_AXIS, jmesh.MODEL_AXIS, jsp.SEQ_AXIS)
    assert ttp.MODEL_AXIS == jmesh.MODEL_AXIS
    assert tsp.SEQ_AXIS == jsp.SEQ_AXIS


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("GC_RCA_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdevice.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmm.build_fusion_model(tmm.FusionConfig())
    from garbage_classification_rca_tpu_torch.cli import test_both

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        test_both.main(["--late_fusion=MM_RCA", "--model_path=x.pth"])
    from garbage_classification_rca_tpu_torch.cli import test_image, test_text
    from garbage_classification_rca_tpu_torch.models.registry import (
        get_image_model, get_text_model)

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        test_text.main(["--text_model=bert", "--model_path=x.pth"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        test_image.main(["--image_model=transformer_B16",
                         "--model_path=x.pth"])
    from garbage_classification_rca_tpu_torch.cli import (blip2_train,
                                                          qformer_train)

    for trainer in (blip2_train, qformer_train):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trainer.main(["--dataset_folder_name=x"])
    from garbage_classification_rca_tpu_torch.cli import serve

    # the model and seq axes take the same road to the device
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--mesh_shape=data:1,model:1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        test_text.main(["--text_model=distilbert", "--model_path=x.pth",
                        "--mesh_shape=seq:1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_text_model("distilbert").load_tree({"encoder": {"layers": []}})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_image_model("transformer_B16").load_tree({"layers": []})
    assert tdevice.resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_other_devices():
    t = torch.empty(2, 16, 48, device="meta")
    i = torch.empty(2, 16, 80, device="meta")
    p = tmm.FusionModel.__new__(tmm.FusionModel)
    torch.nn.Module.__init__(p)
    from garbage_classification_rca_tpu_torch.ops.attention import (
        AttentionUnit)

    for name, g in zip(rca_fused.UNITS, rca_fused._GEOM):
        setattr(p, name, AttentionUnit(*g).to("meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        rca_fused.rca_fused(p, t, i, reverse=True)
    q = torch.empty(2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        mha_fused.mha(q, q, q, heads=4)
    e = lambda *shape: torch.empty(shape, device="meta")
    attn = (e(64, 192), e(192), e(64, 64), e(64))
    mlp = (e(64, 32), e(32), e(32, 64), e(64))
    for call in (
            lambda: transformer_block.postnorm_attn_block(
                q, None, *attn, e(64), e(64), heads=1),
            lambda: transformer_block.postnorm_mlp_block(q, *mlp, e(64),
                                                         e(64)),
            lambda: transformer_block.attn_block(q, e(64), e(64), *attn,
                                                 heads=1),
            lambda: transformer_block.mlp_block(q, e(64), e(64), *mlp)):
        with pytest.raises(ValueError, match="cpu or cuda"):
            call()
    with pytest.raises(ValueError, match="different devices"):
        transformer_block.mlp_block(torch.zeros(2, 8, 64), e(64), e(64),
                                    *[torch.zeros(t.shape) for t in mlp])


@pytest.mark.parametrize("script", sorted((ROOT / "scripts" / "reference")
                                          .glob("*/*.sh")),
                         ids=lambda s: s.stem)
def test_reference_launcher_flags_parse_like_jax(script):
    flags = [ln.strip().rstrip("\\").strip()
             for ln in script.read_text().splitlines()
             if ln.strip().startswith("--")]
    want = dataclasses.asdict(jconfig.args_parser(flags))
    assert dataclasses.asdict(tconfig.args_parser(flags)) == want


def test_compute_dtype_mapping():
    assert tconfig.torch_compute_dtype("bfloat16") is torch.bfloat16
    assert tconfig.torch_compute_dtype("float32") is torch.float32


def test_arch_tables_and_dtype_policy_match_jax():
    """The port's own copies: the per-arch run tables, the eval CLIs'
    param-dtype policy, the model constants and the registry's names."""
    import types

    import jax.numpy as jnp_

    from garbage_classification_rca_tpu.models import registry as jreg
    from garbage_classification_rca_tpu.models.image import vit as jvit
    from garbage_classification_rca_tpu.models.text import bert as jbert
    from garbage_classification_rca_tpu.models.text import roberta as jrob
    from garbage_classification_rca_tpu.utils import dtype as jdtype
    from garbage_classification_rca_tpu_torch.models import registry as treg
    from garbage_classification_rca_tpu_torch.models.image import vit as tvit
    from garbage_classification_rca_tpu_torch.models.text import bert as tbert
    from garbage_classification_rca_tpu_torch.models.text import (
        roberta as trob)
    from garbage_classification_rca_tpu_torch.utils import dtype as tdtype

    for table in ("TEXT_ARCHS", "IMAGE_ARCHS"):
        want = {k: dataclasses.astuple(v)
                for k, v in getattr(jconfig, table).items()}
        got = {k: dataclasses.astuple(v)
               for k, v in getattr(tconfig, table).items()}
        assert got == want
    same = {jnp_.bfloat16: torch.bfloat16, jnp_.float32: torch.float32}
    for param in ("", "float32", "bfloat16"):
        for default in ("float32", "bfloat16"):
            args = types.SimpleNamespace(param_dtype=param)
            assert tdtype.resolve_param_dtype(args, default) is same[
                jdtype.resolve_param_dtype(args, default)]
    assert set(treg.IMAGE_MODELS) == set(jreg.IMAGE_MODELS)
    assert set(treg.TEXT_MODELS) == set(jreg.TEXT_MODELS)
    assert {k: dataclasses.astuple(v) for k, v in tvit.CONFIGS.items()} == {
        k: dataclasses.astuple(v) for k, v in jvit.CONFIGS.items()}
    for name in ("HIDDEN", "LAYERS", "HEADS", "FFN", "VOCAB", "MAX_POS",
                 "TYPE_VOCAB", "LN_EPS"):
        assert getattr(tbert, name) == getattr(jbert, name), name
    for name in ("HIDDEN", "LAYERS", "VOCAB", "MAX_POS", "PAD_IDX"):
        assert getattr(trob, name) == getattr(jrob, name), name
    import garbage_classification_rca_tpu as jpkg
    import garbage_classification_rca_tpu_torch as tpkg

    assert tpkg.NUM_CLASSES == jpkg.NUM_CLASSES


def test_convert_checked_reports_a_wrong_architecture():
    from garbage_classification_rca_tpu_torch.checkpoint.torch_convert import (
        convert_checked)
    from garbage_classification_rca_tpu_torch.models.registry import (
        get_image_model)

    sd = {"features.0.weight": np.zeros((2, 2), np.float32)}
    with pytest.raises(SystemExit, match="does not match --image_model=x"):
        convert_checked(get_image_model("transformer_B16").convert_torch, sd,
                        "--image_model=x", num_classes=4)


def test_tokenizers_match_jax():
    texts = ["coffee cup", "greasy pizza box with sauce", "", "UNKNOWNWORD!",
             "water bottle " * 40]
    for name in ("distilbert", "bert", "gpt2", "roberta"):
        vocab = VOCAB.parent / "bpe" if name == "roberta" else VOCAB
        tt = ttokenizer.get_tokenizer(name, vocab_dir=str(vocab))
        jt = jtokenizer.get_tokenizer(name, vocab_dir=str(vocab))
        for seq in (16, 64):
            a, b = tt.encode_batch(texts, seq), jt.encode_batch(texts, seq)
            assert np.array_equal(a.input_ids, b.input_ids)
            assert np.array_equal(a.attention_mask, b.attention_mask)


def test_batcher_matches_jax(tiny_dataset, monkeypatch):
    """The port keeps the JAX package's PIL + pad + cv2-resize route (its
    fallback when the optional native library is absent); the JAX side is
    pinned to that route here."""
    from garbage_classification_rca_tpu import native

    monkeypatch.setattr(native, "pad_resize_batch", lambda *a, **k: None)
    monkeypatch.setattr(native, "decode_enabled", lambda: False)
    tm = tmanifest.build_manifest(str(tiny_dataset))
    jm = jmanifest.build_manifest(str(tiny_dataset))
    assert [dataclasses.astuple(s) for s in tm.samples] == \
        [dataclasses.astuple(s) for s in jm.samples]
    tok = ttokenizer.get_tokenizer("distilbert", vocab_dir=str(VOCAB))
    jtok = jtokenizer.get_tokenizer("distilbert", vocab_dir=str(VOCAB))
    tb = tpipeline.ImageTextBatcher(tm, (64, 48), tokenizer=tok, workers=2)
    jb = jpipeline.ImageTextBatcher(jm, (64, 48), tokenizer=jtok, workers=2)
    got = list(tb.iter_batches(5))
    want = list(jb.iter_batches(5))
    tb.close()
    jb.close()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def test_synonymizer_and_synonym_batcher_match_jax(tiny_dataset):
    from garbage_classification_rca_tpu.cli import main_text as jmain_text
    from garbage_classification_rca_tpu.data import synonymize as jsyn
    from garbage_classification_rca_tpu_torch.cli import (
        main_text as tmain_text)
    from garbage_classification_rca_tpu_torch.data import synonymize as tsyn

    assert tsyn.SYNONYMS == jsyn.SYNONYMS and tsyn.MAX_SWAPS == jsyn.MAX_SWAPS
    texts = ["old plastic water bottle with a broken lid", "battery",
             "nothing to swap here", "", "Small GLASS jar and a paper bag"]
    a, b = tsyn.Synonymizer(seed=3), jsyn.Synonymizer(seed=3)
    assert [a.augment(t) for t in texts * 3] == [b.augment(t)
                                                 for t in texts * 3]
    assert tsyn.Synonymizer(llm_fn=str.upper).augment("a cup") == "A CUP"
    # the paraphraser's prompts are copies: the chat the JAX backend
    # renders, read from its tokenizer
    seen = []

    class Tok:
        pad_token = "x"

        def apply_chat_template(self, chat, **kw):
            seen.append(chat)
            raise StopIteration

    class Model:
        def eval(self):
            return self

    with pytest.raises(StopIteration):
        jsyn.make_hf_llm_fn(model=Model(), tokenizer=Tok())(' "tin can" ')
    assert seen == [[{"role": "system", "content": tsyn.system_prompt()},
                     {"role": "user", "content": tsyn.user_prompt("tin can")}]]
    with pytest.raises(FileNotFoundError, match="/some/llama"):
        tsyn.make_hf_llm_fn("/some/llama", device="cpu")
    assert tmain_text.HEAD_KEYS_BY_MODEL == jmain_text.HEAD_KEYS_BY_MODEL
    # the batcher: the gate's draws and the re-tokenized text
    tok = ttokenizer.get_tokenizer("distilbert", vocab_dir=str(VOCAB))
    jtok = jtokenizer.get_tokenizer("distilbert", vocab_dir=str(VOCAB))
    kw = dict(seq_len=16, workers=2, with_images=False, prob=0.6, seed=1)
    tb = tmain_text.SynonymBatcher(
        tmanifest.build_manifest(str(tiny_dataset)), (0, 0), tokenizer=tok,
        synonymizer=tsyn.Synonymizer(seed=1), **kw)
    jb = jmain_text.SynonymBatcher(
        jmanifest.build_manifest(str(tiny_dataset)), (0, 0), tokenizer=jtok,
        synonymizer=jsyn.Synonymizer(seed=1), **kw)
    got = list(tb.iter_batches(5, shuffle=True, seed=2))
    want = list(jb.iter_batches(5, shuffle=True, seed=2))
    plain = list(tpipeline.ImageTextBatcher(
        tb.m, (0, 0), tokenizer=tok, seq_len=16, with_images=False
    ).iter_batches(5, shuffle=True, seed=2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and "image" not in g
        for k in g:
            assert np.array_equal(g[k], w[k]), k
    assert any(not np.array_equal(g["input_ids"], p["input_ids"])
               for g, p in zip(got, plain))        # some word was swapped


def test_normalize_and_to_device_match_jax():
    x = np.random.default_rng(0).integers(0, 256, (2, 8, 8, 3), np.uint8)
    want = np.asarray(jimages.normalize_on_device(jnp.asarray(x)))
    batches = list(tpipeline.to_device(iter([{"image": x}]), "cpu"))
    got = timages.normalize_on_device(batches[0]["image"],
                                      dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert timages.normalize_on_device(
        batches[0]["image"], dtype=torch.bfloat16).dtype == torch.bfloat16


def test_vlm_host_copies_match_jax(tmp_path):
    """The port's own copies of ``models/vlm/prompts.py`` and the CLIP part
    of ``data/images.py``, the BLIP-2 configurations (defaults and the
    tiny test geometry) and the prompt batcher's host arrays."""
    from PIL import Image

    from garbage_classification_rca_tpu.cli import blip2_common as jbc
    from garbage_classification_rca_tpu.models.vlm import blip2 as jblip2
    from garbage_classification_rca_tpu.models.vlm import prompts as jp
    from garbage_classification_rca_tpu_torch.cli import blip2_common as tbc
    from garbage_classification_rca_tpu_torch.models.vlm import (
        blip2 as tblip2)
    from garbage_classification_rca_tpu_torch.models.vlm import prompts as tp

    for name in ("ANSWER_WORDS", "FOLDER_TO_ANSWER", "ANSWER_TO_CLASS_IDX",
                 "PROMPT_TEMPLATE", "MAX_PROMPT_TOKENS"):
        assert getattr(tp, name) == getattr(jp, name), name
    for path in ("/d/blue/water_bottle_12.jpg", "x/ttr/old_phone_11.png"):
        assert tp.prompt_text_from_path(path) == jp.prompt_text_from_path(
            path)
        assert tp.build_prompt(tp.prompt_text_from_path(path)) == \
            jp.build_prompt(jp.prompt_text_from_path(path))
    for text in ("Yel", "Blu", "Gre", "Bla", "Answer: Greenish", "purple",
                 "Answer:  Black label", ""):
        assert tp.find_closest_string(text) == jp.find_closest_string(text)
    assert np.array_equal(timages.CLIP_MEAN, jimages.CLIP_MEAN)
    assert np.array_equal(timages.CLIP_STD, jimages.CLIP_STD)
    rng = np.random.default_rng(0)
    for i, hw in enumerate([(90, 60), (300, 410)]):
        path = tmp_path / f"{i}.jpg"
        Image.fromarray(rng.integers(0, 256, hw + (3,), np.uint8)).save(path)
        got = timages.blip_preprocess_image(str(path))
        assert got.shape == (224, 224, 3) and got.dtype == np.uint8
        assert np.array_equal(got, jimages.blip_preprocess_image(str(path)))
    x = rng.integers(0, 256, (2, 8, 8, 3), np.uint8)
    np.testing.assert_allclose(
        tbc.normalize_clip(torch.from_numpy(x), torch.float32).numpy(),
        np.asarray(jbc.normalize_clip(jnp.asarray(x), jnp.float32)),
        rtol=1e-6, atol=1e-6)
    assert tbc.left_pad([5, 6], 4, 1) == jbc.left_pad([5, 6], 4, 1)
    assert tbc.left_pad(list(range(9)), 4, 1) == jbc.left_pad(
        list(range(9)), 4, 1)
    # every field of the port's configurations (with the train-time
    # dropout rates) equal to the JAX package's
    for t, j in ((tblip2.Blip2Config(), jblip2.Blip2Config()),
                 (tbc.tiny_blip2_config(), jbc.tiny_blip2_config())):
        for part in ("vision", "qformer", "opt"):
            tp, jp_ = getattr(t, part), getattr(j, part)
            for f in dataclasses.fields(tp):
                assert getattr(tp, f.name) == getattr(jp_, f.name), f.name
            assert {f.name for f in dataclasses.fields(tp)} == {
                f.name for f in dataclasses.fields(jp_)}, part
        assert (t.lora_r, t.lora_alpha, t.lora_scale, t.lora_dropout) == (
            j.lora_r, j.lora_alpha, j.lora_scale, j.lora_dropout)


def test_blip2_batcher_matches_jax(tiny_dataset):
    from garbage_classification_rca_tpu.cli import blip2_common as jbc
    from garbage_classification_rca_tpu.cli import blip2_train as jtrain
    from garbage_classification_rca_tpu_torch.cli import blip2_common as tbc
    from garbage_classification_rca_tpu_torch.cli import blip2_train as ttrain

    bpe = str(VOCAB.parent / "bpe")
    tm = tmanifest.build_manifest(str(tiny_dataset))
    jm = jmanifest.build_manifest(str(tiny_dataset))
    tb = tbc.Blip2Batcher(tm, ttokenizer.get_tokenizer("opt", vocab_dir=bpe),
                          workers=2)
    jb = jbc.Blip2Batcher(jm, jtokenizer.get_tokenizer("opt", vocab_dir=bpe),
                          workers=2)
    got, want = list(tb.iter_batches(5)), list(jb.iter_batches(5))
    assert np.array_equal(ttrain.answer_first_token_table(tb, tm.classes),
                          jtrain.answer_first_token_table(jb, jm.classes))
    tb.close()
    jb.close()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def test_vlm_train_windows_and_constants_match_jax(tiny_dataset):
    """The trainers' host side: the shuffled windows of ``acc_steps``
    microbatches (a trailing partial one) of ``iter_accum_windows`` with
    every batch key, the recipes' constants and the Q-Former's dropout
    rates."""
    from garbage_classification_rca_tpu.cli import blip2_common as jbc
    from garbage_classification_rca_tpu.cli import blip2_train as jtrain
    from garbage_classification_rca_tpu.cli import qformer_train as jqtrain
    from garbage_classification_rca_tpu.models.vlm import qformer as jqf
    from garbage_classification_rca_tpu_torch.cli import blip2_common as tbc
    from garbage_classification_rca_tpu_torch.cli import blip2_train as ttrain
    from garbage_classification_rca_tpu_torch.cli import (
        qformer_train as tqtrain)
    from garbage_classification_rca_tpu_torch.models.vlm import qformer as tqf

    bpe = str(VOCAB.parent / "bpe")
    tb = tbc.Blip2Batcher(tmanifest.build_manifest(str(tiny_dataset)),
                          ttokenizer.get_tokenizer("opt", vocab_dir=bpe),
                          workers=2)
    jb = jbc.Blip2Batcher(jmanifest.build_manifest(str(tiny_dataset)),
                          jtokenizer.get_tokenizer("opt", vocab_dir=bpe),
                          workers=2)
    got = list(tbc.iter_accum_windows(tb, 2, 4, shuffle=True, seed=3))
    want = list(jbc.iter_accum_windows(jb, 2, 4, shuffle=True, seed=3))
    tb.close()
    jb.close()
    assert [w["valid"].shape[0] for w in got] == [4, 2]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g) == jbc.BATCH_KEYS
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    assert (ttrain.BLIP2_LR, ttrain.BLIP2_ACC, tqtrain.QF_ACC) == (
        jtrain.BLIP2_LR, jtrain.BLIP2_ACC, jqtrain.QF_ACC)
    for mod in (ttrain, tqtrain):
        assert (mod.TRAIN_SUFFIX, mod.VAL_SUFFIX) == ("_Train", "_Val")
    assert (tqf.HIDDEN_DROPOUT, tqf.ATTN_DROPOUT) == (jqf.HIDDEN_DROPOUT,
                                                      jqf.ATTN_DROPOUT)


def test_sampler_config_copy_is_the_jax_one():
    """The port's frozen ``ops/sampling.SamplerConfig`` is a copy of the
    JAX package's: the same fields and defaults, frozen, GREEDY its
    default."""
    from garbage_classification_rca_tpu.ops import sampling as jsmp
    from garbage_classification_rca_tpu_torch.ops import sampling as tsmp

    assert [(f.name, f.default) for f in dataclasses.fields(
        tsmp.SamplerConfig)] == [(f.name, f.default) for f in
                                 dataclasses.fields(jsmp.SamplerConfig)]
    assert tsmp.GREEDY == tsmp.SamplerConfig()
    assert dataclasses.astuple(tsmp.GREEDY) == dataclasses.astuple(
        jsmp.GREEDY)
    with pytest.raises(dataclasses.FrozenInstanceError):
        tsmp.GREEDY.temperature = 1.0
