"""PyTorch port, the model axis through the five BLIP-2 CLIs and
``cli.serve``, and the seq axis through ``cli.test_text``, over two gloo
ranks on the CPU (``GC_RCA_TINY_BLIP2=1``, fp32, the ``tiny_dataset``
fixture), each held to the one-process port run and to the JAX CLI at the
same flags:

  * ``cli.blip2_test --mesh_shape=data:1,model:2``, the 1-token path and
    ``--max_new_tokens=4``: the report CSV byte-identical;
  * ``cli.qformer_test`` the same (JAX ``tests/test_blip2_cli.py``);
  * ``cli.serve``: the response lines equal (matched by id);
  * one epoch of ``cli.blip2_train`` at ``data:1,model:2``: the logged
    loss within 1e-5 of one process's and of the JAX step functions' over
    the same windows, and its BEST file evaluates (``cli.blip2_test``) to
    the one-process BEST file's report CSV; ``cli.qformer_train`` at
    ``model:2``: the logged loss within 1e-5;
  * ``cli.test_text --text_model=distilbert --mesh_shape=seq:2``: the CSV
    byte-identical;
  * every rank gets the whole result; the expert axis, and the pipe axis
    outside ``cli.blip2_train`` / ``cli.blip2_test``, still raise, naming
    ROADMAP item 7, and ``cli.serve`` refuses a data axis.

One ``multihost.launch`` runs every two-rank CLI.
"""

import glob
import io
import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_multihost import VOCAB, launch_script
from tests.test_torch_serve_cli import blip_pth  # noqa: F401 — fixture

torch.set_num_threads(2)

BPE = os.path.join(VOCAB, "bpe")
TP = "--mesh_shape=data:1,model:2"
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _tiny(monkeypatch):
    monkeypatch.setenv("GC_RCA_TINY_BLIP2", "1")
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    for flag in ("GC_RCA_FUSED_ATTN", "GC_RCA_FLASH_BWD", "GC_RCA_MULTIHOST"):
        monkeypatch.delenv(flag, raising=False)


def _requests(tiny_dataset):
    imgs = sorted(glob.glob(os.path.join(str(tiny_dataset), "*", "*.jpg")))
    reqs = [{"id": f"t{i}", "text": t, "max_new": n} for i, (t, n) in
            enumerate([("Question: which bin? Answer:", 5),
                       ("hello world", 2), ("a battery pack", 4)])]
    reqs += [{"id": f"i{i}", "text": "Question: which bin? Answer:",
              "image": p, "max_new": 3 + i} for i, p in enumerate(imgs[:2])]
    return "\n".join(json.dumps(r) for r in reqs) + "\n"


@pytest.fixture(scope="module")
def text_ckpt(tmp_path_factory):
    """A reference-layout DistilBERT classifier .pth, 2 layers."""
    import transformers as tf

    torch.manual_seed(7)
    enc = tf.DistilBertModel(tf.DistilBertConfig(n_layers=2)).eval()
    head = torch.nn.Linear(768, 4)
    sd = {"model." + k: v for k, v in enc.state_dict().items()}
    sd["out.weight"], sd["out.bias"] = head.weight.detach(), \
        head.bias.detach()
    path = tmp_path_factory.mktemp("text_ckpt") / "distilbert_cls.pth"
    torch.save(sd, path)
    return str(path)


@pytest.fixture(scope="module")
def clf_pth(tmp_path_factory):
    """A reference ``MultimodalClassifier`` .pth for the tiny Q-Former."""
    from garbage_classification_rca_tpu_torch.cli.blip2_common import (
        tiny_blip2_config)

    hidden = tiny_blip2_config().qformer.hidden
    torch.manual_seed(0)
    lin = torch.nn.Linear(hidden, 4)
    path = tmp_path_factory.mktemp("clf") / "Classifier_epoch_1_acc_0.5.pth"
    torch.save({"classifier.weight": lin.weight.detach(),
                "classifier.bias": lin.bias.detach()}, path)
    return str(path)


def cli_argv(tiny_dataset, blip, clf, text, tree):
    """{run: (cli, argv without the mesh, mesh flag)}."""
    vlm = [f"--dataset_folder_name={tiny_dataset}", f"--vocab_dir={BPE}",
           f"--model_path={blip}", "--compute_dtype=float32",
           "--eval_batch_size=4", "--data_workers=2"]
    train = [f"--dataset_folder_name={tree}", f"--vocab_dir={BPE}",
             f"--model_path={blip}", "--batch_size=2", "--epochs=1",
             "--compute_dtype=float32", "--data_workers=2"]
    return {
        "blip2_test": ("blip2_test", vlm, TP),
        "blip2_generate": ("blip2_test", vlm + ["--max_new_tokens=4"], TP),
        "qformer_test": ("qformer_test", vlm + [
            f"--classifier_weights={clf}"], TP),
        "serve": ("serve", [f"--model_path={blip}", f"--vocab_dir={BPE}",
                            "--compute_dtype=float32", "--max_prompt=16",
                            "--max_new_tokens=5", "--serve_slots=2",
                            "--steps_per_sync=2"], TP),
        "blip2_train": ("blip2_train", train, TP),
        "qformer_train": ("qformer_train", train, "--mesh_shape=model:2"),
        "test_text": ("test_text", [
            "--text_model=distilbert", f"--model_path={text}",
            f"--dataset_folder_name={tiny_dataset}",
            f"--vocab_dir={VOCAB}/wordpiece", "--compute_dtype=float32",
            "--eval_batch_size=8", "--data_workers=2"],
            "--mesh_shape=seq:2"),
    }


WORKER = """
    import importlib, io, json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)

    spec = torch.load(sys.argv[1], weights_only=False)
    rank = os.environ["RANK"]
    root = os.getcwd()
    pkg = "garbage_classification_rca_tpu_torch.cli."
    for name, (cli, argv, mesh) in spec["runs"].items():
        mod = importlib.import_module(pkg + cli)
        os.makedirs(name, exist_ok=True)
        os.chdir(name)
        if cli == "serve":
            out = io.StringIO()
            stdin = io.StringIO(spec["requests"] if rank == "0" else "")
            mod.main(argv + [mesh], stdin=stdin, stdout=out)
            with open(f"lines_rank{rank}.json", "w") as f:
                json.dump(out.getvalue().splitlines(), f)
        elif hasattr(mod, "evaluate"):
            evaluate = mod.evaluate

            def keep(args, evaluate=evaluate):
                out = evaluate(args)
                np.savez(f"rank{rank}.npz", acc=out[0], labels=out[1],
                         preds=out[2])
                return out

            mod.evaluate = keep
            mod.main(argv + [mesh])
        else:
            mod.main(argv + [mesh])
        os.chdir(root)
    # what still raises, or is refused, over two ranks
    from garbage_classification_rca_tpu_torch.cli import serve
    try:
        serve.main(spec["runs"]["serve"][1] + ["--mesh_shape=data:2"],
                   stdin=io.StringIO(""), stdout=io.StringIO())
        sys.exit(5)
    except NotImplementedError as e:
        with open(f"serve_data_rank{rank}.txt", "w") as f:
            f.write(str(e))
"""


@pytest.fixture(scope="module")
def tree(tiny_dataset, tmp_path_factory):
    base = tmp_path_factory.mktemp("train_tree") / "ds"
    os.symlink(tiny_dataset, f"{base}_Train")
    os.symlink(tiny_dataset, f"{base}_Val")
    return str(base)


@pytest.fixture(scope="module")
def runs(tiny_dataset, blip_pth, clf_pth, text_ckpt,  # noqa: F811
         tree, tmp_path_factory):
    """The one two-rank launch: every CLI of ``cli_argv`` with its mesh,
    each in its own directory. Returns (the directory, the argv)."""
    d = tmp_path_factory.mktemp("tp_cli")
    argv = cli_argv(tiny_dataset, blip_pth, clf_pth, text_ckpt, tree)
    spec = d / "spec.pt"
    torch.save({"runs": argv, "requests": _requests(tiny_dataset)}, spec)
    env_keep = {k: os.environ.get(k) for k in ("GC_RCA_TINY_BLIP2",)}
    os.environ["GC_RCA_TINY_BLIP2"] = "1"
    try:
        launch_script(d, WORKER, [spec], nproc=2)
    finally:
        for k, v in env_keep.items():
            if v is None:
                os.environ.pop(k, None)
    return d, argv


def _csv(root):
    csvs = glob.glob(os.path.join(str(root), "**", "*.csv"), recursive=True)
    assert len(csvs) == 1, csvs
    with open(csvs[0], "rb") as f:
        return os.path.basename(csvs[0]), f.read()


def _in(d, fn, *a, **k):
    cwd = os.getcwd()
    os.makedirs(d, exist_ok=True)
    os.chdir(d)
    try:
        return fn(*a, **k)
    finally:
        os.chdir(cwd)


def _mod(pkg, cli):
    import importlib

    return importlib.import_module(f"{pkg}.cli.{cli}")


def _port(cli):
    return _mod("garbage_classification_rca_tpu_torch", cli)


def _jax(cli):
    return _mod("garbage_classification_rca_tpu", cli)


def _same_on_ranks(d):
    got = [np.load(os.path.join(d, f"rank{r}.npz")) for r in range(2)]
    for k in ("acc", "labels", "preds"):
        np.testing.assert_array_equal(got[0][k], got[1][k])


@pytest.mark.parametrize("name", ["blip2_test", "blip2_generate",
                                  "qformer_test"])
def test_tp_vlm_eval_reports_match_one_process_and_jax(runs, tmp_path, name):
    d, argv = runs
    cli, flags, mesh = argv[name]
    _same_on_ranks(d / name)
    got = _csv(d / name / "test_set_reports")
    one = _in(tmp_path / "one", _port(cli).main, flags)
    jax_acc = _in(tmp_path / "jax", _jax(cli).main, flags + [mesh])
    assert got == _csv(tmp_path / "one" / "test_set_reports")
    assert got == _csv(tmp_path / "jax" / "test_set_reports")
    assert float(np.load(d / name / "rank0.npz")["acc"]) == one == jax_acc


def test_tp_serve_lines_match_one_process_and_jax(runs, tiny_dataset):
    d, argv = runs
    _, flags, mesh = argv["serve"]
    with open(d / "serve" / "lines_rank0.json") as f:
        got = json.load(f)
    with open(d / "serve" / "lines_rank1.json") as f:
        assert json.load(f) == []                 # rank 0 writes stdout
    raw = _requests(tiny_dataset)
    out = []
    for main, argv_ in ((_port("serve").main, flags),
                        (_jax("serve").main, flags + [mesh])):
        buf = io.StringIO()
        assert main(argv_, stdin=io.StringIO(raw), stdout=buf) == 0
        out.append(sorted(buf.getvalue().splitlines()))
    assert len(got) == 5 and all("tokens" in json.loads(l) for l in got)
    assert sorted(got) == out[0] == out[1]


def _losses(d):
    return [json.loads(line)["avg_loss"]
            for p in sorted(glob.glob(os.path.join(str(d), "runs", "*.jsonl")))
            for line in open(p)]


def test_tp_blip2_train_matches_one_process_and_jax(runs, tmp_path,
                                                    tiny_dataset):
    import jax.numpy as jnp

    from garbage_classification_rca_tpu.cli import blip2_train as jtrain
    from tests.test_torch_vlm_train_cli import _jax_epoch_losses

    d, argv = runs
    _, flags, _ = argv["blip2_train"]
    got = _losses(d / "blip2_train")
    one = _in(tmp_path / "one", _port("blip2_train").main, flags)
    want = _losses(tmp_path / "one")

    def make(cfg, params, lora):
        opt, step = jtrain.make_lora_train_step(cfg, params,
                                                compute_dtype=jnp.float32)
        return lora, opt.init(lora), step

    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got, _jax_epoch_losses(flags, 1, make),
                               rtol=LOSS_RTOL)
    # the BEST files evaluate to the same report
    best = glob.glob(str(d / "blip2_train" / "model_weights" / "*" /
                         "BEST_*"))
    assert len(best) == 1 and one.best_path is not None
    test_flags = argv["blip2_test"][1][:2] + ["--compute_dtype=float32",
                                              "--eval_batch_size=4"]
    for sub, path in (("tp_best", best[0]), ("one_best", one.best_path)):
        _in(tmp_path / sub, _port("blip2_test").main,
            test_flags + [f"--model_path={path}"])
    assert _csv(tmp_path / "tp_best") == _csv(tmp_path / "one_best")


def test_tp_qformer_train_matches_one_process(runs, tmp_path):
    d, argv = runs
    _, flags, _ = argv["qformer_train"]
    got = _losses(d / "qformer_train")
    _in(tmp_path / "one", _port("qformer_train").main, flags)
    want = _losses(tmp_path / "one")
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_sp_test_text_report_matches_one_process_and_jax(runs, tmp_path,
                                                         monkeypatch):
    from garbage_classification_rca_tpu.models.text import distilbert as jdb

    d, argv = runs
    _, flags, mesh = argv["test_text"]
    _same_on_ranks(d / "test_text")
    got = _csv(d / "test_text" / "test_set_reports")
    _in(tmp_path / "one", _port("test_text").main, flags)
    monkeypatch.setattr(jdb, "LAYERS", 2)
    _in(tmp_path / "jax", _jax("test_text").main, flags + [mesh])
    assert got == _csv(tmp_path / "one" / "test_set_reports")
    assert got == _csv(tmp_path / "jax" / "test_set_reports")


def test_serve_refuses_a_data_axis(runs):
    d, _ = runs
    for r in range(2):
        with open(d / f"serve_data_rank{r}.txt") as f:
            assert "only replicates" in f.read()


@pytest.mark.parametrize("cli,mesh", [
    ("blip2_test", "data:1,expert:2"), ("qformer_test", "model:1,pipe:2"),
    ("blip2_train", "data:1,expert:2"), ("qformer_train", "pipe:2"),
    ("serve", "expert:2"), ("test_text", "seq:1,pipe:2"),
    ("test_image", "model:2"), ("main_text", "seq:2")])
def test_pipe_expert_and_foreign_axes_still_raise(cli, mesh, tiny_dataset):
    argv = [f"--dataset_folder_name={tiny_dataset}", "--model_path=x.pth",
            f"--mesh_shape={mesh}"]
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 7"):
        _port(cli).main(argv)
