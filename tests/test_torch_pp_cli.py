"""PyTorch port, the pipe axis through ``cli.blip2_test`` and
``cli.blip2_train`` (GPipe of the OPT decoder, ``parallel/pp.py``) over
gloo ranks on the CPU (``GC_RCA_TINY_BLIP2=1``, fp32, the
``tiny_dataset`` fixture, a tiny peft-wrapped HF checkpoint), each held
to the one-process port run and to the JAX CLI at the same flags:

  * ``cli.blip2_test --mesh_shape=pipe:2`` at 1 token and at
    ``--max_new_tokens=3`` (and at ``data:2,pipe:2`` over four ranks):
    the report CSV byte-identical, every rank with the whole result (JAX
    ``tests/test_blip2_cli.py::test_blip2_cli_pipe_mesh_same_report``);
  * two epochs of ``cli.blip2_train --mesh_shape=pipe:2`` (one at
    ``data:2,pipe:2``): the logged losses within rtol 1e-4 of one
    process's and of the JAX CLI's (JAX
    ``test_blip2_train_pp_matches_dp``); its BEST file holds every
    layer's adapters and ``cli.blip2_test`` in one process reads it to
    the one-process BEST file's report;
  * one epoch, then ``--resume_from`` to the second: the RESUME file
    equals the straight run's bit for bit (each stage's adapters and
    AdamW state); a pipe RESUME on a data mesh, a data RESUME on a pipe
    mesh and another pipe size exit with the JAX trainer's words;
  * the guards, before any rank starts, with the JAX CLIs' words:
    ``--hf_internal_dropout``, ``--gen_temperature`` and
    ``--int8_weights`` on a pipe mesh, a model axis beside it, a pipe
    size that does not divide the decoder, a launch across hosts.

One ``multihost.launch`` runs the two-rank runs, one the four-rank ones.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_multihost import VOCAB, launch_script
from tests.test_torch_serve_cli import blip_pth  # noqa: F401 — fixture

torch.set_num_threads(2)

BPE = os.path.join(VOCAB, "bpe")
PIPE, DP_PIPE = "--mesh_shape=pipe:2", "--mesh_shape=data:2,pipe:2"
LOSS_RTOL = 1e-4                  # JAX tests/test_blip2_cli.py, pp vs dp


@pytest.fixture(autouse=True)
def _tiny(monkeypatch):
    monkeypatch.setenv("GC_RCA_TINY_BLIP2", "1")
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    for flag in ("GC_RCA_FUSED_ATTN", "GC_RCA_FLASH_BWD", "GC_RCA_MULTIHOST"):
        monkeypatch.delenv(flag, raising=False)


@pytest.fixture(scope="module")
def tree(tiny_dataset, tmp_path_factory):
    base = tmp_path_factory.mktemp("train_tree") / "ds"
    os.symlink(tiny_dataset, f"{base}_Train")
    os.symlink(tiny_dataset, f"{base}_Val")
    return str(base)


def flags(tiny_dataset, blip, tree):
    """(eval flags, train flags) without the mesh."""
    ev = [f"--dataset_folder_name={tiny_dataset}", f"--vocab_dir={BPE}",
          f"--model_path={blip}", "--compute_dtype=float32",
          "--eval_batch_size=4", "--data_workers=2"]
    train = [f"--dataset_folder_name={tree}", f"--vocab_dir={BPE}",
             f"--model_path={blip}", "--batch_size=2",
             "--compute_dtype=float32", "--data_workers=2"]
    return ev, train


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


def _csv(root):
    csvs = glob.glob(os.path.join(str(root), "**", "*.csv"), recursive=True)
    assert len(csvs) == 1, csvs
    with open(csvs[0], "rb") as f:
        return os.path.basename(csvs[0]), f.read()


def _losses(d):
    return [json.loads(line)["avg_loss"]
            for p in sorted(glob.glob(os.path.join(str(d), "runs", "*.jsonl")))
            for line in open(p)]


def _resume(d):
    return os.path.join(str(d), "model_weights", "blip2_lora", "RESUME")


WORKER = """
    import importlib, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)

    spec = torch.load(sys.argv[1], weights_only=False)
    rank = os.environ["RANK"]
    root = os.getcwd()
    pkg = "garbage_classification_rca_tpu_torch.cli."
    for name, cli, argv, refused in spec["runs"]:
        mod = importlib.import_module(pkg + cli)
        os.makedirs(name, exist_ok=True)
        os.chdir(name)
        if hasattr(mod, "evaluate"):
            evaluate = mod.evaluate

            def keep(args, evaluate=evaluate):
                out = evaluate(args)
                np.savez(f"rank{rank}.npz", acc=out[0], labels=out[1],
                         preds=out[2])
                return out

            mod.evaluate = keep
        try:
            mod.main(argv)
            assert not refused, name
        except SystemExit as e:
            if not refused:
                raise
            with open(f"refused_rank{rank}.txt", "w") as f:
                f.write(str(e))
        finally:
            if hasattr(mod, "evaluate"):
                mod.evaluate = evaluate
        os.chdir(root)
"""


def _launch(d, runs, nproc):
    torch.save({"runs": runs}, d / "spec.pt")
    keep = os.environ.get("GC_RCA_TINY_BLIP2")
    os.environ["GC_RCA_TINY_BLIP2"] = "1"
    try:
        launch_script(d, WORKER, [d / "spec.pt"], nproc=nproc)
    finally:
        if keep is None:
            os.environ.pop("GC_RCA_TINY_BLIP2", None)


@pytest.fixture(scope="module")
def runs(tiny_dataset, blip_pth, tree, tmp_path_factory):  # noqa: F811
    """The one-process port runs (eval, generate, two epochs of training
    whose RESUME the ranks are refused), then the two-rank launch and the
    four-rank one. Returns (one-process dir, pipe:2 dir, data:2,pipe:2
    dir, flags)."""
    os.environ["GC_RCA_TINY_BLIP2"] = "1"
    os.environ["GC_RCA_PLATFORM"] = "cpu"
    ev, train = flags(tiny_dataset, blip_pth, tree)
    one = tmp_path_factory.mktemp("one")
    _in(one / "test1", _port("blip2_test").main, ev)
    _in(one / "gen", _port("blip2_test").main, ev + ["--max_new_tokens=3"])
    _in(one / "train", _port("blip2_train").main, train + ["--epochs=2"])
    two = tmp_path_factory.mktemp("pipe2")
    straight = two / "train"
    _launch(two, [
        ("test1", "blip2_test", ev + [PIPE], False),
        ("gen", "blip2_test", ev + ["--max_new_tokens=3", PIPE], False),
        ("train", "blip2_train", train + ["--epochs=2", PIPE], False),
        ("resumed", "blip2_train", train + ["--epochs=1", PIPE], False),
        ("resumed", "blip2_train", train + [
            "--epochs=2", PIPE, f"--resume_from={_resume(two / 'resumed')}"],
         False),
        ("pipe_on_data", "blip2_train", train + [
            "--epochs=2", "--mesh_shape=data:2",
            f"--resume_from={_resume(straight)}"], True),
        ("data_on_pipe", "blip2_train", train + [
            "--epochs=3", PIPE, f"--resume_from={_resume(one / 'train')}"],
         True)], 2)
    four = tmp_path_factory.mktemp("data2pipe2")
    _launch(four, [
        ("test1", "blip2_test", ev + [DP_PIPE], False),
        ("gen", "blip2_test", ev + ["--max_new_tokens=3", DP_PIPE], False),
        ("train", "blip2_train", train + ["--epochs=1", DP_PIPE], False)], 4)
    return one, two, four, (ev, train)


@pytest.fixture(scope="module")
def jax_reports(runs, tmp_path_factory):
    """The JAX CLI's reports at ``data:2,pipe:2`` (its pipe meshes give
    the data mesh's report: JAX tests/test_blip2_cli.py), by run name."""
    ev = runs[3][0]
    out = {}
    for name, extra in (("test1", []), ("gen", ["--max_new_tokens=3"])):
        d = tmp_path_factory.mktemp("jax_" + name)
        _in(d, _mod("garbage_classification_rca_tpu", "blip2_test").main,
            ev + extra + [DP_PIPE])
        out[name] = _csv(d / "test_set_reports")
    return out


@pytest.mark.parametrize("mesh", ["pipe:2", "data:2,pipe:2"])
@pytest.mark.parametrize("name", ["test1", "gen"])
def test_pp_blip2_test_report_matches_one_process_and_jax(runs, jax_reports,
                                                         name, mesh):
    one, two, four, _ = runs
    d = (two if mesh == "pipe:2" else four) / name
    n = 2 if mesh == "pipe:2" else 4
    got = [np.load(d / f"rank{r}.npz") for r in range(n)]
    for g in got[1:]:
        for k in ("acc", "labels", "preds"):
            np.testing.assert_array_equal(g[k], got[0][k])
    report = _csv(d / "test_set_reports")
    assert report == _csv(one / name / "test_set_reports")
    assert report == jax_reports[name]


def test_pp_blip2_train_matches_one_process_and_jax(runs, tmp_path):
    from garbage_classification_rca_tpu_torch.train.engine import (
        load_checkpoint)

    one, two, four, (ev, train) = runs
    got, want = _losses(two / "train"), _losses(one / "train")
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(_losses(four / "train"), want[:1],
                               rtol=LOSS_RTOL)
    _in(tmp_path / "jax", _mod("garbage_classification_rca_tpu",
                               "blip2_train").main,
        train + ["--epochs=2", PIPE])
    np.testing.assert_allclose(got, _losses(tmp_path / "jax"),
                               rtol=LOSS_RTOL)
    # the BEST file: every layer's adapters, read in one process
    best = glob.glob(str(two / "train" / "model_weights" / "*" / "BEST_*"))
    one_best = glob.glob(str(one / "train" / "model_weights" / "*" /
                             "BEST_*"))
    assert len(best) == len(one_best) == 1
    sd = load_checkpoint(best[0])["state_dict"]
    assert set(sd) == set(load_checkpoint(one_best[0])["state_dict"]) == {
        f"{i}.{p}.{ab}" for i in range(2) for p in ("q", "k")
        for ab in ("a", "b")}
    for sub, path in (("pipe_best", best[0]), ("one_best", one_best[0])):
        _in(tmp_path / sub, _port("blip2_test").main,
            ev[:2] + ["--compute_dtype=float32", "--eval_batch_size=4",
                      f"--model_path={path}"])
    assert _csv(tmp_path / "pipe_best") == _csv(tmp_path / "one_best")


def test_pp_resume_continues_bit_for_bit(runs):
    _, two, _, _ = runs
    a, b = (torch.load(_resume(two / sub), weights_only=True)
            for sub in ("train", "resumed"))
    assert a["meta"]["pipe"] == b["meta"]["pipe"] == 2
    assert a["meta"]["epoch"] == b["meta"]["epoch"] == 1
    assert set(a["state_dict"]) == set(b["state_dict"])
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
    stages = [a["optimizer"]["stages"], b["optimizer"]["stages"]]
    assert len(stages[0]) == len(stages[1]) == 2
    for sa, sb in zip(*stages):
        for pid, st in sa["state"].items():
            for name, v in st.items():
                assert torch.equal(torch.as_tensor(v),
                                   torch.as_tensor(sb["state"][pid][name]))
    assert a["meta"]["best_val_acc"] == b["meta"]["best_val_acc"]


@pytest.mark.parametrize("case", ["pipe_on_data", "data_on_pipe",
                                  "other_pipe_size"])
def test_pp_resume_refused_across_meshes(runs, case, tmp_path):
    """The JAX trainer's words; the third in one process, over a mesh of
    pipe:4 that never forms its group (the refusal comes first)."""
    _, two, _, _ = runs
    want = {"pipe_on_data": "payload is stage-stacked (saved by a pipe:N "
                            "run); resume with the same --mesh_shape",
            "data_on_pipe": "payload is per-layer (saved by a dp/tp run); "
                            "resume with the same --mesh_shape",
            "other_pipe_size": "--resume_from was saved with pipe:2; resume "
                               "with the same mesh (got pipe:4)"}[case]
    if case != "other_pipe_size":
        for r in range(2):
            with open(two / case / f"refused_rank{r}.txt") as f:
                assert want in f.read()
        return
    from garbage_classification_rca_tpu_torch.cli.blip2_common import (
        VlmResume)
    from garbage_classification_rca_tpu_torch.parallel.mesh import DataMesh

    lora = torch.nn.Linear(2, 2)
    opt = torch.optim.AdamW(lora.parameters())
    with pytest.raises(SystemExit, match=want.replace("(", r"\(")
                       .replace(")", r"\)")):
        VlmResume.load(_resume(two / "train"), lora, opt,
                       DataMesh(0, 4, axes=(("pipe", 4),)))


@pytest.mark.parametrize("cli,extra,match", [
    ("blip2_train", ["--hf_internal_dropout"], "--hf_internal_dropout is "
     "not supported on a pipe mesh"),
    ("blip2_test", ["--max_new_tokens=3", "--gen_temperature=0.7"],
     "sampled decode is not supported on pipe meshes"),
    ("blip2_test", ["--max_new_tokens=3", "--int8_weights"],
     "weight-only int8 is not supported on pipe meshes"),
    ("blip2_train", ["--mesh_shape=model:2,pipe:2"],
     "combine pipe with data only"),
    ("blip2_test", ["--mesh_shape=model:2,pipe:2"],
     "combine pipe with data only"),
    ("blip2_test", ["--mesh_shape=pipe:4"],
     "pipe:4 must divide the 2-layer OPT decoder"),
    ("blip2_train", ["multihost"], "pipe axis is single-process only"),
])
def test_pp_guards_exit_before_any_rank_starts(cli, extra, match,
                                               tiny_dataset, monkeypatch):
    argv = [f"--dataset_folder_name={tiny_dataset}", "--model_path=x.pth"]
    if extra == ["multihost"]:
        for k, v in (("GC_RCA_MULTIHOST", "1"),
                     ("GC_RCA_COORDINATOR", "localhost:1"),
                     ("GC_RCA_PROCESS_ID", "0"),
                     ("GC_RCA_NUM_PROCESSES", "2")):
            monkeypatch.setenv(k, v)
        extra = []
    if not any(a.startswith("--mesh_shape") for a in extra):
        extra = extra + [PIPE]
    with pytest.raises(SystemExit, match=match):
        _port(cli).main(argv + extra)
