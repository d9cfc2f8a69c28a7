"""PyTorch port, ``--fsdp`` (``parallel/fsdp.py``: FSDP2's
``fully_shard`` over the data axis) on gloo ranks on the CPU.

  * the placement rule against the JAX package's ``leaf_spec`` (the dim a
    parameter is sharded on; JAX replicates small parameters, the port
    shards them on dim 0: placement only);
  * ``cli.main_text`` (DistilBERT cut to 1 layer and to the test
    vocabulary's 344 tokens, AdamW, class weights, the internal dropout,
    both phases) over two ranks with ``--fsdp`` against the same run
    replicated (one launch runs both), within the JAX package's
    ``tests/test_fsdp.py`` tolerance (rtol 3e-4, atol 1e-6): the JSONL
    rows, the BEST file and the RESUME file's weights and optimizer state;
    with one rank (the group of one process ``--fsdp`` forms, in this
    process; SGD, whose update does not amplify rounding as AdamW's
    sign-like first steps do) against the run without a group;
  * the rank-0 BEST file written under ``--fsdp`` evaluates in a
    one-process ``cli.test_text``, its RESUME file loads into a
    one-process model and optimizer, and resuming it in a run of another
    world size stops that run.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.parallel import fsdp as jfsdp
from garbage_classification_rca_tpu_torch.cli import main_text, test_text
from garbage_classification_rca_tpu_torch.models.registry import get_text_model
from garbage_classification_rca_tpu_torch.models.text import distilbert
from garbage_classification_rca_tpu_torch.parallel import fsdp, multihost
from garbage_classification_rca_tpu_torch.train.engine import (
    load_model_state, maybe_load_resume)
from garbage_classification_rca_tpu_torch.train.optim import make_optimizer
from tests.test_torch_multihost import launch_script

torch.set_num_threads(2)

VOCAB = os.path.join(os.path.dirname(__file__), "fixtures", "vocab",
                     "wordpiece")
RTOL, ATOL = 3e-4, 1e-6
VOCAB_SIZE = 344          # tests/fixtures/vocab/wordpiece/vocab.txt


@pytest.mark.parametrize("shape", [
    (768, 3072), (3072, 768), (30522, 768), (768,), (4, 4), (3, 3, 64, 64),
    (16, 1024), (1024, 6), (7, 4097)])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_shard_dim_matches_the_jax_leaf_spec(shape, n):
    spec = tuple(jfsdp.leaf_spec(np.empty(shape, np.float32), n))
    want = next((d for d, a in enumerate(spec) if a is not None), None)
    assert fsdp.shard_dim(shape, n) == want


MAIN_TEXT = """
    import os, sys
    import torch
    torch.set_num_threads(1)
    from garbage_classification_rca_tpu_torch.cli import main_text
    from garbage_classification_rca_tpu_torch.models.text import distilbert
    distilbert.LAYERS, distilbert.VOCAB = 1, int(sys.argv[1])
    for sub, extra in (("fsdp", ["--fsdp"]), ("rep", [])):
        os.makedirs(sub, exist_ok=True)
        os.chdir(sub)
        main_text.main(sys.argv[2:] + extra)
        os.chdir("..")
"""


def _argv(base):
    return [f"--dataset_folder_name={base}", "--text_model=distilbert",
            "--epochs=1", "--ft_epochs=1", "--batch_size=4",
            "--batch_size_FT=4", "--acc_steps=2", "--acc_steps_FT=1",
            "--opt=adamw", "--lr=0.001", "--reg=0.01", "--seq_len=16",
            "--balance_weights", "--hf_internal_dropout", "--no-tl",
            "--data_workers=2", f"--vocab_dir={VOCAB}"]


def _outputs(d):
    rows = [json.loads(line) for f in glob.glob(str(d / "runs" / "*.jsonl"))
            for line in open(f)]
    bests = sorted(glob.glob(str(d / "model_weights" / "distilbert" /
                                 "BEST_*")), key=os.path.getmtime)
    resume = maybe_load_resume(str(d / "model_weights" / "distilbert" /
                                   "RESUME"))
    return sorted(rows, key=lambda r: r["phase"] != "train"), bests, resume


def _close(a, b, what):
    assert abs(a - b) <= ATOL + RTOL * abs(b), (what, a, b)


def _assert_runs_close(got, want):
    """FSDP against unsharded at the JAX FSDP tolerance."""
    (rg, bg, pg), (rw, bw, pw) = got, want

    def close(a, b):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)

    assert [r["phase"] for r in rg] == [r["phase"] for r in rw] == [
        "train", "fine_tune"]
    for g, w in zip(rg, rw):
        for k in ("avg_loss", "grad_norm_last", "param_global_norm"):
            _close(g[k], w[k], k)
        assert g["val_acc"] == w["val_acc"]
    sg = torch.load(bg[-1], weights_only=True)["state_dict"]
    sw = torch.load(bw[-1], weights_only=True)["state_dict"]
    for k, v in sw.items():
        close(sg[k], v)
    for k, v in pw["state_dict"].items():
        close(pg["state_dict"][k], v)
    og, ow = pg["optimizer"]["state"], pw["optimizer"]["state"]
    assert og.keys() == ow.keys()
    for i in ow:
        for name, v in ow[i].items():
            close(og[i][name], v)


def _cut(monkeypatch):
    """This process as the workers: on the CPU, DistilBERT at 1 layer and
    the test vocabulary."""
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    monkeypatch.setattr(distilbert, "LAYERS", 1)
    monkeypatch.setattr(distilbert, "VOCAB", VOCAB_SIZE)


@pytest.fixture()
def tree(tiny_dataset, tmp_path):
    base = tmp_path / "ds"
    os.symlink(tiny_dataset, f"{base}_Train")
    os.symlink(tiny_dataset, f"{base}_Val")
    return str(base)


def test_fsdp_over_two_ranks_equals_replicated_and_saves_whole_files(
        tree, tmp_path, monkeypatch):
    argv = _argv(tree)
    launch_script(tmp_path, MAIN_TEXT,
                  [VOCAB_SIZE] + argv + ["--mesh_shape=data:2"])
    sharded, replicated = _outputs(tmp_path / "fsdp"), _outputs(
        tmp_path / "rep")
    _assert_runs_close(sharded, replicated)
    _cut(monkeypatch)
    monkeypatch.chdir(tmp_path)

    # the rank-0 files are an unsharded run's
    rows, bests, resume = sharded
    acc = test_text.main(["--text_model=distilbert",
                          f"--model_path={bests[-1]}",
                          f"--dataset_folder_name={tree}_Val",
                          "--seq_len=16", f"--vocab_dir={VOCAB}",
                          "--compute_dtype=float32", "--eval_batch_size=8"])
    assert acc == pytest.approx(max(r["val_acc"] for r in rows))
    assert resume["meta"]["world"] == 2
    model = get_text_model("distilbert").build(4, layers=1)
    load_model_state(model, resume["state_dict"])
    opt = make_optimizer("adamw", model.named_parameters(), 0.001, 0.01)
    opt.load_state_dict(resume["optimizer"])
    assert len(opt.state) == len(list(model.parameters()))
    resume_path = os.path.join(os.path.dirname(bests[-1]), "RESUME")
    with pytest.raises(SystemExit, match="written by a run of 2 ranks"):
        main_text.main(argv + ["--epochs=2", f"--model_path={resume_path}"])


def test_fsdp_with_one_rank_equals_the_run_without_a_group(tree, tmp_path,
                                                           monkeypatch,
                                                           capsys):
    """``--fsdp`` in a plain one-process run forms a group of one (gloo
    here, NCCL on the card): every parameter one shard."""
    argv = [a for a in _argv(tree) if not a.startswith("--opt")] + [
        "--opt=sgd"]
    _cut(monkeypatch)
    for k in ("RANK", "WORLD_SIZE", "GC_RCA_MULTIHOST"):
        monkeypatch.delenv(k, raising=False)
    for sub, extra in (("fsdp1", ["--fsdp"]), ("one", [])):
        (tmp_path / sub).mkdir()
        monkeypatch.chdir(tmp_path / sub)
        try:
            main_text.main(argv + extra)
        finally:
            multihost.shutdown()
    assert "process group: 1 rank(s), backend gloo" in capsys.readouterr().out
    _assert_runs_close(_outputs(tmp_path / "fsdp1"), _outputs(tmp_path / "one"))
