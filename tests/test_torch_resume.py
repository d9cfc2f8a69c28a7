"""PyTorch port, full and mid-epoch RESUME of the three engine trainers
(``cli.main_image``, ``cli.main_text``, ``cli.main_both``) on the CPU, in
the patterns of the JAX package's ``tests/test_engine.py`` resume tests.

Each CLI case runs the trainer three times in this process
(``GC_RCA_PLATFORM=cpu``): uninterrupted; "killed" (its train step raises
at a chosen call, as a killed process would stop); resumed from the
killed run's ``model_weights/<model>/RESUME`` through
``--model_path=.../RESUME`` with the same flags. The resumed run must end
bit for bit where the uninterrupted one did: the final RESUME files' model
state dicts (BatchNorm buffers included) and optimizer states are equal,
and so are the scheduler state, the key, best accuracy and epoch, and the
JSONL rows of every epoch the resumed run logs (losses, grad and param
norms, lr, val accuracies; all but the wall times). Kill points: at an
epoch boundary (RESUME holds the finished epoch) and mid-epoch under
``--resume_every_steps=1`` (RESUME holds the windows done so far, and the
epoch's losses so far); a kill in the fine_tune phase resumes without
running phase 1 again. ``--use_synonyms`` is left out: its host random
stream is not saved, in either package.

The engine's pieces: the ``RESUME.prev`` fallback of an interrupted swap,
the stale-RESUME ``SystemExit`` and ``cast_for_training`` keeping a bf16
checkpoint's dtype on a resume. The VLM trainers' resume:
``tests/test_torch_vlm_resume.py``.
"""

import dataclasses
import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu_torch import config as tconfig
from garbage_classification_rca_tpu_torch.cli import main_both as port_both
from garbage_classification_rca_tpu_torch.cli import main_image as port_image
from garbage_classification_rca_tpu_torch.cli import main_text as port_text
from garbage_classification_rca_tpu_torch.config import RunConfig
from garbage_classification_rca_tpu_torch.models.image import (
    efficientnet_v2 as teffv2)
from garbage_classification_rca_tpu_torch.models.text import (
    distilbert as tdistil)
from garbage_classification_rca_tpu_torch.train import engine
from garbage_classification_rca_tpu_torch.utils.dtype import cast_for_training

torch.set_num_threads(2)

VOCAB = os.path.join(os.path.dirname(__file__), "fixtures", "vocab",
                     "wordpiece")


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """Each run writes full-size checkpoints: removed after the test."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


class Killed(Exception):
    """What the dying train step raises."""


def _dying(make_train_step, at):
    """``make_train_step`` whose steps raise at the `at`-th call (counted
    over every step the run builds)."""
    calls = {"n": 0}

    def make(*a, **kw):
        step = make_train_step(*a, **kw)

        def dying(*sa):
            calls["n"] += 1
            if calls["n"] == at:
                raise Killed
            return step(*sa)

        return dying

    return make


def _rows(d):
    rows = [json.loads(line) for f in sorted(glob.glob(str(d / "runs" /
                                                          "*.jsonl")))
            for line in open(f)]
    for r in rows:
        r.pop("epoch_time_seconds")
    return rows


def _resume_file(d, model_name):
    return torch.load(d / "model_weights" / model_name / "RESUME",
                      weights_only=True)


def _assert_same_tree(a, b, where=""):
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype, where
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same_tree(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


def _assert_same_end(got, want):
    _assert_same_tree(got["state_dict"], want["state_dict"], "state_dict")
    _assert_same_tree(got["optimizer"], want["optimizer"], "optimizer")
    gm, wm = dict(got["meta"]), dict(want["meta"])
    for m in (gm, wm):           # timestamped file names
        m["best_path"] = os.path.basename(m["best_path"]).rsplit("_", 6)[0]
    assert gm == wm


# ---------------------------------------------------------------------------
# the three CLIs, each killed and resumed
# ---------------------------------------------------------------------------


@pytest.fixture()
def train_tree(tiny_dataset, tmp_path):
    base = tmp_path / "ds"
    os.symlink(tiny_dataset, f"{base}_Train")
    os.symlink(tiny_dataset, f"{base}_Val")
    return str(base)


def _image_case(base, monkeypatch, tmp_path):
    monkeypatch.setitem(tconfig.IMAGE_ARCHS, "res18", dataclasses.replace(
        tconfig.IMAGE_ARCHS["res18"], input_size=(48, 48)))
    argv = [f"--dataset_folder_name={base}", "--image_model=res18",
            "--epochs=2", "--ft_epochs=1", "--batch_size=4",
            "--batch_size_FT=4", "--acc_steps=2", "--acc_steps_FT=1",
            "--opt=adamw", "--lr=0.001", "--reg=0.01", "--prob_aug=1.0",
            "--compute_dtype=float32", "--data_workers=2", "--tl"]
    return port_image, argv, "res18"


def _text_case(base, monkeypatch, tmp_path):
    monkeypatch.setattr(tdistil, "LAYERS", 1)
    argv = [f"--dataset_folder_name={base}", "--text_model=distilbert",
            "--epochs=1", "--ft_epochs=2", "--batch_size=4",
            "--batch_size_FT=4", "--acc_steps=1", "--acc_steps_FT=2",
            "--opt=adamw", "--lr=0.001", "--reg=0.01", "--seq_len=16",
            "--balance_weights", "--hf_internal_dropout",
            "--data_workers=2", f"--vocab_dir={VOCAB}"]
    return port_text, argv, "distilbert"


def _both_case(base, monkeypatch, tmp_path):
    from tests.test_torch_fusion_train_cli import _ckpt
    from tests.test_torch_train_cli import STAGES, _tree

    monkeypatch.setenv("GC_RCA_MM_IMAGE_SIZE", "64")
    monkeypatch.setitem(teffv2.CONFIGS, "eff_v2_medium", dataclasses.replace(
        teffv2.CONFIGS["eff_v2_medium"], stages=STAGES))
    base = tmp_path / "garbage"
    _tree(base, np.random.default_rng(3))
    ckpt = _ckpt(tmp_path / "mm_rca.pth", "MM_RCA", "distilbert", 4)
    argv = [f"--dataset_folder_name={base}", "--late_fusion=MM_RCA",
            "--reverse", "--epochs=2", "--ft_epochs=1", "--batch_size=4",
            "--batch_size_FT=4", "--acc_steps=1", "--acc_steps_FT=2",
            "--opt=sgd", "--lr=0.0016", "--reg=0.03", "--fraction_lr=3",
            "--balance_weights", "--prob_aug=1.0", "--seq_len=16",
            "--compute_dtype=float32", "--data_workers=2",
            f"--vocab_dir={VOCAB}"]
    return port_both, argv + [f"--model_path={ckpt}"], "MM_RCA_distilbert"


# (case, --resume_every_steps, the step call that raises, the phase the
# RESUME then holds, its epoch, its step): 12 train samples at batch 4
# make 3 batches an epoch; windows of acc_steps
CASES = {
    # image, acc 2: 2 windows an epoch in phase 1; the 3rd call is epoch
    # 1's first window, so RESUME holds the end of epoch 0
    "main_image_epoch": (_image_case, 0, 3, "train", 0, 0),
    # image: the 4th call is epoch 1's second window; RESUME after window 1
    "main_image_mid_epoch": (_image_case, 1, 4, "train", 1, 1),
    # text: phase 1 is 3 windows (acc 1); phase 2 (acc 2) 2 an epoch: the
    # 6th call is fine_tune epoch 1's first window
    "main_text_epoch": (_text_case, 0, 6, "fine_tune", 0, 0),
    # text: the 5th call is fine_tune epoch 0's second window
    "main_text_mid_epoch": (_text_case, 1, 5, "fine_tune", 0, 1),
    # both: phase 1 at acc 1 is 3 windows an epoch; the 5th call is
    # epoch 1's second window
    "main_both_mid_epoch": (_both_case, 1, 5, "train", 1, 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_killed_run_resumes_bit_identical(case, train_tree, tmp_path,
                                          monkeypatch):
    make_case, every, at, phase, epoch, step = CASES[case]
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    cli, argv, model_name = make_case(train_tree, monkeypatch, tmp_path)
    argv = argv + [f"--resume_every_steps={every}"]

    def run(d, extra=(), kill=None):
        d.mkdir(exist_ok=True)
        monkeypatch.chdir(d)
        with monkeypatch.context() as mp:
            if kill:
                mp.setattr(cli, "make_train_step",
                           _dying(cli.make_train_step, kill))
            return cli.main(argv + list(extra))

    want_best = run(tmp_path / "full")
    want_rows = _rows(tmp_path / "full")
    want = _resume_file(tmp_path / "full", model_name)
    with pytest.raises(Killed):
        run(tmp_path / "killed", kill=at)
    killed_rows = _rows(tmp_path / "killed")
    payload = _resume_file(tmp_path / "killed", model_name)
    assert (payload["meta"]["phase_name"], payload["meta"]["epoch"],
            payload["meta"]["step"]) == (phase, epoch, step)
    assert len(payload["meta"].get("losses", ())) == step
    path = os.path.join("model_weights", model_name, "RESUME")
    best = run(tmp_path / "killed", [f"--model_path={path}"])
    got_rows = _rows(tmp_path / "killed")[len(killed_rows):]

    _assert_same_end(_resume_file(tmp_path / "killed", model_name), want)
    assert got_rows == want_rows[len(want_rows) - len(got_rows):]
    # the resumed run logs from the killed epoch on (after the saved one
    # at an epoch boundary), and no phase-1 row when it resumes phase 2
    assert (got_rows[0]["phase"], got_rows[0]["epoch"]) == (
        phase, epoch + (step == 0))
    assert killed_rows + got_rows == want_rows
    assert (best.best_val_acc, best.best_epoch) == (want_best.best_val_acc,
                                                    want_best.best_epoch)
    assert os.path.isfile(best.best_path)


# ---------------------------------------------------------------------------
# the engine's pieces
# ---------------------------------------------------------------------------


def _saved(tmp_path, monkeypatch, epoch, step=0):
    monkeypatch.chdir(tmp_path)
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    return engine.save_train_state(
        model=model, optimizer=opt, model_name="unit",
        key=engine.Key(5), epoch=epoch, phase_name="train", scheduler=None,
        best=engine.PhaseResult(50.0, 1, None), step=step,
        losses=[0.5] * step, grad_norms=[1.0] * step, param_norm=2.0,
        layers=0)


def test_resume_swap_falls_back_to_prev(tmp_path, monkeypatch):
    path = _saved(tmp_path, monkeypatch, 3)
    assert engine.maybe_load_resume(path)["meta"]["epoch"] == 3
    # the kill inside the swap: the new file never landed, the old one
    # was moved aside
    os.replace(path, path + ".prev")
    payload = engine.maybe_load_resume(path)
    assert payload is not None and payload["meta"]["epoch"] == 3
    # the next save swaps in cleanly and removes the .prev
    path = _saved(tmp_path, monkeypatch, 4)
    assert engine.maybe_load_resume(path)["meta"]["epoch"] == 4
    assert not os.path.exists(path + ".prev")
    assert not os.path.exists(path + ".tmp")
    # not a RESUME name: no resume; a missing file: none either
    assert engine.maybe_load_resume(str(tmp_path / "BEST_x")) is None
    assert engine.maybe_load_resume(str(tmp_path / "x" / "RESUME")) is None
    # a RESUME name that holds something else
    torch.save({"format": "other"}, path)
    with pytest.raises(SystemExit, match="not a RESUME file"):
        engine.maybe_load_resume(path)


def test_stale_mid_epoch_resume_is_refused(tiny_dataset, tmp_path,
                                           monkeypatch):
    """A RESUME whose step is past the epoch's optimizer windows (a stale
    file, or another batch geometry) stops the run instead of logging the
    restored partial losses as a whole epoch."""
    from garbage_classification_rca_tpu_torch.data.manifest import (
        build_manifest)
    from garbage_classification_rca_tpu_torch.data.pipeline import (
        ImageTextBatcher)
    from garbage_classification_rca_tpu_torch.train.optim import (
        PlateauScheduler)

    path = _saved(tmp_path, monkeypatch, 0, step=4)
    plan = engine.ResumePlan(path)
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    batcher = ImageTextBatcher(build_manifest(str(tiny_dataset)), (8, 8),
                               workers=1)
    # 12 samples / batch 2 / acc 2: 3 windows an epoch; step 3 would be
    # the save at the epoch's last window, step 4 is stale
    try:
        with pytest.raises(SystemExit, match="stale RESUME"):
            engine.run_phase(
                phase_name="train", epochs=1, model=model, optimizer=opt,
                train_step=None, eval_fn=None, batcher=batcher,
                batch_size=2, acc_steps=2, logger=None, device="cpu",
                args=RunConfig(seed=7, resume_every_steps=1),
                model_name="unit", scheduler=PlateauScheduler(0.1),
                resume=plan)
    finally:
        batcher.close()


def test_cast_for_training_keeps_a_bf16_checkpoint(train_tree, tmp_path,
                                                   monkeypatch):
    """A --param_dtype=bfloat16 run resumed with the flag left empty goes
    on in bf16 (its BatchNorm statistics stay fp32), as the JAX
    package's ``cast_for_training`` keeps it; with the flag given, the
    flag decides."""
    model = torch.nn.BatchNorm1d(3)
    args = RunConfig(param_dtype="")
    model.weight.data = model.weight.data.bfloat16()
    cast_for_training(args, model, resumed=True)
    assert model.weight.dtype == torch.bfloat16
    cast_for_training(args, model, resumed=False)
    assert model.weight.dtype == torch.float32
    assert model.running_mean.dtype == torch.float32
    cast_for_training(RunConfig(param_dtype="bfloat16"), model, resumed=True)
    assert model.weight.dtype == torch.bfloat16
    assert model.running_mean.dtype == torch.float32

    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    cli, argv, name = _image_case(train_tree, monkeypatch, tmp_path)
    argv = [a for a in argv if not a.startswith(("--epochs", "--ft_"))]
    monkeypatch.chdir(tmp_path)
    cli.main(argv + ["--epochs=1", "--ft_epochs=0", "--param_dtype=bfloat16"])
    path = os.path.join("model_weights", name, "RESUME")
    saved = torch.load(path, weights_only=True)["state_dict"]
    assert saved["fc.w"].dtype == torch.bfloat16
    assert saved["stem.bn.mean"].dtype == torch.float32
    seen = {}
    real = cli.make_train_step

    def spy(model, *a, **kw):
        seen["dtypes"] = {p.dtype for p in model.parameters()}
        seen["bn"] = model.stem.bn.mean.dtype
        return real(model, *a, **kw)

    monkeypatch.setattr(cli, "make_train_step", spy)
    cli.main(argv + ["--epochs=2", "--ft_epochs=0", f"--model_path={path}"])
    assert seen == {"dtypes": {torch.bfloat16}, "bn": torch.float32}
    after = torch.load(path, weights_only=True)
    assert after["meta"]["epoch"] == 1
    assert after["state_dict"]["fc.w"].dtype == torch.bfloat16
