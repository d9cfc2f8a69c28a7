"""PyTorch port, full and mid-epoch RESUME of the two VLM trainers
(``cli.blip2_train``, ``cli.qformer_train``) on the CPU
(``GC_RCA_TINY_BLIP2=1``, fp32), in the patterns of the JAX package's
``tests/test_blip2_cli.py`` resume tests.

12 samples at ``--batch_size=1`` and acc 8 are 2 optimizer windows an
epoch; every run trains 2 epochs from the tiny peft ``.pth`` of
``tests/test_torch_vlm_train_cli.py``. Each case runs the trainer
uninterrupted, "killed" (its train step raises at a chosen call, as a
killed process would stop) and resumed from the killed run's
``model_weights/<model>/RESUME`` through ``--resume_from`` with the same
flags. Kill points: the first window of epoch 1 (RESUME holds epoch 0's
end) and its second window under ``--resume_every_steps=1`` (RESUME holds
epoch 1's first window and its loss), the latter also with
``--hf_internal_dropout`` (BLIP-2 carries its key, the Q-Former derives
it). The resumed run must end bit for bit
where the uninterrupted one did: the trained module (the adapters, the
classifier), AdamW's state, the RESUME meta, the JSONL rows but their wall
times, and the BEST files. A stale RESUME (a step past the epoch's
windows) is the JAX trainers' ``SystemExit``; the killed-and-resumed
losses equal the JAX trainer's, killed and resumed the same way.
"""

import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_vlm_train_cli import blip  # noqa: F401 (fixture)

torch.set_num_threads(2)

BPE = os.path.join(os.path.dirname(__file__), "fixtures", "vocab", "bpe")
MODEL = {"blip2_train": "blip2_lora", "qformer_train": "qformer_classifier"}
# the call of the train step that raises: epoch 1's first window (RESUME
# holds epoch 0's end) or its second (RESUME holds one window of epoch 1)
KILL = {"epoch": 3, "mid_epoch": 4}
FACTORY = {"blip2_train": "make_lora_train_step",
           "qformer_train": "make_steps"}


@pytest.fixture(autouse=True)
def _tiny(monkeypatch):
    monkeypatch.setenv("GC_RCA_TINY_BLIP2", "1")
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    for flag in ("GC_RCA_FUSED_ATTN", "GC_RCA_FLASH_BWD", "GC_RCA_MULTIHOST"):
        monkeypatch.delenv(flag, raising=False)


@pytest.fixture(scope="module")
def work(tiny_dataset, tmp_path_factory):
    """A work directory holding the ``_Train`` / ``_Val`` tree; removed
    with its checkpoints after the module."""
    d = tmp_path_factory.mktemp("vlm_resume")
    os.symlink(tiny_dataset, d / "ds_Train")
    os.symlink(tiny_dataset, d / "ds_Val")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _argv(work, blip, every, hf=False):
    return ([f"--dataset_folder_name={work}/ds", f"--vocab_dir={BPE}",
             f"--model_path={blip}", "--batch_size=1", "--epochs=2",
             "--compute_dtype=float32", "--data_workers=2"]
            + (["--resume_every_steps=1"] if every else [])
            + (["--hf_internal_dropout"] if hf else []))


def _dying(module, cli, at):
    """``chip_smoke._dying_step`` on `cli`'s step factory: its train step
    raises ``chip_smoke._Killed`` at the `at`-th call; yields the call
    counter."""
    return chip_smoke._dying_step(module, at, FACTORY[cli])


def _in(d, fn, monkeypatch):
    d.mkdir(parents=True, exist_ok=True)
    monkeypatch.chdir(d)
    try:
        return fn()
    finally:
        monkeypatch.chdir(d.parent)


def _end(d, cli):
    """(final RESUME payload, JSONL rows without wall times, BEST
    payloads by file name without the time stamp) of the run in `d`."""
    from garbage_classification_rca_tpu_torch.train.engine import (
        load_checkpoint)

    rows = [{k: v for k, v in json.loads(line).items()
             if k != "epoch_time_seconds"}
            for p in sorted(glob.glob(str(d / "runs" / "*.jsonl")))
            for line in open(p)]
    base = d / "model_weights" / MODEL[cli]
    best = {os.path.basename(p).rsplit("_", 6)[0]: load_checkpoint(p)
            for p in glob.glob(str(base / "BEST_*"))}
    return torch.load(base / "RESUME", weights_only=True), rows, best


def _port(cli):
    import importlib

    return importlib.import_module(
        f"garbage_classification_rca_tpu_torch.cli.{cli}")


@pytest.fixture(scope="module")
def runs(work, blip):
    """``runs(cli, kind, hf)``: the run in its own directory of `work`,
    made once: "straight" uninterrupted, or killed at ``KILL[kind]`` and
    then resumed ("epoch" without ``--resume_every_steps``, "mid_epoch"
    with it); `hf`: with ``--hf_internal_dropout``, whose masks draw on the
    trainers' keys. -> (directory, RESUME meta the kill left)."""
    made = {}

    def get(cli, kind, hf=False):
        if (cli, kind, hf) in made:
            return made[(cli, kind, hf)]
        mp = pytest.MonkeyPatch()
        module = _port(cli)
        d = work / f"{cli}_{kind}{'_hf' if hf else ''}"
        argv = _argv(work, blip, kind != "epoch", hf)
        try:
            if kind == "straight":
                _in(d, lambda: module.main(argv), mp)
                made[(cli, kind, hf)] = d, None
                return made[(cli, kind, hf)]
            with _dying(module, cli, KILL[kind]) as calls:
                def killed():
                    with pytest.raises(chip_smoke._Killed):
                        module.main(argv)

                _in(d, killed, mp)
                path = d / "model_weights" / MODEL[cli] / "RESUME"
                meta = torch.load(path, weights_only=True)["meta"]
                calls["n"] = -100             # no more kills
                _in(d, lambda: module.main(
                    argv + [f"--resume_from={path}"]), mp)
            assert calls["n"] == -100 + 2 * 2 - KILL[kind] + 1
        finally:
            mp.undo()
        made[(cli, kind, hf)] = d, meta
        return made[(cli, kind, hf)]

    return get


@pytest.mark.parametrize("kind,hf", [("epoch", False), ("mid_epoch", False),
                                     ("mid_epoch", True)])
@pytest.mark.parametrize("cli", ["blip2_train", "qformer_train"])
def test_vlm_killed_run_resumes_bit_identical(cli, kind, hf, runs):
    d_straight, _ = runs(cli, "straight", hf)
    d_resumed, saved = runs(cli, kind, hf)
    # what the kill left: epoch 0's end, or one window of epoch 1 and its
    # loss
    if kind == "epoch":
        assert (saved["epoch"], saved["step"]) == (0, 0)
        assert "losses" not in saved
    else:
        assert (saved["epoch"], saved["step"]) == (1, 1)
        assert len(saved["losses"]) == 1
    (ra, rows_a, best_a), (rb, rows_b, best_b) = (
        _end(d_straight, cli), _end(d_resumed, cli))
    assert ra["state_dict"].keys() == rb["state_dict"].keys()
    for k, v in ra["state_dict"].items():
        assert torch.equal(v, rb["state_dict"][k]), k
    oa, ob = ra["optimizer"], rb["optimizer"]
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys() and oa["state"]
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    meta_a = {k: v for k, v in ra["meta"].items() if k != "best_path"}
    meta_b = {k: v for k, v in rb["meta"].items() if k != "best_path"}
    assert meta_a == meta_b and meta_a["epoch"] == 1
    assert rows_a == rows_b and len(rows_a) == 2
    assert rows_a[0]["avg_loss"] != rows_a[1]["avg_loss"]
    assert best_a.keys() == best_b.keys() and best_a
    for name, pa in best_a.items():
        pb = best_b[name]
        assert pa["meta"] == pb["meta"], name
        for k, v in pa["state_dict"].items():
            assert torch.equal(v, pb["state_dict"][k]), (name, k)


@pytest.mark.parametrize("cli", ["blip2_train", "qformer_train"])
def test_vlm_stale_resume_is_refused(cli, runs, work, blip, monkeypatch):
    """A RESUME whose step is past the epoch's 2 windows (another
    --batch_size or dataset) is the JAX trainers' SystemExit, before any
    window runs."""
    d, _ = runs(cli, "mid_epoch")
    payload = torch.load(d / "model_weights" / MODEL[cli] / "RESUME",
                         weights_only=True)
    payload["meta"].update(epoch=1, step=5, losses=[1.0] * 5)
    stale = work / f"{cli}_stale" / "model_weights" / MODEL[cli] / "RESUME"
    stale.parent.mkdir(parents=True)
    torch.save(payload, stale)
    with _dying(_port(cli), cli, 1) as calls, \
            pytest.raises(SystemExit, match=r"RESUME step 5 > 2 optimizer "
                          r"windows in epoch 1 — stale RESUME dir"):
        _in(stale.parents[2], lambda: _port(cli).main(
            _argv(work, blip, True) + [f"--resume_from={stale}"]),
            monkeypatch)
    assert calls["n"] == 0


def _jax_killed_and_resumed(cli, work, blip, monkeypatch):
    """The JAX trainer killed at epoch 1's second window under
    ``--resume_every_steps=1`` and resumed from its RESUME: the epoch
    losses the two runs log. The Q-Former's classifier is the port's
    (drawn from ``--seed`` + 2), in the JAX layout."""
    import importlib

    import jax.numpy as jnp

    from garbage_classification_rca_tpu.models.vlm import blip2 as jblip2
    from garbage_classification_rca_tpu_torch.config import args_parser
    from garbage_classification_rca_tpu_torch.models.vlm import blip2
    from garbage_classification_rca_tpu_torch.nn import core

    module = importlib.import_module(
        f"garbage_classification_rca_tpu.cli.{cli}")
    argv = _argv(work, blip, every=True)
    if cli == "qformer_train":
        def init_classifier(key, cfg):
            clf = blip2.init_classifier_(
                core.Linear(cfg.qformer.hidden, 4), args_parser(argv).seed + 2)
            return {"w": jnp.asarray(clf.w.detach().numpy().T),
                    "b": jnp.asarray(clf.b.detach().numpy())}

        monkeypatch.setattr(jblip2, "init_classifier", init_classifier)
    d = work / f"jax_{cli}"
    with _dying(module, cli, KILL["mid_epoch"]), \
            pytest.raises(chip_smoke._Killed):
        _in(d, lambda: module.main(argv), monkeypatch)
    _in(d, lambda: module.main(argv + [
        f"--resume_from={d}/model_weights/{MODEL[cli]}/RESUME"]),
        monkeypatch)
    rows = [json.loads(line)
            for p in sorted(glob.glob(str(d / "runs" / "*.jsonl")))
            for line in open(p)]
    return {r["epoch"]: r["avg_loss"] for r in rows}


@pytest.mark.parametrize("cli", ["blip2_train", "qformer_train"])
def test_vlm_resumed_losses_match_jax(cli, runs, work, blip, monkeypatch):
    """The port's killed-and-resumed run logs, epoch by epoch, the losses
    of the JAX trainer killed and resumed at the same window (1e-5
    relative, the bar ``tests/test_torch_vlm_train_cli.py`` holds the
    trainers to)."""
    d, _ = runs(cli, "mid_epoch")
    got = {r["epoch"]: r["avg_loss"] for r in _end(d, cli)[1]}
    want = _jax_killed_and_resumed(cli, work, blip, monkeypatch)
    assert sorted(got) == sorted(want) == [0, 1]
    np.testing.assert_allclose([got[0], got[1]], [want[0], want[1]],
                               rtol=1e-5)
