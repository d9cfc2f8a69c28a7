"""PyTorch port, ``cli.main_image`` on the conv backbones against the JAX
package's ``cli.main_image``, both run in this process on the CPU
(``GC_RCA_PLATFORM=cpu`` for the port), in the pattern of
``tests/test_torch_unimodal_train.py``.

ResNet-18 at full width and depth and ShuffleNetV2 x2.0 at full width
(``IMAGE_ARCHS``' input size cut to 64 x 64 on both sides) from one
torchvision-layout ``.pth`` (``tests/torch_refs``) that both CLIs load,
for 1 + 1 epochs on the ``tiny_dataset`` tree: phase 1 trains the head on
a frozen backbone (``--tl``; BatchNorm on batch statistics all the same),
phase 2 everything at lr 1e-4; SGD with weight decay, class weights,
fp32, no augmentation (neither tower has another random site).
ShuffleNet runs 2 units a stage (``REPEATS`` patched on both sides, the
``.pth`` cut to match): at full depth its fp32 gradients are
ill-conditioned (two XLA compilations of the same JAX step put its
early-layer gradients 1-2% apart, ``tests/test_torch_conv_train.py``),
and the fine-tune epoch's loss and grad norm then drift past the bars;
ResNet-18 sits within them at full depth once phase 2's lr is 1e-4 (at
3.3e-3 its fine-tune loss drifts 3.5e-4 the same way). Per epoch the
avg_loss agrees within 1e-4, the val accuracies and the lr are equal,
and the grad and param norms agree within 1e-3. Then ``cli.test_image`` on the port's
BEST file (its BatchNorm folded) writes a report CSV byte-identical to
the JAX ``cli.test_image``'s on the JAX BEST directory, and evaluates to
the trainer's own best val accuracy.
"""

import dataclasses
import shutil

import pytest
import torch

from garbage_classification_rca_tpu import config as jconfig
from garbage_classification_rca_tpu.models.image import (
    shufflenet_v2 as jshuffle)
from garbage_classification_rca_tpu_torch import config as tconfig
from garbage_classification_rca_tpu_torch.models.image import (
    shufflenet_v2 as tshuffle)
from garbage_classification_rca_tpu_torch.cli import main_image as port_image
from garbage_classification_rca_tpu_torch.cli import test_image as port_test
from tests.test_torch_conv_backbones import _ref as _conv_ref
from tests.test_torch_conv_train import SHUFFLE_REPEATS
from tests.test_torch_image_eval import _run_cli
from tests.test_torch_unimodal_train import _assert_rows, _run

torch.set_num_threads(2)

SIZE = (64, 64)


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """Each run writes full-size checkpoints: removed after the test."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture()
def train_tree(tiny_dataset, tmp_path):
    import os

    base = tmp_path / "ds"
    os.symlink(tiny_dataset, f"{base}_Train")
    os.symlink(tiny_dataset, f"{base}_Val")
    return str(base)


@pytest.mark.parametrize("name", ["res18", "shuffle_net"])
def test_main_image_conv_matches_jax_cli(name, train_tree, tmp_path,
                                         monkeypatch):
    from garbage_classification_rca_tpu import native
    from garbage_classification_rca_tpu.cli import main_image as jax_cli
    from garbage_classification_rca_tpu.cli import test_image as jax_test

    # the JAX batcher on its PIL + cv2 route, the one the port copies
    monkeypatch.setattr(native, "pad_resize_batch", lambda *a, **k: None)
    monkeypatch.setattr(native, "decode_enabled", lambda: False)
    for table in (jconfig.IMAGE_ARCHS, tconfig.IMAGE_ARCHS):
        monkeypatch.setitem(table, name, dataclasses.replace(
            table[name], input_size=SIZE))
    ckpt = tmp_path / f"{name}.pth"
    with torch.no_grad():
        sd = _conv_ref(name).state_dict()
    if name == "shuffle_net":
        for mod in (jshuffle, tshuffle):
            monkeypatch.setattr(mod, "REPEATS", SHUFFLE_REPEATS)
        sd = {k: v for k, v in sd.items() if not k.startswith("stage") or
              int(k.split(".")[1]) < SHUFFLE_REPEATS[0]}
    torch.save(sd, ckpt)
    argv = [f"--dataset_folder_name={train_tree}", f"--image_model={name}",
            "--epochs=1", "--ft_epochs=1", "--batch_size=4",
            "--batch_size_FT=4", "--acc_steps=2", "--acc_steps_FT=2",
            "--opt=sgd", "--lr=0.001", "--reg=0.03", "--fraction_lr=10",
            "--balance_weights", "--prob_aug=0.0", "--compute_dtype=float32",
            "--data_workers=2", "--tl", f"--model_path={ckpt}"]
    jbest, want = _run(jax_cli.main, argv, tmp_path / "jax", monkeypatch)
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    best, got = _run(port_image.main, argv, tmp_path / "port", monkeypatch)
    _assert_rows(got, want)
    assert (best.best_val_acc, best.best_epoch) == (jbest.best_val_acc,
                                                    jbest.best_epoch)
    payload = torch.load(best.best_path, weights_only=True)
    # no transformer layers: the loader builds the model at its one depth
    assert payload["meta"]["layers"] == 0

    test_argv = [f"--image_model={name}",
                 f"--dataset_folder_name={train_tree}_Val",
                 "--compute_dtype=float32", "--eval_batch_size=8",
                 "--data_workers=2"]
    monkeypatch.delenv("GC_RCA_PLATFORM")
    want_csv = _run_cli(jax_test.main, test_argv + [
        f"--model_path={jbest.best_path}"], tmp_path, monkeypatch,
        "jax_test")
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    got_csv = _run_cli(port_test.main, test_argv + [
        f"--model_path={best.best_path}"], tmp_path, monkeypatch, "port_test")
    assert got_csv == want_csv
    assert got_csv[0].endswith(f"_acc_{best.best_val_acc:.2f}.csv")
