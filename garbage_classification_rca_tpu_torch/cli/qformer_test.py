"""Q-Former classifier test CLI.

``python -m garbage_classification_rca_tpu_torch.cli.qformer_test
  --model_path=<HF Blip2ForConditionalGeneration .pth>
  --classifier_weights=<MultimodalClassifier .pth: classifier.weight /
  classifier.bias; or a BEST file of cli.qformer_train>
  --dataset_folder_name=<test-root>``

Parity with reference q_former_test_set.py:229-278 through the JAX
package's ``cli/qformer_test.py``: the BLIP-2 backbone (its EVA ViT-g
runs K2 on the card; the OPT tower does not run) and the Linear(768, 4)
head on the Q-Former's first query output; the report goes under
``test_set_reports/qformer/``. Without ``--classifier_weights`` the head
is drawn from ``--seed + 2``. Accuracy divides by the real dataset size.
Runs on CUDA; ``GC_RCA_PLATFORM=cpu`` runs it on the CPU; over N GPUs
with ``torchrun --nproc_per_node=N --mesh_shape=data:N``, and with the OPT
tower sliced over a model axis (``--mesh_shape=data:D,model:M`` over D x M
ranks, as the JAX CLI places it; the tower does not run here). Not ported
yet: the pipe axis (ROADMAP.md queue 1 item 7) and the JAX package's
orbax directories.
"""

from __future__ import annotations

import os

import numpy as np

from .. import NUM_CLASSES
from ..config import args_parser, torch_compute_dtype
from ..data.manifest import build_manifest
from ..eval.report import generate_report_and_image
from ..parallel.mesh import clamp_eval_batch
from ..parallel.multihost import is_primary
from . import check_eval_flags, data_mesh
from .blip2_common import Blip2Batcher, build_blip2, place_blip2, vlm_eval
from .qformer_train import make_eval_step

BASE_PATH = "./test_set_reports"


def load_classifier(path: str, hidden: int):
    """The reference two-file layout: MultimodalClassifier.state_dict()
    (its one Linear is the attribute ``classifier``, q_former_training.py:
    24-47) -> {"w": [hidden, 4], "b": [4]}, the JAX tree's classifier;
    a bare Linear's or another width's file exits with the JAX CLI's
    diagnostics."""
    from ..checkpoint.torch_convert import load_torch_state_dict

    csd = load_torch_state_dict(path)
    if "classifier.weight" not in csd or "classifier.bias" not in csd:
        raise SystemExit(
            f"--classifier_weights {path} does not look like a "
            "MultimodalClassifier state_dict (expected keys "
            "'classifier.weight'/'classifier.bias', found "
            f"{sorted(csd)[:8]}) — was it saved via "
            "q_former_training.py:33-47?")
    if tuple(csd["classifier.weight"].shape) != (NUM_CLASSES, hidden):
        raise SystemExit(
            f"--classifier_weights expects Linear({hidden}, {NUM_CLASSES}) "
            f"but {path} has weight shape "
            f"{tuple(csd['classifier.weight'].shape)} — trained against a "
            "different Q-Former width or class count?")
    return {"w": np.asarray(csd["classifier.weight"]).T,
            "b": np.asarray(csd["classifier.bias"])}


def evaluate(args):
    """(acc %, labels, preds, stats) of the test folder."""
    check_eval_flags(args, allowed=("model",))
    if args.classifier_weights and os.path.isdir(args.classifier_weights):
        raise SystemExit("orbax checkpoint directories are not read by the "
                         "PyTorch port yet (ROADMAP.md); pass the "
                         "reference MultimodalClassifier .pth")
    mesh = data_mesh(args, allowed=("model",))
    device = mesh.device
    dtype = torch_compute_dtype(args.compute_dtype)
    cfg, model, tok = build_blip2(args, device, dtype, with_lora=False,
                                  classifier=True)
    if args.classifier_weights and os.path.isfile(args.classifier_weights):
        from ..checkpoint.from_jax import load_jax_tree
        from ..train.engine import load_checkpoint

        best = load_checkpoint(args.classifier_weights)
        if best is not None:                  # cli.qformer_train's BEST
            model.classifier.load_state_dict(best["state_dict"])
        else:
            load_jax_tree(model.classifier, load_classifier(
                args.classifier_weights, cfg.qformer.hidden),
                allow_skipped=())
    place_blip2(model, mesh)
    m = build_manifest(args.dataset_folder_name)
    print(f"Num of test images: {len(m)}")
    b = Blip2Batcher(m, tok, workers=args.data_workers)
    try:
        return vlm_eval(make_eval_step(model, dtype), b, clamp_eval_batch(
            args.eval_batch_size or 16, len(m), mesh), device,
            prefetch_depth=args.prefetch_depth, mesh=mesh)
    finally:
        b.close()


def main(argv=None):
    args = args_parser(argv)
    acc, labels, preds, _ = evaluate(args)
    if not is_primary():
        return acc
    report = generate_report_and_image(
        labels, preds, acc, os.path.join(BASE_PATH, "qformer"), "qformer",
        kind="qformer")
    print(f"Test accuracy: {acc:.2f} %")
    print(report)
    return acc


if __name__ == "__main__":
    main()
