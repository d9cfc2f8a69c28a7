"""Image-model test-set evaluation CLI.

``python -m garbage_classification_rca_tpu_torch.cli.test_image
  --image_model=transformer_B16 --model_path=<ckpt.pth>
  --dataset_folder_name=<test-root>``
loads the reference ``.pth`` (or a BEST file of the port's
``cli.main_image``), evaluates the test folder, prints accuracy +
report, and writes the confusion-matrix PNG + report CSV under
``test_set_reports/<arch>/``. The images are normalized on the device and
the forward runs in ``--compute_dtype`` (ViT's encoder layers are the fused
pre-norm block kernels where the shape fits; the conv backbones are cuDNN
convolutions and PyTorch ops, their BatchNorm folded into the convs first,
in fp32). Same flags as the JAX package's ``cli/test_image.py``; over N
GPUs with ``torchrun --nproc_per_node=N --mesh_shape=data:N`` (rank 0
writes the report); the other mesh axes, orbax checkpoint directories and
``--profile_dir`` are not ported yet. Runs on CUDA;
``GC_RCA_PLATFORM=cpu`` runs it on the CPU. Image models: transformer_B16,
transformer_L16, shuffle_net, res18, res50, res152, mb, convnext, b0, b4,
b5, eff_v2_small, eff_v2_medium, eff_v2_large.
"""

from __future__ import annotations

import os
import sys

from ..config import IMAGE_ARCHS, args_parser, torch_compute_dtype
from ..data.manifest import build_manifest
from ..data.pipeline import ImageTextBatcher
from ..eval.harness import run_image_eval
from ..eval.report import generate_report_and_image
from ..models.registry import get_image_model
from ..nn.fold import fold_batchnorm
from ..parallel.mesh import clamp_eval_batch
from ..parallel.multihost import is_primary
from ..utils.dtype import resolve_param_dtype
from . import (check_eval_flags, data_mesh, load_unimodal_model,
               resolve_model)

BASE_PATH = "./test_set_reports"


def evaluate(args):
    """Build the model the flags name, load its weights and evaluate the
    test folder: (acc %, labels, preds, stats, manifest)."""
    mdef = resolve_model(get_image_model, args.image_model)
    check_eval_flags(args)
    if args.profile_dir:
        raise NotImplementedError(
            "--profile_dir is not ported to PyTorch yet (ROADMAP.md, queue "
            "1 item 3); chip_smoke.py profiles the image eval path")
    spec = IMAGE_ARCHS[args.image_model]
    mesh = data_mesh(args)
    device = mesh.device
    print(f"Image Model: {args.image_model}")
    model = load_unimodal_model(mdef, args.model_path,
                                f"--image_model={args.image_model}", device)
    if "bn_eps" in mdef.extras:
        # inference-time conv + BN folding, for the models that have BN
        fold_batchnorm(model, mdef.extras["bn_eps"])
    model.to(resolve_param_dtype(args, args.compute_dtype))

    manifest = build_manifest(args.dataset_folder_name)
    print(f"Num of test images: {len(manifest)}")
    batch_size = clamp_eval_batch(args.eval_batch_size or spec.eval_batch,
                                  len(manifest), mesh)
    batcher = ImageTextBatcher(manifest, spec.input_size,
                               workers=args.data_workers)
    try:
        return run_image_eval(
            model, batcher, batch_size, device,
            torch_compute_dtype(args.compute_dtype),
            prefetch_depth=args.prefetch_depth, mesh=mesh) + (manifest,)
    finally:
        batcher.close()


def main(argv=None):
    args = args_parser(argv)
    if args.model_path == "":
        print("Please provide test model path")
        sys.exit(0)   # exit code 0 is reference-faithful
    acc, labels, preds, stats, manifest = evaluate(args)
    if not is_primary():
        return acc
    print(f"\nsamples checked for test: {stats['n']}")
    print(f"eval throughput: {stats['samples_per_s']:.1f} samples/s "
          f"(p50 step {stats['p50_step_s'] * 1e3:.1f} ms)")
    report = generate_report_and_image(
        labels, preds, acc, os.path.join(BASE_PATH, args.image_model),
        args.image_model, kind="image")
    print(manifest.class_to_idx)
    print(f"Test accuracy: {acc:.2f} %")
    print("Test Report:")
    print(report)
    return acc


if __name__ == "__main__":
    main()
