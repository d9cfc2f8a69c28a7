#!/usr/bin/env python3
"""Where the BLIP-2 LoRA gradients of the kernel path and the plain paths
part, on the card (full width and depth, chip_smoke's seeded weights and
phase 13's first microbatch).

    python3 tools/vlm_grad_conditioning.py      # one H100, ~2 minutes

For fp32 (a microbatch of 4, TF32 off in matmuls and convolutions) and
bf16 (16), the adapter gradients of ``blip2.lm_loss`` on:
  * the kernel path, twice (is it deterministic?);
  * OPT's flash pair on its plain versions, EVA on K2: the plain side of
    ``chip_smoke.compare_vlm_train_paths``, and its control (the same with
    OPT's query embeddings moved one ulp);
  * the same with EVA on ``mha_reference`` too, and ``mha_reference`` under
    autograd in EVA and OPT (``chip_smoke.plain_versions``);
  * fp32 only: the kernel path against the latter with EVA's patch
    convolution in TF32 (cuDNN's default).
Each pair is printed as the loss's relative difference and, per OPT layer,
the worst adapter gradient: fp32 max |d| over the tensor's largest |g|,
bf16 the cosine; then chip_smoke's check on the same microbatch, with the
kernel path's score over the control's for each gradient that misses the
bar.
"""

from __future__ import annotations

import contextlib
import gc
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from garbage_classification_rca_tpu_torch.cli.blip2_common import (  # noqa: E402
    blip2_config)
from garbage_classification_rca_tpu_torch.data.tokenizer import (  # noqa: E402
    get_tokenizer)
from garbage_classification_rca_tpu_torch.kernels import _build  # noqa: E402
from garbage_classification_rca_tpu_torch.kernels import mha_fused as K  # noqa: E402
from garbage_classification_rca_tpu_torch.models.vlm import (  # noqa: E402
    blip2, blip2_vision)


@contextlib.contextmanager
def eva_attention(fn=None):
    saved = blip2_vision.mha
    blip2_vision.mha = fn or saved
    try:
        yield
    finally:
        blip2_vision.mha = saved


def compare(name, a, b, dtype):
    (la, ga), (lb, gb) = a, b
    per_layer = {}
    pick = max if dtype == torch.float32 else min
    for n, x in ga.items():
        s = c.grad_score(x, gb[n], dtype)
        layer = int(n.split(".")[0])
        per_layer[layer] = pick(per_layer.get(layer, s), s)
    print(f"{str(dtype)[6:]:8s} {name}: loss {la:.6f} / {lb:.6f}, relative "
          f"{abs(la - lb) / abs(lb):.3e}; worst "
          f"{pick(per_layer.values()):.6g}; by layer "
          + " ".join(f"{i}:{v:.2e}" for i, v in sorted(per_layer.items())),
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    _build.library("mha_fused")
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = blip2_config()
    window = c._vlm_train_window(c.VLM_ACC, c.VLM_TRAIN_BATCH,
                                 get_tokenizer("opt"), c.SEED + 271, dev)
    mb16 = {k: v[0] for k, v in window.items()}
    pair = c.flash_pair_plain()
    for dtype, batch in ((torch.float32, c.VLM_TRAIN_FP32_BATCH),
                         (torch.bfloat16, c.VLM_TRAIN_BATCH)):
        fp32 = dtype == torch.float32
        torch.backends.cudnn.allow_tf32 = False
        model = blip2.build_model(cfg, dev, lora=True)
        blip2.init_(model, c.SEED + 240)
        blip2.init_lora_(model.lora, c.SEED + 241, b_std=0.01)
        if not fp32:
            model.cast_(torch.bfloat16, keep_fp32=("lora",))
        model.lora.requires_grad_(True)
        mb = {k: v[:batch] for k, v in mb16.items()}

        def run(opt_fn=None, eva_fn=None, ulp=0.0):
            with c.opt_attention(model, opt_fn, ulp), eva_attention(eva_fn):
                return c._adapter_grads(model, mb, dtype)

        kern, again = run(), run()
        pplain = run(pair)
        control = run(pair, ulp=2.0 ** -23 if fp32 else 2.0 ** -8)
        pplain_eva = run(pair, K.mha_reference)
        plain = run(K.mha_reference, K.mha_reference)
        compare("kernel vs kernel, again", kern, again, dtype)
        compare("kernel vs the pair's plain versions (chip_smoke's)", kern,
                pplain, dtype)
        compare("the control vs the pair's plain versions", control, pplain,
                dtype)
        compare("kernel vs the pair's plain versions, EVA plain", kern,
                pplain_eva, dtype)
        compare("kernel vs mha_reference in EVA and OPT", kern, plain,
                dtype)
        compare("the pair's plain versions vs mha_reference (EVA plain)",
                pplain_eva, plain, dtype)
        if fp32:
            torch.backends.cudnn.allow_tf32 = True
            compare("kernel vs mha_reference in EVA and OPT, TF32 convs",
                    run(), run(K.mha_reference, K.mha_reference), dtype)
            torch.backends.cudnn.allow_tf32 = False
        ok, check = c.compare_vlm_train_paths(model, mb, dtype)
        print(f"{str(dtype)[6:]:8s} chip_smoke's check "
              f"{'ok' if ok else 'FAIL'}: {c._vlm_check_line(check)}")
        print(f"{str(dtype)[6:]:8s} missed the bar, score (control): "
              + " ".join(f"{n} {s:.4g} ({ctl:.4g})" for n, (s, ctl) in
                         check["missed_the_bar"].items()), flush=True)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
