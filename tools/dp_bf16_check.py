"""How far does the bf16 MM-RCA train step move its gradients, on one rank
and over two?

``chip_smoke.py`` phase 19(a) holds the two-rank MM_RCA.sh step to the
one-rank step in fp32 images with TF32 and cuDNN off. This script runs the
same step (``chip_smoke.dp_step_spec``, ``run_dp_step``) in bf16 images
with cuDNN on, the recipe's setting, and compares each run's gradients
with the first one-rank run's:

  (i)   the one-rank step again, from the same weights: does it repeat?
  (ii)  the one-rank step with every normalized image value moved by one
        bf16 ulp, up or down at random (``run_dp_step``'s control);
  (iii) the two-rank step, two processes sharing the card on gloo, each
        with its 16 rows of every microbatch and the batch's global
        BatchNorm statistics (rank 0's all-reduced gradients);
  (iv)  the same pair in fp32 images with cuDNN on: the one-ulp fp32
        control and the two-rank step.

For each it prints the cosine of the whole gradient (every tensor
flattened into one vector), the lowest per-tensor cosines with each
tensor's share of the largest |g|, and the largest per-tensor deviation
(``chip_smoke.dp_card_errors``) with the five tensors that move most.
Ends with one JSON line. Needs one CUDA card (~4 min with the build):

    python3 tools/dp_bf16_check.py
"""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compare(got, want, top=5):
    """Whole-gradient cosine, the `top` lowest per-tensor cosines (name,
    cosine, largest |want| over the largest of all), the largest
    per-tensor deviation and the `top` tensors that move most."""
    import torch
    import torch.nn.functional as F

    import chip_smoke as c

    names = [n for n in want if float(want[n].abs().max()) > 0]
    big = max(float(want[n].abs().max()) for n in names)
    cat = lambda g: torch.cat([g[n].double().flatten()  # noqa: E731
                               for n in names])
    whole = float(F.cosine_similarity(cat(got), cat(want), dim=0))
    per = {n: float(F.cosine_similarity(got[n].double().flatten(),
                                        want[n].double().flatten(), dim=0))
           for n in names}
    low = sorted(per, key=per.get)[:top]
    dev = c.dp_card_errors(got, want)
    worst = sorted(dev, key=dev.get)[-top:][::-1]
    return {"cosine": whole,
            "lowest_tensor_cosines": [
                (n, per[n], float(want[n].abs().max()) / big) for n in low],
            "largest_deviation": dev[worst[0]],
            "moves_most": [(n, dev[n]) for n in worst]}


def main() -> int:
    import torch

    import chip_smoke as c
    from garbage_classification_rca_tpu_torch.kernels import _build
    from garbage_classification_rca_tpu_torch.parallel.mesh import DataMesh

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    print(smi, flush=True)
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda", 0)
    work = os.path.join(ROOT, "runs", "dp_bf16")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = {"card": smi}
    try:
        model, spec = c.dp_step_spec(work)
        init = {k: v.clone() for k, v in model.state_dict().items()}
        paths = []
        for dtype in ("bfloat16", "float32"):
            d = os.path.join(work, dtype)
            os.makedirs(d)
            s = dict(spec, image_dtype=dtype, exact_convs=False, timed=False,
                     out=d)
            model.load_state_dict(init)
            ref = c.run_dp_step(model.to(dev), s, DataMesh(0, 1, dev),
                                control=True)
            runs = {"control": ref["control_grads"]}
            if dtype == "bfloat16":
                model.load_state_dict(init)
                runs["repeat"] = c.run_dp_step(model, s,
                                               DataMesh(0, 1, dev))["grads"]
            model.load_state_dict(init)
            path = os.path.join(d, "spec.pt")
            torch.save(dict(s, model=model.cpu()), path)
            paths.append(path)
            out[dtype] = {"ref": ref, "runs": runs}
        torch.cuda.empty_cache()
        ok, _ = c.dp_launch([os.path.join(ROOT, "chip_smoke.py"),
                             "--dp_step=" + ",".join(paths)], c.DP_RANKS,
                            work, backend="gloo", share_device=True)
        if not ok:
            return 1
        report = {"card": smi}
        for dtype in ("bfloat16", "float32"):
            two = torch.load(os.path.join(work, dtype, "rank0.pt"),
                             weights_only=False)
            ref = out[dtype]["ref"]
            runs = dict(out[dtype]["runs"], two_ranks=two["grads"])
            rows = {}
            for what, grads in runs.items():
                rows[what] = compare(grads, ref["grads"])
                r = rows[what]
                print(f"{dtype} {what}: cosine {r['cosine']:.6f}; lowest "
                      f"per-tensor {r['lowest_tensor_cosines'][:3]}; largest "
                      f"deviation {r['largest_deviation']:.3e}, most "
                      f"{r['moves_most'][:3]}", flush=True)
            rows["loss"] = {"one_rank": ref["loss"],
                            "control": ref["control_loss"],
                            "two_ranks": two["loss"]}
            report[dtype] = rows
        print(json.dumps(report), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    sys.exit(main())
