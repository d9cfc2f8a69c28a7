"""Do the parallel checks see a broken step?

For each fault named on the command line the script copies this checkout
into a temporary directory, breaks one line of the port there (FAULTS),
and runs the check that should see it from the copy. It prints one JSON
line a fault: whether the check ran and held the step, and the numbers it
compared. It exits 1 when a check holds a broken step, fails on an
unbroken copy ("none", "tp_none"), or does not run to its verdict.

    python3 tools/dp_fault_check.py [none] [local_bn] [local_wsum] \
        [local_draws] [tp_none] [tp_bias_per_rank] [tp_no_f] [tp_b_block0]

The data axis, on the card: ``chip_smoke.py``'s phase 19(a)
(``chip_smoke._dp_train_step``: the MM_RCA.sh step at full width over two
ranks sharing the card on gloo, against the one-rank step). ``local_bn``,
train-mode BatchNorm on the rank's own rows; ``local_wsum``, the
gradients divided by the rank's own weight sum; ``local_draws``,
augmentation, dropout and stochastic depth drawn for the rank's rows
alone. Needs one CUDA card; the kernels are built once, in this
checkout, before the copies are made.

The model axis, on the CPU: ``tests/test_torch_tp.py``'s LoRA step (the
tiny BLIP-2, fp32, acc 2, HF dropout on) over two gloo ranks at
``model:2`` against one process, at its bars (loss 1e-5, every adapter
gradient 1e-4 of its tensor's largest |g|). ``tp_bias_per_rank``, the
row-parallel bias added on each rank before the all-reduce (it counts M
times); ``tp_no_f``, Megatron's *f* left out (the gradient of a
column-parallel input is not summed over the model group);
``tp_b_block0``, LoRA's ``b`` not sliced by rank (every rank adds the
first block of its columns).
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "garbage_classification_rca_tpu_torch"
FAULTS = {
    "none": None,
    "local_bn": (f"{PKG}/nn/core.py", "if train and _SHARD is not None:",
                 "if train and False:"),
    "local_wsum": (f"{PKG}/train/loop.py",
                   "all_reduce_sum_([p.grad for p in plain] + [sums, weights])",
                   "all_reduce_sum_([p.grad for p in plain] + [sums])"),
    "local_draws": (f"{PKG}/nn/core.py",
                    "    if _SHARD is None:\n        return draw(",
                    "    if True:\n        return draw("),
    "tp_none": None,
    "tp_bias_per_rank": (
        f"{PKG}/parallel/tp.py",
        "y = reduce_from_model(F.linear(x, lin.w.to(x.dtype)), shard)",
        "y = reduce_from_model(F.linear(x, lin.w.to(x.dtype), "
        "lin.b.to(x.dtype)), shard) - lin.b.to(x.dtype)"),
    "tp_no_f": (f"{PKG}/parallel/tp.py",
                "if not torch.is_grad_enabled() or not x.requires_grad:",
                "if True:"),
    "tp_b_block0": (f"{PKG}/models/vlm/opt.py",
                    "b = pair.b[:, p.tp.cols(pair.b.shape[1])]",
                    "b = pair.b[:, :pair.b.shape[1] // p.tp.size]"),
}
NUMBERS = ("loss_diff", "grad_worst", "grad_bar", "state_worst", "state_bar",
           "control_grad_worst", "control_state_worst",
           "grad_worst_own_scale", "launches_per_rank")
RUN = r"""
import json, os, subprocess, torch
import chip_smoke as c
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip()
torch.set_grad_enabled(False)
torch.backends.cuda.matmul.allow_tf32 = False
work = os.path.abspath(os.path.join("runs", "dp_fault"))
os.makedirs(work)
r = {}
held = c._dp_train_step(torch.device("cuda", 0), r, work, smi)
print("RESULT " + json.dumps({**r.get("dp_step", {}), "held": bool(held),
                              "card": smi}), flush=True)
"""
RUN_TP = r"""
import json, os, pathlib, tempfile, torch
from garbage_classification_rca_tpu_torch.parallel.mesh import DataMesh
from tests.test_torch_multihost import launch_script
from tests.test_torch_tp import (GRAD_BAR, LOSS_BAR, VOCAB, WORKER,
                                 _grad_errors, lora_step)
bpe = os.path.join(VOCAB, "bpe")
one = lora_step(DataMesh(0, 1), bpe)
d = pathlib.Path(tempfile.mkdtemp(prefix="tp_fault_"))
torch.save({"axes": {"model": 2}, "decoder": None, "bpe": bpe}, d / "spec.pt")
launch_script(d, WORKER, [d / "spec.pt"], nproc=2)
got = torch.load(d / "rank0.pt", weights_only=False)["lora"]
errs = _grad_errors(got["grads"], one["grads"])
loss_d = abs(got["loss"] - one["loss"])
loss_bar = LOSS_BAR * max(1.0, abs(one["loss"]))
print("RESULT " + json.dumps({
    "held": loss_d <= loss_bar and max(errs.values()) <= GRAD_BAR,
    "loss_diff": loss_d, "loss_bar": loss_bar,
    "grad_worst": max(errs.values()), "grad_bar": GRAD_BAR,
    "worst": sorted(errs, key=errs.get)[-3:]}), flush=True)
"""
TP_NUMBERS = ("loss_diff", "loss_bar", "grad_worst", "grad_bar", "worst")


def _ignored_names():
    """The names ``.gitignore`` lists without a path (run outputs, caches;
    the kernel build, listed by its path, is copied and reused)."""
    with open(os.path.join(ROOT, ".gitignore")) as f:
        names = [ln.strip().rstrip("/") for ln in f]
    return [n for n in names if n and not n.startswith("#") and "/" not in n]


def run_fault(name: str) -> dict:
    tmp = tempfile.mkdtemp(prefix="dp_fault_")
    copy = os.path.join(tmp, "repo")
    try:
        shutil.copytree(ROOT, copy, ignore=shutil.ignore_patterns(
            ".git", *_ignored_names()))
        if FAULTS[name] is not None:
            rel, old, new = FAULTS[name]
            path = os.path.join(copy, rel)
            with open(path) as f:
                src = f.read()
            if src.count(old) != 1:
                raise SystemExit(f"{name}: the line to break is not in {rel}")
            with open(path, "w") as f:
                f.write(src.replace(old, new))
        tp = name.startswith("tp_")
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=copy)
        res = subprocess.run([sys.executable, "-c", RUN_TP if tp else RUN],
                             cwd=copy, capture_output=True, text=True,
                             timeout=600, env=env)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lines = res.stdout.splitlines()
    found = [ln for ln in lines if ln.startswith("RESULT ")]
    out = json.loads(found[-1][7:]) if found else {"held": False}
    out = {"fault": name, "ran": bool(found), "held": out["held"],
           **({} if tp else {"card": out.get("card")}),
           **{k: out.get(k) for k in (TP_NUMBERS if tp else NUMBERS)}}
    if not found:
        out["rc"] = res.returncode
        out["tail"] = (lines + res.stderr.splitlines())[-20:]
    return out


def main(argv) -> int:
    from garbage_classification_rca_tpu_torch.kernels import _build

    names = argv or list(FAULTS)
    unknown = [n for n in names if n not in FAULTS]
    if unknown:
        raise SystemExit(f"unknown faults {unknown}; known: {list(FAULTS)}")
    if any(not n.startswith("tp_") for n in names):
        _build.build_all()
    ok = True
    for name in names:
        out = run_fault(name)
        print(json.dumps(out), flush=True)
        ok &= out["ran"] and out["held"] == (FAULTS[name] is None)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main(sys.argv[1:]))
