"""Does ``chip_smoke.py``'s phase 19(a) see a broken data-parallel step?

For each fault named on the command line the script copies this checkout
into a temporary directory, breaks one line of the port there (FAULTS),
and runs phase 19(a) (``chip_smoke._dp_train_step``: the MM_RCA.sh step
at full width over two ranks sharing the card on gloo, against the
one-rank step) from the copy. It prints one JSON line a fault: whether
phase 19(a) ran and held the step, and the numbers it compared. It exits
1 when phase 19(a) holds a broken step, fails on the unbroken copy
("none"), or does not run to its verdict.

    python3 tools/dp_fault_check.py [none] [local_bn] [local_wsum] [local_draws]

The faults: ``local_bn``, train-mode BatchNorm on the rank's own rows;
``local_wsum``, the gradients divided by the rank's own weight sum;
``local_draws``, augmentation, dropout and stochastic depth drawn for the
rank's rows alone. Needs one CUDA card; the kernels are built once, in
this checkout, before the copies are made.
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
        res = subprocess.run([sys.executable, "-c", RUN], cwd=copy,
                             capture_output=True, text=True, timeout=600)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lines = res.stdout.splitlines()
    found = [ln for ln in lines if ln.startswith("RESULT ")]
    out = json.loads(found[-1][7:]) if found else {"held": False}
    out = {"fault": name, "ran": bool(found), "held": out["held"],
           "card": out.get("card"), **{k: out.get(k) for k in NUMBERS}}
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
    _build.build_all()
    ok = True
    for name in names:
        out = run_fault(name)
        print(json.dumps(out), flush=True)
        ok &= out["ran"] and out["held"] == (name == "none")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main(sys.argv[1:]))
