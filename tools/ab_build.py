#!/usr/bin/env python3
"""The port's kernel build, timed three ways on one machine, each a
compile of the three ``csrc/*.cu`` sources, one nvcc a source, all
started together:

  * "pipes": without ``--split-compile``, each nvcc's ``-Xptxas=-v``
    report on a pipe, the pipes read one process after the other (the
    build before ``kernels/_build.py`` wrote the reports to files);
  * "files": without ``--split-compile``, the reports in files (into
    scratch names under ``csrc/build/``);
  * ``_build.build_all()`` without ``--split-compile``, then with it
    (``_build.NVCC_FLAGS``), each followed by chip_smoke.py's phase-3
    checks on its libraries: every kernel against its plain version and
    its time, so that the two builds' kernels can be compared.

    python3 tools/ab_build.py

Needs one CUDA device and nvcc. Exits non-zero when a build or a check
fails.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from garbage_classification_rca_tpu_torch.kernels import _build  # noqa: E402

SPLIT = "--split-compile=0"


def nvcc(name, tag, **out):
    """nvcc for one whole source without --split-compile, into a scratch
    library; `out`: the Popen's stdout / stderr."""
    flags = [f for f in _build.NVCC_FLAGS if f != SPLIT]
    return subprocess.Popen([_build._nvcc(), *flags, "-o",
                             str(_build.BUILD_DIR / f"{tag}_{name}.so"),
                             str(_build.CSRC / f"{name}.cu")], **out)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    pipes = {n: nvcc(n, "pipe", stdout=subprocess.PIPE,
                     stderr=subprocess.STDOUT, text=True)
             for n in _build.sources()}
    for n, p in pipes.items():
        p.communicate()
        print(f"  pipe {n}: {time.perf_counter() - t0:.1f} s rc "
              f"{p.returncode}", flush=True)
    print(f"whole files, pipes: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    left = {}
    for n in _build.sources():
        with open(_build.BUILD_DIR / f"whole_{n}.so.log", "w") as log:
            left[n] = nvcc(n, "whole", stdout=log, stderr=subprocess.STDOUT)
    while left:
        for n, p in list(left.items()):
            if p.poll() is not None:
                del left[n]
                print(f"  whole {n}: {time.perf_counter() - t0:.1f} s rc "
                      f"{p.returncode}", flush=True)
        time.sleep(0.2)
    print(f"whole files: {time.perf_counter() - t0:.1f} s", flush=True)

    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    ok = True
    for label, extra in (("baseline", []), ("split-compile", [SPLIT])):
        _build.NVCC_FLAGS[:] = [f for f in _build.NVCC_FLAGS
                                if f != SPLIT] + extra
        _build._libs.clear()
        t0 = time.perf_counter()
        try:
            _build.build_all()
        except RuntimeError as e:
            print(f"{label}: build failed: {str(e)[:2000]}", flush=True)
            ok = False
            continue
        print(f"{label}: build {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        report = {}
        good = True
        for fn in (cs.check_rca, cs.check_mha, cs.check_rca_bwd,
                   cs.check_mha_train, cs.check_mha_drop,
                   cs.check_postnorm_blocks, cs.check_prenorm_blocks):
            good &= fn(dev, report)
        ok &= good
        print(f"{label}: PHASE 3 ok={good} in {time.perf_counter() - t0:.1f}"
              f" s; " + "; ".join(f"{k} {v.get('ms', float('nan')):.4f} ms"
                                 for k, v in report.items()
                                 if isinstance(v, dict)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
