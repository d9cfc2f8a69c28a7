#!/usr/bin/env python3
"""The port's MM-RCA block kernels alone on one card: builds only
``csrc/rca_fused.cu``, prints its registers and spills, then runs
chip_smoke.py's phase-3 checks of K1 (``rca_fused``) and K3
(``rca_fused_bwd``): each route against the plain version, the staged
routes against the per-sample ones bit for bit, both timed
new-old-old-new with each stage kernel's time from the profiler. Prints
the two kernels' report rows as one JSON line and exits non-zero when a
check fails. A quicker loop than the whole smoke test while a kernel of
that source changes.

    python3 tools/check_rca_fused.py

Needs one CUDA device and nvcc.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from garbage_classification_rca_tpu_torch.kernels import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        return cs._fail("CUDA is not available")
    _build.library("rca_fused")          # builds csrc/rca_fused.cu alone
    log = _build._target("rca_fused").with_suffix(".log").read_text()
    for entry, used, spills in cs.ptxas_report(log):
        print(f"  {entry}: {used}; {spills}", flush=True)
    device = torch.device("cuda", 0)
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {}
    ok = cs.check_rca(device, report) & cs.check_rca_bwd(device, report)
    print(json.dumps({k: report[k] for k in ("rca_fused", "rca_fused_bwd")}))
    return 0 if ok else cs._fail("an rca kernel disagrees")


if __name__ == "__main__":
    sys.exit(main())
