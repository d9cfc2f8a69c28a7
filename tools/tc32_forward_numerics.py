#!/usr/bin/env python3
"""How far the fp32 training forward's 3xTF32 products sit from the fp32
forward bar (1e-5 + 1e-5 |x| on out and lse), on the CPU, against the
Pallas ``_mha_fwd_lse`` / ``_mha_fwd_lse_drop`` of the JAX package in
interpret mode, at 32 x 64 x 768 (12 heads of 64): the cases of
``tests/test_torch_mha_routes.py::test_3xtf32_forward_holds_the_fp32_bar_
against_jax`` and more, with q and k scaled so that the largest |S| reaches
about 5, 30 and 35. Each row prints max |d| / bar (at most 1 within the
bar) for out and lse, of:

  * k8:     the kernel's order (``_mm_k8``: one fp32 accumulator, each k8
            step adding lo.hi, hi.lo, hi.hi, as exact 8-term sums rounded
            once; wld V over each 32-key half, the halves added);
  * 3mm:    the three passes each taken as its own fp32 matmul
            (``_mm_3xtf32``, the backward test's emulation);
  * fp64:   S and wld V in fp64, each rounded once to fp32;
  * 1xTF32: one TF32 pass (hi.hi alone);
  * plain:  the port's plain forward (torch's fp32 matmul).

    JAX_PLATFORMS=cpu python tools/tc32_forward_numerics.py

Needs the JAX package and its interpret mode; runs in about a minute.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from garbage_classification_rca_tpu.kernels import mha_fused as jmha  # noqa: E402
from garbage_classification_rca_tpu_torch.kernels import mha_fused as K  # noqa: E402
from test_torch_mha_routes import (  # noqa: E402
    _fwd_bar_excess, _fwd_emulated, _inputs, _mm_3xtf32, _mm_k8, _mm_tf32)


def _fp64(a, b):
    return (a.double() @ b.double()).float()


def main():
    b, n, d, heads = 32, 64, 768, 12
    products = {
        "k8": (_mm_k8, lambda a, c: _mm_k8(a, c, halves=2)),
        "3mm": (_mm_3xtf32, _mm_3xtf32), "fp64": (_fp64, _fp64),
        "1xTF32": (_mm_tf32, _mm_tf32)}
    for amp in (1.0, 2.4, 2.6):
        for masked, causal, p in ((True, False, 0.1), (False, True, 0.0),
                                  (False, False, 0.1)):
            q, k, v, _, m = _inputs(b, n, d, 31 + causal,
                                    fully_masked=masked and not causal)
            q, k = q * np.float32(amp), k * np.float32(amp)
            jm = jnp.asarray(m) if masked else None
            tm = torch.from_numpy(m) if masked else None
            jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
            kw = dict(heads=heads, scale=0.125, mask=jm, causal=causal,
                      interpret=True)
            if p:
                jdm = jmha._drop_keep_mask(jax.random.PRNGKey(5), p, b,
                                           heads, n)
                want = jmha._mha_fwd_lse_drop(jq, jk, jv, jdm, keep=1.0 - p,
                                              **kw)
                dm = torch.from_numpy(np.array(jdm))
            else:
                want = jmha._mha_fwd_lse(jq, jk, jv, **kw)
                dm = None
            args = [torch.from_numpy(a) for a in (q, k, v)] + [dm]
            opts = dict(heads=heads, keep=1.0 - p, mask=tm, causal=causal)
            s_max = float((K._heads(args[0], heads) @ K._heads(
                args[1], heads).transpose(-1, -2)).abs().max()) * 0.125
            got = {name: _fwd_emulated(ms, mo, *args, **opts)
                   for name, (ms, mo) in products.items()}
            got["plain"] = (K.mha_fwd_lse_drop_reference(*args, **opts) if p
                            else K.mha_fwd_lse_reference(
                                *args[:3], heads=heads, mask=tm,
                                causal=causal))
            cols = ", ".join(
                f"{name} {_fwd_bar_excess(o, want[0]):.3f} / "
                f"{_fwd_bar_excess(lse, want[1]):.3f}"
                for name, (o, lse) in got.items())
            print(f"|S| max {s_max:5.1f} masked={masked!s:5s} "
                  f"causal={causal!s:5s} p={p}: {cols}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
