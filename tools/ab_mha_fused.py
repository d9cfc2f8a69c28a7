#!/usr/bin/env python3
"""A/B of variants of the port's ``csrc/mha_fused.cu`` on one card, in one
process: the flash pair's tensor-core route (K4a ``mha_fwd_lse`` / K4b
``mha_flash_bwd``, bf16, head dim 64) at the ViT-B/16 train shape, the
CUDA-core kernels of the same source at chip_smoke.py's phase-3 shapes
(K2 ``mha`` bf16 128x64x768; the fp32 pair 16x64x768; K7a / K7b fp32
128x64x768, p 0.1; all key-masked), and, where the source has them, K2's
tensor-core route (128x64x768 masked, 128x197x768 unmasked) and the fp32
training pair's 3xTF32 routes (K4a / K4b 16x64x768 and 128x64x768, K7a /
K7b 128x64x768, p 0.1). The 3xTF32 forward of each source that has it is
first held to the plain forward (out and lse within 1e-5 + 1e-5 |x|,
bit-identical over two runs) at those shapes and at 4x50x768 causal.

    python3 tools/ab_mha_fused.py tree DIR [DIR ...]

``tree`` is the package's own ``csrc/``; each DIR holds another
``mha_fused.cu`` (and the headers it includes), e.g. a parent commit's.
Each is built with the package's nvcc flags (all at once), its registers
and spills printed, held to the plain pair (128x197x768 unmasked under
chip_smoke.py's bf16 limits, bit-identical gradients over two runs, and
four masked / causal edge cases under its edge limits; a source without
the tensor-core route is timed on its CUDA-core kernels only), then timed
with CUDA graphs (chip_smoke.time_ms, median of 5) in the order given and
again in reverse, so every variant is read twice around the others. Needs
one CUDA device and nvcc.
"""

import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from garbage_classification_rca_tpu_torch.kernels import _build  # noqa: E402
from garbage_classification_rca_tpu_torch.kernels import mha_fused as K  # noqa: E402


def build(dirs):
    procs = {}
    for d in dirs:
        src = os.path.join(_build.CSRC if d == "tree" else d, "mha_fused.cu")
        out = os.path.join(_build.BUILD_DIR, f"ab_{len(procs)}.so")
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        procs[d] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for d, (out, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {d}:\n{log[-3000:]}")
        for entry, used, spills in cs.ptxas_report(log):
            if "(tc" in entry:
                print(f"{d}: {entry}: {used}; {spills}", flush=True)
        libs[d] = ctypes.CDLL(out)
    return libs


def _kernel_calls(gen, dev):
    """{name: (call, reps, needs)} at phase 3's shapes: the CUDA-core
    kernels (K2 bf16 128x64x768 and the fp32 pair 16x64x768, key-masked;
    K7a / K7b fp32 128x64x768, p 0.1) and the routes of this tree that a
    parent's source may lack (`needs`: the C entry): K2 on the tensor cores
    at 128x64x768 masked and 128x197x768 unmasked, the fp32 backward on
    3xTF32 (K4b 16x64x768, K7b 128x64x768)."""
    from garbage_classification_rca_tpu_torch.nn.core import Key

    def inputs(b, n, dtype, count):
        return [torch.randn((b, n, 768), generator=gen).to(dev, dtype)
                for _ in range(count)]

    q2, k2, v2 = inputs(128, 64, torch.bfloat16, 3)
    m2 = cs._mask(128, 64, gen, dev)
    q9, k9, v9 = inputs(128, 197, torch.bfloat16, 3)
    q4, k4, v4, do4 = inputs(16, 64, torch.float32, 4)
    m4 = cs._mask(16, 64, gen, dev)
    o4, lse4 = K.mha_fwd_lse_reference(q4, k4, v4, heads=12, mask=m4)
    q7, k7, v7, do7 = inputs(128, 64, torch.float32, 4)
    m7 = cs._mask(128, 64, gen, dev)
    dm = K.drop_keep_mask(Key(7), 0.1, 128, 12, 64, dev)
    kw = dict(heads=12, keep=0.9, mask=m7)
    o7, lse7 = K.mha_fwd_lse_drop_reference(q7, k7, v7, dm, **kw)
    o8, lse8 = K.mha_fwd_lse_reference(q7, k7, v7, heads=12, mask=m7)
    plan = {(name, x.shape): K.flash_plan(x.shape, 12, x.dtype, dropout=drop,
                                          route=route)
            for name, x, drop, route in (
                ("old", q4, False, "cuda_core"), ("new", q4, False, "tc32"),
                ("old", q7, True, "cuda_core"), ("new", q7, True, "tc32"))}
    p4 = lambda name: plan[(name, q4.shape)]
    p7 = lambda name: plan[(name, q7.shape)]
    return {
        "mha bf16 128x64x768 (CUDA cores)": (
            lambda: K.mha(q2, k2, v2, heads=12, mask=m2, route="cuda_core"),
            20, None),
        "mha_fwd_lse fp32 16x64x768 (CUDA cores)": (
            lambda: K.launch_fwd_lse(p4("old"), q4, k4, v4, heads=12,
                                     mask=m4), 20, None),
        "mha_fwd_lse fp32 128x64x768 (CUDA cores)": (
            lambda: K.launch_fwd_lse(K.flash_plan(
                q7.shape, 12, q7.dtype, route="cuda_core"), q7, k7,
                v7, heads=12, mask=m7), 20, None),
        "mha_fwd_lse tc32 fp32 16x64x768": (
            lambda: K.launch_fwd_lse(p4("new"), q4, k4, v4, heads=12,
                                     mask=m4), 20, "mha_forward_lse_tc32"),
        "mha_fwd_lse tc32 fp32 128x64x768": (
            lambda: K.launch_fwd_lse(K.flash_plan(
                q7.shape, 12, q7.dtype, route="tc32"), q7, k7, v7, heads=12,
                mask=m7), 20, "mha_forward_lse_tc32"),
        "mha_fwd_lse_drop tc32 fp32 128x64x768": (
            lambda: K.launch_fwd_lse_drop(p7("new"), q7, k7, v7, dm, **kw),
            20, "mha_forward_lse_tc32"),
        "mha_flash_bwd fp32 16x64x768 (CUDA cores)": (
            lambda: K.launch_flash_bwd(p4("old"), q4, k4, v4, o4, do4, lse4,
                                       heads=12, mask=m4), 20, None),
        "mha_fwd_lse_drop fp32 128x64x768 (CUDA cores)": (
            lambda: K.launch_fwd_lse_drop(p7("old"), q7, k7, v7, dm, **kw),
            20, None),
        "mha_flash_bwd_drop fp32 128x64x768 (CUDA cores)": (
            lambda: K.launch_flash_bwd_drop(p7("old"), q7, k7, v7, o7, do7,
                                            lse7, dm, **kw), 20, None),
        "mha tc bf16 128x64x768": (
            lambda: K.mha(q2, k2, v2, heads=12, mask=m2, route="tc"), 20,
            "mha_forward_tc"),
        "mha tc bf16 128x197x768 unmasked": (
            lambda: K.mha(q9, k9, v9, heads=12, route="tc"), 20,
            "mha_forward_tc"),
        "mha_flash_bwd tc32 fp32 16x64x768": (
            lambda: K.launch_flash_bwd(p4("new"), q4, k4, v4, o4, do4, lse4,
                                       heads=12, mask=m4), 20,
            "mha_flash_backward_tc32"),
        "mha_flash_bwd tc32 fp32 128x64x768 (no dropout)": (
            lambda: K.launch_flash_bwd(
                K.flash_plan(q7.shape, 12, q7.dtype), q7, k7, v7, o8, do7,
                lse8, heads=12, mask=m7), 20, "mha_flash_backward_tc32"),
        "mha_flash_bwd_drop tc32 fp32 128x64x768": (
            lambda: K.launch_flash_bwd_drop(p7("new"), q7, k7, v7, o7, do7,
                                            lse7, dm, **kw), 20,
            "mha_flash_backward_tc32")}


def _tc32_forward_cases(gen, dev):
    """(q, k, v, mask, keep mask or None, keep, causal) at the 3xTF32
    forward's main shapes and a causal edge case."""
    from garbage_classification_rca_tpu_torch.nn.core import Key

    out = []
    for b, n, p, causal in ((16, 64, 0.0, False), (128, 64, 0.0, False),
                            (128, 64, 0.1, False), (4, 50, 0.1, True)):
        q, k, v = (torch.randn((b, n, 768), generator=gen).to(dev)
                   for _ in range(3))
        m = cs._mask(b, n, gen, dev)
        m[-1] = 0
        dm = K.drop_keep_mask(Key(b + n), p, b, 12, n, dev) if p else None
        out.append((q, k, v, m, dm, 1.0 - p, causal))
    return out


def check_tc32_forward(cases):
    """The 3xTF32 forward of the loaded source against the plain forward:
    (max error, ok)."""
    worst, ok = 0.0, True
    for q, k, v, m, dm, keep, causal in cases:
        kw = dict(heads=12, mask=m, causal=causal)
        if dm is None:
            plan = K.flash_plan(q.shape, 12, q.dtype, route="tc32")
            run = lambda: K.launch_fwd_lse(plan, q, k, v, **kw)
            want = K.mha_fwd_lse_reference(q, k, v, **kw)
        else:
            plan = K.flash_plan(q.shape, 12, q.dtype, dropout=True)
            run = lambda: K.launch_fwd_lse_drop(plan, q, k, v, dm, keep=keep,
                                                **kw)
            want = K.mha_fwd_lse_drop_reference(q, k, v, dm, keep=keep, **kw)
        got, again = run(), run()
        torch.cuda.synchronize()
        ok &= all(torch.equal(x, y) for x, y in zip(got, again))
        for x, y in zip(got, want):
            e, good = cs.max_err_ok(x, y, torch.float32, "mha")
            worst, ok = max(worst, e), ok and good
    return worst, ok


def main(dirs):
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    libs = build(dirs)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    b, n, d, h = 128, 197, 768, 12
    q, k, v, do = (torch.randn((b, n, d), generator=gen).to(dev, torch.bfloat16)
                   for _ in range(4))
    edges = []
    for eb, en, masked, causal in ((4, 65, True, True), (4, 197, True, False),
                                   (4, 256, False, True), (4, 17, True, True)):
        x = [torch.randn((eb, en, 256), generator=gen).to(dev, torch.bfloat16)
             for _ in range(4)]
        m = cs._mask(eb, en, gen, dev) if masked else None
        if m is not None:
            m[-1] = 0
        edges.append((x, m, causal))
    plan = K.flash_plan(q.shape, h, q.dtype)
    tc = {name: hasattr(lib, "mha_forward_lse_tc")
          for name, lib in libs.items()}
    others = _kernel_calls(gen, dev)
    fwd_cases = _tc32_forward_cases(gen, dev)
    ok_all = True
    for name, lib in libs.items():
        _build._libs["mha_fused"] = lib
        if hasattr(lib, "mha_forward_lse_tc32"):
            e, ok = check_tc32_forward(fwd_cases)
            ok_all &= ok
            print(f"{name}: 3xTF32 forward max|d| {e:.3e}, within 1e-5 + "
                  f"1e-5|x| and bit-identical over two runs: "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
        if not tc[name]:
            continue
        o, lse, g = cs._flash_pair(plan, q, k, v, do, h)
        again = cs._flash_pair(plan, q, k, v, do, h)[2]
        torch.cuda.synchronize()
        e_f, e_b, ok = cs._held_to_plain(q, k, v, do, h, None, False, o, lse,
                                         g)
        same = all(torch.equal(x, y) for x, y in zip(g, again))
        for x, m, causal in edges:
            p = K.flash_plan(x[0].shape, 4, x[0].dtype)
            out = cs._flash_pair(p, *x, 4, m, causal)
            torch.cuda.synchronize()
            ok &= cs._held_to_plain(*x, 4, m, causal, *out, edge=True)[2]
        ok_all &= ok and same
        print(f"{name}: fwd max|d| {e_f:.3e}, bwd {e_b:.3e}, edge cases and "
              f"limits {'ok' if ok else 'FAIL'}, gradients bit-identical "
              f"over two runs: {same}", flush=True)
    times = {name: {} for name in libs}
    for name in list(libs) + list(reversed(list(libs))):
        _build._libs["mha_fused"] = libs[name]
        calls = {k: (fn, reps) for k, (fn, reps, needs) in others.items()
                 if needs is None or hasattr(libs[name], needs)}
        if tc[name]:
            calls["mha_fwd_lse tc bf16 128x197x768"] = (
                lambda: K.launch_fwd_lse(plan, q, k, v, heads=h), 5)
            calls["mha_flash_bwd tc bf16 128x197x768"] = (
                lambda: K.launch_flash_bwd(plan, q, k, v, o, do, lse,
                                           heads=h), 5)
        for call, (fn, reps) in calls.items():
            times[name].setdefault(call, []).append(
                cs.time_ms(fn, reps=reps)[0])
    for name, rows in times.items():
        for call, ms in rows.items():
            print(f"{name}: {call}: {ms} ms (in the order given, then "
                  f"reversed)", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["tree"]))
