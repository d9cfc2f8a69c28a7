#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (garbage_classification_rca_tpu_torch).

    python3 chip_smoke.py        # needs one NVIDIA GPU; ~4 minutes

Phases, each of which fails the run when it fails:
  1. device: the card's name and power limit;
  2. build: nvcc compiles every csrc/*.cu for sm_90a, one process per
     source, all started together;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the main paths' shapes and edge cases, with the tolerances below;
     kernel / plain / library-call times from CUDA graphs timed with CUDA
     events after a warm-up (median of 5);
  4. eval: the MM-RCA eval path (EfficientNetV2-M at 480x480, 6-layer
     DistilBERT at seq 64, the MM-RCA block, eval batch 128, bf16) with
     random seeded weights over synthetic batches through ``run_eval``;
     launch counters zeroed before and read after that run; logits against
     the same model on the plain versions; samples/s, p50 batch latency,
     peak memory;
  5. train: the MM_RCA.sh recipe at full width (fp32 master weights, bf16
     images, batch 16 x acc_steps 10, SGD lr 0.0016 reg 0.03, class
     weights, augmentation p=1.0, head dropout 0.6, stochastic depth) —
     three optimizer steps all trainable and one with the phase-1 mask,
     launch counters read around them (per microbatch: K1 1, K3 1, K4a 6,
     K4b 6); steps/s, samples/s, peak memory, a profiler breakdown; one
     more step with ``hf_internal_dropout`` (per microbatch K1 1, K3 1,
     K7a 6, K7b 6); microbatches' loss and gradients on the kernel path
     against the plain path; then ``cli.main_both`` with the MM_RCA.sh flags for 1 + 1
     epochs on a synthetic 480x480 JPEG tree and ``cli.test_both`` on its
     BEST checkpoint;
  6. text eval: BERT-base at full width and depth (12 layers, seq 64,
     batch 256, bf16, random seeded weights, WordPiece ids) through
     ``run_eval`` with ``cli.test_text``'s step: launches per batch K5a 12,
     K5b 12, K2 0; logits against the plain path (bf16, and fp32 with TF32
     off); samples/s, p50, peak memory, a profiler breakdown; one batch
     each of DistilBERT (6 + 6 launches) and RoBERTa (12 + 12);
  7. image eval: ViT-B/16 at full width and depth (batch 64, 224x224,
     bf16) through ``run_image_eval``: K6a 12 and K6b 12 per batch, the
     same readings; then ``cli.test_text`` (DistilBERT) and
     ``cli.test_image`` (ViT-B/16) evaluate reference-layout ``.pth`` files
     on a synthetic JPEG tree;
  8. text train: the DistilBERT classifier at full width and depth (batch
     128, seq 64, fp32, SGD, head dropout 0.6, class weights) with
     ``--hf_internal_dropout``: three steps all trainable and one head
     only, per microbatch K7a 6, K7b 6, K4a 0, K4b 0; a step with the flag
     off (K4a 6, K4b 6, K7 0); a step of BERT-base with the flag (12 + 12);
     one microbatch's loss and gradients on the kernel path against the
     plain path from the same key; steps/s, samples/s, peak memory, a
     profiler breakdown; then ``cli.main_text --hf_internal_dropout`` for
     1 + 1 epochs on a synthetic tree and ``cli.test_text`` on its BEST
     file;
  9. image train: ViT-B/16 at full width and depth (batch 128, 224x224,
     bf16 images over fp32 master weights, augmentation p=1.0): K4a 12 and
     K4b 12 per microbatch, the same readings; ``cli.main_image`` ->
     ``cli.test_image``.

Prints a ``{"kernels": [...]}`` line, the nvidia-smi name/power line, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero, with
no result line, when CUDA is absent or any phase fails.

Tolerances (kernel vs plain version, same inputs, same card):
  * fp32: rca_fused |d| <= 2e-5 + 2e-5|x| (the JAX package's bar for this
    kernel); mha and mha_fwd_lse |d| <= 1e-5 + 1e-5|x|. They compute in
    fp32 and differ only in summation order. The backward kernels
    (rca_fused_bwd, mha_flash_bwd): |d| <= 5e-5 (1 + |x|), the JAX
    package's backward bar. The dropout pair (mha_fwd_lse_drop,
    mha_flash_bwd_drop) is held to its plain pair's limits, fp32 and bf16,
    on the same keep mask.
  * bf16: |d| <= one bf16 ulp of the value + 1e-5 (rca_fused: fp32 math,
    one final rounding that may land on either neighbour) and + 1e-3 for
    mha (its softmax weights are rounded to bf16 before the PV product,
    and a weight that rounds to the neighbouring bf16 value moves the
    output by at most its ulp times |v|); gradients: one ulp + 2e-3 of
    the tensor's largest |x| (a rounded dS element moves every sum it
    enters by about its ulp).
  * the fused transformer blocks (postnorm_attn_block, postnorm_mlp_block,
    attn_block, mlp_block): fp32 |d| <= 2e-5 + 2e-5|x| (fp32 sums in
    another order over K up to 3072); bf16 one ulp of the value + 1e-2 of
    the tensor's largest |x| (q / k / v, the softmax weights and the MLP
    hidden are rounded to bf16 inside the block, and an element that
    rounds to the neighbouring value moves every sum it enters).
  * eval model, bf16: argmax agreement >= 0.98 and max |logit difference|
    <= 0.05 between the kernel path and the plain path; fp32 (TF32 off):
    max |logit difference| <= 1e-4 and equal argmax. The same limits hold
    the text and image eval models.
  * train microbatches (``compare_train_paths``, three of them): fp32
    images, TF32 off, the loss within 1e-5 relative and every gradient
    within 1e-4 of its tensor's largest |g|; bf16 images, the loss within
    1e-3 relative and every gradient's cosine >= 0.999 (>= 0.998 in the
    bf16 image tower, whose gradients move that far when the RCA block's
    di moves by one bf16 ulp in a few elements — measured in the same run);
    biases whose gradient is rounding noise around an exact zero are held
    to their sibling weight's scale. The unimodal train paths
    (``compare_unimodal_paths``) are held the same way: fp32 1e-5 / 1e-4,
    bf16 images (ViT) 1e-3 and cosine >= 0.999.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import subprocess
import sys
import time

PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
SEED = 0
N_BATCHES, BATCH = 8, 128        # eval batch 128: config.MULTIMODAL_EVAL_BATCH


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def bf16_ulp(x):
    import torch

    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def max_err_ok(got, want, dtype, kind):
    """(max |d|, ok) under the tolerance of the module docstring."""
    import torch

    g, w = got.float(), want.float()
    d = (g - w).abs()
    if dtype == torch.float32:
        tol = (2e-5 + 2e-5 * w.abs()) if kind in ("rca", "block") else \
            (1e-5 + 1e-5 * w.abs())
    else:
        extra = {"rca": 1e-5, "block": 1e-2 * float(w.abs().max())}.get(
            kind, 1e-3)
        tol = bf16_ulp(torch.maximum(g.abs(), w.abs())) + extra
    finite = bool(torch.isfinite(g).all())
    return float(d.max()), finite and bool((d <= tol).all())


def time_ms(fn, reps: int = 20, warmup: int = 3, trials: int = 5):
    """Device time of one call: a CUDA graph of `reps` calls (no host
    launch gaps between them), replayed and timed with CUDA events,
    `trials` times. Returns (median, min, max) in ms per call."""
    import statistics

    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    out = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out), min(out), max(out)


def time_ms_eager(fn, reps: int = 20, warmup: int = 3, trials: int = 5):
    """Device time of one call without a CUDA graph, for calls that seed a
    generator (a CUDA graph cannot capture that): CUDA events around
    `reps` eager calls, `trials` times; host launch gaps count. Returns
    (median, min, max) in ms per call."""
    import statistics

    import torch

    for _ in range(warmup):
        fn()
    out = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out), min(out), max(out)


# ---------------------------------------------------------------------------
# phase 3: kernels
# ---------------------------------------------------------------------------


def _rca_params(dtype, device, gen):
    import types

    import torch

    from garbage_classification_rca_tpu_torch.ops import attention as att

    p = types.SimpleNamespace(
        sa_txt=att.AttentionUnit(48, 48, 128, 96, generator=gen),
        sa_img=att.AttentionUnit(80, 80, 128, 96, generator=gen),
        rca_ti=att.AttentionUnit(96, 96, 64, 48, generator=gen),
        rca_it=att.AttentionUnit(96, 96, 64, 48, generator=gen))
    for name in ("sa_txt", "sa_img", "rca_ti", "rca_it"):
        u = getattr(p, name)
        with torch.no_grad():   # non-trivial LayerNorm affine
            u.norm.scale.uniform_(0.5, 1.5, generator=gen)
            u.norm.bias.uniform_(-0.5, 0.5, generator=gen)
        setattr(p, name, u.to(device=device, dtype=dtype))
    return p


def check_rca(device, report):
    import torch

    from garbage_classification_rca_tpu_torch.kernels import rca_fused as K

    gen = torch.Generator().manual_seed(SEED)
    main = None
    ok_all = True
    for dtype in (torch.float32, torch.bfloat16):
        p = _rca_params(dtype, device, gen)
        for b in (128, 13):
            t = torch.randn((b, 16, 48), generator=gen).to(device, dtype)
            i = torch.randn((b, 16, 80), generator=gen).to(device, dtype)
            for reverse in (True, False):
                got = K.rca_fused(p, t, i, reverse=reverse)
                torch.cuda.synchronize()
                want = K.rca_fused_reference(p, t, i, reverse=reverse)
                errs = [max_err_ok(g, w, dtype, "rca")
                        for g, w in zip(got, want)]
                err = max(e for e, _ in errs)
                ok = all(o for _, o in errs)
                ok_all &= ok
                print(f"  rca_fused {str(dtype)[6:]:8s} B={b:3d} "
                      f"reverse={reverse!s:5s}: max|d|={err:.3e} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if dtype == torch.bfloat16 and b == 128 and reverse:
                    main = (p, t, i, err)
    # the training path's mixed input: t fp32 (text tower), i bf16 (image
    # tower), fp32 weights; outputs in t's dtype
    p32 = _rca_params(torch.float32, device, gen)
    t = torch.randn((16, 16, 48), generator=gen).to(device)
    i = torch.randn((16, 16, 80), generator=gen).to(device, torch.bfloat16)
    got = K.rca_fused(p32, t, i, reverse=True)
    torch.cuda.synchronize()
    want = K.rca_fused_reference(p32, t, i, reverse=True)
    errs = [max_err_ok(g, w, torch.float32, "rca") for g, w in zip(got, want)]
    ok = all(o for _, o in errs) and got[0].dtype == torch.float32
    ok_all &= ok
    print(f"  rca_fused t float32 i bfloat16 B= 16 reverse=True : max|d|="
          f"{max(e for e, _ in errs):.3e} {'ok' if ok else 'FAIL'}",
          flush=True)
    p, t, i, err = main
    ms, ms_lo, ms_hi = time_ms(lambda: K.rca_fused(p, t, i, reverse=True))
    plain_ms, p_lo, p_hi = time_ms(
        lambda: K.rca_fused_reference(p, t, i, reverse=True))
    b = t.shape[0]
    flops = 2867200 * b                      # per sample, see csrc note
    nbytes = (t.numel() + i.numel() + 2 * b * 16 * 48) * t.element_size() \
        + K.N_WEIGHTS * p.sa_txt.q.w.element_size()
    bound_ops = flops / PEAK_FLOPS["float32"] * 1e3
    bound_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    report["rca_fused"] = {
        "name": "rca_fused", "route": "cuda",
        "source": "garbage_classification_rca_tpu_torch/csrc/rca_fused.cu",
        "replaces": "garbage_classification_rca_tpu/kernels/rca_fused.py:69",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bound_ops, bound_bytes),
        "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
        "library_ms": None}
    print(f"  rca_fused B=128 bf16 (median of 5 [min, max]): kernel {ms:.4f} "
          f"[{ms_lo:.4f}, {ms_hi:.4f}] ms, plain {plain_ms:.4f} [{p_lo:.4f}, "
          f"{p_hi:.4f}] ms, bound {report['rca_fused']['bound_ms']:.4f} ms",
          flush=True)
    return ok_all


def _mask(b, n, gen, device):
    import torch

    lens = torch.randint(1, n + 1, (b,), generator=gen)
    lens[0] = n
    m = (torch.arange(n)[None, :] < lens[:, None]).to(torch.int32)
    return m.to(device)


def check_mha(device, report):
    import torch
    import torch.nn.functional as F

    from garbage_classification_rca_tpu_torch.kernels import mha_fused as K

    gen = torch.Generator().manual_seed(SEED + 1)
    ok_all = True
    main = None
    cases = [(128, 64, 768, 12, False), (8, 512, 768, 12, False),
             (16, 100, 768, 12, True)]
    for dtype in (torch.float32, torch.bfloat16):
        for b, n, d, h, causal in cases:
            q, k, v = (torch.randn((b, n, d), generator=gen).to(device, dtype)
                       for _ in range(3))
            m = _mask(b, n, gen, device)
            got = K.mha(q, k, v, heads=h, mask=m, causal=causal)
            torch.cuda.synchronize()
            want = K.mha_reference(q, k, v, heads=h, mask=m, causal=causal)
            err, ok = max_err_ok(got, want, dtype, "mha")
            ok_all &= ok
            print(f"  mha {str(dtype)[6:]:8s} B={b:3d} N={n:3d} D={d} H={h} "
                  f"causal={causal!s:5s}: max|d|={err:.3e} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if dtype == torch.bfloat16 and (b, n, causal) == (128, 64, False):
                main = (q, k, v, m, h, err)
    q, k, v, m, h, err = main
    b, n, d = q.shape
    ms, ms_lo, ms_hi = time_ms(lambda: K.mha(q, k, v, heads=h, mask=m))
    plain_ms, p_lo, p_hi = time_ms(
        lambda: K.mha_reference(q, k, v, heads=h, mask=m))

    def sdpa():
        rs = lambda a: a.view(b, n, h, d // h).transpose(1, 2)
        o = F.scaled_dot_product_attention(
            rs(q), rs(k), rs(v), attn_mask=m.bool()[:, None, None, :])
        return o.transpose(1, 2).reshape(b, n, d)

    library_ms, l_lo, l_hi = time_ms(sdpa)
    flops = 4 * b * n * n * d                # QK^T and PV, every head
    nbytes = 4 * q.numel() * q.element_size() + m.numel() * 4
    bound_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    bound_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    report["mha"] = {
        "name": "mha", "route": "cuda",
        "source": "garbage_classification_rca_tpu_torch/csrc/mha_fused.cu",
        "replaces": "garbage_classification_rca_tpu/kernels/mha_fused.py:91",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bound_ops, bound_bytes),
        "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
        "library_ms": library_ms}
    print(f"  mha B=128 N=64 D=768 bf16 (median of 5 [min, max]): kernel "
          f"{ms:.4f} [{ms_lo:.4f}, {ms_hi:.4f}] ms, plain {plain_ms:.4f} "
          f"[{p_lo:.4f}, {p_hi:.4f}] ms, sdpa {library_ms:.4f} [{l_lo:.4f}, "
          f"{l_hi:.4f}] ms, bound {report['mha']['bound_ms']:.4f} ms",
          flush=True)
    return ok_all


def grad_err_ok(got, want, dtype):
    """(max |d|, ok) for a gradient: |d| <= 5e-5 (1 + |x|) in fp32 (the
    JAX package's backward bar), and one ulp of the value + 2e-3 of the
    tensor's largest |x| in bf16 (a product input rounded to the
    neighbouring bf16 value moves the sum by about its ulp)."""
    import torch

    g, w = got.float(), want.float()
    d = (g - w).abs()
    if dtype == torch.float32:
        tol = 5e-5 * (1.0 + w.abs())
    else:
        tol = bf16_ulp(torch.maximum(g.abs(), w.abs())) \
            + 2e-3 * float(w.abs().max())
    finite = bool(torch.isfinite(g).all())
    return float(d.max()), finite and bool((d <= tol).all())


def rca_bwd_flops(b):
    """Operations of the block's backward with its forward recomputed, per
    the csrc note: 8,601,600 per sample."""
    return 8601600 * b


def check_rca_bwd(device, report):
    """K3 against the autograd of the plain version: B=16 (the train
    microbatch) and a ragged 13, (t fp32, i bf16) as training gives them
    and all fp32, reverse on and off."""
    import torch

    from garbage_classification_rca_tpu_torch.kernels import rca_fused as K

    gen = torch.Generator().manual_seed(SEED + 6)
    p = _rca_params(torch.float32, device, gen)
    ok_all, main = True, None
    for i_dtype in (torch.bfloat16, torch.float32):
        for b in (16, 13):
            t = torch.randn((b, 16, 48), generator=gen).to(device)
            i = torch.randn((b, 16, 80), generator=gen).to(device, i_dtype)
            g = [torch.randn((b, 16, 48), generator=gen).to(device)
                 for _ in range(2)]
            for reverse in (True, False):
                got = K.rca_fused_bwd(p, t, i, *g, reverse=reverse)
                torch.cuda.synchronize()
                want = K.rca_fused_bwd_reference(p, t, i, *g,
                                                 reverse=reverse)
                pairs = [(got[0], want[0], t.dtype), (got[1], want[1], i_dtype)]
                pairs += [(a, c, torch.float32)
                          for a, c in zip(got[2], want[2])]
                errs = [grad_err_ok(a, c, dt) for a, c, dt in pairs]
                err = max(e for e, _ in errs)
                ok = all(o for _, o in errs)
                ok_all &= ok
                print(f"  rca_fused_bwd i={str(i_dtype)[6:]:8s} B={b:3d} "
                      f"reverse={reverse!s:5s}: max|d|={err:.3e} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if i_dtype == torch.bfloat16 and b == 16 and reverse:
                    main = (t, i, g, err)
    t, i, g, err = main
    ms, ms_lo, ms_hi = time_ms(lambda: K.rca_fused_bwd(p, t, i, *g,
                                                       reverse=True))
    plain_ms, p_lo, p_hi = time_ms(
        lambda: K.rca_fused_bwd_reference(p, t, i, *g, reverse=True))
    b = t.shape[0]
    nbytes = (t.numel() * 4 * 2 + i.numel() * i.element_size() * 2
              + sum(a.numel() * 4 for a in g) + 2 * K.N_WEIGHTS * 4)
    bound_ops = rca_bwd_flops(b) / PEAK_FLOPS["float32"] * 1e3
    bound_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    report["rca_fused_bwd"] = {
        "name": "rca_fused_bwd", "route": "cuda",
        "source": "garbage_classification_rca_tpu_torch/csrc/rca_fused.cu",
        "replaces": "garbage_classification_rca_tpu/kernels/rca_fused.py:219",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bound_ops, bound_bytes),
        "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
        "library_ms": None}
    print(f"  rca_fused_bwd B=16 t fp32 i bf16 (median of 5 [min, max]): "
          f"kernel {ms:.4f} [{ms_lo:.4f}, {ms_hi:.4f}] ms, plain "
          f"{plain_ms:.4f} [{p_lo:.4f}, {p_hi:.4f}] ms, bound "
          f"{report['rca_fused_bwd']['bound_ms']:.4f} ms", flush=True)
    return ok_all


def _efficient_attention(q, k, v, bias, h):
    """The library's memory-efficient attention on [B, N, D] tensors:
    (out and lse in its own layout, the rest of its outputs)."""
    import torch

    b, n, d = q.shape
    rs = lambda a: a.view(b, n, h, d // h).transpose(1, 2)
    return torch.ops.aten._scaled_dot_product_efficient_attention(
        rs(q), rs(k), rs(v), bias, True)


def check_mha_train(device, report):
    """K4a and K4b against their plain versions: (16, 64, 768, 12 heads),
    the DistilBERT training shape, and N=512, fp32 (the training dtype)
    and bf16, random key lengths, and a causal case."""
    import torch

    from garbage_classification_rca_tpu_torch.kernels import mha_fused as K

    gen = torch.Generator().manual_seed(SEED + 7)
    ok_all, main = True, {}
    cases = [(16, 64, 768, 12, False), (4, 512, 768, 12, False),
             (6, 100, 768, 12, True)]
    for dtype in (torch.float32, torch.bfloat16):
        for b, n, d, h, causal in cases:
            q, k, v, do = (torch.randn((b, n, d), generator=gen).to(device,
                                                                  dtype)
                           for _ in range(4))
            m = _mask(b, n, gen, device)
            o, lse = K.mha_fwd_lse(q, k, v, heads=h, mask=m, causal=causal)
            torch.cuda.synchronize()
            o_w, lse_w = K.mha_fwd_lse_reference(q, k, v, heads=h, mask=m,
                                                 causal=causal)
            e_o, ok_o = max_err_ok(o, o_w, dtype, "mha")
            e_l, ok_l = max_err_ok(lse, lse_w, torch.float32, "mha")
            grads = K.mha_flash_bwd(q, k, v, o, do, lse, heads=h, mask=m,
                                    causal=causal)
            torch.cuda.synchronize()
            want = K.mha_flash_bwd_reference(q, k, v, o, do, lse, heads=h,
                                             mask=m, causal=causal)
            errs = [grad_err_ok(a, c, dtype) for a, c in zip(grads, want)]
            e_b = max(e for e, _ in errs)
            ok = ok_o and ok_l and all(o_ for _, o_ in errs)
            ok_all &= ok
            print(f"  mha_fwd_lse/mha_flash_bwd {str(dtype)[6:]:8s} B={b:3d} "
                  f"N={n:3d} causal={causal!s:5s}: fwd max|d|={e_o:.3e} "
                  f"lse {e_l:.3e} bwd {e_b:.3e} {'ok' if ok else 'FAIL'}",
                  flush=True)
            if dtype == torch.float32 and (b, n) == (16, 64):
                main = dict(q=q, k=k, v=v, do=do, m=m, h=h, o=o, lse=lse,
                            e_f=max(e_o, e_l), e_b=e_b)
    q, k, v, do, m, h = (main[x] for x in ("q", "k", "v", "do", "m", "h"))
    o, lse = main["o"], main["lse"]
    b, n, d = q.shape
    ms_f, f_lo, f_hi = time_ms(lambda: K.mha_fwd_lse(q, k, v, heads=h,
                                                     mask=m))
    plain_f = time_ms(lambda: K.mha_fwd_lse_reference(q, k, v, heads=h,
                                                      mask=m))[0]
    ms_b, b_lo, b_hi = time_ms(lambda: K.mha_flash_bwd(
        q, k, v, o, do, lse, heads=h, mask=m))
    plain_b = time_ms(lambda: K.mha_flash_bwd_reference(
        q, k, v, o, do, lse, heads=h, mask=m))[0]
    bias = ((m.float() - 1.0) * 1e30)[:, None, None, :].expand(
        b, h, n, n).contiguous()
    lib = _efficient_attention(q, k, v, bias, h)
    lib_f = time_ms(lambda: _efficient_attention(q, k, v, bias, h))[0]
    rs = lambda a: a.view(b, n, h, d // h).transpose(1, 2)
    lib_b = time_ms(lambda: torch.ops.aten.
                    _scaled_dot_product_efficient_attention_backward(
                        rs(do), rs(q), rs(k), rs(v), bias, lib[0], lib[1],
                        lib[2], lib[3], 0.0, [True, True, True, False]))[0]
    item = q.element_size()
    flops_f = 4 * b * n * n * d
    bytes_f = 4 * q.numel() * item + m.numel() * 4 + b * h * n * 4
    flops_b = 10 * b * n * n * d      # S, dP, dV, dQ, dK
    bytes_b = 8 * q.numel() * item + m.numel() * 4 + b * h * n * 4
    for name, ms, plain, lib_ms, flops, nbytes, err, line in (
            ("mha_fwd_lse", ms_f, plain_f, lib_f, flops_f, bytes_f,
             main["e_f"], 274),
            ("mha_flash_bwd", ms_b, plain_b, lib_b, flops_b, bytes_b,
             main["e_b"], 317)):
        bound_ops = flops / PEAK_FLOPS["float32"] * 1e3
        bound_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        report[name] = {
            "name": name, "route": "cuda",
            "source": "garbage_classification_rca_tpu_torch/csrc/mha_fused.cu",
            "replaces": f"garbage_classification_rca_tpu/kernels/mha_fused.py:"
                        f"{line}",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
            "library_ms": lib_ms}
    print(f"  mha_fwd_lse B=16 N=64 D=768 fp32 (median of 5 [min, max]): "
          f"kernel {ms_f:.4f} [{f_lo:.4f}, {f_hi:.4f}] ms, plain "
          f"{plain_f:.4f} ms, efficient attention {lib_f:.4f} ms, bound "
          f"{report['mha_fwd_lse']['bound_ms']:.4f} ms", flush=True)
    print(f"  mha_flash_bwd B=16 N=64 D=768 fp32: kernel {ms_b:.4f} "
          f"[{b_lo:.4f}, {b_hi:.4f}] ms, plain {plain_b:.4f} ms, efficient "
          f"attention backward {lib_b:.4f} ms, bound "
          f"{report['mha_flash_bwd']['bound_ms']:.4f} ms", flush=True)
    ok_all &= _mha_train_vit_shape(device, report, gen)
    return ok_all


def _mha_train_vit_shape(device, report, gen):
    """K4a / K4b at the image trainer's shape: ViT-B/16, batch 128, 197
    tokens, no mask, bf16. Checked against the plain versions and timed;
    the readings go under ``vit_shape`` of the two kernels' rows."""
    import torch

    from garbage_classification_rca_tpu_torch.kernels import mha_fused as K

    b, n, d, h, dtype = 128, 197, 768, 12, torch.bfloat16
    q, k, v, do = (torch.randn((b, n, d), generator=gen).to(device, dtype)
                   for _ in range(4))
    o, lse = K.mha_fwd_lse(q, k, v, heads=h)
    grads = K.mha_flash_bwd(q, k, v, o, do, lse, heads=h)
    torch.cuda.synchronize()
    o_w, lse_w = K.mha_fwd_lse_reference(q, k, v, heads=h)
    e_o, ok_o = max_err_ok(o, o_w, dtype, "mha")
    e_l, ok_l = max_err_ok(lse, lse_w, torch.float32, "mha")
    want = K.mha_flash_bwd_reference(q, k, v, o, do, lse, heads=h)
    errs = [grad_err_ok(a, c, dtype) for a, c in zip(grads, want)]
    del o_w, lse_w, want
    ok = ok_o and ok_l and all(o_ for _, o_ in errs)
    ms_f = time_ms(lambda: K.mha_fwd_lse(q, k, v, heads=h), reps=5)[0]
    plain_f = time_ms(lambda: K.mha_fwd_lse_reference(q, k, v, heads=h),
                      reps=5)[0]
    ms_b = time_ms(lambda: K.mha_flash_bwd(q, k, v, o, do, lse, heads=h),
                   reps=5)[0]
    plain_b = time_ms(lambda: K.mha_flash_bwd_reference(
        q, k, v, o, do, lse, heads=h), reps=5)[0]
    lib = _efficient_attention(q, k, v, None, h)
    lib_f = time_ms(lambda: _efficient_attention(q, k, v, None, h),
                    reps=5)[0]
    rs = lambda a: a.view(b, n, h, d // h).transpose(1, 2)
    lib_b = time_ms(lambda: torch.ops.aten.
                    _scaled_dot_product_efficient_attention_backward(
                        rs(do), rs(q), rs(k), rs(v), None, lib[0], lib[1],
                        lib[2], lib[3], 0.0, [True, True, True, False]),
                    reps=5)[0]
    item = q.element_size()
    rows = (("mha_fwd_lse", ms_f, plain_f, lib_f, 4 * b * n * n * d,
             4 * q.numel() * item + b * h * n * 4, max(e_o, e_l)),
            ("mha_flash_bwd", ms_b, plain_b, lib_b, 10 * b * n * n * d,
             8 * q.numel() * item + b * h * n * 4,
             max(e for e, _ in errs)))
    for name, ms, plain, lib_ms, flops, nbytes, err in rows:
        bound_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        bound_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        report[name]["vit_shape"] = {
            "shape": [b, n, d], "heads": h, "dtype": "bfloat16",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "library_ms": lib_ms, "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes"}
        print(f"  {name} B={b} N={n} D={d} bf16 unmasked (ViT-B/16 train): "
              f"max|d|={err:.3e} {'ok' if ok else 'FAIL'}; kernel {ms:.4f} "
              f"ms, plain {plain:.4f} ms, efficient attention {lib_ms:.4f} "
              f"ms, bound {report[name]['vit_shape']['bound_ms']:.4f} ms",
              flush=True)
    return ok


def check_mha_drop(device, report):
    """K7a and K7b against their plain versions on the same keep mask: the
    text trainer's shape (fp32 [128, 64, 768], 12 heads, p 0.1, random key
    lengths), bf16, causal, unmasked, N = 197 and N = 50 (odd rows of mask
    bytes), N = 512, p = 0.5; every masked case with a fully masked sample
    and every case with a fully dropped row. The mask is drawn twice from
    the key and must come out the same, bit for bit. Times: the kernels on
    a mask drawn before (CUDA graph) and with the draw (eager), the plain
    versions, and the library's efficient attention with dropout_p (it
    draws its own mask inside: a yardstick of time, never an oracle)."""
    import torch

    from garbage_classification_rca_tpu_torch.kernels import mha_fused as K
    from garbage_classification_rca_tpu_torch.nn.core import Key

    gen = torch.Generator().manual_seed(SEED + 60)
    ok_all, main = True, None
    cases = [(128, 64, 768, 12, True, False, 0.1),
             (16, 64, 768, 12, True, True, 0.1),
             (8, 197, 768, 12, False, False, 0.1),
             (8, 50, 768, 12, True, False, 0.1),
             (4, 512, 768, 12, True, False, 0.1),
             (16, 64, 768, 12, True, False, 0.5),
             (4, 197, 1024, 16, False, False, 0.1)]
    for dtype in (torch.float32, torch.bfloat16):
        for ci, (b, n, d, h, masked, causal, p) in enumerate(cases):
            q, k, v, do = (torch.randn((b, n, d), generator=gen).to(device,
                                                                  dtype)
                           for _ in range(4))
            m = None
            if masked:
                m = _mask(b, n, gen, device)
                m[-1] = 0                     # every key of this sample
            key = Key(SEED + 61 + ci)
            dm = K.drop_keep_mask(key, p, b, h, n, device)
            same = torch.equal(dm, K.drop_keep_mask(key, p, b, h, n, device))
            dm[0, 0, 1] = 0                   # a fully dropped row
            kw = dict(heads=h, keep=1.0 - p, mask=m, causal=causal)
            o, lse = K.mha_fwd_lse_drop(q, k, v, dm, **kw)
            grads = K.mha_flash_bwd_drop(q, k, v, o, do, lse, dm, **kw)
            torch.cuda.synchronize()
            o_w, lse_w = K.mha_fwd_lse_drop_reference(q, k, v, dm, **kw)
            e_o, ok_o = max_err_ok(o, o_w, dtype, "mha")
            e_l, ok_l = max_err_ok(lse, lse_w, torch.float32, "mha")
            want = K.mha_flash_bwd_drop_reference(q, k, v, o, do, lse, dm,
                                                  **kw)
            errs = [grad_err_ok(a, c, dtype) for a, c in zip(grads, want)]
            e_b = max(e for e, _ in errs)
            zero_row = bool((o[0, 1, :d // h] == 0).all())
            ok = (same and ok_o and ok_l and zero_row
                  and all(o_ for _, o_ in errs))
            ok_all &= ok
            print(f"  mha_fwd_lse_drop/mha_flash_bwd_drop {str(dtype)[6:]:8s} "
                  f"B={b:3d} N={n:3d} D={d} p={p} mask={masked!s:5s} causal="
                  f"{causal!s:5s}: fwd max|d|={e_o:.3e} lse {e_l:.3e} bwd "
                  f"{e_b:.3e} redraw equal={same} {'ok' if ok else 'FAIL'}",
                  flush=True)
            if dtype == torch.float32 and ci == 0:
                main = dict(q=q, k=k, v=v, do=do, m=m, h=h, o=o, lse=lse,
                            dm=dm, key=key, p=p, e_f=max(e_o, e_l), e_b=e_b)
            del o_w, lse_w, want
    q, k, v, do, m, h, o, lse, dm, key, p = (main[x] for x in (
        "q", "k", "v", "do", "m", "h", "o", "lse", "dm", "key", "p"))
    b, n, d = q.shape
    kw = dict(heads=h, keep=1.0 - p, mask=m)
    ms_f, f_lo, f_hi = time_ms(lambda: K.mha_fwd_lse_drop(q, k, v, dm, **kw))
    ms_b, b_lo, b_hi = time_ms(lambda: K.mha_flash_bwd_drop(
        q, k, v, o, do, lse, dm, **kw))
    plain_f = time_ms(lambda: K.mha_fwd_lse_drop_reference(q, k, v, dm,
                                                           **kw))[0]
    plain_b = time_ms(lambda: K.mha_flash_bwd_drop_reference(
        q, k, v, o, do, lse, dm, **kw))[0]
    draw = time_ms_eager(lambda: K.drop_keep_mask(key, p, b, h, n, device))[0]
    with_draw_f = time_ms_eager(lambda: K.mha_fwd_lse_drop(
        q, k, v, K.drop_keep_mask(key, p, b, h, n, device), **kw))[0]
    with_draw_b = time_ms_eager(lambda: K.mha_flash_bwd_drop(
        q, k, v, o, do, lse, K.drop_keep_mask(key, p, b, h, n, device),
        **kw))[0]
    bias = ((m.float() - 1.0) * 1e30)[:, None, None, :].expand(
        b, h, n, n).contiguous()
    rs = lambda a: a.view(b, n, h, d // h).transpose(1, 2)
    lib_call = lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
        rs(q), rs(k), rs(v), bias, True, p)
    lib = lib_call()
    lib_f = time_ms_eager(lib_call)[0]
    lib_b = time_ms_eager(
        lambda: torch.ops.aten.
        _scaled_dot_product_efficient_attention_backward(
            rs(do), rs(q), rs(k), rs(v), bias, lib[0], lib[1], lib[2],
            lib[3], p, [True, True, True, False]))[0]
    item = q.element_size()
    small = m.numel() * 4 + b * h * n * 4            # key mask and lse
    rows = (("mha_fwd_lse_drop", ms_f, plain_f, lib_f, with_draw_f,
             4 * b * n * n * d, 4 * q.numel() * item + dm.numel() + small,
             main["e_f"], 560),
            ("mha_flash_bwd_drop", ms_b, plain_b, lib_b, with_draw_b,
             10 * b * n * n * d, 8 * q.numel() * item + dm.numel() + small,
             main["e_b"], 610))
    for name, ms, plain, lib_ms, with_draw, flops, nbytes, err, line in rows:
        bound_ops = flops / PEAK_FLOPS["float32"] * 1e3
        bound_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        report[name] = {
            "name": name, "route": "cuda",
            "source": "garbage_classification_rca_tpu_torch/csrc/mha_fused.cu",
            "replaces": f"garbage_classification_rca_tpu/kernels/mha_fused.py:"
                        f"{line}",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
            "library_ms": lib_ms,
            "library_is": "efficient attention with dropout_p (draws its own "
                          "mask inside), eager",
            "ms_with_mask_draw_eager": with_draw, "mask_draw_ms_eager": draw,
            "bytes": nbytes, "gflops": flops / 1e9}
    print(f"  mha_fwd_lse_drop B={b} N={n} D={d} fp32 p={p} (median of 5 "
          f"[min, max]): kernel {ms_f:.4f} [{f_lo:.4f}, {f_hi:.4f}] ms, with "
          f"the mask draw (eager) {with_draw_f:.4f} ms (the draw alone "
          f"{draw:.4f} ms), plain {plain_f:.4f} ms, efficient attention with "
          f"dropout (eager) {lib_f:.4f} ms, bound "
          f"{report['mha_fwd_lse_drop']['bound_ms']:.4f} ms "
          f"({report['mha_fwd_lse_drop']['bound_by']})", flush=True)
    print(f"  mha_flash_bwd_drop same shape: kernel {ms_b:.4f} [{b_lo:.4f}, "
          f"{b_hi:.4f}] ms, with the mask draw (eager) {with_draw_b:.4f} ms, "
          f"plain {plain_b:.4f} ms, efficient attention backward with "
          f"dropout (eager) {lib_b:.4f} ms, bound "
          f"{report['mha_flash_bwd_drop']['bound_ms']:.4f} ms "
          f"({report['mha_flash_bwd_drop']['bound_by']})", flush=True)
    return ok_all


def _block_weights(d, ffn, dtype, device, gen):
    """Input-major weights in `dtype`, fp32 biases and LN parameters (what
    a layer's ``packed()`` hands the wrappers)."""
    import torch

    w = lambda i, o: (torch.randn((i, o), generator=gen) * i ** -0.5).to(
        device, dtype)
    vec = lambda k: (torch.randn((k,), generator=gen) * 0.1).to(device)
    ls = (1.0 + torch.randn((d,), generator=gen) * 0.1).to(device)
    return dict(ls=ls, lb=vec(d), wqkv=w(d, 3 * d), bqkv=vec(3 * d),
                wout=w(d, d), bout=vec(d), w1=w(d, ffn), b1=vec(ffn),
                w2=w(ffn, d), b2=vec(d))


def _library_attn(x, mask, p, heads, eps, post):
    """The unfused chain of library calls for an attention block (no single
    PyTorch call computes one): F.linear + scaled_dot_product_attention +
    F.linear + F.layer_norm, weights in F.linear's [out, in] layout."""
    import torch.nn.functional as F

    b, n, d = x.shape
    h = x if post else F.layer_norm(x, (d,), p["ls_t"], p["lb_t"], eps)
    q, k, v = F.linear(h, p["wqkv_oi"], p["bqkv_t"]).chunk(3, dim=-1)
    rs = lambda a: a.reshape(b, n, heads, d // heads).transpose(1, 2)
    am = None if mask is None else mask.bool()[:, None, None, :]
    a = F.scaled_dot_product_attention(rs(q), rs(k), rs(v), attn_mask=am)
    y = x + F.linear(a.transpose(1, 2).reshape(b, n, d), p["wout_oi"],
                     p["bout_t"])
    return F.layer_norm(y, (d,), p["ls_t"], p["lb_t"], eps) if post else y


def _library_mlp(x, p, eps, post):
    import torch.nn.functional as F

    d = x.shape[-1]
    h = x if post else F.layer_norm(x, (d,), p["ls_t"], p["lb_t"], eps)
    y = x + F.linear(F.gelu(F.linear(h, p["w1_oi"], p["b1_t"])), p["w2_oi"],
                     p["b2_t"])
    return F.layer_norm(y, (d,), p["ls_t"], p["lb_t"], eps) if post else y


def _check_blocks(device, report, *, post, main, odd, seed):
    """The two fused blocks of one family (post-norm: K5a / K5b; pre-norm:
    K6a / K6b) against their plain versions: fp32 (TF32 off) and bf16, at
    the main path's shape `main` and the odd one `odd` (both (B, N, D,
    heads, FFN)); post-norm with random key lengths and, at the odd shape, a
    fully masked row; the MLP with gelu and, at the odd shape, relu. Then
    the times at the main shape in bf16: kernel, plain version, and the
    unfused chain of library calls."""
    import torch

    from garbage_classification_rca_tpu_torch.kernels import (
        transformer_block as K)

    gen = torch.Generator().manual_seed(seed)
    eps = 1e-12 if post else 1e-6
    a_name, m_name = (("postnorm_attn_block", "postnorm_mlp_block") if post
                      else ("attn_block", "mlp_block"))
    lines = {"postnorm_attn_block": 346, "postnorm_mlp_block": 361,
             "attn_block": 88, "mlp_block": 127}

    def attn(fn, x, mask, p, heads):
        if post:
            return fn(x, mask, p["wqkv"], p["bqkv"], p["wout"], p["bout"],
                      p["ls"], p["lb"], heads=heads, eps=eps)
        return fn(x, p["ls"], p["lb"], p["wqkv"], p["bqkv"], p["wout"],
                  p["bout"], heads=heads, eps=eps)

    def mlp(fn, x, p, act="gelu"):
        if post:
            return fn(x, p["w1"], p["b1"], p["w2"], p["b2"], p["ls"],
                      p["lb"], eps=eps, act=act)
        return fn(x, p["ls"], p["lb"], p["w1"], p["b1"], p["w2"], p["b2"],
                  eps=eps, act=act)

    a_ref = getattr(K, a_name + "_reference")
    m_ref = getattr(K, m_name + "_reference")
    ok_all, kept = True, None
    for dtype in (torch.float32, torch.bfloat16):
        for shape in (main, odd):
            b, n, d, heads, ffn = shape
            p = _block_weights(d, ffn, dtype, device, gen)
            x = torch.randn((b, n, d), generator=gen).to(device, dtype)
            mask = None
            if post:
                mask = _mask(b, n, gen, device)
                if shape == odd:
                    mask[-1] = 0          # every key of this sample masked
            cases = [(a_name, attn(getattr(K, a_name), x, mask, p, heads),
                      lambda: attn(a_ref, x, mask, p, heads)),
                     (m_name, mlp(getattr(K, m_name), x, p),
                      lambda: mlp(m_ref, x, p))]
            if shape == odd:
                cases.append((m_name + " relu",
                              mlp(getattr(K, m_name), x, p, "relu"),
                              lambda: mlp(m_ref, x, p, "relu")))
            torch.cuda.synchronize()
            errs = {}
            for name, got, plain in cases:
                err, ok = max_err_ok(got, plain(), dtype, "block")
                ok_all &= ok
                errs[name] = err
                print(f"  {name:24s} {str(dtype)[6:]:8s} B={b:3d} N={n:3d} "
                      f"D={d} H={heads} FFN={ffn}: max|d|={err:.3e} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
            if dtype == torch.bfloat16 and shape == main:
                kept = (x, mask, p, heads, errs)
    x, mask, p, heads, errs = kept
    b, n, d = x.shape
    ffn = p["w1"].shape[1]
    for k in ("wqkv", "wout", "w1", "w2"):
        p[k + "_oi"] = p[k].t().contiguous()
    for k in ("ls", "lb", "bqkv", "bout", "b1", "b2"):
        p[k + "_t"] = p[k].to(x.dtype)
    item = x.element_size()
    tokens = b * n
    rows = (
        (a_name, lambda: attn(getattr(K, a_name), x, mask, p, heads),
         lambda: attn(a_ref, x, mask, p, heads),
         lambda: _library_attn(x, mask, p, heads, eps, post),
         tokens * (2 * (d * 3 * d + d * d) + 4 * n * d),
         2 * x.numel() * item + 4 * d * d * item + 6 * d * 4
         + (mask.numel() * 4 if post else 0)),
        (m_name, lambda: mlp(getattr(K, m_name), x, p),
         lambda: mlp(m_ref, x, p),
         lambda: _library_mlp(x, p, eps, post),
         tokens * 4 * d * ffn,
         2 * x.numel() * item + 2 * d * ffn * item + (3 * d + ffn) * 4))
    for name, kern, plain, lib, flops, nbytes in rows:
        ms, lo, hi = time_ms(kern, reps=5)
        plain_ms = time_ms(plain, reps=5)[0]
        lib_ms = time_ms(lib, reps=5)[0]
        bound_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        bound_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        report[name] = {
            "name": name, "route": "cuda",
            "source": "garbage_classification_rca_tpu_torch/csrc/"
                      "transformer_block.cu",
            "replaces": "garbage_classification_rca_tpu/kernels/"
                        f"transformer_block.py:{lines[name]}",
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
            "library_ms": lib_ms,
            "library_is": "unfused chain: F.linear + scaled_dot_product_"
                          "attention + F.layer_norm" if "attn" in name else
                          "unfused chain: F.linear + F.gelu + F.layer_norm",
            "gflops": flops / 1e9, "tflops_per_s": flops / ms / 1e9}
        print(f"  {name} B={b} N={n} D={d} FFN={ffn} bf16 (median of 5 [min, "
              f"max]): kernel {ms:.4f} [{lo:.4f}, {hi:.4f}] ms "
              f"({flops / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.4f} ms, "
              f"library chain {lib_ms:.4f} ms, bound "
              f"{report[name]['bound_ms']:.4f} ms "
              f"({report[name]['bound_by']})", flush=True)
    return ok_all


def check_postnorm_blocks(device, report):
    """K5a / K5b at the BERT-family eval shape (256 x 64 x 768, 12 heads,
    FFN 3072) and at N = 17 with a batch of 3."""
    return _check_blocks(device, report, post=True,
                         main=(256, 64, 768, 12, 3072),
                         odd=(3, 17, 768, 12, 3072), seed=SEED + 20)


def check_prenorm_blocks(device, report):
    """K6a / K6b at the ViT-B/16 eval shape (64 x 197 x 768, 12 heads, FFN
    3072) and at N = 17 with ViT-L/16's widths (1024, 16 heads, 4096)."""
    return _check_blocks(device, report, post=False,
                         main=(64, 197, 768, 12, 3072),
                         odd=(3, 17, 1024, 16, 4096), seed=SEED + 21)


# ---------------------------------------------------------------------------
# phase 4: the model
# ---------------------------------------------------------------------------


class SyntheticBatcher:
    """ImageTextBatcher stand-in: seeded uint8 480x480 images and
    WordPiece-tokenized random texts, fixed-shape batches, all made before
    the run so that the measured loop holds no data generation."""

    def __init__(self, n, batch_size, image_size, tokenizer, seq_len, seed):
        import numpy as np

        rng = np.random.default_rng(seed)
        words = [w for w in tokenizer.vocab
                 if w.isalpha() and not w.startswith("[")]
        self.m = list(range(n))
        self.batches = []
        h, w = image_size
        for start in range(0, n, batch_size):
            k = min(batch_size, n - start)
            texts = [" ".join(rng.choice(words, rng.integers(2, 40)))
                     for _ in range(k)] + [""] * (batch_size - k)
            enc = tokenizer.encode_batch(texts, seq_len)
            label = rng.integers(0, 4, batch_size).astype(np.int32)
            self.batches.append({
                "image": rng.integers(0, 256, (batch_size, h, w, 3),
                                      dtype=np.uint8),
                "input_ids": enc.input_ids,
                "attention_mask": enc.attention_mask,
                "label": label,
                "valid": (np.arange(batch_size) < k).astype(np.int32)})

    def iter_batches(self, batch_size, *, shuffle=False, **_):
        assert batch_size == len(self.batches[0]["label"]) and not shuffle
        yield from self.batches


@contextlib.contextmanager
def plain_versions():
    """Route the model's kernel call sites to the plain versions (eval and
    train; the plain versions are differentiable by autograd)."""
    from garbage_classification_rca_tpu_torch.kernels import mha_fused
    from garbage_classification_rca_tpu_torch.kernels import rca_fused
    from garbage_classification_rca_tpu_torch.kernels import (
        transformer_block as tb)
    from garbage_classification_rca_tpu_torch.models.fusion import multimodal
    from garbage_classification_rca_tpu_torch.models.image import vit
    from garbage_classification_rca_tpu_torch.models.text import encoder_common

    def plain_dropout(q, k, v, *, heads, key, p, scale=0.0, mask=None,
                      causal=False):
        b, n, _ = q.shape
        dm = mha_fused.drop_keep_mask(key, p, b, heads, n, q.device)
        return mha_fused.mha_fwd_lse_drop_reference(
            q, k, v, dm, heads=heads, keep=1.0 - p, scale=scale, mask=mask,
            causal=causal)[0]

    sites = ((tb, "postnorm_attn_block", tb.postnorm_attn_block_reference),
             (tb, "postnorm_mlp_block", tb.postnorm_mlp_block_reference),
             (tb, "attn_block", tb.attn_block_reference),
             (tb, "mlp_block", tb.mlp_block_reference),
             (vit, "mha", mha_fused.mha_reference),
             (vit, "mha_flash_train", mha_fused.mha_reference),
             (encoder_common, "mha_flash_train_dropout", plain_dropout),
             (encoder_common, "mha", mha_fused.mha_reference),
             (encoder_common, "mha_flash_train", mha_fused.mha_reference),
             (multimodal, "rca_fused", rca_fused.rca_fused_reference),
             (multimodal, "rca_fused_trainable",
              rca_fused.rca_fused_reference))
    saved = [getattr(mod, name) for mod, name, _ in sites]
    for mod, name, plain in sites:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(sites, saved):
            setattr(mod, name, fn)


def _randomize_bn(model, gen):
    import torch

    from garbage_classification_rca_tpu_torch.nn.core import BatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.scale.uniform_(0.5, 1.5, generator=gen)
                m.bias.uniform_(-0.2, 0.2, generator=gen)
                m.mean.normal_(0.0, 0.2, generator=gen)
                m.var.uniform_(0.5, 2.0, generator=gen)


def _logits(model, batch, dtype, device):
    import torch

    from garbage_classification_rca_tpu_torch.data.images import (
        normalize_on_device)

    with torch.inference_mode():
        x = normalize_on_device(torch.from_numpy(batch["image"]).to(device),
                                dtype=dtype)
        ids = torch.from_numpy(batch["input_ids"]).to(device)
        mask = torch.from_numpy(batch["attention_mask"]).to(device)
        return model(ids, mask, x).float()


def _kind(name: str) -> str:
    n = name.lower()
    if "rca_fused_kernel" in n:
        return "rca_fused kernel"
    if "mha_kernel" in n:
        return "mha kernel"
    if "attn_heads_kernel" in n or "attn_out_kernel" in n:
        return "fused attention block kernels"
    if "mlp_kernel" in n:
        return "fused MLP block kernel"
    if "rca_bwd" in n:
        return "rca_fused_bwd kernel"
    if "mha_bwd" in n:
        return "mha_flash_bwd kernels"
    if "memcpy" in n or "memset" in n:
        return "copies"
    if "conv" in n or "fprop" in n or "dgrad" in n or "wgrad" in n:
        return "convolutions"
    if "gemm" in n or "nvjet" in n or "cutlass" in n or "cublas" in n:
        return "matmuls"
    return "elementwise + reductions"


def profile_batch(model, batch, dtype, device, reps=3):
    from garbage_classification_rca_tpu_torch.cli.test_both import (
        make_both_eval_step)

    return profile_step(make_both_eval_step(model, dtype), batch, device,
                        reps)


def profile_step(step, batch, device, reps=3):
    """torch.profiler (CUPTI) over `reps` eval steps of one batch: device
    time per batch by kind of kernel, the top kernels, and the device's idle
    share of the window (1 - kernel time / host wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        dev = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        step(dev)[0].cpu()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                step(dev)[0].cpu()
            wall = time.perf_counter() - t0
    kinds, top = {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        ms = us / 1e3 / reps
        kinds[_kind(e.key)] = kinds.get(_kind(e.key), 0.0) + ms
        top.append((ms, e.count // reps, e.key.replace("void at::native::",
                                                       "")[:160]))
    busy = sum(kinds.values())
    out = {"device_ms_per_batch": busy, "wall_ms_per_batch": wall * 1e3 / reps,
           "idle_share": 1.0 - busy / (wall * 1e3 / reps) if wall else None,
           "by_kind_ms": dict(sorted(kinds.items(), key=lambda kv: -kv[1]))}
    print(f"  profile of one batch (mean of {reps}): device {busy:.2f} ms, "
          f"wall {out['wall_ms_per_batch']:.2f} ms, idle share "
          f"{out['idle_share']:.3f}", flush=True)
    for k, ms in out["by_kind_ms"].items():
        print(f"    {k:26s} {ms:8.3f} ms  {ms / busy:6.1%}", flush=True)
    for ms, cnt, name in sorted(top, reverse=True)[:8]:
        print(f"    top: {ms:8.3f} ms x{cnt:<4d} {name}", flush=True)
    return out


def check_model(device, n_batches, batch_size, results):
    import copy

    import torch

    from garbage_classification_rca_tpu_torch.cli.test_both import (
        run_multimodal_eval)
    from garbage_classification_rca_tpu_torch.data.tokenizer import (
        WordPieceTokenizer)
    from garbage_classification_rca_tpu_torch.models.fusion import multimodal
    from garbage_classification_rca_tpu_torch.nn.fold import fold_batchnorm

    ok = True
    cfg = multimodal.FusionConfig(strategy="MM_RCA", reverse=True)
    t0 = time.perf_counter()
    model32 = multimodal.build_fusion_model(
        cfg, device=device, generator=torch.Generator().manual_seed(SEED + 2))
    _randomize_bn(model32,
                  torch.Generator(device=device).manual_seed(SEED + 5))
    fold_batchnorm(model32.image, 1e-3)
    tok = WordPieceTokenizer.from_vocab_file(
        "tests/fixtures/vocab/wordpiece/vocab.txt")
    data = SyntheticBatcher(n_batches * batch_size, batch_size, (480, 480),
                            tok, 64, SEED + 3)
    first = data.batches[0]
    print(f"  model built in {time.perf_counter() - t0:.1f} s", flush=True)

    # fp32, TF32 off: kernel path vs plain path on 8 samples
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    small = {k: v[:8] for k, v in first.items()}
    lk = _logits(model32, small, torch.float32, device)
    with plain_versions():
        lp = _logits(model32, small, torch.float32, device)
    d32 = float((lk - lp).abs().max())
    same32 = bool((lk.argmax(-1) == lp.argmax(-1)).all())
    fin = bool(torch.isfinite(lk).all())
    ok &= fin and same32 and d32 <= 1e-4 and tuple(lk.shape) == (8, 4)
    print(f"  fp32 logits kernel vs plain: max|d|={d32:.3e}, argmax equal="
          f"{same32}, finite={fin}", flush=True)
    torch.backends.cudnn.allow_tf32 = True

    # bf16: the CLI's cast, then the measured run_eval
    model = copy.deepcopy(model32).to(torch.bfloat16)
    del model32
    torch.cuda.empty_cache()
    dtype = torch.bfloat16
    run_multimodal_eval(model, SyntheticBatcher(batch_size, batch_size,
                                                (480, 480), tok, 64, SEED + 4),
                        batch_size, device, dtype, progress=False)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    _zero_counters()
    acc, labels, preds, stats = run_multimodal_eval(
        model, data, batch_size, device, dtype, progress=False)
    torch.cuda.synchronize()
    launches = _read_counters()
    peak = torch.cuda.max_memory_allocated(device)
    results["launches"] = launches
    want = _want_launches(rca_fused=n_batches, mha=6 * n_batches)
    ok &= launches == want and len(preds) == n_batches * batch_size
    print(f"  launches over {n_batches} batches: {launches} (want {want})",
          flush=True)
    # two more runs of the same loop, for the spread (counters not read)
    rates = [stats["samples_per_s"]]
    p50s = [stats["p50_step_s"] * 1e3]
    for _ in range(2):
        _, _, _, st = run_multimodal_eval(model, data, batch_size, device,
                                          dtype, progress=False)
        rates.append(st["samples_per_s"])
        p50s.append(st["p50_step_s"] * 1e3)
    print(f"  run_eval x3 over {n_batches} batches of {batch_size}: "
          f"samples/s {sorted(rates)}, p50 batch ms {sorted(p50s)} (the p50 "
          f"includes the prediction readback); peak memory "
          f"{peak / 2**30:.2f} GiB; accuracy on random labels {acc:.2f} %",
          flush=True)
    results["model"] = {"samples_per_s": sorted(rates)[1],
                        "samples_per_s_runs": rates,
                        "p50_batch_ms": sorted(p50s)[1],
                        "peak_mem_gib": peak / 2**30,
                        "batches": n_batches, "batch": batch_size}

    results["model"]["profile"] = profile_batch(model, data.batches[0],
                                                dtype, device)

    # bf16 logits, kernel path vs plain path, on two batches
    agree, n, dmax = 0, 0, 0.0
    for batch in data.batches[:2]:
        lk = _logits(model, batch, dtype, device)
        with plain_versions():
            lp = _logits(model, batch, dtype, device)
        fin = bool(torch.isfinite(lk).all())
        ok &= fin and tuple(lk.shape) == (batch_size, 4)
        agree += int((lk.argmax(-1) == lp.argmax(-1)).sum())
        n += lk.shape[0]
        dmax = max(dmax, float((lk - lp).abs().max()))
    frac = agree / n
    ok &= frac >= 0.98 and dmax <= 0.05
    results["model"].update(argmax_agreement=frac, max_logit_diff=dmax)
    print(f"  bf16 logits kernel vs plain over {n} samples: argmax "
          f"agreement {frac:.4f}, max|d|={dmax:.3e}", flush=True)
    return ok


# ---------------------------------------------------------------------------
# phase 5: the MM-RCA train path
# ---------------------------------------------------------------------------

TRAIN_BATCH, ACC_STEPS = 16, 10        # the MM_RCA.sh recipe
TRAIN_IMAGE = 480
TRAIN_LAUNCHES = {"rca_fused": 1, "rca_fused_bwd": 1, "mha_fwd_lse": 6,
                  "mha_flash_bwd": 6, "mha": 0}     # per microbatch


def _counters():
    from garbage_classification_rca_tpu_torch.kernels import mha_fused
    from garbage_classification_rca_tpu_torch.kernels import rca_fused
    from garbage_classification_rca_tpu_torch.kernels import (
        transformer_block as tb)

    return {"rca_fused": rca_fused.rca_fused, "mha": mha_fused.mha,
            "rca_fused_bwd": rca_fused.rca_fused_bwd,
            "mha_fwd_lse": mha_fused.mha_fwd_lse,
            "mha_flash_bwd": mha_fused.mha_flash_bwd,
            "mha_fwd_lse_drop": mha_fused.mha_fwd_lse_drop,
            "mha_flash_bwd_drop": mha_fused.mha_flash_bwd_drop,
            "postnorm_attn_block": tb.postnorm_attn_block,
            "postnorm_mlp_block": tb.postnorm_mlp_block,
            "attn_block": tb.attn_block, "mlp_block": tb.mlp_block}


BLOCK_KERNELS = ("postnorm_attn_block", "postnorm_mlp_block", "attn_block",
                 "mlp_block")


def _want_launches(**counts):
    """Every counter's expected value: the named ones, 0 for the rest."""
    return {k: counts.get(k, 0) for k in _counters()}


def _zero_counters():
    for fn in _counters().values():
        fn.launches = 0


def _read_counters():
    return {k: fn.launches for k, fn in _counters().items()}


def _train_stack(tok, acc, batch, seed, device):
    """[acc, B, ...] device stack of synthetic 480x480 uint8 images and
    WordPiece texts, labels over the 4 classes, every sample valid."""
    import numpy as np
    import torch

    data = SyntheticBatcher(acc * batch, batch, (TRAIN_IMAGE, TRAIN_IMAGE),
                            tok, 64, seed)
    return {k: torch.from_numpy(np.stack([b[k] for b in data.batches])).to(
        device) for k in data.batches[0]}


def _microbatch_grads(model, cfg, mb, image_dtype, key, class_weights):
    """One microbatch's loss and {name: grad} through the model's current
    call sites (kernels or plain versions), the recipe's augmentation,
    head dropout and class weights."""
    import torch

    from garbage_classification_rca_tpu_torch.data.augment import (
        augment_batch)
    from garbage_classification_rca_tpu_torch.data.images import (
        normalize_on_device)
    from garbage_classification_rca_tpu_torch.train.loss import (
        cross_entropy_loss_and_weight)

    k_in, k_model = key.split(2)
    for p in model.parameters():
        p.grad = None
    with torch.enable_grad():
        x = augment_batch(mb["image"], 1.0, k_in.generator(mb["image"].device))
        logits = model(mb["input_ids"], mb["attention_mask"],
                       normalize_on_device(x, dtype=image_dtype),
                       train=True, key=k_model)
        loss, _ = cross_entropy_loss_and_weight(logits, mb["label"],
                                                class_weights, 0.0,
                                                mb["valid"])
        loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return float(loss.detach()), grads


def exact_zero_grads(model):
    """Names of the parameters whose gradient is zero in exact arithmetic,
    so that both paths give rounding noise there: every attention key bias
    (softmax ignores a per-row constant), and the ``project.bn.bias`` of a
    block without residual whose output reaches the loss only through 1x1
    convs each followed by a train-mode BN (which removes a per-channel
    constant; a 3x3 conv's zero padding would not): the first block of an
    "mb" stage followed by "mb" blocks or the head. A residual block's
    ``project.bn.bias`` joins them whenever stochastic depth keeps every
    sample of the batch."""
    names = {n for n, _ in model.named_parameters() if n.endswith("k.b")}
    stages = model.image_cfg.stages
    for si, (btype, _, _, stride, c_in, c_out, n) in enumerate(stages):
        nxt = stages[si + 1][0] if si + 1 < len(stages) else "mb"
        if btype == "mb" and (stride != 1 or c_in != c_out) and (
                n > 1 or nxt == "mb"):
            names.add(f"image.stages.{si}.0.project.bn.bias")
    return names


def _sibling(name):
    """The weight a bias that may be rounding noise is sized against."""
    return name[:-1] + "w" if name.endswith("k.b") else name[:-4] + "scale"


GRAD_CHECK_SEEDS = 3          # microbatches (and draws) the paths are held on
# bf16 limits of compare_train_paths. The image tower's and the noise
# biases' are about twice the largest gap that the "one_ulp" noise floor
# gave on the H100 (lowest image-tower cosine 0.99891, largest noise-bias
# ratio 0.0189, over three microbatches; PERF.md, PR 2 findings)
BF16_COS = 0.999              # cosine, every gradient outside the image tower
BF16_COS_IMAGE = 0.998        # cosine, the image tower
BF16_NOISE_BIAS = 4e-2        # |d| / max(|g|, sibling |g|)max, noise biases


def _bf16_bits(x):
    """(sign bit, magnitude bits) of a bf16 tensor, as int32."""
    import torch

    b = x.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
    return b & 0x8000, b & 0x7FFF


def _ulp_steps(a, b):
    """(How many bf16 ulps `a` lies from `b`, counted on the magnitude;
    whether their signs agree)."""
    sa, ma = _bf16_bits(a)
    sb, mb = _bf16_bits(b)
    return ma - mb, (sa == sb) | ((ma == 0) & (mb == 0))


def _move_ulps(x, steps):
    """bf16 `x` with each magnitude moved by `steps` ulps, kept finite."""
    import torch

    s, m = _bf16_bits(x)
    bits = s | (m + steps).clamp(0, 0x7F7F)
    return torch.where(bits >= 0x8000, bits - 0x10000, bits).to(
        torch.int16).view(torch.bfloat16)


@contextlib.contextmanager
def di_tap(store, replace=None):
    """Route the model's RCA call site (kernel or plain, whichever is set)
    through an identity on its image input i that, on the way back, hands
    on ``replace(di)`` when given (else di) and records it in
    ``store["di"]``."""
    import torch

    from garbage_classification_rca_tpu_torch.models.fusion import multimodal

    class _Tap(torch.autograd.Function):
        @staticmethod
        def forward(ctx, i):
            return i.view_as(i)

        @staticmethod
        def backward(ctx, g):
            if replace is not None:
                g = replace(g)
            store["di"] = g.detach().clone()
            return g

    inner = multimodal.rca_fused_trainable
    multimodal.rca_fused_trainable = (
        lambda p, t, i, **kw: inner(p, t, _Tap.apply(i), **kw))
    try:
        yield
    finally:
        multimodal.rca_fused_trainable = inner


def _grad_scores(ga, gb, fp32, exact_zero):
    """Gradients `ga` against `gb` (the plain path's), name by name:
    (scores, biases, zeros, finite). scores: (value, name) — fp32 the
    largest |d| over the tensor's largest |g|, bf16 the cosine (1 - that
    ratio for a tensor whose gradient is below 1e-6 of the model's largest,
    held to that floor); biases: |d| / max(own, sibling |g|max) of the
    biases that may be rounding noise; zeros: |g| / sibling |g|max of those
    zero in exact arithmetic, the larger over both paths."""
    import torch

    mx = {n: float(g.abs().max()) for n, g in gb.items()}
    floor = 1e-6 * max(mx.values())
    scores, biases, zeros, finite = [], [], [], True
    for n in gb:
        finite &= bool(torch.isfinite(ga[n]).all())
        d = float((ga[n] - gb[n]).abs().max())
        if n.endswith(("k.b", "project.bn.bias")):
            sib = max(mx[_sibling(n)], floor)
            biases.append((d / max(mx[n], sib), n))
            if n in exact_zero:
                zeros.append((max(mx[n], float(ga[n].abs().max())) / sib, n))
        elif fp32 or mx[n] < floor:
            r = d / max(mx[n], floor)
            scores.append((r if fp32 else 1.0 - r, n))
        else:
            scores.append((float(torch.nn.functional.cosine_similarity(
                ga[n].flatten().double(), gb[n].flatten().double(), dim=0)),
                n))
    scores.sort(reverse=fp32)
    biases.sort(reverse=True)
    zeros.sort(reverse=True)
    return scores, biases, zeros, finite


def _worst(xs, image=None, k=3):
    """The first `k` (value, name) of a sorted list, optionally only the
    image tower's (image=True) or only the rest (image=False)."""
    if image is not None:
        xs = [x for x in xs if x[1].startswith("image.") == image]
    return [(float(f"{v:.5g}"), n) for v, n in xs[:k]]


def compare_train_paths(model, cfg, stack, class_weights, results):
    """Kernel path against plain path, same weights and same draws,
    deterministic cuDNN, on GRAD_CHECK_SEEDS microbatches with their own
    draws. fp32 images with TF32 off: the loss within 1e-5 relative, every
    gradient within 1e-4 of its tensor's largest |g|. bf16 images: the loss
    within 1e-3 relative, each gradient's cosine >= BF16_COS, >=
    BF16_COS_IMAGE in the image tower. A tensor whose gradient is below
    1e-6 of the model's largest is held to that floor instead of its own
    size (1e-4 in fp32, 1e-2 in bf16). The biases that may be rounding
    noise (key biases, ``project.bn.bias``) are held, to 1e-4 in fp32 and
    BF16_NOISE_BIAS in bf16, to the larger of their own and their sibling
    weight's largest |g|; those zero in exact arithmetic
    (``exact_zero_grads``) must also stay below 0.1 of that sibling's on
    both paths.

    The image tower's bf16 gradients come out of a 57-block bf16 backward
    fed by the RCA block's di, which K3 and the plain version each round to
    bf16 from fp32 sums taken in different orders. Two more plain-path runs
    per microbatch size that: "kernel_di" hands the image tower K3's own di
    (its gradients should then match the kernel path's), and "one_ulp"
    moves the plain di by one bf16 ulp, up or down, at random elements, as
    many as K3's di differs in (its cosines against the plain path are the
    noise floor of a di that is right to one rounding). They are reported,
    not judged."""
    import torch

    from garbage_classification_rca_tpu_torch.nn.core import Key

    ok = True
    exact_zero = exact_zero_grads(model)
    checks = {"fp32": [], "bf16": []}
    # deterministic cuDNN algorithms: the two paths must differ only where
    # the kernels do, not by the atomics of a convolution's backward
    torch.backends.cudnn.deterministic = True
    for seed in range(GRAD_CHECK_SEEDS):
        mb = {k: v[seed] for k, v in stack.items()}
        key = Key(SEED + 11 + seed)
        for image_dtype in (torch.float32, torch.bfloat16):
            fp32 = image_dtype == torch.float32
            tag = "fp32" if fp32 else "bf16"
            torch.backends.cudnn.allow_tf32 = not fp32
            run = lambda: _microbatch_grads(model, cfg, mb, image_dtype, key,
                                            class_weights)
            dk, dp = {}, {}
            with di_tap(dk):
                lk, gk = run()
            with plain_versions(), di_tap(dp):
                lp, gp = run()
            rel = abs(lk - lp) / max(abs(lp), 1e-30)
            scores, biases, zeros, finite = _grad_scores(gk, gp, fp32,
                                                         exact_zero)
            row = {"seed": seed, "loss_kernel": lk, "loss_plain": lp,
                   "loss_rel": rel, "worst_image": _worst(scores, True),
                   "worst_rest": _worst(scores, False),
                   "worst_noise_bias": _worst(biases),
                   "exact_zero_worst": _worst(zeros)}
            ok &= finite and lk == lk and rel <= (1e-5 if fp32 else 1e-3)
            ok &= all(z <= 0.1 for z, _ in zeros)
            ok &= all(r <= (1e-4 if fp32 else BF16_NOISE_BIAS)
                      for r, _ in biases)
            if fp32:
                ok &= all(r <= 1e-4 for r, _ in scores)
            else:
                ok &= all(c >= (BF16_COS_IMAGE if n.startswith("image.")
                                else BF16_COS) for c, n in scores)
                steps, same = _ulp_steps(dk["di"], dp["di"])
                differ = (steps != 0) | ~same
                share = float(differ.float().mean())
                row["di_share_differing"] = share
                row["di_share_of_those_one_ulp"] = float(
                    (same & (steps.abs() == 1)).sum()) / max(
                        int(differ.sum()), 1)
                row["di_ulps_max_same_sign"] = int(
                    torch.where(same, steps.abs(), 0).max())
                row["di_sign_flips"] = int((~same).sum())
                g = torch.Generator(device=steps.device).manual_seed(
                    SEED + 13 + seed)
                u = torch.rand(steps.shape, generator=g, device=steps.device)
                nudge = torch.where(u < share / 2, -1,
                                    torch.where(u < share, 1, 0))
                for what, replace in (
                        ("kernel_di", lambda di: dk["di"]),
                        ("one_ulp", lambda di: _move_ulps(di, nudge))):
                    with plain_versions(), di_tap({}, replace):
                        _, gx = run()
                    ref = gk if what == "kernel_di" else gp
                    s, b_, _, _ = _grad_scores(gx, ref, False, exact_zero)
                    row[f"{what}_worst_image"] = _worst(s, True)
                    row[f"{what}_worst_noise_bias"] = _worst(b_)
                    del gx
            print(f"  train microbatch {seed}, kernel vs plain, {tag} images:"
                  f" {json.dumps(row)}", flush=True)
            checks[tag].append(row)
            del gk, gp
            torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    results["grad_check_fp32"] = checks["fp32"]
    results["grad_check_bf16"] = checks["bf16"]
    return ok


def profile_train_step(step, stack, key, reps=1, acc_steps=None):
    """torch.profiler over `reps` train steps: device time by kind of
    kernel and the device's idle share of the window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in range(reps):
            float(step(stack, key.fold_in(r))[0])
        wall = time.perf_counter() - t0
    kinds, top, ops = {}, [], 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        ms = us / 1e3 / reps
        kinds[_kind(e.key)] = kinds.get(_kind(e.key), 0.0) + ms
        ops += e.count
        top.append((ms, e.count // reps, e.key.replace("void at::native::",
                                                       "")[:160]))
    busy = sum(kinds.values())
    out = {"device_ms_per_step": busy, "wall_ms_per_step": wall * 1e3 / reps,
           "idle_share": 1.0 - busy / (wall * 1e3 / reps),
           "device_ops_per_step": ops // reps,
           "by_kind_ms": dict(sorted(kinds.items(), key=lambda kv: -kv[1]))}
    print(f"  profile of one train step ({acc_steps or ACC_STEPS} "
          f"microbatches): device "
          f"{busy:.1f} ms, wall {out['wall_ms_per_step']:.1f} ms, idle share "
          f"{out['idle_share']:.3f}, {out['device_ops_per_step']} device "
          f"operations (kernels, copies, fills) launched", flush=True)
    for k, ms in out["by_kind_ms"].items():
        print(f"    {k:26s} {ms:9.2f} ms  {ms / busy:6.1%}", flush=True)
    for ms, cnt, name in sorted(top, reverse=True)[:10]:
        print(f"    top: {ms:9.2f} ms x{cnt:<5d} {name}", flush=True)
    return out


def check_train(device, results):
    """The full-width train step: EffNetV2-M at 480x480, 6-layer DistilBERT
    at seq 64, fp32 master weights, bf16 images, batch 16 x acc 10, SGD lr
    0.0016 reg 0.03, class weights, augmentation at p=1.0, head dropout
    0.6. Three optimizer steps all trainable and one with the phase-1
    mask, launch counts per microbatch asserted; then the kernel path
    against the plain path on one microbatch."""
    import torch

    from garbage_classification_rca_tpu_torch.cli.main_both import (
        fusion_head_mask)
    from garbage_classification_rca_tpu_torch.data.augment import (
        augment_batch)
    from garbage_classification_rca_tpu_torch.data.images import (
        normalize_on_device)
    from garbage_classification_rca_tpu_torch.data.tokenizer import (
        WordPieceTokenizer)
    from garbage_classification_rca_tpu_torch.models.fusion import multimodal
    from garbage_classification_rca_tpu_torch.nn.core import Key
    from garbage_classification_rca_tpu_torch.train.loop import (
        make_train_step)
    from garbage_classification_rca_tpu_torch.train.optim import (
        make_optimizer)

    ok = True
    cfg = multimodal.FusionConfig(strategy="MM_RCA", reverse=True,
                                  drop_ratio=0.6,
                                  image_or_text_dropout_chance=0.0)
    model = multimodal.build_fusion_model(
        cfg, device=device, generator=torch.Generator().manual_seed(SEED + 8))
    tok = WordPieceTokenizer.from_vocab_file(
        "tests/fixtures/vocab/wordpiece/vocab.txt")
    stack = _train_stack(tok, ACC_STEPS, TRAIN_BATCH, SEED + 9, device)
    class_weights = torch.tensor([0.8, 1.1, 0.9, 1.3], device=device)
    dtype = torch.bfloat16

    def batch_to_inputs(mb, key):
        x = augment_batch(mb["image"], 1.0, key.generator(device))
        return (mb["input_ids"], mb["attention_mask"],
                normalize_on_device(x, dtype=dtype))

    def make(trainable):
        opt = make_optimizer("sgd", model.named_parameters(), 0.0016,
                             0.03, trainable)
        return make_train_step(model, opt, batch_to_inputs=batch_to_inputs,
                               class_weights=class_weights)

    step_all = make(None)
    step_heads = make(fusion_head_mask(model))
    key = Key(SEED + 10)
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.startswith(("text.layers.0.q", "image.stem", "rca_ti",
                               "final_with_everything"))}
    float(step_all(stack, key.fold_in(100))[0])     # warm-up step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    _zero_counters()
    t0 = time.perf_counter()
    losses, norms = [], []
    for s, step in enumerate((step_all, step_all, step_all, step_heads)):
        loss, mb_losses, nrm = step(stack, key.fold_in(s))
        losses.append(float(loss))
        norms.append({k: float(v) for k, v in nrm.items()})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counters()
    peak = torch.cuda.max_memory_allocated(device)
    n_mb = 4 * ACC_STEPS
    want = _want_launches(**{k: v * n_mb
                             for k, v in TRAIN_LAUNCHES.items()})
    ok &= launches == want
    print(f"  launches over 4 steps x {ACC_STEPS} microbatches: {launches} "
          f"(want {want})", flush=True)
    changed = {n: bool((p.detach() != before[n]).any())
               for n, p in model.named_parameters() if n in before}
    finite = all(l == l and abs(l) < float("inf") for l in losses)
    ok &= finite and all(changed.values())
    steps_per_s = 4 / wall
    print(f"  4 optimizer steps in {wall:.2f} s: {steps_per_s:.3f} steps/s, "
          f"{steps_per_s * ACC_STEPS * TRAIN_BATCH:.1f} train samples/s; "
          f"peak memory {peak / 2**30:.2f} GiB; losses {losses}; grad norms "
          f"{[round(n['grad_norm'], 4) for n in norms]}; params changed "
          f"{changed}", flush=True)
    results["train"] = {"steps_per_s": steps_per_s,
                        "samples_per_s": steps_per_s * ACC_STEPS * TRAIN_BATCH,
                        "step_ms": wall / 4 * 1e3, "peak_mem_gib": peak / 2**30,
                        "losses": losses, "norms": norms,
                        "batch": TRAIN_BATCH, "acc_steps": ACC_STEPS}
    results["train_launches"] = launches
    results["train"]["profile"] = profile_train_step(step_all, stack,
                                                     key.fold_in(200))
    # one further step with the DistilBERT tower's internal dropout on
    model.cfg = dataclasses.replace(cfg, hf_internal_dropout=True)
    _zero_counters()
    loss_hf = float(step_all(stack, key.fold_in(300))[0])
    torch.cuda.synchronize()
    launches = _read_counters()
    model.cfg = cfg
    want = _want_launches(rca_fused=ACC_STEPS, rca_fused_bwd=ACC_STEPS,
                          mha_fwd_lse_drop=6 * ACC_STEPS,
                          mha_flash_bwd_drop=6 * ACC_STEPS)
    ok &= launches == want and loss_hf == loss_hf
    print(f"  one step with hf_internal_dropout: loss {loss_hf:.4f}, "
          f"launches { {k: v for k, v in launches.items() if v} } (want "
          f"{ {k: v for k, v in want.items() if v} }, every other 0)",
          flush=True)
    results["train_hf_dropout_launches"] = launches
    ok &= compare_train_paths(model, cfg, stack, class_weights, results)
    del model, stack
    torch.cuda.empty_cache()
    return ok


def _write_jpeg_tree(root, n_train, n_val, seed, size=480):
    """A 4-class tree ``<root>_Train`` / ``<root>_Val`` of `size` x `size`
    JPEGs whose file names carry the text."""
    import os

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    words = {"black": "coffee cup", "blue": "water bottle",
             "green": "banana peel", "ttr": "battery pack"}
    for split, n in (("_Train", n_train), ("_Val", n_val)):
        for c, (cls, text) in enumerate(words.items()):
            d = os.path.join(root + split, cls)
            os.makedirs(d, exist_ok=True)
            for j in range(n // 4):
                arr = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
                arr[..., c % 3] //= 2
                Image.fromarray(arr).save(
                    os.path.join(d, f"{text.replace(' ', '_')}_{j}.jpg"),
                    quality=90)


def check_cli(device, results):
    """``cli.main_both`` with the MM_RCA.sh flags for 1 + 1 epochs on a
    synthetic 480x480 tree (64 train, 32 val), then ``cli.test_both``'s
    evaluation on its BEST checkpoint (its report step writes a seaborn
    PNG and a pandas CSV, packages the card's machine lacks); both in this
    process, in a work directory of the checkout, deleted afterwards."""
    import glob
    import json as _json
    import os
    import shutil

    from garbage_classification_rca_tpu_torch.cli import main_both, test_both
    from garbage_classification_rca_tpu_torch.config import args_parser

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "runs", "chip_smoke_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    _write_jpeg_tree(os.path.join(work, "garbage"), 64, 32, SEED + 12)
    vocab = os.path.join(here, "tests", "fixtures", "vocab", "wordpiece")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        best = main_both.main([
            "--dataset_folder_name=garbage", "--late_fusion=MM_RCA",
            "--ft_epochs=1", "--epochs=1", "--prob_aug=1.00",
            "--acc_steps=10", "--acc_steps_FT=10", "--opt=sgd",
            "--text_model=distilbert", "--fraction_lr=3",
            "--image_text_dropout=0.0", "--balance_weights", "--reg=0.03",
            "--lr=0.0016", "--reverse", f"--vocab_dir={vocab}"])
        train_s = time.perf_counter() - t0
        rows = [_json.loads(line) for f in glob.glob("runs/*.jsonl")
                for line in open(f)]
        bests = glob.glob("model_weights/MM_RCA_distilbert/BEST_*")
        t0 = time.perf_counter()
        acc, _, preds, _ = test_both.evaluate(args_parser([
            "--late_fusion=MM_RCA", "--reverse", "--text_model=distilbert",
            f"--model_path={best.best_path}",
            "--dataset_folder_name=garbage_Val", f"--vocab_dir={vocab}",
            "--eval_batch_size=16"]))
        test_s = time.perf_counter() - t0
        bests = [os.path.join(work, b) for b in bests]
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    ok = (len(rows) == 2 and all(r["avg_loss"] == r["avg_loss"]
                                  for r in rows)
          and {r["phase"] for r in rows} == {"train", "fine_tune"}
          and all({"val_acc_image_only", "val_acc_text_only"} <= set(r)
                  for r in rows)
          and best.best_path in bests
          and 0.0 <= acc <= 100.0 and len(preds) == 32)
    print(f"  cli.main_both 1+1 epochs in {train_s:.1f} s: "
          f"{[(r['phase'], round(r['avg_loss'], 4), r['val_acc']) for r in rows]}"
          f", BEST {os.path.basename(best.best_path or '')}; cli.test_both "
          f"on it in {test_s:.1f} s: accuracy {acc:.2f} %", flush=True)
    results["cli"] = {"train_s": train_s, "test_s": test_s, "rows": rows,
                      "test_acc": acc}
    return ok


# ---------------------------------------------------------------------------
# phases 6 and 7: the unimodal eval paths
# ---------------------------------------------------------------------------

TEXT_BATCH, TEXT_BATCHES, TEXT_SEQ = 256, 4, 64    # TEXT_ARCHS eval batch
IMAGE_BATCH, IMAGE_BATCHES, IMAGE_SIZE = 64, 4, 224   # IMAGE_ARCHS, B/16


class SyntheticEvalBatcher:
    """Batcher stand-in for the unimodal eval loops: seeded token ids from
    the tokenizer's vocabulary (text) or uint8 images, fixed-shape batches
    made before the run."""

    def __init__(self, n_batches, batch_size, seed, *, tokenizer=None,
                 seq_len=0, image_size=0):
        import numpy as np

        rng = np.random.default_rng(seed)
        self.m = list(range(n_batches * batch_size))
        self.batches = []
        words = tokenizer and [w for w in tokenizer.vocab if w.isalpha()]
        for _ in range(n_batches):
            batch = {"label": rng.integers(0, 4, batch_size).astype(np.int32),
                     "valid": np.ones(batch_size, np.int32)}
            if tokenizer is not None:
                texts = [" ".join(rng.choice(words, rng.integers(2, 40)))
                         for _ in range(batch_size)]
                enc = tokenizer.encode_batch(texts, seq_len)
                batch["input_ids"] = enc.input_ids
                batch["attention_mask"] = enc.attention_mask
            else:
                batch["image"] = rng.integers(
                    0, 256, (batch_size, image_size, image_size, 3),
                    dtype=np.uint8)
            self.batches.append(batch)

    def iter_batches(self, batch_size, *, shuffle=False, **_):
        assert batch_size == len(self.batches[0]["label"]) and not shuffle
        yield from self.batches


def _eval_path(title, model32, data, run, step_of, logits_of, per_batch,
               device, results, key):
    """One unimodal eval path on the card. fp32 (TF32 off) on 16 samples:
    kernel path against plain path. Then bf16: a warm-up run, the measured
    run with the counters zeroed before and read after, two more runs for
    the spread, a profile of one batch, and the logits of two batches
    against the plain path."""
    import copy

    import torch

    ok = True
    batch_size = len(data.batches[0]["label"])
    n_batches = len(data.batches)
    print(f"  {title}: {n_batches} batches of {batch_size}", flush=True)
    small = {k: v[:16] for k, v in data.batches[0].items()}
    torch.backends.cudnn.allow_tf32 = False
    lk = logits_of(model32, small, torch.float32)
    with plain_versions():
        lp = logits_of(model32, small, torch.float32)
    torch.backends.cudnn.allow_tf32 = True
    d32 = float((lk - lp).abs().max())
    same32 = bool((lk.argmax(-1) == lp.argmax(-1)).all())
    fin = bool(torch.isfinite(lk).all())
    ok &= fin and same32 and d32 <= 1e-4 and tuple(lk.shape) == (16, 4)
    print(f"  fp32 logits kernel vs plain: max|d|={d32:.3e}, argmax equal="
          f"{same32}, finite={fin}", flush=True)

    model = copy.deepcopy(model32).to(torch.bfloat16)
    del model32
    torch.cuda.empty_cache()
    run(model, data)                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    _zero_counters()
    acc, labels, preds, stats = run(model, data)
    torch.cuda.synchronize()
    launches = _read_counters()
    peak = torch.cuda.max_memory_allocated(device)
    want = _want_launches(**{k: v * n_batches for k, v in per_batch.items()})
    ok &= launches == want and len(preds) == n_batches * batch_size
    print(f"  launches over {n_batches} batches: "
          f"{ {k: v for k, v in launches.items() if v} } (want "
          f"{ {k: v for k, v in want.items() if v} }, every other 0)",
          flush=True)
    results[key + "_launches"] = launches
    rates, p50s = [stats["samples_per_s"]], [stats["p50_step_s"] * 1e3]
    for _ in range(2):
        st = run(model, data)[3]
        rates.append(st["samples_per_s"])
        p50s.append(st["p50_step_s"] * 1e3)
    print(f"  run_eval x3 over {n_batches} batches of {batch_size}: "
          f"samples/s {sorted(rates)}, p50 batch ms {sorted(p50s)} (the p50 "
          f"includes the prediction readback); peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    results[key] = {"samples_per_s": sorted(rates)[1],
                    "samples_per_s_runs": rates,
                    "p50_batch_ms": sorted(p50s)[1],
                    "peak_mem_gib": peak / 2**30, "batches": n_batches,
                    "batch": batch_size,
                    "profile": profile_step(step_of(model), data.batches[0],
                                            device)}
    agree, n, dmax = 0, 0, 0.0
    for batch in data.batches[:2]:
        lk = logits_of(model, batch, torch.bfloat16)
        with plain_versions():
            lp = logits_of(model, batch, torch.bfloat16)
        ok &= bool(torch.isfinite(lk).all())
        ok &= tuple(lk.shape) == (batch_size, 4)
        agree += int((lk.argmax(-1) == lp.argmax(-1)).sum())
        n += lk.shape[0]
        dmax = max(dmax, float((lk - lp).abs().max()))
    ok &= agree / n >= 0.98 and dmax <= 0.05
    results[key].update(argmax_agreement=agree / n, max_logit_diff=dmax,
                        fp32_max_logit_diff=d32)
    print(f"  bf16 logits kernel vs plain over {n} samples: argmax "
          f"agreement {agree / n:.4f}, max|d|={dmax:.3e}", flush=True)
    del model
    torch.cuda.empty_cache()
    return ok


def _text_logits(model, batch, dtype):
    import torch

    dev = next(model.parameters()).device
    with torch.inference_mode():
        return model(torch.from_numpy(batch["input_ids"]).to(dev),
                     torch.from_numpy(batch["attention_mask"]).to(dev)
                     ).float()


def _image_logits(model, batch, dtype):
    import torch

    from garbage_classification_rca_tpu_torch.data.images import (
        normalize_on_device)

    dev = next(model.parameters()).device
    with torch.inference_mode():
        return model(normalize_on_device(
            torch.from_numpy(batch["image"]).to(dev), dtype=dtype)).float()


def check_text_eval(device, results):
    """BERT-base at full width and depth through ``run_eval`` with
    ``cli.test_text``'s step; then one batch each of DistilBERT and
    RoBERTa for the launch counts and the agreement with the plain path."""
    import torch

    from garbage_classification_rca_tpu_torch.cli.test_text import (
        make_text_eval_step)
    from garbage_classification_rca_tpu_torch.data.tokenizer import (
        get_tokenizer)
    from garbage_classification_rca_tpu_torch.eval.harness import run_eval
    from garbage_classification_rca_tpu_torch.models.registry import (
        get_text_model)

    keys = ("input_ids", "attention_mask", "label", "valid")

    def run(model, data):
        return run_eval(make_text_eval_step(model), data,
                        len(data.batches[0]["label"]), device, keys=keys,
                        progress=False)

    def build(name, seed):
        return get_text_model(name).build(
            4, generator=torch.Generator().manual_seed(seed)).to(device).eval()

    tok = get_tokenizer("bert", vocab_dir="tests/fixtures/vocab/wordpiece")
    data = SyntheticEvalBatcher(TEXT_BATCHES, TEXT_BATCH, SEED + 30,
                                tokenizer=tok, seq_len=TEXT_SEQ)
    ok = _eval_path("bert", build("bert", SEED + 31), data, run,
                    make_text_eval_step, _text_logits,
                    {"postnorm_attn_block": 12, "postnorm_mlp_block": 12},
                    device, results, "text_eval")
    for name, vocab, layers in (("distilbert", "wordpiece", 6),
                                ("roberta", "bpe", 12)):
        tok = get_tokenizer(name, vocab_dir=f"tests/fixtures/vocab/{vocab}")
        one = SyntheticEvalBatcher(1, TEXT_BATCH, SEED + 32, tokenizer=tok,
                                   seq_len=TEXT_SEQ)
        model = build(name, SEED + 33).to(torch.bfloat16)
        _zero_counters()
        preds = run(model, one)[2]
        torch.cuda.synchronize()
        launches = _read_counters()
        want = _want_launches(postnorm_attn_block=layers,
                              postnorm_mlp_block=layers)
        lk = _text_logits(model, one.batches[0], torch.bfloat16)
        with plain_versions():
            lp = _text_logits(model, one.batches[0], torch.bfloat16)
        frac = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
        dmax = float((lk - lp).abs().max())
        good = (launches == want and len(preds) == TEXT_BATCH
                and bool(torch.isfinite(lk).all()) and frac >= 0.98
                and dmax <= 0.05)
        ok &= good
        print(f"  {name}: one batch of {TEXT_BATCH}, launches "
              f"{ {k: v for k, v in launches.items() if v} }, bf16 kernel vs "
              f"plain argmax agreement {frac:.4f}, max|d|={dmax:.3e} "
              f"{'ok' if good else 'FAIL'}", flush=True)
        results[f"text_eval_{name}"] = {"argmax_agreement": frac,
                                        "max_logit_diff": dmax}
        del model
        torch.cuda.empty_cache()
    return ok


def check_image_eval(device, results):
    """ViT-B/16 at full width and depth through ``run_image_eval``."""
    import torch

    from garbage_classification_rca_tpu_torch.eval.harness import (
        make_eval_step, run_image_eval)
    from garbage_classification_rca_tpu_torch.models.registry import (
        get_image_model)

    def run(model, data):
        return run_image_eval(model, data, len(data.batches[0]["label"]),
                              device, torch.bfloat16, progress=False)

    model = get_image_model("transformer_B16").build(
        4, generator=torch.Generator().manual_seed(SEED + 41)).to(device).eval()
    with torch.no_grad():    # torchvision's class token starts at zero
        model.class_token.normal_(0.0, 0.02, generator=torch.Generator(
            device=device).manual_seed(SEED + 42))
    data = SyntheticEvalBatcher(IMAGE_BATCHES, IMAGE_BATCH, SEED + 40,
                                image_size=IMAGE_SIZE)
    return _eval_path("transformer_B16", model, data, run,
                      lambda m: make_eval_step(m, torch.bfloat16),
                      _image_logits, {"attn_block": 12, "mlp_block": 12},
                      device, results, "image_eval")


_DISTILBERT_KEYS = {"q": "attention.q_lin", "k": "attention.k_lin",
                    "v": "attention.v_lin", "out": "attention.out_lin",
                    "ln_att": "sa_layer_norm", "fc1": "ffn.lin1",
                    "fc2": "ffn.lin2", "ln_ffn": "output_layer_norm"}
_VIT_KEYS = {"ln_1": "ln_1", "ln_2": "ln_2", "out": "self_attention.out_proj",
             "fc1": "mlp.linear_1", "fc2": "mlp.linear_2"}
_LEAF = {"w": "weight", "b": "bias", "scale": "weight", "bias": "bias"}


def _reference_state_dict(model, kind):
    """The port model's weights under the reference checkpoint's key names
    (HF DistilBERT classifier under ``model.`` / ``out.``; torchvision ViT):
    the port's parameters already have torch's layouts."""
    sd = {}
    for name, t in model.state_dict().items():
        parts = name.split(".")
        leaf = _LEAF.get(parts[-1])
        if kind == "distilbert":
            if parts[0] == "head":
                key = f"out.{leaf}"
            elif parts[1] == "layers":
                key = (f"model.transformer.layer.{parts[2]}."
                       f"{_DISTILBERT_KEYS[parts[3]]}.{leaf}")
            else:
                key = "model.embeddings." + {
                    "word_emb": "word_embeddings.weight",
                    "pos_emb": "position_embeddings.weight",
                    "ln_emb": f"LayerNorm.{leaf}"}[parts[1]]
        elif parts[0] == "layers":
            pre = f"encoder.layers.encoder_layer_{parts[1]}."
            key = pre + (f"self_attention.in_proj_{leaf}" if parts[2] == "qkv"
                         else f"{_VIT_KEYS[parts[2]]}.{leaf}")
        else:
            key = {"class_token": "class_token",
                   "pos_embedding": "encoder.pos_embedding",
                   "conv_proj": f"conv_proj.{leaf}",
                   "ln": f"encoder.ln.{leaf}",
                   "head": f"heads.head.{leaf}"}[parts[0]]
        sd[key] = t.detach().cpu().contiguous()
    return sd


def check_eval_clis(device, results):
    """``cli.test_text`` (DistilBERT, 6 layers) and ``cli.test_image``
    (ViT-B/16, 12 layers) on reference-layout ``.pth`` files with random
    seeded weights and a synthetic 32-image JPEG tree: the CLIs' own
    loading, tokenizing, decoding and evaluation (their report step writes
    a seaborn PNG and a pandas CSV, packages the card's machine lacks),
    with the launch counts of two batches of 16 asserted."""
    import os
    import shutil

    import torch

    from garbage_classification_rca_tpu_torch.cli import test_image, test_text
    from garbage_classification_rca_tpu_torch.config import args_parser
    from garbage_classification_rca_tpu_torch.models.registry import (
        get_image_model, get_text_model)

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "runs", "chip_smoke_eval_clis")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    vocab = os.path.join(here, "tests", "fixtures", "vocab", "wordpiece")
    out = {}
    try:
        _write_jpeg_tree(os.path.join(work, "garbage"), 0, 32, SEED + 50)
        val = os.path.join(work, "garbage_Val")
        for cli, flag, name, kind, counts in (
                (test_text, "text_model", "distilbert", "distilbert",
                 {"postnorm_attn_block": 6, "postnorm_mlp_block": 6}),
                (test_image, "image_model", "transformer_B16", "vit",
                 {"attn_block": 12, "mlp_block": 12})):
            getter = get_text_model if kind == "distilbert" else \
                get_image_model
            model = getter(name).build(
                4, generator=torch.Generator().manual_seed(SEED + 51))
            ckpt = os.path.join(work, f"{name}.pth")
            torch.save(_reference_state_dict(model, kind), ckpt)
            del model
            _zero_counters()
            t0 = time.perf_counter()
            res = cli.evaluate(args_parser([
                f"--{flag}={name}", f"--model_path={ckpt}",
                f"--dataset_folder_name={val}", f"--vocab_dir={vocab}",
                "--eval_batch_size=16"]))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            acc, labels, preds = res[0], res[1], res[2]
            launches = _read_counters()
            want = _want_launches(**{k: 2 * v for k, v in counts.items()})
            good = (launches == want and len(preds) == 32
                    and 0.0 <= acc <= 100.0
                    and sorted(set(labels.tolist())) == [0, 1, 2, 3])
            print(f"  cli.{cli.__name__.rsplit('.', 1)[-1]} --{flag}={name} "
                  f"on 32 JPEGs in {secs:.1f} s: accuracy {acc:.2f} %, "
                  f"launches { {k: v for k, v in launches.items() if v} } "
                  f"{'ok' if good else 'FAIL'}", flush=True)
            out[name] = {"seconds": secs, "acc": acc, "ok": good}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    results["eval_clis"] = out
    return all(v["ok"] for v in out.values())


# ---------------------------------------------------------------------------
# phases 8 and 9: the unimodal train paths
# ---------------------------------------------------------------------------

TEXT_TRAIN_BATCH, BERT_TRAIN_BATCH = 128, 64     # TEXT_ARCHS train batches
IMAGE_TRAIN_BATCH = 128                          # IMAGE_ARCHS, B/16
UNIMODAL_LR, UNIMODAL_REG = 0.001, 0.01          # the CLIs' defaults


def _unimodal_grads(model, forward, inputs, mb, class_weights, key):
    """One microbatch's loss and {name: grad} through the model's current
    call sites (kernels or plain versions)."""
    import torch

    from garbage_classification_rca_tpu_torch.train.loss import (
        cross_entropy_loss_and_weight)

    for p in model.parameters():
        p.grad = None
    with torch.enable_grad():
        logits = forward(*inputs, train=True, key=key)
        loss, _ = cross_entropy_loss_and_weight(
            logits, mb["label"], class_weights, 0.0, mb["valid"])
        loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return float(loss.detach()), grads


def compare_unimodal_paths(title, model, forward, inputs, mb, class_weights,
                           key, fp32):
    """Kernel path against plain path from the same key (the dropout masks
    are drawn outside the kernels, so both paths see the same ones). fp32
    with TF32 off: the loss within 1e-5 relative, every gradient within
    1e-4 of its tensor's largest |g|; bf16 activations: 1e-3 and cosine >=
    BF16_COS. The attention key biases, whose gradient is zero in exact
    arithmetic, are held to their sibling weight's scale as
    ``compare_train_paths`` holds them."""
    import torch

    exact_zero = {n for n, _ in model.named_parameters()
                  if n.endswith("k.b")}
    torch.backends.cudnn.allow_tf32 = not fp32
    lk, gk = _unimodal_grads(model, forward, inputs, mb, class_weights, key)
    with plain_versions():
        lp, gp = _unimodal_grads(model, forward, inputs, mb, class_weights,
                                 key)
    torch.backends.cudnn.allow_tf32 = True
    rel = abs(lk - lp) / max(abs(lp), 1e-30)
    scores, biases, zeros, finite = _grad_scores(gk, gp, fp32, exact_zero)
    ok = finite and lk == lk and rel <= (1e-5 if fp32 else 1e-3)
    ok &= all(z <= 0.1 for z, _ in zeros)
    ok &= all(r <= (1e-4 if fp32 else BF16_NOISE_BIAS) for r, _ in biases)
    ok &= all((r <= 1e-4) if fp32 else (r >= BF16_COS) for r, _ in scores)
    row = {"loss_kernel": lk, "loss_plain": lp, "loss_rel": rel,
           "worst": _worst(scores), "worst_key_bias": _worst(biases),
           "exact_zero_worst": _worst(zeros)}
    print(f"  {title}, kernel vs plain, {'fp32' if fp32 else 'bf16'}: "
          f"{json.dumps(row)} {'ok' if ok else 'FAIL'}", flush=True)
    return ok, row


def _timed_steps(steps, stack, key, device):
    """Run the steps; (wall seconds, losses, launches, peak bytes)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    _zero_counters()
    t0 = time.perf_counter()
    losses = [float(step(stack, key.fold_in(s))[0])
              for s, step in enumerate(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, losses, _read_counters(), torch.cuda.max_memory_allocated(
        device)


def _shown(launches):
    return {k: v for k, v in launches.items() if v}


def check_text_train(device, results):
    """The text trainer's step at full width and depth: DistilBERT, batch
    128, seq 64, fp32, SGD, head dropout 0.6, class weights, with and
    without ``hf_internal_dropout``; one step of BERT-base with it."""
    import torch

    from garbage_classification_rca_tpu_torch.cli.main_text import (
        HEAD_DROPOUT, head_keys_for)
    from garbage_classification_rca_tpu_torch.data.tokenizer import (
        get_tokenizer)
    from garbage_classification_rca_tpu_torch.models.registry import (
        get_text_model)
    from garbage_classification_rca_tpu_torch.nn.core import Key
    from garbage_classification_rca_tpu_torch.train.loop import (
        head_only_mask, make_train_step)
    from garbage_classification_rca_tpu_torch.train.optim import (
        make_optimizer)

    ok = True
    tok = get_tokenizer("distilbert",
                        vocab_dir="tests/fixtures/vocab/wordpiece")
    class_weights = torch.tensor([0.8, 1.1, 0.9, 1.3], device=device)
    key = Key(SEED + 70)

    def stack_of(batch):
        data = SyntheticEvalBatcher(1, batch, SEED + 71, tokenizer=tok,
                                    seq_len=TEXT_SEQ)
        return {k: torch.from_numpy(v)[None].to(device)
                for k, v in data.batches[0].items()}

    def inputs(mb, key):
        return (mb["input_ids"], mb["attention_mask"])

    def make(model, flag, trainable=None):
        opt = make_optimizer("sgd", model.named_parameters(), UNIMODAL_LR,
                             UNIMODAL_REG, trainable)
        return make_train_step(
            model, opt, batch_to_inputs=inputs, class_weights=class_weights,
            forward=functools.partial(model, drop_ratio=HEAD_DROPOUT,
                                      hf_internal_dropout=flag))

    model = get_text_model("distilbert").build(
        4, generator=torch.Generator().manual_seed(SEED + 72)).to(
            device).eval()
    stack = stack_of(TEXT_TRAIN_BATCH)
    step_on = make(model, True)
    step_heads = make(model, True, head_only_mask(
        model, head_keys_for("distilbert")))
    step_off = make(model, False)
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if n in ("encoder.layers.0.q.w", "encoder.word_emb.w",
                       "head.w")}
    float(step_on(stack, key.fold_in(100))[0])             # warm-up
    float(step_off(stack, key.fold_in(101))[0])
    wall, losses, launches, peak = _timed_steps(
        (step_on, step_on, step_on, step_heads), stack, key, device)
    want = _want_launches(mha_fwd_lse_drop=6 * 4, mha_flash_bwd_drop=6 * 4)
    changed = {n: bool((p.detach() != before[n]).any())
               for n, p in model.named_parameters() if n in before}
    finite = all(l == l and abs(l) < float("inf") for l in losses)
    ok &= launches == want and finite and all(changed.values())
    print(f"  distilbert, hf_internal_dropout: 4 steps of {TEXT_TRAIN_BATCH} "
          f"in {wall:.3f} s: {4 / wall:.2f} steps/s, "
          f"{4 * TEXT_TRAIN_BATCH / wall:.1f} samples/s; peak memory "
          f"{peak / 2**30:.2f} GiB; losses {losses}; launches "
          f"{_shown(launches)} (want {_shown(want)}, every other 0); params "
          f"changed {changed}", flush=True)
    results["text_train_launches"] = launches
    results["text_train"] = {
        "steps_per_s": 4 / wall, "samples_per_s": 4 * TEXT_TRAIN_BATCH / wall,
        "step_ms": wall / 4 * 1e3, "peak_mem_gib": peak / 2**30,
        "losses": losses, "batch": TEXT_TRAIN_BATCH, "seq": TEXT_SEQ}
    wall, losses, launches, _ = _timed_steps((step_off,) * 4, stack, key,
                                             device)
    want = _want_launches(mha_fwd_lse=6 * 4, mha_flash_bwd=6 * 4)
    ok &= launches == want and all(l == l for l in losses)
    print(f"  distilbert, flag off: 4 steps in {wall:.3f} s: "
          f"{4 / wall:.2f} steps/s; launches {_shown(launches)} (want "
          f"{_shown(want)}, every other 0)", flush=True)
    results["text_train"]["flag_off_steps_per_s"] = 4 / wall
    results["text_train_flag_off_launches"] = launches
    results["text_train"]["profile"] = profile_train_step(
        step_on, stack, key.fold_in(200), reps=3, acc_steps=1)
    results["text_train"]["profile_flag_off"] = profile_train_step(
        step_off, stack, key.fold_in(201), reps=3, acc_steps=1)
    mb = {k: v[0] for k, v in stack.items()}
    good, row = compare_unimodal_paths(
        "distilbert microbatch with hf_internal_dropout", model,
        functools.partial(model, drop_ratio=HEAD_DROPOUT,
                          hf_internal_dropout=True),
        inputs(mb, None), mb, class_weights, Key(SEED + 73), True)
    ok &= good
    results["text_train"]["grad_check"] = row
    del model, step_on, step_heads, step_off
    torch.cuda.empty_cache()

    bert = get_text_model("bert").build(
        4, generator=torch.Generator().manual_seed(SEED + 74)).to(
            device).eval()
    stack = stack_of(BERT_TRAIN_BATCH)
    step = make(bert, True)
    wall, losses, launches, _ = _timed_steps((step,), stack, key, device)
    want = _want_launches(mha_fwd_lse_drop=12, mha_flash_bwd_drop=12)
    ok &= launches == want and losses[0] == losses[0]
    print(f"  bert, hf_internal_dropout: one step of {BERT_TRAIN_BATCH}: "
          f"loss {losses[0]:.4f}, launches {_shown(launches)} (want "
          f"{_shown(want)}, every other 0)", flush=True)
    del bert, step
    torch.cuda.empty_cache()
    return ok


def check_image_train(device, results):
    """The image trainer's step at full width and depth: ViT-B/16, batch
    128, 224x224, bf16 images over fp32 master weights, augmentation at
    p=1.0, SGD, class weights."""
    import numpy as np
    import torch

    from garbage_classification_rca_tpu_torch.cli.main_image import (
        head_keys_for)
    from garbage_classification_rca_tpu_torch.data.augment import (
        augment_batch)
    from garbage_classification_rca_tpu_torch.data.images import (
        normalize_on_device)
    from garbage_classification_rca_tpu_torch.models.registry import (
        get_image_model)
    from garbage_classification_rca_tpu_torch.nn.core import Key
    from garbage_classification_rca_tpu_torch.train.loop import (
        head_only_mask, make_train_step)
    from garbage_classification_rca_tpu_torch.train.optim import (
        make_optimizer)

    ok = True
    model = get_image_model("transformer_B16").build(
        4, generator=torch.Generator().manual_seed(SEED + 80)).to(
            device).eval()
    with torch.no_grad():    # torchvision's class token starts at zero
        model.class_token.normal_(0.0, 0.02, generator=torch.Generator(
            device=device).manual_seed(SEED + 81))
    rng = np.random.default_rng(SEED + 82)
    stack = {"image": torch.from_numpy(rng.integers(
                 0, 256, (1, IMAGE_TRAIN_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3),
                 dtype=np.uint8)).to(device),
             "label": torch.from_numpy(rng.integers(
                 0, 4, (1, IMAGE_TRAIN_BATCH)).astype(np.int32)).to(device),
             "valid": torch.ones((1, IMAGE_TRAIN_BATCH), dtype=torch.int32,
                                 device=device)}
    class_weights = torch.tensor([0.8, 1.1, 0.9, 1.3], device=device)
    key = Key(SEED + 83)

    def inputs_in(dtype):
        def batch_to_inputs(mb, key):
            x = augment_batch(mb["image"], 1.0, key.generator(device))
            return (normalize_on_device(x, dtype=dtype),)
        return batch_to_inputs

    def make(trainable=None):
        opt = make_optimizer("sgd", model.named_parameters(), UNIMODAL_LR,
                             UNIMODAL_REG, trainable)
        return make_train_step(model, opt,
                               batch_to_inputs=inputs_in(torch.bfloat16),
                               class_weights=class_weights)

    step_all = make()
    step_heads = make(head_only_mask(model, head_keys_for("transformer_B16")))
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if n in ("layers.0.qkv.w", "conv_proj.w", "head.w")}
    float(step_all(stack, key.fold_in(100))[0])            # warm-up
    wall, losses, launches, peak = _timed_steps(
        (step_all, step_all, step_all, step_heads), stack, key, device)
    want = _want_launches(mha_fwd_lse=12 * 4, mha_flash_bwd=12 * 4)
    changed = {n: bool((p.detach() != before[n]).any())
               for n, p in model.named_parameters() if n in before}
    finite = all(l == l and abs(l) < float("inf") for l in losses)
    ok &= launches == want and finite and all(changed.values())
    print(f"  transformer_B16: 4 steps of {IMAGE_TRAIN_BATCH} in {wall:.3f} "
          f"s: {4 / wall:.2f} steps/s, {4 * IMAGE_TRAIN_BATCH / wall:.1f} "
          f"samples/s; peak memory {peak / 2**30:.2f} GiB; losses {losses}; "
          f"launches {_shown(launches)} (want {_shown(want)}, every other "
          f"0); params changed {changed}", flush=True)
    results["image_train_launches"] = launches
    results["image_train"] = {
        "steps_per_s": 4 / wall,
        "samples_per_s": 4 * IMAGE_TRAIN_BATCH / wall,
        "step_ms": wall / 4 * 1e3, "peak_mem_gib": peak / 2**30,
        "losses": losses, "batch": IMAGE_TRAIN_BATCH,
        "profile": profile_train_step(step_all, stack, key.fold_in(200),
                                      reps=2, acc_steps=1)}
    # kernel path against plain path on 32 samples
    mb = {k: v[0, :32] for k, v in stack.items()}
    checks = {}
    for dtype in (torch.float32, torch.bfloat16):
        k_in, k_model = Key(SEED + 84).split(2)
        good, row = compare_unimodal_paths(
            "transformer_B16 microbatch of 32", model, model,
            inputs_in(dtype)(mb, k_in), mb, class_weights, k_model,
            dtype == torch.float32)
        ok &= good
        checks[str(dtype)[6:]] = row
    results["image_train"]["grad_check"] = checks
    del model, step_all, step_heads, stack
    torch.cuda.empty_cache()
    return ok


def check_train_clis(device, results):
    """``cli.main_text --hf_internal_dropout`` and ``cli.main_image`` for
    1 + 1 epochs on a synthetic 224x224 JPEG tree (64 train, 32 val; the
    file names carry the text), then ``cli.test_text`` / ``cli.test_image``
    evaluate the BEST files (``evaluate()``: the report step needs packages
    the card's machine lacks). In this process, in a work directory of the
    checkout, deleted afterwards."""
    import glob
    import json as _json
    import os
    import shutil

    import torch

    from garbage_classification_rca_tpu_torch.cli import (
        main_image, main_text, test_image, test_text)
    from garbage_classification_rca_tpu_torch.config import args_parser

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "runs", "chip_smoke_train_clis")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    vocab = os.path.join(here, "tests", "fixtures", "vocab", "wordpiece")
    cwd = os.getcwd()
    out = {}
    common = ["--dataset_folder_name=garbage", "--epochs=1", "--ft_epochs=1",
              "--batch_size=16", "--batch_size_FT=16", "--balance_weights",
              "--opt=sgd", f"--vocab_dir={vocab}"]
    # phase 1 and 2: 4 steps each; the val eval: 32 samples in one batch
    runs = (
        ("main_text", main_text, test_text,
         ["--text_model=distilbert", "--hf_internal_dropout", "--seq_len=64"],
         ["--text_model=distilbert", "--seq_len=64"], "distilbert",
         {"mha_fwd_lse_drop": 48, "mha_flash_bwd_drop": 48,
          "postnorm_attn_block": 12, "postnorm_mlp_block": 12},
         {"postnorm_attn_block": 6, "postnorm_mlp_block": 6}),
        ("main_image", main_image, test_image,
         ["--image_model=transformer_B16", "--prob_aug=1.0"],
         ["--image_model=transformer_B16"], "transformer_B16",
         {"mha_fwd_lse": 96, "mha_flash_bwd": 96, "mha": 24},
         {"attn_block": 12, "mlp_block": 12}))
    try:
        _write_jpeg_tree(os.path.join(work, "garbage"), 64, 32, SEED + 90,
                         size=IMAGE_SIZE)
        os.chdir(work)
        for name, trainer, tester, flags, test_flags, model_name, want_train, \
                want_test in runs:
            _zero_counters()
            t0 = time.perf_counter()
            best = trainer.main(common + flags + [f"--name={name}"])
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            launches = _read_counters()
            rows = [_json.loads(line)
                    for f in glob.glob(f"runs/{name}_*.jsonl")
                    for line in open(f)]
            _zero_counters()
            res = tester.evaluate(args_parser(test_flags + [
                f"--model_path={best.best_path}",
                "--dataset_folder_name=garbage_Val", f"--vocab_dir={vocab}",
                "--eval_batch_size=32"]))
            torch.cuda.synchronize()
            test_launches = _read_counters()
            acc, preds = res[0], res[2]
            good = (len(rows) == 2
                    and all(r["avg_loss"] == r["avg_loss"] for r in rows)
                    and {r["phase"] for r in rows} == {"train", "fine_tune"}
                    and launches == _want_launches(**want_train)
                    and test_launches == _want_launches(**want_test)
                    and os.path.isfile(best.best_path)
                    and os.path.dirname(best.best_path).endswith(model_name)
                    and 0.0 <= acc <= 100.0 and len(preds) == 32)
            print(f"  cli.{name} 1+1 epochs in {train_s:.1f} s: "
                  f"{[(r['phase'], round(r['avg_loss'], 4), r['val_acc']) for r in rows]}"
                  f", launches {_shown(launches)}; its BEST file in the test "
                  f"CLI: accuracy {acc:.2f} %, launches "
                  f"{_shown(test_launches)} {'ok' if good else 'FAIL'}",
                  flush=True)
            out[name] = {"train_s": train_s, "rows": rows, "test_acc": acc,
                         "ok": good}
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    results["train_clis"] = out
    return all(v["ok"] for v in out.values())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return _fail("CUDA is not available")
    try:
        from garbage_classification_rca_tpu_torch.kernels import _build
    except ImportError as e:
        return _fail(f"the port's package is missing ({e})")
    device = torch.device("cuda", 0)
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False

    print("[1/9] device", flush=True)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi unavailable"
    print(f"  {name}; {smi_line}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    print("[2/9] build", flush=True)
    t0 = time.perf_counter()
    try:
        logs = _build.build_all()
    except Exception as e:  # noqa: BLE001 — reported, run fails
        return _fail(f"build: {e}")
    print(f"  built {sorted(logs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for n, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {n}: {line.strip()}", flush=True)

    print("[3/9] kernels vs plain versions", flush=True)
    report = {}
    try:
        ok = check_rca(device, report)
        ok &= check_mha(device, report)
        ok &= check_rca_bwd(device, report)
        ok &= check_mha_train(device, report)
        ok &= check_mha_drop(device, report)
        ok &= check_postnorm_blocks(device, report)
        ok &= check_prenorm_blocks(device, report)
    except Exception as e:  # noqa: BLE001 — reported, run fails
        import traceback

        traceback.print_exc()
        return _fail(f"kernels: {type(e).__name__}: {e}")
    if not ok:
        return _fail("a kernel disagrees with its plain version")

    results = {}
    for title, check in (
            ("[4/9] MM-RCA eval path",
             lambda: check_model(device, N_BATCHES, BATCH, results)),
            ("[5/9] MM-RCA train path: full-width train step",
             lambda: check_train(device, results)),
            ("[5/9] MM-RCA train path: cli.main_both -> cli.test_both",
             lambda: check_cli(device, results)),
            ("[6/9] text eval path: BERT-base, DistilBERT, RoBERTa",
             lambda: check_text_eval(device, results)),
            ("[7/9] image eval path: ViT-B/16",
             lambda: check_image_eval(device, results)),
            ("[7/9] unimodal eval CLIs: cli.test_text, cli.test_image",
             lambda: check_eval_clis(device, results)),
            ("[8/9] text train path: DistilBERT and BERT-base with "
             "hf_internal_dropout",
             lambda: check_text_train(device, results)),
            ("[9/9] image train path: ViT-B/16",
             lambda: check_image_train(device, results)),
            ("[9/9] unimodal train CLIs: cli.main_text -> cli.test_text, "
             "cli.main_image -> cli.test_image",
             lambda: check_train_clis(device, results))):
        print(title, flush=True)
        try:
            ok = check()
        except Exception as e:  # noqa: BLE001 — reported, run fails
            import traceback

            traceback.print_exc()
            return _fail(f"{title}: {type(e).__name__}: {e}")
        if not ok:
            return _fail(f"{title}: check failed")
    # launches on each kernel's own main path: the MM-RCA eval path for K1 /
    # K2, its train path for K3 / K4a / K4b (K1 runs on both), the text
    # eval path for K5a / K5b, the image eval path for K6a / K6b, the text
    # train path (hf_internal_dropout) for K7a / K7b
    by_path = {"eval": results["launches"], "train": results["train_launches"],
               "text_eval": results["text_eval_launches"],
               "image_eval": results["image_eval_launches"],
               "text_train": results["text_train_launches"],
               "text_train_flag_off":
                   results["text_train_flag_off_launches"],
               "image_train": results["image_train_launches"],
               "train_hf_dropout": results["train_hf_dropout_launches"]}
    kernels = []
    for key, path in (("rca_fused", "eval"), ("mha", "eval"),
                      ("rca_fused_bwd", "train"), ("mha_fwd_lse", "train"),
                      ("mha_flash_bwd", "train"),
                      ("postnorm_attn_block", "text_eval"),
                      ("postnorm_mlp_block", "text_eval"),
                      ("attn_block", "image_eval"),
                      ("mlp_block", "image_eval"),
                      ("mha_fwd_lse_drop", "text_train"),
                      ("mha_flash_bwd_drop", "text_train")):
        row = dict(report[key])
        row["launches"] = by_path[path][key]
        row["launches_by_path"] = {p: c[key] for p, c in by_path.items()}
        kernels.append(row)
        if row["launches"] <= 0:
            return _fail(f"{key} was not launched on the {path} path")
    print(json.dumps({"model": results["model"], "train": results["train"],
                      "text_eval": results["text_eval"],
                      "text_eval_others": {
                          k: results[f"text_eval_{k}"]
                          for k in ("distilbert", "roberta")},
                      "image_eval": results["image_eval"],
                      "eval_clis": results["eval_clis"],
                      "text_train": results["text_train"],
                      "image_train": results["image_train"],
                      "train_clis": results["train_clis"],
                      "grad_checks": {k: results[k] for k in (
                          "grad_check_fp32", "grad_check_bf16")},
                      "card": smi_line}))
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
