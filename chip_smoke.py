#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (garbage_classification_rca_tpu_torch).

    python3 chip_smoke.py        # needs one NVIDIA GPU; ~1 minute

Phases, each of which fails the run when it fails:
  1. device: the card's name and power limit;
  2. build: nvcc compiles every csrc/*.cu for sm_90a, one process per
     source, all started together;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the main path's shapes and edge cases, with the tolerances below;
     kernel / plain / library-call times from CUDA graphs timed with CUDA
     events after a warm-up (median of 5);
  4. model: the MM-RCA eval path (EfficientNetV2-M at 480x480, 6-layer
     DistilBERT at seq 64, the MM-RCA block, eval batch 128, bf16) with
     random seeded weights over synthetic batches through ``run_eval``;
     launch counters read around that run; logits against the same model
     on the plain versions; samples/s, p50 batch latency, peak memory.

Prints a ``{"kernels": [...]}`` line, the nvidia-smi name/power line, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero, with
no result line, when CUDA is absent or any phase fails.

Tolerances (kernel vs plain version, same inputs, same card):
  * fp32: rca_fused |d| <= 2e-5 + 2e-5|x| (the JAX package's bar for this
    kernel); mha |d| <= 1e-5 + 1e-5|x|. Both compute in fp32 and differ only
    in summation order.
  * bf16: |d| <= one bf16 ulp of the value + 1e-5 (rca_fused: fp32 math,
    one final rounding that may land on either neighbour) and + 1e-3 for
    mha (its softmax weights are rounded to bf16 before the PV product,
    and a weight that rounds to the neighbouring bf16 value moves the
    output by at most its ulp times |v|).
  * model, bf16: argmax agreement >= 0.98 and max |logit difference|
    <= 0.05 between the kernel path and the plain path; fp32 (TF32 off):
    max |logit difference| <= 1e-4 and equal argmax.
"""

from __future__ import annotations

import contextlib
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
        tol = (2e-5 + 2e-5 * w.abs()) if kind == "rca" else \
            (1e-5 + 1e-5 * w.abs())
    else:
        extra = 1e-5 if kind == "rca" else 1e-3
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
    p, t, i, err = main
    ms, ms_lo, ms_hi = time_ms(lambda: K.rca_fused(p, t, i, reverse=True))
    plain_ms, p_lo, p_hi = time_ms(
        lambda: K.rca_fused_reference(p, t, i, reverse=True))
    b = t.shape[0]
    flops = 2867200 * b                      # per sample, see csrc note
    nbytes = (t.numel() + i.numel() + 2 * b * 16 * 48) * t.element_size() \
        + 78848 * p.sa_txt.q.w.element_size()
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
    """Route the model's kernel call sites to the plain versions."""
    from garbage_classification_rca_tpu_torch.kernels import mha_fused
    from garbage_classification_rca_tpu_torch.kernels import rca_fused
    from garbage_classification_rca_tpu_torch.models.fusion import multimodal
    from garbage_classification_rca_tpu_torch.models.text import encoder_common

    saved = (encoder_common.mha, multimodal.rca_fused)
    encoder_common.mha = mha_fused.mha_reference
    multimodal.rca_fused = rca_fused.rca_fused_reference
    try:
        yield
    finally:
        encoder_common.mha, multimodal.rca_fused = saved


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
        return model(ids, mask, x, eval_mode=True).float()


def _kind(name: str) -> str:
    n = name.lower()
    if "rca_fused_kernel" in n:
        return "rca_fused kernel"
    if "mha_kernel" in n:
        return "mha kernel"
    if "memcpy" in n or "memset" in n:
        return "copies"
    if "conv" in n or "fprop" in n:
        return "convolutions"
    if "gemm" in n or "nvjet" in n or "cutlass" in n or "cublas" in n:
        return "matmuls"
    return "elementwise + reductions"


def profile_batch(model, batch, dtype, device, reps=3):
    """torch.profiler (CUPTI) over `reps` eval steps of one batch: device
    time per batch by kind of kernel, the top kernels, and the device's idle
    share of the window (1 - kernel time / host wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from garbage_classification_rca_tpu_torch.cli.test_both import (
        make_both_eval_step)

    step = make_both_eval_step(model, dtype)
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
    from garbage_classification_rca_tpu_torch.kernels import mha_fused
    from garbage_classification_rca_tpu_torch.kernels import rca_fused
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
    rca_fused.rca_fused.launches = 0
    mha_fused.mha.launches = 0
    acc, labels, preds, stats = run_multimodal_eval(
        model, data, batch_size, device, dtype, progress=False)
    torch.cuda.synchronize()
    launches = {"rca_fused": rca_fused.rca_fused.launches,
                "mha": mha_fused.mha.launches}
    peak = torch.cuda.max_memory_allocated(device)
    results["launches"] = launches
    want = {"rca_fused": n_batches, "mha": 6 * n_batches}
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

    print("[1/4] device", flush=True)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi unavailable"
    print(f"  {name}; {smi_line}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    print("[2/4] build", flush=True)
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

    print("[3/4] kernels vs plain versions", flush=True)
    report = {}
    try:
        ok = check_rca(device, report)
        ok &= check_mha(device, report)
    except Exception as e:  # noqa: BLE001 — reported, run fails
        return _fail(f"kernels: {type(e).__name__}: {e}")
    if not ok:
        return _fail("a kernel disagrees with its plain version")

    print("[4/4] MM-RCA eval path", flush=True)
    results = {}
    try:
        ok = check_model(device, N_BATCHES, BATCH, results)
    except Exception as e:  # noqa: BLE001 — reported, run fails
        import traceback

        traceback.print_exc()
        return _fail(f"model: {type(e).__name__}: {e}")
    if not ok:
        return _fail("the MM-RCA eval path check failed")
    launches = results["launches"]
    kernels = []
    for key in ("rca_fused", "mha"):
        row = dict(report[key])
        row["kernel_ms"] = row["ms"]
        row["launches"] = launches[key]
        kernels.append(row)
    print(json.dumps({"model": results["model"], "card": smi_line}))
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
