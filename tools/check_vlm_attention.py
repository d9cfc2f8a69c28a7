#!/usr/bin/env python3
"""The tensor-core attention at the VLM head dims on one card, in one
process: K2 (``mha``) at EVA ViT-g's 16x257x1408 (16 heads of 88, no
mask) and OPT-2.7B's 16x132x2560 (32 heads of 80, causal, left-pad key
mask), K4a (``mha_fwd_lse``) and K4b (``mha_flash_bwd``) at OPT's LoRA
shape 16x136x2560, bf16.

    python3 tools/check_vlm_attention.py [--no-time] [--bwd]

``--bwd`` runs K4b alone.

Builds ``csrc/mha_fused.cu`` with the package's nvcc flags and prints the
registers and spills of its tensor-core kernels. Then, on each shape, the
"tc" route and the CUDA-core route against the plain version under the
tensor-core route's bars in chip_smoke.py (bf16 one ulp + the larger of
1e-3 and one weight's rounding move, the count of elements past one ulp +
1e-3 beside it; lse 1e-5 + 1e-5 |x|; both routes sum S in another order
than the plain version), bit-identical over two runs: the path's mask, a mask with an
all-pad sample, a one-key sample and a sample whose first 100 keys are pads
(causal rows with no attendable key at or before the diagonal), and N = 1.
Unless ``--no-time``, the two routes timed new-old-old-new (CUDA graphs of
20 launches, median of 5; chip_smoke.time_ms) beside the plain version,
the library call with the equivalent additive bias (SDPA for K2, efficient
attention for K4a) and the bound. K4b the same way from the default
forward's out and lse, both routes on the same inputs, at chip_smoke.py's
bf16 backward bar (one ulp + 2e-3 of the tensor's largest |x|; at N = 1,
where dQ and dK are zero in exact arithmetic, the rounding of the two dot
products they come from), timed beside the plain version, the library's
efficient-attention backward and the bound. Needs one CUDA device and
nvcc.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from garbage_classification_rca_tpu_torch.kernels import _build  # noqa: E402
from garbage_classification_rca_tpu_torch.kernels import mha_fused as K  # noqa: E402

BF16 = torch.bfloat16


def left_pad(b, n, pads, device):
    pads = torch.tensor(pads)[:, None]
    return (torch.arange(n)[None] >= pads).to(torch.int32).to(device)


def shapes(device):
    """{name: (b, n, d, heads, causal, lse, masks)}: the path's mask (OPT:
    prompts left-padded by 0..47 tokens) and the edge masks."""
    out = {}
    for name, (n, d, h, causal, lse) in {
            "eva": (257, 1408, 16, False, False),
            "opt": (132, 2560, 32, True, False),
            "opt_lse": (136, 2560, 32, True, True)}.items():
        b = 16
        path = None if not causal else left_pad(
            b, n, [3 * i for i in range(b)], device)
        edge = left_pad(b, n, [n, n - 1, 100] + [5 * i for i in range(b - 3)],
                        device)
        out[name] = (b, n, d, h, causal, lse,
                     {"path": path, "edge": edge})
    return out


def held(plan, q, k, v, h, m, causal, lse):
    """(max |d| out, over one ulp + 1e-3, max |d| lse, ok) of one route."""
    kw = dict(heads=h, mask=m, causal=causal)
    if lse:
        got, l_got = K.launch_fwd_lse(plan, q, k, v, **kw)
        again = K.launch_fwd_lse(plan, q, k, v, **kw)[0]
        want, l_want = K.mha_fwd_lse_reference(q, k, v, **kw)
    else:
        got = K.launch_mha(plan, q, k, v, **kw)
        again = K.launch_mha(plan, q, k, v, **kw)
        want = K.mha_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    err, ok, over = cs._k2_held(got, want, q, k, v, h, m, causal,
                                edge=True)
    e_l = 0.0
    if lse:
        d = (l_got - l_want).abs()
        e_l = float(d.max())
        ok &= bool((d <= 1e-5 + 1e-5 * l_want.abs()).all())
    ok &= torch.equal(got, again)
    return err, over, e_l, ok


def plans(name, shape, h, lse):
    if lse:
        return (K.flash_plan(shape, h, BF16),
                K.flash_plan(shape, h, BF16, route="cuda_core"))
    return K.mha_plan(shape, h, BF16), K.mha_plan(shape, h, BF16,
                                                   route="cuda_core")


def check_bwd(dev, gen, timing):
    """K4b at OPT's LoRA shape on both routes, checked and (with
    `timing`) timed: whether every case held."""
    b, n, d, h = 16, 136, 2560, 32
    masks = shapes(dev)["opt_lse"][6]
    tc = K.flash_plan((b, n, d), h, BF16)
    old = K.flash_plan((b, n, d), h, BF16, route="cuda_core")
    ok_all = (tc.route, tc.bwd_route, old.bwd_route) == ("tc", "tc",
                                                         "cuda_core")
    for nn_ in (n, 1):
        q, k, v, do = (torch.randn((b, nn_, d), generator=gen).to(dev, BF16)
                       for _ in range(4))
        cases = masks if nn_ == n else {"N=1": left_pad(
            b, 1, [1, 0] + [0] * (b - 2), dev)}
        for label, m in cases.items():
            kw = dict(heads=h, mask=m, causal=True)
            o, lse = K.mha_fwd_lse(q, k, v, **kw)
            want = K.mha_flash_bwd_reference(q, k, v, o, do, lse, **kw)
            for route in ("tc", "cuda_core"):
                plan = K.flash_plan((b, nn_, d), h, BF16, route=route)
                got = K.launch_flash_bwd(plan, q, k, v, o, do, lse, **kw)
                again = K.launch_flash_bwd(plan, q, k, v, o, do, lse, **kw)
                torch.cuda.synchronize()
                errs = [cs.grad_err_ok(a, c, BF16)
                        for a, c in zip(got, want)]
                if nn_ == 1:
                    errs[:2] = cs._single_key(q, k, v, do, h, got)
                ok = all(x for _, x in errs) and all(
                    torch.equal(a, c) for a, c in zip(got, again))
                ok_all &= ok
                print(f"opt_bwd {route:9s} {b}x{nn_}x{d} H={h} causal "
                      f"mask={label}: max|d| dq {errs[0][0]:.3e} dk "
                      f"{errs[1][0]:.3e} dv {errs[2][0]:.3e} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
    if not timing:
        return ok_all
    q, k, v, do = (torch.randn((b, n, d), generator=gen).to(dev, BF16)
                   for _ in range(4))
    m = masks["path"]
    kw = dict(heads=h, mask=m, causal=True)
    o, lse = K.mha_fwd_lse(q, k, v, **kw)
    run = {"tc": lambda: K.launch_flash_bwd(tc, q, k, v, o, do, lse, **kw),
           "cuda_core": lambda: K.launch_flash_bwd(old, q, k, v, o, do, lse,
                                                   **kw)}
    ab = {"tc": [], "cuda_core": []}
    for route in ("tc", "cuda_core", "cuda_core", "tc"):
        ab[route].append(cs.time_ms(run[route])[0])
    plain = cs.time_ms(lambda: K.mha_flash_bwd_reference(
        q, k, v, o, do, lse, **kw))[0]
    allowed = m.bool()[:, None, :] & torch.ones(
        (n, n), dtype=torch.bool, device=dev).tril()[None]
    bias = torch.where(allowed, 0.0, K.NEG).to(BF16)[:, None]
    bias = bias.expand(b, h, n, n).contiguous()
    lib_out = cs._efficient_attention(q, k, v, bias, h)
    rs = lambda a: a.view(b, n, h, d // h).transpose(1, 2)
    lib = cs.time_ms(lambda: torch.ops.aten.
                     _scaled_dot_product_efficient_attention_backward(
                         rs(do), rs(q), rs(k), rs(v), bias, lib_out[0],
                         lib_out[1], lib_out[2], lib_out[3], 0.0,
                         [True, True, True, False]))[0]
    _, _, flops, nbytes = cs._vlm_train_bound(q, m)
    bound = max(flops / cs.PEAK_FLOPS["bfloat16"],
                nbytes / cs.PEAK_BYTES_PER_S) * 1e3
    t_new, t_old = sum(ab["tc"]) / 2, sum(ab["cuda_core"]) / 2
    split = cs.block_parts(run["tc"], ("dq", "dkdv"), part_of=lambda k: (
        "dq" if "dq_wide_kernel" in k else
        "dkdv" if "dkdv_wide_kernel" in k else None))
    print(f"opt_bwd {b}x{n}x{d} new-old-old-new: tc {ab['tc'][0]:.4f} / "
          f"{ab['tc'][1]:.4f} ms (dQ {split['dq']:.4f} + dK / dV "
          f"{split['dkdv']:.4f}, the profiler), CUDA cores "
          f"{ab['cuda_core'][0]:.4f} / {ab['cuda_core'][1]:.4f} ms; plain "
          f"{plain:.4f}, library {lib:.4f}, bound {bound:.4f} ms; share of "
          f"the bound tc {bound / t_new:.3f}, CUDA cores "
          f"{bound / t_old:.3f}; tc / library {t_new / lib:.2f}",
          flush=True)
    return ok_all


def main() -> int:
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library("mha_fused")
    log = _build._target("mha_fused").with_suffix(".log").read_text()
    for entry, used, spills in cs.ptxas_report(log):
        if "(tc" in entry:
            print(f"{entry}: {used}; {spills}", flush=True)
    timing = "--no-time" not in sys.argv
    gen = torch.Generator().manual_seed(17)
    ok_all = True
    forwards = {} if "--bwd" in sys.argv else shapes(dev)
    for name, (b, n, d, h, causal, lse, masks) in forwards.items():
        tc, old = plans(name, (b, n, d), h, lse)
        ok_all &= tc.route == "tc"
        for nn_ in (n, 1):
            q, k, v = (torch.randn((b, nn_, d), generator=gen).to(dev, BF16)
                       for _ in range(3))
            cases = masks if nn_ == n else {"N=1": left_pad(
                b, 1, [1, 0] + [0] * (b - 2), dev) if causal else None}
            for label, m in cases.items():
                p_tc, p_old = plans(name, (b, nn_, d), h, lse)
                for plan in (p_tc, p_old):
                    err, over, e_l, ok = held(plan, q, k, v, h, m, causal,
                                              lse)
                    ok_all &= ok
                    print(f"{name} {plan.route:9s} {b}x{nn_}x{d} H={h} "
                          f"causal={causal} mask={label}: max|d|={err:.3e} "
                          f"over one ulp + 1e-3: {over}"
                          + (f", lse {e_l:.3e}" if lse else "")
                          + f" {'ok' if ok else 'FAIL'}", flush=True)
        if not timing:
            continue
        q, k, v = (torch.randn((b, n, d), generator=gen).to(dev, BF16)
                   for _ in range(3))
        m = masks["path"]
        kw = dict(heads=h, mask=m, causal=causal)
        run = {"tc": (lambda: K.launch_fwd_lse(tc, q, k, v, **kw)) if lse
               else (lambda: K.launch_mha(tc, q, k, v, **kw)),
               "cuda_core": (lambda: K.launch_fwd_lse(old, q, k, v, **kw))
               if lse else (lambda: K.launch_mha(old, q, k, v, **kw))}
        ab = {"tc": [], "cuda_core": []}
        for route in ("tc", "cuda_core", "cuda_core", "tc"):
            ab[route].append(cs.time_ms(run[route])[0])
        plain = cs.time_ms(lambda: (K.mha_fwd_lse_reference if lse
                                    else K.mha_reference)(q, k, v, **kw))[0]
        allowed = torch.ones((b, n, n), dtype=torch.bool, device=dev)
        if m is not None:
            allowed &= m.bool()[:, None, :]
        if causal:
            allowed &= torch.ones((n, n), dtype=torch.bool,
                                  device=dev).tril()[None]
        bias = torch.where(allowed, 0.0, K.NEG).to(BF16)[:, None]
        rs = lambda a: a.view(b, n, h, d // h).transpose(1, 2)
        if lse:
            bias = bias.expand(b, h, n, n).contiguous()
            lib = cs.time_ms(lambda: cs._efficient_attention(q, k, v, bias,
                                                             h))[0]
        else:
            lib = cs.time_ms(lambda: F.scaled_dot_product_attention(
                rs(q), rs(k), rs(v), attn_mask=bias))[0]
        flops = cs._k2_flops(b, n, d, m, causal) if causal else \
            4 * b * n * n * d
        nbytes = 4 * q.numel() * 2 + (m.numel() * 4 if m is not None else 0) \
            + (b * h * n * 4 if lse else 0)
        bound = max(flops / cs.PEAK_FLOPS["bfloat16"],
                    nbytes / cs.PEAK_BYTES_PER_S) * 1e3
        t_new, t_old = sum(ab["tc"]) / 2, sum(ab["cuda_core"]) / 2
        print(f"{name} {b}x{n}x{d} new-old-old-new: tc {ab['tc'][0]:.4f} / "
              f"{ab['tc'][1]:.4f} ms, CUDA cores {ab['cuda_core'][0]:.4f} / "
              f"{ab['cuda_core'][1]:.4f} ms; plain {plain:.4f}, library "
              f"{lib:.4f}, bound {bound:.4f} ms; share of the bound tc "
              f"{bound / t_new:.3f}, CUDA cores {bound / t_old:.3f}; tc / "
              f"library {t_new / lib:.2f}", flush=True)
    ok_all &= check_bwd(dev, gen, timing)
    print("ALL OK" if ok_all else "FAILED", flush=True)
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
