"""Masked / causal multi-head attention: the CUDA kernels of
``csrc/mha_fused.cu`` and their plain PyTorch versions.

Replaces, in ``garbage_classification_rca_tpu/kernels/mha_fused.py``:
  * ``mha`` (eval): ``out = softmax(Q K^T * scale + mask_bias) V`` per
    head, q/k/v [B, N, D] with head h the columns h*dh:(h+1)*dh; scale
    1/sqrt(dh) by default; the key mask bias is (m - 1) * 1e30; causal
    masks key > query with -1e30. The softmax runs in fp32 with the max
    subtracted and its weights are rounded to V's dtype before the PV
    product (fp32 accumulation);
  * ``_mha_fwd_lse`` (``mha_fwd_lse`` here): the same forward, which also
    gives the fp32 logsumexp [B, H, N] of each score row;
  * ``_mha_flash_bwd`` (``mha_flash_bwd``): the flash backward from
    (q, k, v, out, lse), scores recomputed, never stored;
  * ``mha_flash_train``: the two under autograd, for the training path;
  * ``_mha_fwd_lse_drop`` / ``_mha_flash_bwd_drop`` (``mha_fwd_lse_drop``,
    ``mha_flash_bwd_drop``): the same pair with dropout on the softmax
    weights, the HF text towers' attention-probs dropout. The keep mask
    (uint8 [B, H, N, N]) is an input, drawn outside the kernels; the
    weights are rounded to V's dtype before ``/ keep``; lse is the
    logsumexp before dropout;
  * ``mha_flash_train_dropout``: that pair under autograd. It holds
    (q, k, v, out, lse, mask) and the site's key between forward and
    backward and draws the keep mask again from the key in the backward,
    so nothing of size [B, H, N, N] lives in between.
``csrc/mha_fused.cu`` explains what bounds the kernels on the H100 and how
their design answers that.

Each call takes a route on the card, chosen by the host-side plan
``flash_plan``: the forwards (``mha``, ``mha_fwd_lse``) in bf16 at head dim
64 and N <= 256 on the tensor cores ("tc": wgmma products fed by TMA, the
exact two-pass softmax in registers), and so the plain backward; the fp32
backward at head dim 64 and N <= 64, with or without dropout, and the
fp32 dropout forward at those shapes on 3xTF32 tensor-core products
("tc32": one kernel a side, a block per (head, sample)); every other
shape, the fp32 eval forward and the fp32 training forward without
dropout on the fp32 CUDA-core kernels ("cuda_core"; the last takes "tc32"
on request). The eval forward ``mha`` also takes head dims 80 (OPT-2.7B)
and 88 (EVA ViT-g), on the CUDA cores (``mha_plan``); the flash pair without
dropout takes 80 too (OPT-2.7B's LoRA training, on the CUDA cores), and
refuses 88; the dropout pair refuses both. A failure of any route raises;
none gives way to another.
``launch_mha`` / ``launch_fwd_lse`` / ``launch_fwd_lse_drop`` /
``launch_flash_bwd`` / ``launch_flash_bwd_drop`` run a given plan (the A/B
timing of the routes).

The wrappers run the plain versions for tensors on the CPU and the kernels
for tensors on a CUDA device; ``mha.launches``, ``mha_fwd_lse.launches``,
``mha_flash_bwd.launches``, ``mha_fwd_lse_drop.launches`` and
``mha_flash_bwd_drop.launches`` count kernel launches, and their
``route_launches`` count them by route.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

NEG = -1e30
MAX_N = 512          # DistilBERT's position table, the most --seq_len gives
HEAD_DIMS = (32, 64, 128)          # every kernel: K2, both flash pairs
FLASH_HEAD_DIMS = (32, 64, 80, 128)     # K2, K4a / K4b: + OPT-2.7B's LoRA
MHA_HEAD_DIMS = (32, 64, 80, 88, 128)   # K2 alone: + EVA ViT-g
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TC_HEAD_DIM = 64     # the flash pair's tensor-core route: bf16, head dim 64,
TC_MAX_N = 256       # N <= 256 (four 64-row tiles: a tile's scores in
TC_TILE = 64         # registers)
_TC_BOX = TC_TILE * TC_HEAD_DIM * 2   # one 64 x 64 bf16 tile in shared memory
TC32_HEAD_DIM = 64   # the fp32 training pair's tensor-core route (3xTF32):
TC32_MAX_N = 64      # head dim 64, N <= 64, the whole head in one block
_TC32_LD = 68        # its tiles' row stride (floats; the mask's, bytes)
# csrc/mha_fused.cu tc32::SMEM: Q, K, V, dO, wld and dS tiles, lse / Delta /
# key bias, the keep-mask bytes
TC32_SMEM = (6 * TC32_MAX_N * _TC32_LD * 4 + 3 * TC32_MAX_N * 4
             + TC32_MAX_N * _TC32_LD)
# tc32::FWD_SMEM: Q, K and V tiles, the key bias and each key half's row max
# and sum, the keep-mask bytes (three blocks to an SM)
TC32_FWD_SMEM = (3 * TC32_MAX_N * _TC32_LD * 4 + 5 * TC32_MAX_N * 4
                 + TC32_MAX_N * _TC32_LD)


def _heads(a, heads):
    """[B, N, D] -> fp32 [B, H, N, dh]."""
    b, n, d = a.shape
    return a.reshape(b, n, heads, d // heads).transpose(1, 2).float()


def _merge(a, dtype):
    """[B, H, N, dh] -> [B, N, D] in `dtype`."""
    b, h, n, dh = a.shape
    return a.transpose(1, 2).reshape(b, n, h * dh).to(dtype)


def _scale(d, heads, scale):
    return float(scale) if scale != 0.0 else 1.0 / math.sqrt(d // heads)


def _scores(q, k, heads, scale, mask, causal):
    """fp32 [B, H, N, N] scores with the mask and causal biases."""
    n = q.shape[1]
    s = _heads(q, heads) @ _heads(k, heads).transpose(-1, -2) * scale
    if mask is not None:
        s = s + ((mask.float() - 1.0) * -NEG)[:, None, None, :]
    if causal:
        tri = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
        s = torch.where(tri, s, torch.full_like(s, NEG))
    return s


def mha_reference(q, k, v, *, heads: int, scale: float = 0.0, mask=None,
                  causal: bool = False) -> torch.Tensor:
    """Plain version (the JAX ``mha_reference`` graph)."""
    s = _scores(q, k, heads, _scale(q.shape[2], heads, scale), mask, causal)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    w = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype)
    return _merge(w.float() @ _heads(v, heads), q.dtype)


def mha_fwd_lse_reference(q, k, v, *, heads: int, scale: float = 0.0,
                          mask=None, causal: bool = False):
    """Plain version of ``mha_fwd_lse``: (``mha_reference``'s output, the
    fp32 logsumexp [B, H, N] of the score rows)."""
    s = _scores(q, k, heads, _scale(q.shape[2], heads, scale), mask, causal)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    ssum = e.sum(dim=-1, keepdim=True)
    w = (e / ssum).to(v.dtype)
    lse = (m + torch.log(ssum))[..., 0]
    return _merge(w.float() @ _heads(v, heads), q.dtype), lse


def mha_flash_bwd_reference(q, k, v, o, do, lse, *, heads: int,
                            scale: float = 0.0, mask=None,
                            causal: bool = False):
    """Plain version of ``mha_flash_bwd``, at the Pallas kernel's rounding
    points: W = exp(S - lse) in fp32; W and dO in V's dtype for dV and dP;
    Delta = rowsum(dO * O) in fp32; dS in q's dtype for dQ and dK."""
    scale = _scale(q.shape[2], heads, scale)
    w = torch.exp(_scores(q, k, heads, scale, mask, causal) - lse[..., None])
    dol = _heads(do.to(v.dtype), heads)
    vh = _heads(v, heads)
    dv = w.to(v.dtype).float().transpose(-1, -2) @ dol
    dp = dol @ vh.transpose(-1, -2)
    delta = (_heads(do, heads) * _heads(o, heads)).sum(-1, keepdim=True)
    ds = (w * (dp - delta)).to(q.dtype).float()
    dq = ds @ _heads(k, heads) * scale
    dk = ds.transpose(-1, -2) @ _heads(q, heads) * scale
    return _merge(dq, q.dtype), _merge(dk, q.dtype), _merge(dv, q.dtype)


def _check(q, k, v, heads, mask, max_n=MAX_N):
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v must be equal [B, N, D], got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    b, n, d = q.shape
    if heads <= 0 or d % heads:
        raise ValueError(f"D={d} not divisible by heads={heads}")
    if max_n is not None and n > max_n:
        raise ValueError(f"mha takes N <= {max_n}, got {n}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share a dtype in float32/bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v lie on different devices")
    if mask is not None:
        if tuple(mask.shape) != (b, n) or mask.dtype != torch.int32:
            raise TypeError(f"mask must be int32 [B, N], got {mask.dtype} "
                            f"{tuple(mask.shape)}")
        if mask.device != q.device:
            raise ValueError("mask and q lie on different devices")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mha runs on cpu or cuda, not {q.device}")


def _kernel_args(tensors, b, d, heads, head_dims=HEAD_DIMS):
    """Checks the kernels' own limits on CUDA tensors."""
    if d // heads not in head_dims:
        raise ValueError(f"the mha kernels take head dims {head_dims}, got "
                         f"{d // heads}")
    if b > 65535:
        raise ValueError(f"the mha kernels take B <= 65535, got {b}")
    if not all(a.is_contiguous() for a in tensors if a is not None):
        raise ValueError("the mha kernels need contiguous tensors")


def mha(q, k, v, *, heads: int, scale: float = 0.0,
        mask: Optional[torch.Tensor] = None, causal: bool = False,
        route: Optional[str] = None) -> torch.Tensor:
    """q/k/v: [B, N, D]; mask: optional int32 [B, N] key validity
    (1 = attendable). Returns [B, N, D] in q's dtype. On the card it runs
    ``mha_plan``'s route ("tc" for bf16 at head dim 64 and N <= 256, else
    "cuda_core"); `route` asks for one (the A/B)."""
    _check(q, k, v, heads, mask)
    if q.device.type == "cpu":
        return mha_reference(q, k, v, heads=heads, scale=scale, mask=mask,
                             causal=causal)
    return launch_mha(mha_plan(q.shape, heads, q.dtype, route=route), q, k,
                      v, heads=heads, scale=scale, mask=mask, causal=causal)


def mha_plan(shape, heads: int, dtype, route: Optional[str] = None
             ) -> "FlashPlan":
    """The launch plan of ``mha`` (the eval forward) on q / k / v of
    `shape`: ``flash_plan``'s at head dims 32 / 64 / 128; at head dims 80
    (OPT-2.7B) and 88 (EVA ViT-g), which only this forward takes, the
    CUDA-core kernel, and no backward (``bwd_route`` "none")."""
    b, n, d = shape
    dh = d // heads if heads > 0 and d % heads == 0 else None
    if dh in HEAD_DIMS:
        return flash_plan(shape, heads, dtype, route=route)
    if dh not in MHA_HEAD_DIMS:
        raise ValueError(f"mha takes head dims {MHA_HEAD_DIMS}, got D={d} "
                         f"with {heads} heads")
    if dtype not in _DTYPES:
        raise TypeError(f"mha takes float32 / bfloat16, got {dtype}")
    if route not in (None, "cuda_core"):
        raise ValueError(f"at head dim {dh} mha runs on the CUDA cores "
                         f"only, not {route!r}")
    if n < 1:
        raise ValueError(f"mha takes N >= 1, got {n}")
    return FlashPlan("cuda_core", n, *_cuda_core_fwd(b, n, heads, dh),
                     "none", (0, 0, 0), 0, (0, 0, 0), 0)


def launch_mha(plan: "FlashPlan", q, k, v, *, heads: int, scale: float = 0.0,
               mask: Optional[torch.Tensor] = None,
               causal: bool = False) -> torch.Tensor:
    """``mha`` on CUDA tensors under the forward route of `plan`
    (``mha_plan`` of this shape)."""
    _check(q, k, v, heads, mask)
    b, n, d = q.shape
    _kernel_args([q, k, v, mask], b, d, heads, MHA_HEAD_DIMS)
    if q.device.type != "cuda":
        raise ValueError("launch_mha takes CUDA tensors")
    if plan.route not in mha.route_launches:
        raise ValueError(f"mha has no {plan.route!r} route")
    from . import _build

    lib = _build.library("mha_fused")
    o = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask.data_ptr() if mask is not None else None, o.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.route == "tc":
            _tc_aligned("mha", (q, k, v))
            fn = lib.mha_forward_tc
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
                ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = fn(*ptrs, b, n, d, heads, _scale(d, heads, scale),
                     int(bool(causal)), plan.np, *plan.grid_fwd,
                     plan.smem_fwd, stream)
        else:
            fn = lib.mha_forward
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = fn(*ptrs, b, n, d, heads, _scale(d, heads, scale),
                     int(bool(causal)), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mha kernel launch failed ({plan.route} route): "
                           f"CUDA error {err}")
    _count(mha, plan.route)
    return o


mha.launches = 0
mha.route_launches = {"tc": 0, "cuda_core": 0}


@dataclass(frozen=True)
class FlashPlan:
    """How one attention call (``mha``, the flash pair ``mha_fwd_lse`` /
    ``mha_flash_bwd``, the dropout pair ``mha_fwd_lse_drop`` /
    ``mha_flash_bwd_drop``) runs on the card. `route`: the forward's, "tc"
    (bf16, head dim 64, N <= 256: wgmma products fed by TMA,
    ``csrc/mha_fused.cu`` namespace ``ftc``), "tc32" (the fp32 training
    forward, with or without dropout, at head dim 64 and N <= 64: one
    kernel per (head, sample) on 3xTF32 products, namespace ``tc32``; the
    eval forward ``mha`` has none) or "cuda_core" (every other shape: the
    fp32 CUDA-core kernels).
    `bwd_route`: the backward's, "tc" (as the forward), "tc32" (fp32, head
    dim 64, N <= 64, with or without dropout: one fused kernel on 3xTF32
    products), "cuda_core", or "none" (``mha_plan`` at head dims 80 / 88,
    which no backward takes). `np`: the keys the tensor-core score products
    cover (N rounded up to 16 where a route is "tc", else N). Grids
    (x, y, z) and dynamic shared memory in bytes of the forward, and of the
    backward's dQ kernel and dK / dV kernel; the "tc32" backward is one
    kernel, on grid_dq with smem_dq (grid_dkdv empty). The C entries of the
    tensor-core routes launch exactly this plan and refuse any other; the
    "cuda_core" entries compute the same grids themselves."""
    route: str
    np: int
    grid_fwd: Tuple[int, int, int]
    smem_fwd: int
    bwd_route: str
    grid_dq: Tuple[int, int, int]
    smem_dq: int
    grid_dkdv: Tuple[int, int, int]
    smem_dkdv: int


def flash_plan(shape, heads: int, dtype, route: Optional[str] = None, *,
               bwd_route: Optional[str] = None,
               dropout: bool = False) -> FlashPlan:
    """The launch plan of an attention call on q / k / v of `shape`
    [B, N, D] with `heads` heads (`dropout`: the dropout pair, which has no
    "tc" route and no head dim 80): each side on the tensor cores where a
    route takes the shape, else "cuda_core" (head dim 80 always). The fp32 forward without dropout keeps
    "cuda_core" unless asked for "tc32": the CUDA-core kernel takes the
    same fp32 fused multiply-adds in the same order as the plain version's
    products, bit for bit, and the 3xTF32 kernel's fp32-level differences
    move bf16 roundings downstream in the MM-RCA trainer past what its
    kernel-vs-plain gradient check holds (PERF.md §6). `route` asks for the
    forward's route and, unless `bwd_route` is given too, the backward's
    (the A/B timing of the routes); a route that does not take the shape
    raises."""
    b, n, d = shape
    if dtype not in _DTYPES:
        raise TypeError(f"the flash pair takes float32 / bfloat16, got "
                        f"{dtype}")
    dims = HEAD_DIMS if dropout else FLASH_HEAD_DIMS
    if heads <= 0 or d % heads or d // heads not in dims:
        raise ValueError(f"the flash {'dropout ' if dropout else ''}pair "
                         f"takes head dims {dims}, got D={d} with {heads} "
                         f"heads")
    if n < 1:
        raise ValueError(f"the flash pair takes N >= 1, got {n}")
    dh = d // heads
    tc_fits = (not dropout and dtype == torch.bfloat16
               and dh == TC_HEAD_DIM and n <= TC_MAX_N)
    tc32_fits = (dtype == torch.float32 and dh == TC32_HEAD_DIM
                 and n <= TC32_MAX_N)
    if route is not None and bwd_route is None:
        bwd_route = route
    route = route or ("tc" if tc_fits else "tc32" if tc32_fits and dropout
                      else "cuda_core")
    bwd_route = bwd_route or ("tc" if tc_fits else
                              "tc32" if tc32_fits else "cuda_core")
    if route not in ("tc", "tc32", "cuda_core"):
        raise ValueError(f"unknown route {route!r}")
    if bwd_route not in ("tc", "tc32", "cuda_core"):
        raise ValueError(f"unknown backward route {bwd_route!r}")
    if "tc" in (route, bwd_route) and not tc_fits:
        raise ValueError(f"the tensor-core route takes bfloat16, head dim "
                         f"{TC_HEAD_DIM}, N <= {TC_MAX_N}, no dropout; got "
                         f"{tuple(shape)} with {heads} heads in {dtype}")
    if "tc32" in (route, bwd_route) and not tc32_fits:
        raise ValueError(f"the 3xTF32 route takes float32, head dim "
                         f"{TC32_HEAD_DIM}, N <= {TC32_MAX_N}; got "
                         f"{tuple(shape)} with {heads} heads in {dtype}")
    nt = -(-n // TC_TILE)
    grid = (heads, b, 1)              # the tensor-core kernels: a block a head
    # csrc/mha_fused.cu's CUDA-core kernels: blocks of 32 rows, keys /
    # queries streamed in chunks of 64, fp32 tiles of stride dh + 1; the
    # dK / dV kernel with dropout holds a 64 x 36-byte mask tile
    grid_cc, ldh = (-(-n // 32), heads, b), dh + 1
    np_ = -(-n // 16) * 16 if "tc" in (route, bwd_route) else n
    if route == "tc":
        # the formula of ftc::fwd_smem: K, V and Q tiles, per-key floats,
        # mbarriers, + 1 KB for the 128-byte swizzle's alignment
        fwd = (grid, 3 * nt * _TC_BOX + TC_MAX_N * 4 + 2 * 8 + 1024)
    elif route == "tc32":
        fwd = (grid, TC32_FWD_SMEM)
    else:
        fwd = _cuda_core_fwd(b, n, heads, dh)
    if bwd_route == "tc":
        # ftc::dq_smem / dkdv_smem: one side of the head and two stages of
        # the other, per-key / per-query floats, mbarriers, + 1 KB
        bwd = (grid, (2 * nt + 4) * _TC_BOX + TC_MAX_N * 4 + TC_TILE * 4
               + (nt + 2) * 8 + 1024,
               grid, (2 * nt + 4) * _TC_BOX + 2 * TC_MAX_N * 4
               + (nt + 2) * 8 + 1024)
    elif bwd_route == "tc32":
        bwd = (grid, TC32_SMEM, (0, 0, 0), 0)
    else:
        bwd = (grid_cc, 4 * (192 * ldh + 32 * 65 + 64),
               grid_cc, 4 * (192 * ldh + 2 * 32 * 65 + 128)
               + (64 * 36 if dropout else 0))
    return FlashPlan(route, np_, *fwd, bwd_route, *bwd)


def _cuda_core_fwd(b, n, heads, dh):
    """(grid, shared memory) of the CUDA-core forward: a block per 32 query
    rows, head and sample; Q and a 64-key chunk in fp32 tiles of stride
    dh + 1, and the block's 32 fp32 score rows of N."""
    return (-(-n // 32), heads, b), 4 * (96 * (dh + 1) + 32 * n)


def _count(fn, route):
    fn.launches += 1
    fn.route_launches[route] += 1


def _tc_aligned(name, tensors):
    if any(a.data_ptr() % 16 for a in tensors):
        raise ValueError(f"{name}: the tensor-core route needs 16-byte "
                         "aligned tensors (TMA)")


def mha_fwd_lse(q, k, v, *, heads: int, scale: float = 0.0,
                mask: Optional[torch.Tensor] = None, causal: bool = False):
    """The training forward: (out [B, N, D] in q's dtype, lse [B, H, N]
    fp32). On the card it runs ``flash_plan``'s route ("tc" for bf16 at
    head dim 64 and N <= 256, else "cuda_core"; ``launch_fwd_lse`` takes
    "tc32" too)."""
    _check(q, k, v, heads, mask)
    if q.device.type == "cpu":
        return mha_fwd_lse_reference(q, k, v, heads=heads, scale=scale,
                                     mask=mask, causal=causal)
    return launch_fwd_lse(flash_plan(q.shape, heads, q.dtype), q, k, v,
                          heads=heads, scale=scale, mask=mask, causal=causal)


def launch_fwd_lse(plan: FlashPlan, q, k, v, *, heads: int,
                   scale: float = 0.0, mask: Optional[torch.Tensor] = None,
                   causal: bool = False):
    """``mha_fwd_lse`` on CUDA tensors under the forward route of `plan`
    (``flash_plan`` of this shape, any route that takes it)."""
    _check(q, k, v, heads, mask)
    b, n, d = q.shape
    _kernel_args([q, k, v, mask], b, d, heads, FLASH_HEAD_DIMS)
    if q.device.type != "cuda":
        raise ValueError("launch_fwd_lse takes CUDA tensors")
    from . import _build

    lib = _build.library("mha_fused")
    o = torch.empty_like(q)
    lse = torch.empty((b, heads, n), dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask.data_ptr() if mask is not None else None, o.data_ptr(),
            lse.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.route == "tc32":
            err = _launch_fwd_tc32(lib, plan, q, k, v, o, lse, mask, None,
                                   1.0, heads, scale, causal, stream)
        elif plan.route == "tc":
            _tc_aligned("mha_fwd_lse", (q, k, v))
            fn = lib.mha_forward_lse_tc
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
                ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = fn(*ptrs, b, n, d, heads, _scale(d, heads, scale),
                     int(bool(causal)), plan.np, *plan.grid_fwd,
                     plan.smem_fwd, stream)
        else:
            fn = lib.mha_forward_lse
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = fn(*ptrs, b, n, d, heads, _scale(d, heads, scale),
                     int(bool(causal)), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mha_fwd_lse kernel launch failed ({plan.route} "
                           f"route): CUDA error {err}")
    _count(mha_fwd_lse, plan.route)
    return o, lse


mha_fwd_lse.launches = 0
mha_fwd_lse.route_launches = {"tc": 0, "tc32": 0, "cuda_core": 0}


def _launch_fwd_tc32(lib, plan, q, k, v, o, lse, mask, dm, keep, heads,
                     scale, causal, stream):
    """The 3xTF32 forward under `plan` into `o` / `lse`: its CUDA error."""
    b, n, d = q.shape
    _tc_aligned("the 3xTF32 forward", (q, k, v, o))
    fn = lib.mha_forward_lse_tc32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
              mask.data_ptr() if mask is not None else None,
              dm.data_ptr() if dm is not None else None, o.data_ptr(),
              lse.data_ptr(), b, n, d, heads, _scale(d, heads, scale),
              int(bool(causal)), float(keep), *plan.grid_fwd, plan.smem_fwd,
              stream)


def mha_flash_bwd(q, k, v, o, do, lse, *, heads: int, scale: float = 0.0,
                  mask: Optional[torch.Tensor] = None, causal: bool = False):
    """Flash backward of ``mha_fwd_lse``: (dq, dk, dv) in q's dtype. `do`
    is the output cotangent; it is taken in q's dtype, as the JAX rule
    casts it. On the card it runs ``flash_plan``'s backward route."""
    _check(q, k, v, heads, mask, max_n=None)
    do = do.to(q.dtype)
    if q.device.type == "cpu":
        _check_lse(q, lse, heads)
        return mha_flash_bwd_reference(q, k, v, o, do, lse, heads=heads,
                                       scale=scale, mask=mask, causal=causal)
    return launch_flash_bwd(flash_plan(q.shape, heads, q.dtype), q, k, v, o,
                            do, lse, heads=heads, scale=scale, mask=mask,
                            causal=causal)


def _check_lse(q, lse, heads):
    b, n, _ = q.shape
    if tuple(lse.shape) != (b, heads, n) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 [B, H, N], got {lse.dtype} "
                         f"{tuple(lse.shape)}")


def _launch_tc32(lib, plan, q, k, v, o, do, lse, mask, dm, keep, heads,
                 scale, causal, stream):
    """The fused 3xTF32 backward under `plan`: (CUDA error, dq, dk, dv)."""
    b, n, d = q.shape
    _tc_aligned("the 3xTF32 backward", (q, k, v, o, do))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    fn = lib.mha_flash_backward_tc32
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(),
             mask.data_ptr() if mask is not None else None,
             dm.data_ptr() if dm is not None else None, dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), b, n, d, heads,
             _scale(d, heads, scale), int(bool(causal)), float(keep),
             *plan.grid_dq, plan.smem_dq, stream)
    return err, dq, dk, dv


def launch_flash_bwd(plan: FlashPlan, q, k, v, o, do, lse, *, heads: int,
                     scale: float = 0.0,
                     mask: Optional[torch.Tensor] = None,
                     causal: bool = False):
    """``mha_flash_bwd`` on CUDA tensors under the backward route of `plan`
    (``flash_plan`` of this shape, any route that takes it)."""
    _check(q, k, v, heads, mask, max_n=None)
    _check_lse(q, lse, heads)
    b, n, d = q.shape
    do = do.to(q.dtype).contiguous()
    _kernel_args([q, k, v, o, do, lse, mask], b, d, heads, FLASH_HEAD_DIMS)
    if q.device.type != "cuda":
        raise ValueError("launch_flash_bwd takes CUDA tensors")
    from . import _build

    lib = _build.library("mha_fused")
    route = plan.bwd_route
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "tc32":
            err, dq, dk, dv = _launch_tc32(lib, plan, q, k, v, o, do, lse,
                                           mask, None, 1.0, heads, scale,
                                           causal, stream)
        else:
            dq, dk, dv = (torch.empty_like(q) for _ in range(3))
            delta = torch.empty((b, heads, n), dtype=torch.float32,
                                device=q.device)
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    do.data_ptr(), lse.data_ptr(),
                    mask.data_ptr() if mask is not None else None,
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    delta.data_ptr())
            if route == "tc":
                _tc_aligned("mha_flash_bwd", (q, k, v, o, do))
                fn = lib.mha_flash_backward_tc
                fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [
                    ctypes.c_float] + [ctypes.c_int] * 10 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
                err = fn(*ptrs, b, n, d, heads, _scale(d, heads, scale),
                         int(bool(causal)), plan.np, *plan.grid_dq,
                         plan.smem_dq, *plan.grid_dkdv, plan.smem_dkdv,
                         stream)
            else:
                fn = lib.mha_flash_backward
                fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [
                    ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p]
                fn.restype = ctypes.c_int
                err = fn(*ptrs, b, n, d, heads, _scale(d, heads, scale),
                         int(bool(causal)), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mha_flash_bwd kernel launch failed ({route} "
                           f"route): CUDA error {err}")
    _count(mha_flash_bwd, route)
    return dq, dk, dv


mha_flash_bwd.launches = 0
mha_flash_bwd.route_launches = {"tc": 0, "tc32": 0, "cuda_core": 0}


def flash_train_fits(shape, heads: int, dtype) -> bool:
    """Whether the flash pair takes [B, N, D] with `heads` heads: fp32 or
    bf16, head dims 32 / 64 / 80 / 128, 1 <= N <= 512 (the CUDA-core
    forward holds 32 fp32 score rows of N in shared memory), B <= 65535.
    Within that, ``flash_plan`` sends bf16 at head dim 64 and N <= 256 to
    the "tc" route, the fp32 backward at head dim 64 and N <= 64 to "tc32"
    and the rest (head dim 80 among it) to the CUDA-core kernels."""
    b, n, d = shape
    return (dtype in _DTYPES and heads > 0 and d % heads == 0
            and d // heads in FLASH_HEAD_DIMS and 1 <= n <= MAX_N
            and b <= 65535)


class _FlashTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, heads, scale, causal):
        o, lse = mha_fwd_lse(q, k, v, heads=heads, scale=scale, mask=mask,
                             causal=causal)
        ctx.save_for_backward(q, k, v, o, lse, mask)
        ctx.args = (heads, scale, causal)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse, mask = ctx.saved_tensors
        heads, scale, causal = ctx.args
        dq, dk, dv = mha_flash_bwd(q, k, v, o, g, lse, heads=heads,
                                   scale=scale, mask=mask, causal=causal)
        return dq, dk, dv, None, None, None, None


def mha_flash_train(q, k, v, *, heads: int, scale: float = 0.0,
                    mask: Optional[torch.Tensor] = None,
                    causal: bool = False) -> torch.Tensor:
    """Differentiable attention for training: ``mha_fwd_lse`` forward,
    saving (q, k, v, out, lse); ``mha_flash_bwd`` backward. On CPU tensors
    a shape that ``flash_train_fits`` rejects goes through ``mha_reference``
    under autograd, as the JAX ``mha_flash_train`` sends its misfits to its
    XLA graph; on CUDA tensors it raises."""
    if not flash_train_fits(q.shape, heads, q.dtype):
        if q.device.type == "cpu":
            return mha_reference(q, k, v, heads=heads, scale=scale,
                                 mask=mask, causal=causal)
        raise ValueError(
            f"the flash train kernels take N <= {MAX_N}, head dims "
            f"{FLASH_HEAD_DIMS} and float32/bfloat16, got {tuple(q.shape)} "
            f"with {heads} heads in {q.dtype}")
    return _FlashTrain.apply(q, k, v, mask, heads, float(scale),
                             bool(causal))


# ---------------------------------------------------------------------------
# the flash pair with dropout on the softmax weights
# ---------------------------------------------------------------------------


def _apply_keep(wl, dm, keep: float):
    """``where(dm, wl / keep, 0)`` on weights already cast to V's dtype,
    the division in that dtype (keep itself rounded to it, as the JAX
    kernel's weakly typed scalar is)."""
    k = float(torch.tensor(keep, dtype=wl.dtype))     # host arithmetic
    return torch.where(dm != 0, wl / k, torch.zeros_like(wl))


def mha_fwd_lse_drop_reference(q, k, v, dm, *, heads: int, keep: float,
                               scale: float = 0.0, mask=None,
                               causal: bool = False):
    """Plain version of ``mha_fwd_lse_drop``. dm: uint8 (or bool)
    [B, H, N, N], non-zero = kept."""
    s = _scores(q, k, heads, _scale(q.shape[2], heads, scale), mask, causal)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    ssum = e.sum(dim=-1, keepdim=True)
    wld = _apply_keep((e / ssum).to(v.dtype), dm, keep)
    lse = (m + torch.log(ssum))[..., 0]
    return _merge(wld.float() @ _heads(v, heads), q.dtype), lse


def mha_flash_bwd_drop_reference(q, k, v, o, do, lse, dm, *, heads: int,
                                 keep: float, scale: float = 0.0, mask=None,
                                 causal: bool = False):
    """Plain version of ``mha_flash_bwd_drop``, at the Pallas kernel's
    rounding points: W = exp(S - lse) in fp32; wld = keep(W in V's dtype)
    for dV; dW = where(dm, dP / keep, 0) in fp32; Delta = rowsum(dO * O);
    dS = W * (dW - Delta) in q's dtype."""
    scale = _scale(q.shape[2], heads, scale)
    w = torch.exp(_scores(q, k, heads, scale, mask, causal) - lse[..., None])
    wld = _apply_keep(w.to(v.dtype), dm, keep)
    dol = _heads(do.to(v.dtype), heads)
    dv = wld.float().transpose(-1, -2) @ dol
    dp = dol @ _heads(v, heads).transpose(-1, -2)
    dw = torch.where(dm != 0, dp / keep, torch.zeros_like(dp))
    delta = (_heads(do, heads) * _heads(o, heads)).sum(-1, keepdim=True)
    ds = (w * (dw - delta)).to(q.dtype).float()
    dq = ds @ _heads(k, heads) * scale
    dk = ds.transpose(-1, -2) @ _heads(q, heads) * scale
    return _merge(dq, q.dtype), _merge(dk, q.dtype), _merge(dv, q.dtype)


def _check_drop(q, dm, heads, keep):
    b, n, _ = q.shape
    if tuple(dm.shape) != (b, heads, n, n) or dm.dtype != torch.uint8:
        raise TypeError(f"the keep mask must be uint8 [B, H, N, N], got "
                        f"{dm.dtype} {tuple(dm.shape)}")
    if dm.device != q.device:
        raise ValueError("the keep mask and q lie on different devices")
    if not 0.0 < keep <= 1.0:
        raise ValueError(f"keep = 1 - p must lie in (0, 1], got {keep}")


def mha_fwd_lse_drop(q, k, v, dm, *, heads: int, keep: float,
                     scale: float = 0.0,
                     mask: Optional[torch.Tensor] = None,
                     causal: bool = False):
    """The training forward with dropout on the softmax weights: (out
    [B, N, D] in q's dtype, lse [B, H, N] fp32, of the scores before
    dropout). dm: uint8 [B, H, N, N] keep mask; keep = 1 - p. On the card
    it runs ``flash_plan(..., dropout=True)``'s forward route ("tc32" for
    fp32 at head dim 64 and N <= 64, else "cuda_core")."""
    _check(q, k, v, heads, mask)
    _check_drop(q, dm, heads, keep)
    if q.device.type == "cpu":
        return mha_fwd_lse_drop_reference(q, k, v, dm, heads=heads,
                                          keep=keep, scale=scale, mask=mask,
                                          causal=causal)
    return launch_fwd_lse_drop(
        flash_plan(q.shape, heads, q.dtype, dropout=True), q, k, v, dm,
        heads=heads, keep=keep, scale=scale, mask=mask, causal=causal)


def launch_fwd_lse_drop(plan: FlashPlan, q, k, v, dm, *, heads: int,
                        keep: float, scale: float = 0.0,
                        mask: Optional[torch.Tensor] = None,
                        causal: bool = False):
    """``mha_fwd_lse_drop`` on CUDA tensors under the forward route of
    `plan` (``flash_plan(..., dropout=True)`` of this shape: "tc32" or
    "cuda_core")."""
    _check(q, k, v, heads, mask)
    _check_drop(q, dm, heads, keep)
    b, n, d = q.shape
    _kernel_args([q, k, v, mask, dm], b, d, heads)
    if q.device.type != "cuda":
        raise ValueError("launch_fwd_lse_drop takes CUDA tensors")
    route = plan.route
    if route not in mha_fwd_lse_drop.route_launches:
        raise ValueError(f"the dropout forward has no {route!r} route")
    from . import _build

    lib = _build.library("mha_fused")
    o = torch.empty_like(q)
    lse = torch.empty((b, heads, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "tc32":
            err = _launch_fwd_tc32(lib, plan, q, k, v, o, lse, mask, dm, keep,
                                   heads, scale, causal, stream)
        else:
            fn = lib.mha_forward_lse_drop
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     mask.data_ptr() if mask is not None else None,
                     dm.data_ptr(), o.data_ptr(), lse.data_ptr(), b, n, d,
                     heads, _scale(d, heads, scale), int(bool(causal)),
                     float(keep), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mha_fwd_lse_drop kernel launch failed ({route} "
                           f"route): CUDA error {err}")
    _count(mha_fwd_lse_drop, route)
    return o, lse


mha_fwd_lse_drop.launches = 0
mha_fwd_lse_drop.route_launches = {"tc32": 0, "cuda_core": 0}


def mha_flash_bwd_drop(q, k, v, o, do, lse, dm, *, heads: int, keep: float,
                       scale: float = 0.0,
                       mask: Optional[torch.Tensor] = None,
                       causal: bool = False):
    """Flash backward of ``mha_fwd_lse_drop`` with the same keep mask:
    (dq, dk, dv) in q's dtype. On the card it runs ``flash_plan``'s
    backward route for the dropout pair ("tc32" for fp32 at head dim 64 and
    N <= 64, else "cuda_core")."""
    _check(q, k, v, heads, mask, max_n=None)
    _check_drop(q, dm, heads, keep)
    _check_lse(q, lse, heads)
    do = do.to(q.dtype)
    if q.device.type == "cpu":
        return mha_flash_bwd_drop_reference(
            q, k, v, o, do, lse, dm, heads=heads, keep=keep, scale=scale,
            mask=mask, causal=causal)
    return launch_flash_bwd_drop(
        flash_plan(q.shape, heads, q.dtype, dropout=True), q, k, v, o, do,
        lse, dm, heads=heads, keep=keep, scale=scale, mask=mask,
        causal=causal)


def launch_flash_bwd_drop(plan: FlashPlan, q, k, v, o, do, lse, dm, *,
                          heads: int, keep: float, scale: float = 0.0,
                          mask: Optional[torch.Tensor] = None,
                          causal: bool = False):
    """``mha_flash_bwd_drop`` on CUDA tensors under the backward route of
    `plan` (``flash_plan(..., dropout=True)`` of this shape: "tc32" or
    "cuda_core")."""
    _check(q, k, v, heads, mask, max_n=None)
    _check_drop(q, dm, heads, keep)
    _check_lse(q, lse, heads)
    b, n, d = q.shape
    do = do.to(q.dtype).contiguous()
    _kernel_args([q, k, v, o, do, lse, mask, dm], b, d, heads)
    if q.device.type != "cuda":
        raise ValueError("launch_flash_bwd_drop takes CUDA tensors")
    route = plan.bwd_route
    if route not in ("tc32", "cuda_core"):
        raise ValueError(f"the dropout backward has no {route!r} route")
    from . import _build

    lib = _build.library("mha_fused")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "tc32":
            err, dq, dk, dv = _launch_tc32(lib, plan, q, k, v, o, do, lse,
                                           mask, dm, keep, heads, scale,
                                           causal, stream)
        else:
            fn = lib.mha_flash_backward_drop
            fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            dq, dk, dv = (torch.empty_like(q) for _ in range(3))
            delta = torch.empty((b, heads, n), dtype=torch.float32,
                                device=q.device)
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     do.data_ptr(), lse.data_ptr(),
                     mask.data_ptr() if mask is not None else None,
                     dm.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                     dv.data_ptr(), delta.data_ptr(), b, n, d, heads,
                     _scale(d, heads, scale), int(bool(causal)), float(keep),
                     _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mha_flash_bwd_drop kernel launch failed "
                           f"({route} route): CUDA error {err}")
    _count(mha_flash_bwd_drop, route)
    return dq, dk, dv


mha_flash_bwd_drop.launches = 0
mha_flash_bwd_drop.route_launches = {"tc32": 0, "cuda_core": 0}


def flash_drop_fits(shape, heads: int, dtype) -> bool:
    """Whether the dropout pair takes [B, N, D] with `heads` heads. The
    keep mask is read from device memory a tile at a time and costs the
    kernels no shared memory that grows with N, so the limits are the
    plain pair's (``flash_train_fits``) at head dims 32 / 64 / 128 (no path
    drops OPT-2.7B's attention weights: head dim 80 has no dropout pair).
    A caller asks this before it consumes the dropout site."""
    return (flash_train_fits(shape, heads, dtype)
            and shape[2] // heads in HEAD_DIMS)


def drop_keep_mask(key, p: float, b: int, heads: int, n: int,
                   device) -> torch.Tensor:
    """The uint8 [B, H, N, N] keep mask of one attention-probs site, drawn
    from the site's key (``nn.core.Key`` or anything with its
    ``keep_mask``): the mask ``HFDropout.__call__`` would draw on the
    weights at that site."""
    return key.keep_mask((b, heads, n, n), p, device).view(torch.uint8)


class _FlashTrainDrop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, key, heads, scale, causal, p):
        b, n, _ = q.shape
        dm = drop_keep_mask(key, p, b, heads, n, q.device)
        o, lse = mha_fwd_lse_drop(q, k, v, dm, heads=heads, keep=1.0 - p,
                                  scale=scale, mask=mask, causal=causal)
        # the key, not the [B, H, N, N] mask, waits for the backward
        ctx.save_for_backward(q, k, v, o, lse, mask)
        ctx.args = (key, heads, scale, causal, p)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse, mask = ctx.saved_tensors
        key, heads, scale, causal, p = ctx.args
        b, n, _ = q.shape
        dm = drop_keep_mask(key, p, b, heads, n, q.device)
        dq, dk, dv = mha_flash_bwd_drop(
            q, k, v, o, g, lse, dm, heads=heads, keep=1.0 - p, scale=scale,
            mask=mask, causal=causal)
        return dq, dk, dv, None, None, None, None, None, None


def mha_flash_train_dropout(q, k, v, *, heads: int, key, p: float,
                            scale: float = 0.0,
                            mask: Optional[torch.Tensor] = None,
                            causal: bool = False) -> torch.Tensor:
    """``mha_flash_train`` with dropout (probability `p`) on the softmax
    weights fused into both passes. `key` is the dropout site's key
    (``HFDropout.site_key``). On CPU tensors a shape that
    ``flash_drop_fits`` rejects goes through the plain forward under
    autograd, with the same mask; on CUDA tensors it raises."""
    if not 0.0 < p < 1.0:
        raise ValueError(f"dropout probability must lie in (0, 1), got {p}")
    if not flash_drop_fits(q.shape, heads, q.dtype):
        if q.device.type == "cpu":
            b, n, _ = q.shape
            dm = drop_keep_mask(key, p, b, heads, n, q.device)
            return mha_fwd_lse_drop_reference(
                q, k, v, dm, heads=heads, keep=1.0 - p, scale=scale,
                mask=mask, causal=causal)[0]
        raise ValueError(
            f"the flash dropout kernels take N <= {MAX_N}, head dims "
            f"{HEAD_DIMS} and float32/bfloat16, got {tuple(q.shape)} with "
            f"{heads} heads in {q.dtype}")
    return _FlashTrainDrop.apply(q, k, v, mask, key, heads, float(scale),
                                 bool(causal), float(p))
