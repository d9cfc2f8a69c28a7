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

The wrappers run the plain versions for tensors on the CPU and the kernels
for tensors on a CUDA device; ``mha.launches``, ``mha_fwd_lse.launches``,
``mha_flash_bwd.launches``, ``mha_fwd_lse_drop.launches`` and
``mha_flash_bwd_drop.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

NEG = -1e30
MAX_N = 512          # DistilBERT's position table, the most --seq_len gives
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def _kernel_args(tensors, b, d, heads):
    """Checks the kernels' own limits on CUDA tensors."""
    if d // heads not in HEAD_DIMS:
        raise ValueError(f"the mha kernels take head dims {HEAD_DIMS}, got "
                         f"{d // heads}")
    if b > 65535:
        raise ValueError(f"the mha kernels take B <= 65535, got {b}")
    if not all(a.is_contiguous() for a in tensors if a is not None):
        raise ValueError("the mha kernels need contiguous tensors")


def mha(q, k, v, *, heads: int, scale: float = 0.0,
        mask: Optional[torch.Tensor] = None,
        causal: bool = False) -> torch.Tensor:
    """q/k/v: [B, N, D]; mask: optional int32 [B, N] key validity
    (1 = attendable). Returns [B, N, D] in q's dtype."""
    _check(q, k, v, heads, mask)
    if q.device.type == "cpu":
        return mha_reference(q, k, v, heads=heads, scale=scale, mask=mask,
                             causal=causal)
    b, n, d = q.shape
    _kernel_args([q, k, v, mask], b, d, heads)
    scale = _scale(d, heads, scale)
    from . import _build

    fn = _build.library("mha_fused").mha_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 mask.data_ptr() if mask is not None else None, o.data_ptr(),
                 b, n, d, heads, float(scale), int(bool(causal)),
                 _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mha kernel launch failed: CUDA error {err}")
    mha.launches += 1
    return o


mha.launches = 0


def mha_fwd_lse(q, k, v, *, heads: int, scale: float = 0.0,
                mask: Optional[torch.Tensor] = None, causal: bool = False):
    """The training forward: (out [B, N, D] in q's dtype, lse [B, H, N]
    fp32)."""
    _check(q, k, v, heads, mask)
    if q.device.type == "cpu":
        return mha_fwd_lse_reference(q, k, v, heads=heads, scale=scale,
                                     mask=mask, causal=causal)
    b, n, d = q.shape
    _kernel_args([q, k, v, mask], b, d, heads)
    from . import _build

    fn = _build.library("mha_fused").mha_forward_lse
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    o = torch.empty_like(q)
    lse = torch.empty((b, heads, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 mask.data_ptr() if mask is not None else None, o.data_ptr(),
                 lse.data_ptr(), b, n, d, heads, _scale(d, heads, scale),
                 int(bool(causal)), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mha_fwd_lse kernel launch failed: CUDA error "
                           f"{err}")
    mha_fwd_lse.launches += 1
    return o, lse


mha_fwd_lse.launches = 0


def mha_flash_bwd(q, k, v, o, do, lse, *, heads: int, scale: float = 0.0,
                  mask: Optional[torch.Tensor] = None, causal: bool = False):
    """Flash backward of ``mha_fwd_lse``: (dq, dk, dv) in q's dtype. `do`
    is the output cotangent; it is taken in q's dtype, as the JAX rule
    casts it."""
    _check(q, k, v, heads, mask, max_n=None)
    b, n, d = q.shape
    if tuple(lse.shape) != (b, heads, n) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 [B, H, N], got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    do = do.to(q.dtype)
    if q.device.type == "cpu":
        return mha_flash_bwd_reference(q, k, v, o, do, lse, heads=heads,
                                       scale=scale, mask=mask, causal=causal)
    do = do.contiguous()
    _kernel_args([q, k, v, o, do, lse, mask], b, d, heads)
    from . import _build

    fn = _build.library("mha_fused").mha_flash_backward
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty((b, heads, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(),
                 mask.data_ptr() if mask is not None else None,
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 delta.data_ptr(), b, n, d, heads, _scale(d, heads, scale),
                 int(bool(causal)), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mha_flash_bwd kernel launch failed: CUDA error "
                           f"{err}")
    mha_flash_bwd.launches += 1
    return dq, dk, dv


mha_flash_bwd.launches = 0


def flash_train_fits(shape, heads: int, dtype) -> bool:
    """Whether the flash pair takes [B, N, D] with `heads` heads: the
    forward holds 32 fp32 score rows of N in shared memory (N <= 512) and
    both kernels are built for head dims 32 / 64 / 128 in fp32 or bf16."""
    b, n, d = shape
    return (dtype in _DTYPES and heads > 0 and d % heads == 0
            and d // heads in HEAD_DIMS and 1 <= n <= MAX_N and b <= 65535)


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
            f"{HEAD_DIMS} and float32/bfloat16, got {tuple(q.shape)} with "
            f"{heads} heads in {q.dtype}")
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
    dropout). dm: uint8 [B, H, N, N] keep mask; keep = 1 - p."""
    _check(q, k, v, heads, mask)
    _check_drop(q, dm, heads, keep)
    if q.device.type == "cpu":
        return mha_fwd_lse_drop_reference(q, k, v, dm, heads=heads,
                                          keep=keep, scale=scale, mask=mask,
                                          causal=causal)
    b, n, d = q.shape
    _kernel_args([q, k, v, mask, dm], b, d, heads)
    from . import _build

    fn = _build.library("mha_fused").mha_forward_lse_drop
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    o = torch.empty_like(q)
    lse = torch.empty((b, heads, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 mask.data_ptr() if mask is not None else None,
                 dm.data_ptr(), o.data_ptr(), lse.data_ptr(), b, n, d, heads,
                 _scale(d, heads, scale), int(bool(causal)), float(keep),
                 _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mha_fwd_lse_drop kernel launch failed: CUDA "
                           f"error {err}")
    mha_fwd_lse_drop.launches += 1
    return o, lse


mha_fwd_lse_drop.launches = 0


def mha_flash_bwd_drop(q, k, v, o, do, lse, dm, *, heads: int, keep: float,
                       scale: float = 0.0,
                       mask: Optional[torch.Tensor] = None,
                       causal: bool = False):
    """Flash backward of ``mha_fwd_lse_drop`` with the same keep mask:
    (dq, dk, dv) in q's dtype."""
    _check(q, k, v, heads, mask, max_n=None)
    _check_drop(q, dm, heads, keep)
    b, n, d = q.shape
    if tuple(lse.shape) != (b, heads, n) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 [B, H, N], got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    do = do.to(q.dtype)
    if q.device.type == "cpu":
        return mha_flash_bwd_drop_reference(
            q, k, v, o, do, lse, dm, heads=heads, keep=keep, scale=scale,
            mask=mask, causal=causal)
    do = do.contiguous()
    _kernel_args([q, k, v, o, do, lse, mask, dm], b, d, heads)
    from . import _build

    fn = _build.library("mha_fused").mha_flash_backward_drop
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty((b, heads, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(),
                 mask.data_ptr() if mask is not None else None,
                 dm.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 delta.data_ptr(), b, n, d, heads, _scale(d, heads, scale),
                 int(bool(causal)), float(keep), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mha_flash_bwd_drop kernel launch failed: CUDA "
                           f"error {err}")
    mha_flash_bwd_drop.launches += 1
    return dq, dk, dv


mha_flash_bwd_drop.launches = 0


def flash_drop_fits(shape, heads: int, dtype) -> bool:
    """Whether the dropout pair takes [B, N, D] with `heads` heads. The
    keep mask is read from device memory a tile at a time and costs the
    kernels no shared memory that grows with N, so the limits are the
    plain pair's (``flash_train_fits``). A caller asks this before it
    consumes the dropout site."""
    return flash_train_fits(shape, heads, dtype)


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
