"""Masked / causal multi-head attention: the CUDA kernel
``csrc/mha_fused.cu`` and its plain PyTorch version.

Replaces ``garbage_classification_rca_tpu/kernels/mha_fused.py::mha``:
``out = softmax(Q K^T * scale + mask_bias) V`` per head, q/k/v [B, N, D]
with head h the columns h*dh:(h+1)*dh; scale 1/sqrt(dh) by default; the
key mask bias is (m - 1) * 1e30; causal masks key > query with -1e30. The
softmax runs in fp32 with the max subtracted and its weights are rounded
to V's dtype before the PV product (fp32 accumulation). ``csrc/mha_fused.cu``
explains what bounds the kernel on the H100 and how its design answers that.

The wrapper runs the plain version for tensors on the CPU and the kernel
for tensors on a CUDA device; ``mha.launches`` counts kernel launches.
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


def mha_reference(q, k, v, *, heads: int, scale: float = 0.0, mask=None,
                  causal: bool = False) -> torch.Tensor:
    """Plain version (the JAX ``mha_reference`` graph)."""
    b, n, d = q.shape
    dh = d // heads
    if scale == 0.0:
        scale = 1.0 / math.sqrt(dh)

    def rs(a):
        return a.reshape(b, n, heads, dh).transpose(1, 2).float()

    s = rs(q) @ rs(k).transpose(-1, -2) * float(scale)
    if mask is not None:
        s = s + ((mask.float() - 1.0) * -NEG)[:, None, None, :]
    if causal:
        tri = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
        s = torch.where(tri, s, torch.full_like(s, NEG))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    w = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype)
    o = w.float() @ rs(v)
    return o.transpose(1, 2).reshape(b, n, d).to(q.dtype)


def _check(q, k, v, heads, mask):
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v must be equal [B, N, D], got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    b, n, d = q.shape
    if heads <= 0 or d % heads:
        raise ValueError(f"D={d} not divisible by heads={heads}")
    if n > MAX_N:
        raise ValueError(f"mha takes N <= {MAX_N}, got {n}")
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


def mha(q, k, v, *, heads: int, scale: float = 0.0,
        mask: Optional[torch.Tensor] = None,
        causal: bool = False) -> torch.Tensor:
    """q/k/v: [B, N, D]; mask: optional int32 [B, N] key validity
    (1 = attendable). Returns [B, N, D] in q's dtype."""
    _check(q, k, v, heads, mask)
    if q.device.type == "cpu":
        return mha_reference(q, k, v, heads=heads, scale=scale, mask=mask,
                             causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"mha runs on cpu or cuda, not {q.device}")
    b, n, d = q.shape
    if d // heads not in HEAD_DIMS:
        raise ValueError(f"the mha kernel takes head dims {HEAD_DIMS}, got "
                         f"{d // heads}")
    if b > 65535:
        raise ValueError(f"the mha kernel takes B <= 65535, got {b}")
    tensors = [q, k, v] + ([mask] if mask is not None else [])
    if not all(a.is_contiguous() for a in tensors):
        raise ValueError("mha needs contiguous q/k/v/mask")
    if scale == 0.0:
        scale = 1.0 / math.sqrt(d // heads)
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
