"""Fused MM-RCA block: the CUDA kernel ``csrc/rca_fused.cu`` and its plain
PyTorch version.

Replaces ``garbage_classification_rca_tpu/kernels/rca_fused.py::rca_fused``:
two single-head self-attentions (text patches [B, 16, 48], image patches
[B, 16, 80]; Q/K 128, V 96) then two reverse cross-attentions (Q/K 64,
V 48), each with LayerNorm + ReLU, all arithmetic in fp32, outputs in the
input dtype. ``csrc/rca_fused.cu`` explains what bounds the kernel on the
H100 and how its design answers that.

The wrapper runs the plain version for tensors on the CPU and the kernel
for tensors on a CUDA device; ``rca_fused.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from ..ops import attention as att

N_PATCH = 16
SA_KQ, SA_V = 128, 96
CA_KQ, CA_V = 64, 48
UNITS = ("sa_txt", "sa_img", "rca_ti", "rca_it")
# (d_in_q, d_in_kv, d_kq, d_v) per unit, in UNITS order
_GEOM = ((48, 48, SA_KQ, SA_V), (80, 80, SA_KQ, SA_V),
         (SA_V, SA_V, CA_KQ, CA_V), (SA_V, SA_V, CA_KQ, CA_V))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _unit_tensors(u: att.AttentionUnit) -> List[torch.Tensor]:
    return [u.q.w, u.q.b, u.k.w, u.k.b, u.v.w, u.v.b, u.norm.scale,
            u.norm.bias]


def _weights(p) -> List[torch.Tensor]:
    """The 32 weight tensors in kernel order; `p` has the four units as
    attributes (the fusion model does)."""
    out = []
    for name, (dq, dkv, dkq, dv) in zip(UNITS, _GEOM):
        ws = _unit_tensors(getattr(p, name))
        want = [(dkq, dq), (dkq,), (dkq, dkv), (dkq,), (dv, dkv), (dv,),
                (dv,), (dv,)]
        for w, shape in zip(ws, want):
            if tuple(w.shape) != shape:
                raise ValueError(f"{name}: weight of shape {tuple(w.shape)}, "
                                 f"expected {shape}")
        out.extend(ws)
    return out


def rca_fused_reference(p, t: torch.Tensor, i: torch.Tensor, *,
                        reverse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ops.attention on fp32 copies, outputs in t's dtype."""
    tf, i_f = t.float(), i.float()
    t_sa = att.self_attention(p.sa_txt, tf)
    i_sa = att.self_attention(p.sa_img, i_f)
    ti = att.reverse_cross_attention(p.rca_ti, t_sa, i_sa, reverse)
    it = att.reverse_cross_attention(p.rca_it, i_sa, t_sa, reverse)
    return ti.to(t.dtype), it.to(t.dtype)


def _check(p, t, i) -> List[torch.Tensor]:
    if t.dim() != 3 or tuple(t.shape[1:]) != (N_PATCH, 48):
        raise ValueError(f"t must be [B, 16, 48], got {tuple(t.shape)}")
    if i.dim() != 3 or tuple(i.shape[1:]) != (N_PATCH, 80) \
            or i.shape[0] != t.shape[0]:
        raise ValueError(f"i must be [B, 16, 80] with t's batch, got "
                         f"{tuple(i.shape)}")
    if t.dtype != i.dtype or t.dtype not in _DTYPES:
        raise TypeError(f"t/i must share a dtype in float32/bfloat16, got "
                        f"{t.dtype}/{i.dtype}")
    if t.device != i.device:
        raise ValueError("t and i lie on different devices")
    ws = _weights(p)
    wdt = ws[0].dtype
    for w in ws:
        if w.dtype != wdt or w.dtype not in _DTYPES:
            raise TypeError("the 32 weights must share a dtype in "
                            f"float32/bfloat16, got {w.dtype} and {wdt}")
        if w.device != t.device:
            raise ValueError("weights and inputs lie on different devices")
    return ws


def rca_fused(p, t: torch.Tensor, i: torch.Tensor, *,
              reverse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """t: [B, 16, 48], i: [B, 16, 80] -> (ti, it): 2x [B, 16, 48]."""
    ws = _check(p, t, i)
    if t.device.type == "cpu":
        return rca_fused_reference(p, t, i, reverse=reverse)
    if t.device.type != "cuda":
        raise ValueError(f"rca_fused runs on cpu or cuda, not {t.device}")
    if not (t.is_contiguous() and i.is_contiguous()
            and all(w.is_contiguous() for w in ws)):
        raise ValueError("rca_fused needs contiguous inputs and weights")
    from . import _build

    lib = _build.library("rca_fused")
    fn = lib.rca_fused_forward
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b = t.shape[0]
    ti = torch.empty((b, N_PATCH, CA_V), dtype=t.dtype, device=t.device)
    it = torch.empty_like(ti)
    ptrs = (ctypes.c_void_p * 32)(*[w.data_ptr() for w in ws])
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(t.data_ptr(), i.data_ptr(), ptrs, ti.data_ptr(),
                 it.data_ptr(), b, _DTYPES[t.dtype], _DTYPES[ws[0].dtype],
                 int(bool(reverse)), stream)
    if err != 0:
        raise RuntimeError(f"rca_fused kernel launch failed: CUDA error {err}")
    rca_fused.launches += 1
    return ti, it


rca_fused.launches = 0
