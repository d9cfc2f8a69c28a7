"""Fused MM-RCA block: the CUDA kernels of ``csrc/rca_fused.cu`` (forward
and fused backward) and their plain PyTorch versions.

Replaces ``garbage_classification_rca_tpu/kernels/rca_fused.py``:
``rca_fused`` (two single-head self-attentions over text patches
[B, 16, 48] and image patches [B, 16, 80]; Q/K 128, V 96; then two reverse
cross-attentions, Q/K 64, V 48; each with LayerNorm + ReLU; all arithmetic
in fp32, outputs in t's dtype), ``rca_fused_bwd`` (the whole block's
backward: dt, di and the 32 weight gradients in fp32) and
``rca_fused_trainable`` (forward kernel + backward kernel under autograd).
t and i may differ in dtype (fp32 / bf16), as the training path gives them.
``csrc/rca_fused.cu`` explains what bounds the kernels on the H100 and how
their design answers that.

The wrappers run the plain versions for tensors on the CPU and the kernels
for tensors on a CUDA device; ``rca_fused.launches`` and
``rca_fused_bwd.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import types
from typing import List, Sequence, Tuple

import torch

from ..nn import core
from ..ops import attention as att

N_PATCH = 16
SA_KQ, SA_V = 128, 96
CA_KQ, CA_V = 64, 48
UNITS = ("sa_txt", "sa_img", "rca_ti", "rca_it")
# (d_in_q, d_in_kv, d_kq, d_v) per unit, in UNITS order
_GEOM = ((48, 48, SA_KQ, SA_V), (80, 80, SA_KQ, SA_V),
         (SA_V, SA_V, CA_KQ, CA_V), (SA_V, SA_V, CA_KQ, CA_V))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
N_WEIGHTS = 80480


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


def _units_of(ws: Sequence[torch.Tensor]) -> types.SimpleNamespace:
    """Attention units as the ops.attention functions read them, over the
    32 given tensors."""
    def unit(w8):
        wq, bq, wk, bk, wv, bv, g, be = w8
        return types.SimpleNamespace(
            q=lambda x: core.linear(x, wq, bq),
            k=lambda x: core.linear(x, wk, bk),
            v=lambda x: core.linear(x, wv, bv),
            norm=lambda x: core.layernorm(x, g, be))

    return types.SimpleNamespace(**{
        name: unit(ws[8 * u:8 * u + 8]) for u, name in enumerate(UNITS)})


def _reference(ws, t, i, reverse):
    p = _units_of(ws)
    tf, i_f = t.float(), i.float()
    t_sa = att.self_attention(p.sa_txt, tf)
    i_sa = att.self_attention(p.sa_img, i_f)
    ti = att.reverse_cross_attention(p.rca_ti, t_sa, i_sa, reverse)
    it = att.reverse_cross_attention(p.rca_it, i_sa, t_sa, reverse)
    return ti.to(t.dtype), it.to(t.dtype)


def rca_fused_reference(p, t: torch.Tensor, i: torch.Tensor, *,
                        reverse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ops.attention on fp32 copies of t and i, outputs in
    t's dtype."""
    return _reference(_weights(p), t, i, reverse)


def rca_fused_bwd_reference(p, t, i, g_ti, g_it, *, reverse: bool):
    """Plain version of the backward: autograd of ``rca_fused_reference``.
    Returns (dt, di, [32 weight grads]) with dt / di in t's / i's dtype and
    the weight grads in fp32."""
    ws = [w.detach().float().requires_grad_() for w in _weights(p)]
    t_ = t.detach().requires_grad_()
    i_ = i.detach().requires_grad_()
    with torch.enable_grad():
        outs = _reference(ws, t_, i_, reverse)
        grads = torch.autograd.grad(outs, [t_, i_] + ws, (g_ti, g_it))
    return grads[0], grads[1], list(grads[2:])


def _check(p, t, i) -> List[torch.Tensor]:
    if t.dim() != 3 or tuple(t.shape[1:]) != (N_PATCH, 48):
        raise ValueError(f"t must be [B, 16, 48], got {tuple(t.shape)}")
    if i.dim() != 3 or tuple(i.shape[1:]) != (N_PATCH, 80) \
            or i.shape[0] != t.shape[0]:
        raise ValueError(f"i must be [B, 16, 80] with t's batch, got "
                         f"{tuple(i.shape)}")
    if t.dtype not in _DTYPES or i.dtype not in _DTYPES:
        raise TypeError(f"t/i must be float32 or bfloat16, got "
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
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rca_fused runs on cpu or cuda, not {t.device}")
    return ws


def _contiguous(*tensors):
    if not all(a.is_contiguous() for a in tensors):
        raise ValueError("the rca_fused kernels need contiguous inputs and "
                         "weights")


def rca_fused(p, t: torch.Tensor, i: torch.Tensor, *,
              reverse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """t: [B, 16, 48], i: [B, 16, 80] -> (ti, it): 2x [B, 16, 48] in t's
    dtype."""
    ws = _check(p, t, i)
    if t.device.type == "cpu":
        return rca_fused_reference(p, t, i, reverse=reverse)
    _contiguous(t, i, *ws)
    from . import _build

    fn = _build.library("rca_fused").rca_fused_forward
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                   ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b = t.shape[0]
    ti = torch.empty((b, N_PATCH, CA_V), dtype=t.dtype, device=t.device)
    it = torch.empty_like(ti)
    ptrs = (ctypes.c_void_p * 32)(*[w.data_ptr() for w in ws])
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(t.data_ptr(), i.data_ptr(), ptrs, ti.data_ptr(),
                 it.data_ptr(), b, _DTYPES[t.dtype], _DTYPES[i.dtype],
                 _DTYPES[ws[0].dtype], int(bool(reverse)), stream)
    if err != 0:
        raise RuntimeError(f"rca_fused kernel launch failed: CUDA error {err}")
    rca_fused.launches += 1
    return ti, it


rca_fused.launches = 0


def rca_fused_bwd(p, t, i, g_ti, g_it, *, reverse: bool):
    """Backward of ``rca_fused``: (dt, di, [32 weight grads]); dt / di in
    t's / i's dtype, the weight grads in fp32 in ``_weights`` order.
    g_ti / g_it: [B, 16, 48] cotangents of the two outputs."""
    ws = _check(p, t, i)
    for g in (g_ti, g_it):
        if tuple(g.shape) != (t.shape[0], N_PATCH, CA_V) or g.device != t.device:
            raise ValueError(f"output cotangents must be [B, 16, 48] on "
                             f"{t.device}, got {tuple(g.shape)}")
    if t.device.type == "cpu":
        return rca_fused_bwd_reference(p, t, i, g_ti, g_it, reverse=reverse)
    g_ti = g_ti.to(t.dtype).contiguous()
    g_it = g_it.to(t.dtype).contiguous()
    _contiguous(t, i, *ws)
    from . import _build

    fn = _build.library("rca_fused").rca_fused_backward
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_void_p] * 6 \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b = t.shape[0]
    dt = torch.empty_like(t)
    di = torch.empty_like(i)
    part = torch.empty((b, N_WEIGHTS), dtype=torch.float32, device=t.device)
    dw = torch.empty((N_WEIGHTS,), dtype=torch.float32, device=t.device)
    ptrs = (ctypes.c_void_p * 32)(*[w.data_ptr() for w in ws])
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(t.data_ptr(), i.data_ptr(), ptrs, g_ti.data_ptr(),
                 g_it.data_ptr(), dt.data_ptr(), di.data_ptr(),
                 part.data_ptr(), dw.data_ptr(), b, _DTYPES[t.dtype],
                 _DTYPES[i.dtype], _DTYPES[ws[0].dtype], int(bool(reverse)),
                 stream)
    if err != 0:
        raise RuntimeError(f"rca_fused_bwd kernel launch failed: CUDA error "
                           f"{err}")
    rca_fused_bwd.launches += 1
    grads, off = [], 0
    for w in ws:
        grads.append(dw[off:off + w.numel()].view(w.shape))
        off += w.numel()
    return dt, di, grads


rca_fused_bwd.launches = 0


class _RcaTrainable(torch.autograd.Function):
    """Forward ``rca_fused``; backward ``rca_fused_bwd``. Only the inputs
    are saved, as the JAX custom VJP saves them."""

    @staticmethod
    def forward(ctx, p, t, i, reverse, *ws):
        ctx.p, ctx.reverse = p, reverse
        ctx.save_for_backward(t, i)
        return rca_fused(p, t, i, reverse=reverse)

    @staticmethod
    def backward(ctx, g_ti, g_it):
        t, i = ctx.saved_tensors
        ws = _weights(ctx.p)
        dt, di, grads = rca_fused_bwd(ctx.p, t, i, g_ti, g_it,
                                      reverse=ctx.reverse)
        return (None, dt, di, None,
                *[g.to(w.dtype) for g, w in zip(grads, ws)])


def rca_fused_trainable(p, t: torch.Tensor, i: torch.Tensor, *,
                        reverse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable ``rca_fused``: gradients reach t, i and the 32
    weights of `p` (cast to each parameter's dtype)."""
    return _RcaTrainable.apply(p, t, i, bool(reverse), *_weights(p))
