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
``rca_fused_bwd.launches`` count kernel launches. Both have two routes,
which give the same bits; ``.route_launches`` counts each. The forward
(``rca_fwd_plan``): "staged", the default, two kernels over (sample group,
unit) blocks, and "per_sample", the first version (one block per sample
running the four units in turn). The backward (``rca_bwd_plan``):
"staged", the default, four kernels over (sample, unit) blocks and one
batch-ordered weight-gradient pass, and "per_sample", the first version
(one block per sample + a batch reduce). A "per_sample" route runs only on
request.
"""

from __future__ import annotations

import ctypes
import math
import types
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

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


FWD_ROUTES = ("staged", "per_sample")
H100_SMS = 132
_SA_C = 2 * SA_KQ + SA_V        # q | k | v columns of a self-attention


def _r4(n: int) -> int:
    return -(-n // 4) * 4


def _stage_floats(d_in: int, dkq: int, dv: int, n_x: int, g: int) -> int:
    """csrc/rca_fused.cu's ``Lay``: a stage block's shared memory in floats,
    one unit's staged weights [C][d_in + 4], biases and LayerNorm affine,
    then per sample (16-byte aligned) its n_x x tiles [d_in][16] and the
    attention buffers P [16][C + 1], A [16][16], Y [16][d_v], 1/std [16]."""
    c = 2 * dkq + dv
    head = _r4(c * (d_in + 4) + c + 2 * dv)
    per = _r4(N_PATCH * (n_x * d_in + c + 1 + N_PATCH + dv + 1))
    return head + g * per


# dynamic shared memory of the staged forward's blocks at G = 1, 2 samples
# (stage 1 sized by sa_img, the wider input), and of the per-sample kernel
FWD_STAGE_SMEM = tuple({g: 4 * _stage_floats(d, dkq, dv, nx, g)
                        for g in (1, 2)}
                       for d, dkq, dv, nx in ((80, SA_KQ, SA_V, 1),
                                              (SA_V, CA_KQ, CA_V, 2)))
PER_SAMPLE_FWD_SMEM = 4 * (80 * (_SA_C + 1) + _SA_C + 2 * SA_V + N_PATCH * (
    48 + 80 + 2 * SA_V + _SA_C + 1 + N_PATCH + SA_V))


@dataclass(frozen=True)
class RcaFwdPlan:
    """How one ``rca_fused`` call runs on the card; the wrapper hands it to
    ``rca_fused_forward`` as it is. `route`: "staged" or "per_sample";
    `stages`: (kernel, grid (x, y), dynamic shared memory bytes) in launch
    order, 256 threads a block; `groups`: the samples a block of each
    stage; `workspace`: the float32 regions the kernels share, name ->
    (offset in floats, shape), in one buffer of `floats` values."""
    route: str
    stages: Tuple[Tuple[str, Tuple[int, int], int], ...]
    groups: Tuple[int, ...]
    workspace: Dict[str, Tuple[int, Tuple[int, ...]]]
    floats: int


def rca_fwd_plan(batch: int, route: Optional[str] = None,
                 sms: int = H100_SMS) -> RcaFwdPlan:
    """The launch plan of ``rca_fused`` at `batch` samples on a card of
    `sms` SMs: "staged" (the default) or "per_sample" (on request, for the
    A/B). Staged: ``rca_fwd_self`` (sa_txt | sa_img of G1 samples a block)
    writes t_sa | i_sa to the workspace, ``rca_fwd_cross`` (rca_ti |
    rca_it of G2 samples) reads them. G1 = G2 = 1 while the (batch, 2)
    blocks are no more than the SMs, else 2: one staged copy of a unit's
    weights then serves two samples where an SM would stage it for two
    blocks (the cross blocks fit two an SM)."""
    route = route or "staged"
    if route not in FWD_ROUTES:
        raise ValueError(f"unknown route {route!r}; one of {FWD_ROUTES}")
    if batch < 0:
        raise ValueError(f"batch must be >= 0, got {batch}")
    if route == "per_sample":
        return RcaFwdPlan(route, (("rca_fused_kernel", (batch, 1),
                                   PER_SAMPLE_FWD_SMEM),), (1,), {}, 0)
    g1 = g2 = 1 if 2 * batch <= sms else 2
    shape = (2, batch, N_PATCH, SA_V)
    return RcaFwdPlan(route, (
        ("rca_fwd_self", (-(-batch // g1), 2), FWD_STAGE_SMEM[0][g1]),
        ("rca_fwd_cross", (-(-batch // g2), 2), FWD_STAGE_SMEM[1][g2])),
        (g1, g2), {"sa_out": (0, shape)}, math.prod(shape))


def rca_fused(p, t: torch.Tensor, i: torch.Tensor, *, reverse: bool,
              route: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """t: [B, 16, 48], i: [B, 16, 80] -> (ti, it): 2x [B, 16, 48] in t's
    dtype. On CUDA the plan of ``rca_fwd_plan(B, route, SMs)`` runs; CPU
    tensors take the plain version."""
    ws = _check(p, t, i)
    b = t.shape[0]
    if t.device.type == "cpu":
        rca_fwd_plan(b, route)          # an unknown route raises here too
        return rca_fused_reference(p, t, i, reverse=reverse)
    sms = torch.cuda.get_device_properties(t.device).multi_processor_count
    plan = rca_fwd_plan(b, route, sms)
    _contiguous(t, i, *ws)
    from . import _build

    fn = _build.library("rca_fused").rca_fused_forward
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_void_p] * 3 \
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong] \
        + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ti = torch.empty((b, N_PATCH, CA_V), dtype=t.dtype, device=t.device)
    it = torch.empty_like(ti)
    work = torch.empty((plan.floats,), dtype=torch.float32, device=t.device)
    ptrs = (ctypes.c_void_p * 32)(*[w.data_ptr() for w in ws])
    offsets = (ctypes.c_longlong * 1)(
        *[o for o, _ in plan.workspace.values()][:1])
    g1, g2 = (plan.groups + (0,))[:2]
    smem1, smem2 = ([s for _, _, s in plan.stages] + [0])[:2]
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(t.data_ptr(), i.data_ptr(), ptrs, ti.data_ptr(),
                 it.data_ptr(), work.data_ptr() if plan.floats else None,
                 offsets, plan.floats, b, _DTYPES[t.dtype], _DTYPES[i.dtype],
                 _DTYPES[ws[0].dtype], int(bool(reverse)),
                 int(plan.route == "staged"), g1, g2, smem1, smem2, stream)
    if err != 0:
        raise RuntimeError(f"rca_fused kernel launch failed ({plan.route} "
                           f"route): CUDA error {err}")
    rca_fused.launches += 1
    rca_fused.route_launches[plan.route] += 1
    return ti, it


rca_fused.launches = 0
rca_fused.route_launches = {r: 0 for r in FWD_ROUTES}


BWD_ROUTES = ("staged", "per_sample")
# csrc/rca_fused.cu's shared-memory carve-up, in floats: a unit's staged
# weights (sa_img's [80][353] the largest) + biases + LayerNorm affine, its
# residuals P, A, yhat, 1/std (up to B_G), the cotangent G, dS and
# dq | dk | dv (up to B_XT), then each kernel's own inputs and outputs
_B_G = (80 * (_SA_C + 1) + _SA_C + 2 * SA_V + N_PATCH * (_SA_C + 1)
        + N_PATCH * N_PATCH + N_PATCH * SA_V + N_PATCH)
_B_XT = _B_G + N_PATCH * SA_V + N_PATCH * N_PATCH + N_PATCH * (_SA_C + 1)
STAGE_SMEM = (4 * (_B_G + N_PATCH * (80 + SA_V)),      # x, then t_sa | i_sa
              4 * (_B_XT + 2 * N_PATCH * SA_V),        # xq, xkv
              4 * (_B_XT + N_PATCH * (80 + _SA_C)))    # dx, dq|dk|dv^T
PER_SAMPLE_SMEM = 4 * (_B_XT + 2 * N_PATCH * (48 + 80) + 4 * N_PATCH * SA_V)
WGRAD_TILE, WGRAD_VECS_PER_BLOCK = 16, 32


def wgrad_tiles() -> Tuple[Tuple[int, int, int], ...]:
    """The staged weight-gradient pass's tiles, (unit, first q|k|v column,
    first input feature), in block order: block j computes tiles 2j and
    2j + 1 (16 x 16 outputs each, 4 x 4 a lane of a warp, each warp for
    its own samples); the blocks after them the bias and LayerNorm values,
    WGRAD_VECS_PER_BLOCK a block, unit by unit (q | k | v biases, then the
    scale, then the shift)."""
    return tuple((u, c0, k0) for u, (d_in, _, dkq, dv) in enumerate(_GEOM)
                 for c0 in range(0, 2 * dkq + dv, WGRAD_TILE)
                 for k0 in range(0, d_in, WGRAD_TILE))


WGRAD_VECTORS = sum(2 * dkq + 3 * dv for _, _, dkq, dv in _GEOM)   # 1,632


@dataclass(frozen=True)
class RcaBwdPlan:
    """How one ``rca_fused_bwd`` call runs on the card; the wrapper hands
    it to ``rca_fused_backward`` as it is. `route`: "staged" or
    "per_sample"; `stages`: (kernel, grid (x, y), dynamic shared memory
    bytes) in launch order, 256 threads a block; `workspace`: the float32
    regions the kernels share, name -> (offset in floats, shape), each
    16-byte aligned, in one buffer of `floats` values."""
    route: str
    stages: Tuple[Tuple[str, Tuple[int, int], int], ...]
    workspace: Dict[str, Tuple[int, Tuple[int, ...]]]
    floats: int


def _staged_regions(b: int):
    """The staged route's workspace regions at batch `b`, in the order the
    C entry lays them out; slot (unit, sample) = unit * b + sample."""
    d = tuple((f"d_{name}", (b, N_PATCH, 2 * dkq + dv))
              for name, (_, _, dkq, dv) in zip(UNITS, _GEOM))
    return ((("sa_p", (2, b, N_PATCH, _SA_C)),          # q | k | v
             ("sa_a", (2, b, N_PATCH, N_PATCH)),        # softmax
             ("sa_yh", (2, b, N_PATCH, SA_V)),          # yhat
             ("sa_inv", (2, b, N_PATCH)),               # 1 / std
             ("sa_out", (2, b, N_PATCH, SA_V)))         # t_sa, i_sa
            + d                                         # dq | dk | dv
            # dx_q, dx_kv of rca_ti, then of rca_it
            + (("dx", (4, b, N_PATCH, SA_V)),
               # per-sample LayerNorm scale / shift gradients (first d_v)
               ("ln", (4, b, 2, SA_V))))


def rca_bwd_plan(batch: int, route: Optional[str] = None) -> RcaBwdPlan:
    """The launch plan of ``rca_fused_bwd`` at `batch` samples: "staged"
    (the default) or "per_sample" (on request, for the A/B)."""
    route = route or "staged"
    if route not in BWD_ROUTES:
        raise ValueError(f"unknown route {route!r}; one of {BWD_ROUTES}")
    if batch < 0:
        raise ValueError(f"batch must be >= 0, got {batch}")
    if route == "per_sample":
        return RcaBwdPlan(route, (
            ("rca_bwd_kernel", (batch, 1), PER_SAMPLE_SMEM),
            ("rca_bwd_reduce", (-(-N_WEIGHTS // 256), 1), 0)),
            {"part": (0, (batch, N_WEIGHTS))}, batch * N_WEIGHTS)
    workspace, at = {}, 0
    for name, shape in _staged_regions(batch):
        workspace[name] = (at, shape)
        at += -(-math.prod(shape) // 4) * 4
    grid4 = (len(wgrad_tiles()) // 2
             + -(-WGRAD_VECTORS // WGRAD_VECS_PER_BLOCK))
    return RcaBwdPlan(route, (
        ("rca_bwd_self_fwd", (batch, 2), STAGE_SMEM[0]),
        ("rca_bwd_cross", (batch, 2), STAGE_SMEM[1]),
        ("rca_bwd_self_bwd", (batch, 2), STAGE_SMEM[2]),
        ("rca_bwd_wgrad", (grid4, 1), 0)), workspace, at)


def rca_fused_bwd(p, t, i, g_ti, g_it, *, reverse: bool,
                  route: Optional[str] = None):
    """Backward of ``rca_fused``: (dt, di, [32 weight grads]); dt / di in
    t's / i's dtype, the weight grads in fp32 in ``_weights`` order.
    g_ti / g_it: [B, 16, 48] cotangents of the two outputs. On CUDA the
    plan of ``rca_bwd_plan(B, route)`` runs; CPU tensors take the plain
    version."""
    ws = _check(p, t, i)
    for g in (g_ti, g_it):
        if tuple(g.shape) != (t.shape[0], N_PATCH, CA_V) or g.device != t.device:
            raise ValueError(f"output cotangents must be [B, 16, 48] on "
                             f"{t.device}, got {tuple(g.shape)}")
    b = t.shape[0]
    plan = rca_bwd_plan(b, route)
    if t.device.type == "cpu":
        return rca_fused_bwd_reference(p, t, i, g_ti, g_it, reverse=reverse)
    g_ti = g_ti.to(t.dtype).contiguous()
    g_it = g_it.to(t.dtype).contiguous()
    _contiguous(t, i, *ws)
    from . import _build

    fn = _build.library("rca_fused").rca_fused_backward
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_void_p] * 5 \
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong,
           ctypes.c_void_p] + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dt = torch.empty_like(t)
    di = torch.empty_like(i)
    work = torch.empty((plan.floats,), dtype=torch.float32, device=t.device)
    dw = torch.empty((N_WEIGHTS,), dtype=torch.float32, device=t.device)
    ptrs = (ctypes.c_void_p * 32)(*[w.data_ptr() for w in ws])
    offsets = [o for o, _ in plan.workspace.values()]
    offsets = (ctypes.c_longlong * len(offsets))(*offsets)
    # the first three kernels' shared memory (per-sample: its one kernel's)
    smem = ([s for _, _, s in plan.stages[:-1]] + [0, 0])[:3]
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(t.data_ptr(), i.data_ptr(), ptrs, g_ti.data_ptr(),
                 g_it.data_ptr(), dt.data_ptr(), di.data_ptr(),
                 work.data_ptr(), offsets, plan.floats, dw.data_ptr(), b,
                 _DTYPES[t.dtype], _DTYPES[i.dtype], _DTYPES[ws[0].dtype],
                 int(bool(reverse)), int(plan.route == "staged"), *smem,
                 plan.stages[-1][1][0], stream)
    if err != 0:
        raise RuntimeError(f"rca_fused_bwd kernel launch failed "
                           f"({plan.route} route): CUDA error {err}")
    rca_fused_bwd.launches += 1
    rca_fused_bwd.route_launches[plan.route] += 1
    grads, off = [], 0
    for w in ws:
        grads.append(dw[off:off + w.numel()].view(w.shape))
        off += w.numel()
    return dt, di, grads


rca_fused_bwd.launches = 0
rca_fused_bwd.route_launches = {r: 0 for r in BWD_ROUTES}


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
