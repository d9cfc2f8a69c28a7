"""Fused transformer-encoder blocks: the CUDA kernels of
``csrc/transformer_block.cu`` and their plain PyTorch versions.

Replaces, in ``garbage_classification_rca_tpu/kernels/transformer_block.py``
(same names, same argument order, weights input-major as there):
  * ``postnorm_attn_block``: ``LN(x + out_proj(MHA(x Wqkv + b, key mask)))``
    and ``postnorm_mlp_block``: ``LN(x + act(x W1 + b1) W2 + b2)`` — the
    BERT-family eval layer (eps 1e-12);
  * ``attn_block``: ``x + out_proj(MHA(LN(x) Wqkv + b))`` and ``mlp_block``:
    ``x + act(LN(x) W1 + b1) W2 + b2`` — the ViT eval layer (eps 1e-6).
Forward only, as in the JAX package (its ``*_trainable`` wrappers
differentiate the plain graph and are not ported yet).

Rounding points, shared by the kernels and the plain versions (T is x's
dtype): LayerNorm two-pass in fp32; a pre-norm LN output, q/k/v after the
bias, the softmax weights, each head's output and the MLP hidden (after
bias and activation in fp32) are rounded to T; every product accumulates in
fp32. Post-norm rounds the projection output to T, adds x in T, and rounds
the LN result; pre-norm adds x in fp32 and rounds once. GELU is the exact
erf form (the Pallas body's polynomial differs from it by <= 1.5e-7 times
the hidden's magnitude). The key mask is the additive ``(mask - 1) * 1e30``:
a row whose keys are all masked attends uniformly.

The wrappers run the plain versions for tensors on the CPU and the kernels
for tensors on a CUDA device, where a shape or dtype the kernels do not
take raises; ``<wrapper>.launches`` counts kernel launches. The fit rules
(``attn_fits``, ``mlp_fits``, ``blocks_fit``) are the kernels' own limits:
the card streams the weights through L2, so the JAX package's
weights-resident-in-VMEM limits do not apply. ``csrc/transformer_block.cu``
explains what bounds the kernels on the H100 and which intermediate still
passes through device memory.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Sequence

import torch

from .mha_fused import mha_reference

HEAD_DIM = 64        # the kernels' head dim (BERT-base, ViT-B/16, ViT-L/16)
MAX_N = 224          # q, k, v of one head [N, 65] fp32 + 32 score rows
MAX_SMEM = 232448    # shared memory one block can use on the H100
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = ("gelu", "relu")


def _mlp_smem(rows: int, ffn: int, itemsize: int) -> int:
    """Shared memory of the MLP kernel with `rows` rows per block (the
    formula of ``mlp_smem`` in the CUDA source)."""
    return 4 * (16 * (rows + 4) + 16 * 256 + 64) + rows * ffn * itemsize


def attn_fits(n: int, d: int, heads: int, dtype) -> bool:
    """Whether the attention kernels take [*, n, d] with `heads` heads:
    fp32 or bf16, head dim 64, 1 <= n <= 224 (one head's q, k, v and 32
    score rows live in shared memory)."""
    return (dtype in _DTYPES and heads > 0 and d == heads * HEAD_DIM
            and 1 <= n <= MAX_N)


def mlp_fits(d: int, ffn: int, dtype) -> bool:
    """Whether the MLP kernel takes widths d / ffn: fp32 or bf16, both
    multiples of 16, and an 8-row tile of the hidden fits shared memory
    (ffn <= 13,440 in bf16, 6,720 in fp32)."""
    return (dtype in _DTYPES and d > 0 and ffn > 0 and d % 16 == 0
            and ffn % 16 == 0
            and _mlp_smem(8, ffn, 4 if dtype == torch.float32 else 2)
            <= MAX_SMEM)


def blocks_fit(n: int, d: int, ffn: int, heads: int, dtype) -> bool:
    return attn_fits(n, d, heads, dtype) and mlp_fits(d, ffn, dtype)


class PackedWeights:
    """A layer's weights in the layout the fused blocks take (input-major,
    q | k | v packed, biases and LN parameters in fp32), built once and
    rebuilt only when a source parameter was replaced, cast, moved or
    written — not per batch."""

    def __init__(self):
        self._key = None
        self._value = None

    def get(self, params: Sequence[torch.Tensor], build: Callable):
        key = tuple((p.data_ptr(), 0 if p.is_inference() else p._version,
                     p.dtype) for p in params)
        if key != self._key:
            with torch.inference_mode(False), torch.no_grad():
                self._value = build()
            self._key = key
        return self._value


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _ln(x, scale, bias, eps):
    """fp32 two-pass LayerNorm over the last axis; returns fp32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _mm(a, w, b):
    """a @ w + b accumulated in fp32; returns fp32."""
    return a.float() @ w.float() + b.float()


def _act(h, act):
    if act == "gelu":
        return torch.nn.functional.gelu(h)
    if act == "relu":
        return torch.relu(h)
    raise ValueError(f"act must be one of {_ACTS}, got {act!r}")


def _attention(h, wqkv, bqkv, heads, mask):
    qkv = _mm(h, wqkv, bqkv).to(h.dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    return mha_reference(q, k, v, heads=heads, mask=mask)


def postnorm_attn_block_reference(x, mask, wqkv, bqkv, wout, bout, ln_scale,
                                  ln_bias, *, heads: int,
                                  eps: float = 1e-12) -> torch.Tensor:
    a = _attention(x, wqkv, bqkv, heads, mask)
    out = _mm(a, wout, bout).to(x.dtype)
    return _ln(x + out, ln_scale, ln_bias, eps).to(x.dtype)


def postnorm_mlp_block_reference(x, w1, b1, w2, b2, ln_scale, ln_bias, *,
                                 eps: float = 1e-12,
                                 act: str = "gelu") -> torch.Tensor:
    h1 = _act(_mm(x, w1, b1), act).to(x.dtype)
    out = _mm(h1, w2, b2).to(x.dtype)
    return _ln(x + out, ln_scale, ln_bias, eps).to(x.dtype)


def attn_block_reference(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, *,
                         heads: int, eps: float = 1e-6) -> torch.Tensor:
    h = _ln(x, ln_scale, ln_bias, eps).to(x.dtype)
    a = _attention(h, wqkv, bqkv, heads, None)
    return (x.float() + _mm(a, wout, bout)).to(x.dtype)


def mlp_block_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, *,
                        eps: float = 1e-6, act: str = "gelu") -> torch.Tensor:
    h = _ln(x, ln_scale, ln_bias, eps).to(x.dtype)
    h1 = _act(_mm(h, w1, b1), act).to(x.dtype)
    return (x.float() + _mm(h1, w2, b2)).to(x.dtype)


# ---------------------------------------------------------------------------
# checks and launches
# ---------------------------------------------------------------------------


def _check(name, x, mats, vecs, mask=None):
    """x [B, N, D]; `mats`: ((weight, shape), ...) in x's dtype; `vecs`:
    ((vector, length), ...) of any float dtype; everything on x's device."""
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be [B, N, D], got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    for w, shape in mats:
        if tuple(w.shape) != shape or w.dtype != x.dtype:
            raise TypeError(f"{name}: a weight must be {x.dtype} {shape}, "
                            f"got {w.dtype} {tuple(w.shape)}")
    for v, n in vecs:
        if tuple(v.shape) != (n,) or not v.dtype.is_floating_point:
            raise TypeError(f"{name}: a bias / LN vector must be float "
                            f"[{n}], got {v.dtype} {tuple(v.shape)}")
    if mask is not None and (tuple(mask.shape) != tuple(x.shape[:2])
                             or mask.dtype != torch.int32):
        raise TypeError(f"{name}: mask must be int32 [B, N], got "
                        f"{mask.dtype} {tuple(mask.shape)}")
    others = [w for w, _ in mats] + [v for v, _ in vecs]
    if mask is not None:
        others.append(mask)
    if any(t.device != x.device for t in others):
        raise ValueError(f"{name}: tensors lie on different devices")


def _forward_only(name, x):
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            f"{name} is a forward-only kernel (the *_trainable wrappers "
            "are not ported); call it under torch.no_grad()")


def _ptr(t):
    if not t.is_contiguous():
        raise ValueError("the transformer-block kernels need contiguous "
                         "tensors")
    return t.data_ptr()


def _launch_attn(name, x, mask, ln_scale, ln_bias, wqkv, bqkv, wout, bout,
                 heads, eps, post):
    b, n, d = x.shape
    if not attn_fits(n, d, heads, x.dtype):
        raise ValueError(
            f"{name}: the kernel takes head dim {HEAD_DIM} and N <= {MAX_N} "
            f"in float32/bfloat16, got {tuple(x.shape)} with {heads} heads "
            f"in {x.dtype}")
    _forward_only(name, x)
    from . import _build

    fn = _build.library("transformer_block").tb_attn_block
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    vecs = [v.float().contiguous() for v in (ln_scale, ln_bias, bqkv, bout)]
    att = torch.empty_like(x)      # the heads' outputs, between the kernels
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_ptr(x), _ptr(mask) if mask is not None else None,
                 vecs[0].data_ptr(), vecs[1].data_ptr(), _ptr(wqkv),
                 vecs[2].data_ptr(), _ptr(wout), vecs[3].data_ptr(),
                 att.data_ptr(), y.data_ptr(), b, n, d, heads, float(eps),
                 int(post), _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return y


def _launch_mlp(name, x, ln_scale, ln_bias, w1, b1, w2, b2, eps, act, post):
    b, n, d = x.shape
    ffn = w1.shape[1]
    if act not in _ACTS:
        raise ValueError(f"act must be one of {_ACTS}, got {act!r}")
    if not mlp_fits(d, ffn, x.dtype):
        raise ValueError(
            f"{name}: the kernel takes D and FFN multiples of 16 with 8 "
            f"rows of the hidden in shared memory, got D={d} FFN={ffn} in "
            f"{x.dtype}")
    _forward_only(name, x)
    from . import _build

    fn = _build.library("transformer_block").tb_mlp_block
    fn.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    vecs = [v.float().contiguous() for v in (ln_scale, ln_bias, b1, b2)]
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_ptr(x), vecs[0].data_ptr(), vecs[1].data_ptr(), _ptr(w1),
                 vecs[2].data_ptr(), _ptr(w2), vecs[3].data_ptr(),
                 y.data_ptr(), b * n, d, ffn, float(eps), int(post),
                 int(act == "relu"), _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return y


def _attn_args(name, x, mask, wqkv, bqkv, wout, bout, ln_scale, ln_bias,
               heads):
    d = x.shape[-1]
    if heads <= 0 or d % heads:
        raise ValueError(f"{name}: D={d} not divisible by heads={heads}")
    _check(name, x, ((wqkv, (d, 3 * d)), (wout, (d, d))),
           ((bqkv, 3 * d), (bout, d), (ln_scale, d), (ln_bias, d)), mask)


def _mlp_args(name, x, w1, b1, w2, b2, ln_scale, ln_bias):
    d = x.shape[-1]
    ffn = w1.shape[1] if w1.dim() == 2 else -1
    _check(name, x, ((w1, (d, ffn)), (w2, (ffn, d))),
           ((b1, ffn), (b2, d), (ln_scale, d), (ln_bias, d)))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def postnorm_attn_block(x, mask: Optional[torch.Tensor], wqkv, bqkv, wout,
                        bout, ln_scale, ln_bias, *, heads: int,
                        eps: float = 1e-12) -> torch.Tensor:
    """x: [B, N, D]; mask: int32 [B, N] key validity (or None); wqkv:
    [D, 3D] packed q | k | v; wout: [D, D] -> LN(x + out_proj(MHA(x)))."""
    name = "postnorm_attn_block"
    _attn_args(name, x, mask, wqkv, bqkv, wout, bout, ln_scale, ln_bias,
               heads)
    if x.device.type == "cpu":
        return postnorm_attn_block_reference(
            x, mask, wqkv, bqkv, wout, bout, ln_scale, ln_bias, heads=heads,
            eps=eps)
    y = _launch_attn(name, x, mask, ln_scale, ln_bias, wqkv, bqkv, wout,
                     bout, heads, eps, post=True)
    postnorm_attn_block.launches += 1
    return y


postnorm_attn_block.launches = 0


def postnorm_mlp_block(x, w1, b1, w2, b2, ln_scale, ln_bias, *,
                       eps: float = 1e-12, act: str = "gelu") -> torch.Tensor:
    """x: [B, N, D]; w1: [D, FFN]; w2: [FFN, D] ->
    LN(x + act(x W1 + b1) W2 + b2)."""
    name = "postnorm_mlp_block"
    _mlp_args(name, x, w1, b1, w2, b2, ln_scale, ln_bias)
    if x.device.type == "cpu":
        return postnorm_mlp_block_reference(x, w1, b1, w2, b2, ln_scale,
                                            ln_bias, eps=eps, act=act)
    y = _launch_mlp(name, x, ln_scale, ln_bias, w1, b1, w2, b2, eps, act,
                    post=True)
    postnorm_mlp_block.launches += 1
    return y


postnorm_mlp_block.launches = 0


def attn_block(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, *, heads: int,
               eps: float = 1e-6) -> torch.Tensor:
    """x: [B, N, D] -> x + out_proj(MHA(LN(x))). wqkv: [D, 3D] packed
    q | k | v (the transposed torchvision in_proj layout)."""
    name = "attn_block"
    _attn_args(name, x, None, wqkv, bqkv, wout, bout, ln_scale, ln_bias,
               heads)
    if x.device.type == "cpu":
        return attn_block_reference(x, ln_scale, ln_bias, wqkv, bqkv, wout,
                                    bout, heads=heads, eps=eps)
    y = _launch_attn(name, x, None, ln_scale, ln_bias, wqkv, bqkv, wout,
                     bout, heads, eps, post=False)
    attn_block.launches += 1
    return y


attn_block.launches = 0


def mlp_block(x, ln_scale, ln_bias, w1, b1, w2, b2, *, eps: float = 1e-6,
              act: str = "gelu") -> torch.Tensor:
    """x: [B, N, D] -> x + act(LN(x) W1 + b1) W2 + b2."""
    name = "mlp_block"
    _mlp_args(name, x, w1, b1, w2, b2, ln_scale, ln_bias)
    if x.device.type == "cpu":
        return mlp_block_reference(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                   eps=eps, act=act)
    y = _launch_mlp(name, x, ln_scale, ln_bias, w1, b1, w2, b2, eps, act,
                    post=False)
    mlp_block.launches += 1
    return y


mlp_block.launches = 0
