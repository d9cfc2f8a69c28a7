"""Layer primitives of the port: functions on tensors plus the small
``nn.Module``s that hold their weights.

Weights are stored in torch's layouts (linear ``[out, in]``, conv OIHW);
``checkpoint/from_jax.py`` transposes the JAX package's ``[in, out]`` /
HWIO trees into them. Parameter names follow the JAX trees' leaf names
(``w``/``b``, ``scale``/``bias``, ``mean``/``var``) so that one generic
walk loads any model.

Numerics follow the JAX package's ``nn/core.py``: LayerNorm, BatchNorm,
global pooling and L2 normalisation compute in fp32 and cast back; a
linear or conv casts its weights to the activation dtype.

Randomness (dropout, stochastic depth) draws from an explicit
``torch.Generator``, made from a ``Key``: an integer seed that splits and
folds in data the way a JAX key does, so every random site of a train step
has its own reproducible stream. The streams differ from JAX's bits; the
tests feed both sides the same draws where they compare them.

Under data parallelism (``batch_shard``) a train step's tensors hold one
rank's rows of the global microbatch; the random draws of batch-major
tensors (``rand_rows``) and BatchNorm's statistics are then the global
batch's, so that N ranks compute the one-device step.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional

import numpy as np

import torch
import torch.nn.functional as F
from torch import nn


def _uniform(shape, fan_in: int, generator: Optional[torch.Generator]):
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


_SHARD = None       # the DataMesh of the running data-parallel step


@contextlib.contextmanager
def batch_shard(mesh):
    """Within: the batch-major tensors hold `mesh`'s rank's rows of the
    global batch (a contiguous block, ``DataMesh.local_rows``). Random
    draws through ``rand_rows`` and train-mode ``BatchNorm`` then act on
    the global batch. A mesh of one rank, or None, changes nothing."""
    global _SHARD
    prev = _SHARD
    _SHARD = mesh if mesh is not None and mesh.distributed else None
    try:
        yield
    finally:
        _SHARD = prev


def rand_rows(shape, generator: Optional[torch.Generator], device, *,
              normal: bool = False) -> torch.Tensor:
    """``torch.rand`` (``torch.randn`` with `normal`) of a batch-major
    `shape`. Under ``batch_shard`` it draws the global batch's values,
    ``shape[0] * world`` rows, and returns this rank's block, so that a
    rank sees the one-device draw of its samples."""
    draw = torch.randn if normal else torch.rand
    shape = tuple(shape)
    if _SHARD is None:
        return draw(shape, generator=generator, device=device)
    n = shape[0]
    full = draw((n * _SHARD.world,) + shape[1:], generator=generator,
                device=device)
    return full[_SHARD.rank * n:(_SHARD.rank + 1) * n]


class Key:
    """A random key: a 63-bit seed. ``fold_in`` and ``split`` derive new
    keys through numpy's SeedSequence (host arithmetic, no device work);
    ``generator`` makes the torch.Generator a random op draws from."""

    __slots__ = ("seed",)

    def __init__(self, seed: int):
        self.seed = int(seed) & (2 ** 63 - 1)

    def fold_in(self, data: int) -> "Key":
        s = np.random.SeedSequence([self.seed, int(data) & (2 ** 63 - 1)])
        return Key(int(s.generate_state(1, np.uint64)[0]))

    def split(self, n: int = 2) -> List["Key"]:
        return [self.fold_in(0x5EED0000 + i) for i in range(n)]

    def generator(self, device) -> torch.Generator:
        g = torch.Generator(device=torch.device(device))
        g.manual_seed(self.seed)
        return g

    def keep_mask(self, shape, rate: float, device) -> torch.Tensor:
        """The dropout keep mask this key stands for: bool `shape` on
        `device`, True with probability 1 - rate. The same key, shape and
        device give the same mask again (a backward pass redraws it instead
        of holding it)."""
        return rand_rows(shape, self.generator(device), device) < 1.0 - rate


# ---------------------------------------------------------------------------
# functions
# ---------------------------------------------------------------------------


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w.T + b`` with the weights cast to x's dtype."""
    return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, computed in fp32."""
    y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(),
                     eps)
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of GELU (HF's ``gelu_new``; the JAX
    package's ``gelu(x, approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def relu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x)


def hardsigmoid(x: torch.Tensor) -> torch.Tensor:
    """torch.nn.Hardsigmoid as the JAX package writes it: relu6(x + 3) / 6."""
    return F.relu6(x + 3.0) / 6.0


def hardswish(x: torch.Tensor) -> torch.Tensor:
    return x * hardsigmoid(x)


def embedding(w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, w)


def max_pool(x: torch.Tensor, window: int, stride: int,
             padding: int = 0) -> torch.Tensor:
    """NCHW max pool, torch MaxPool2d semantics: the padding never wins (the
    JAX package pads with -inf)."""
    return F.max_pool2d(x, window, stride, padding)


def avg_pool(x: torch.Tensor, window: int, stride: Optional[int] = None,
             padding: int = 0) -> torch.Tensor:
    """NHWC average pool with torch AvgPool2d semantics (the padding counts
    in the mean, the last partial window is dropped), summed in fp32 and
    cast back, as the JAX package's ``avg_pool``. Returns NHWC."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2).float(), window,
                     window if stride is None else stride, padding)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NC mean over the spatial axes, accumulated in fp32."""
    return x.mean(dim=(2, 3), dtype=torch.float32).to(x.dtype)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 0.0) -> torch.Tensor:
    """``x / ||x||`` in fp32. With ``eps`` a (near-)zero vector maps to 0
    (the double-where form of the JAX package: no 0/0 anywhere)."""
    xf = x.float()
    if not eps:
        return (xf / torch.linalg.vector_norm(xf, dim=dim,
                                              keepdim=True)).to(x.dtype)
    sumsq = (xf * xf).sum(dim=dim, keepdim=True)
    is_zero = sumsq <= eps * eps
    n = torch.sqrt(torch.where(is_zero, torch.ones_like(sumsq), sumsq))
    return torch.where(is_zero, torch.zeros_like(xf), xf / n).to(x.dtype)


# ---------------------------------------------------------------------------
# weight holders
# ---------------------------------------------------------------------------


class Linear(nn.Module):
    """torch.nn.Linear's default init: U(+-1/sqrt(fan_in)).

    Weight-only int8 (``ops/quant.quantize_linear``): ``w`` int8 with the
    fp32 buffer ``w_scale`` [1, out]; the product runs on ``w`` cast to
    x's dtype, then the scale in x's dtype, then the bias, as the JAX
    package's ``linear`` orders them."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w = nn.Parameter(_uniform((d_out, d_in), d_in, generator))
        self.b = (nn.Parameter(_uniform((d_out,), d_in, generator))
                  if bias else None)

    def forward(self, x):
        scale = self._buffers.get("w_scale")
        if scale is None:
            return linear(x, self.w, self.b)
        y = F.linear(x, self.w.to(x.dtype)) * scale.to(x.dtype)
        return y if self.b is None else y + self.b.to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        return layernorm(x, self.scale, self.bias, self.eps)


class Embedding(nn.Module):
    def __init__(self, n: int, d: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w = nn.Parameter(torch.randn((n, d), generator=generator) * 0.02)

    def forward(self, ids):
        return embedding(self.w, ids)


class Conv2d(nn.Module):
    """OIHW conv with torch's default init; stride/padding/groups are
    given per call, as the JAX block code decides them."""

    def __init__(self, kh: int, kw: int, c_in: int, c_out: int, *,
                 groups: int = 1, bias: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fan_in = kh * kw * (c_in // groups)
        self.w = nn.Parameter(_uniform((c_out, c_in // groups, kh, kw),
                                       fan_in, generator))
        self.b = (nn.Parameter(_uniform((c_out,), fan_in, generator))
                  if bias else None)

    def forward(self, x, *, stride=1, padding=0, groups=1):
        return F.conv2d(x, self.w.to(x.dtype),
                        None if self.b is None else self.b.to(x.dtype),
                        stride=stride, padding=padding, groups=groups)


class BatchNorm(nn.Module):
    """BatchNorm over NCHW channels with fp32 statistics (the JAX
    ``batchnorm`` semantics; fp64 ones for an fp64 input). Running stats
    are fp32 buffers.

    Eval normalizes with the running stats, in fp32. Train normalizes with
    the batch's biased variance and updates the running stats in place as
    ``new = (1 - m) * old + m * batch``, the variance taken unbiased —
    torch's and the JAX package's rule; it is PyTorch's own batch_norm,
    which accumulates in fp32 for bf16 inputs and returns the input's
    dtype. Under ``batch_shard`` the statistics are the global batch's
    (``_SyncBatchNorm``)."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x, eps: float, *, train: bool = False,
                momentum: float = 0.1):
        acc = torch.promote_types(x.dtype, torch.float32)
        if train and _SHARD is not None:
            return _SyncBatchNorm.apply(
                x, self.scale.to(acc), self.bias.to(acc), self.mean,
                self.var, eps, momentum, _SHARD)
        if train:
            return F.batch_norm(x, self.mean, self.var, self.scale.to(acc),
                                self.bias.to(acc), training=True,
                                momentum=momentum, eps=eps)
        inv = torch.rsqrt(self.var.to(acc) + eps) * self.scale.to(acc)
        shift = self.bias.to(acc) - self.mean.to(acc) * inv
        y = x.to(acc) * inv[:, None, None] + shift[:, None, None]
        return y.to(x.dtype)


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the global batch of a data-parallel step:
    each rank's per-channel (count, mean, M2) gathered in one collective
    and combined (Chan's rule); the running variance unbiased over the
    global count. The backward all-reduces the per-channel sums of dy and
    dy * x_hat in one collective; the scale and bias gradients are the
    rank's own (the train step sums them over the ranks)."""

    @staticmethod
    def forward(ctx, x, scale, bias, running_mean, running_var, eps,
                momentum, mesh):
        from ..parallel.multihost import gather_rows

        acc = scale.dtype
        xf = x.to(acc)
        dims = [d for d in range(x.ndim) if d != 1]
        view = [1, -1] + [1] * (x.ndim - 2)
        n = x.numel() // x.shape[1]
        mean_l = xf.mean(dims)
        m2_l = ((xf - mean_l.view(view)) ** 2).sum(dims)
        stats = torch.stack([torch.full_like(mean_l, n), mean_l, m2_l])
        every = gather_rows(stats[None], mesh)            # [world, 3, C]
        counts, means, m2s = every[:, 0], every[:, 1], every[:, 2]
        total = counts.sum(0)
        mean = (counts * means).sum(0) / total
        m2 = (m2s + counts * (means - mean) ** 2).sum(0)
        invstd = torch.rsqrt(m2 / total + eps)
        with torch.no_grad():
            running_mean.mul_(1 - momentum).add_(
                momentum * mean.to(running_mean.dtype))
            running_var.mul_(1 - momentum).add_(
                momentum * (m2 / (total - 1)).to(running_var.dtype))
        ctx.save_for_backward(x, scale, mean, invstd, total)
        ctx.mesh = mesh
        y = (xf - mean.view(view)) * (invstd * scale).view(view) \
            + bias.view(view)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        from ..parallel.multihost import all_reduce_sum_

        x, scale, mean, invstd, total = ctx.saved_tensors
        acc = scale.dtype
        dims = [d for d in range(x.ndim) if d != 1]
        view = [1, -1] + [1] * (x.ndim - 2)
        xhat = (x.to(acc) - mean.view(view)) * invstd.view(view)
        dyf = dy.to(acc)
        sum_dy = dyf.sum(dims)
        sum_dy_xhat = (dyf * xhat).sum(dims)
        glob = torch.stack([sum_dy, sum_dy_xhat])
        all_reduce_sum_([glob])
        dx = (scale * invstd).view(view) * (
            dyf - (glob[0] / total).view(view)
            - xhat * (glob[1] / total).view(view))
        return (dx.to(x.dtype), sum_dy_xhat, sum_dy, None, None, None, None,
                None)


class GRU(nn.Module):
    """torch.nn.GRU's weights (one layer, gate order r, z, n) under the JAX
    tree's names, in torch's layout: ``w_ih`` [3H, D], ``w_hh`` [3H, H];
    torch's init, U(+-1/sqrt(H)). ``checkpoint/from_jax.py`` transposes
    the JAX [D, 3H] / [H, 3H] weights into them."""

    def __init__(self, d_in: int, d_hidden: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, h = generator, d_hidden
        self.w_ih = nn.Parameter(_uniform((3 * h, d_in), h, g))
        self.w_hh = nn.Parameter(_uniform((3 * h, h), h, g))
        self.b_ih = nn.Parameter(_uniform((3 * h,), h, g))
        self.b_hh = nn.Parameter(_uniform((3 * h,), h, g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Scan the rows of x [T, D] in order from a zero state -> every
        step's state [T, H], in the dtype x and the weights promote to (the
        JAX cell's ``x @ w_ih`` promotes so: bf16 rows over fp32 weights run
        in fp32). The input projection of all steps is one product; each
        step then adds its recurrent one."""
        x = x.to(torch.promote_types(x.dtype, self.w_ih.dtype))
        gi = linear(x, self.w_ih, self.b_ih)
        w_hh, b_hh = self.w_hh.to(x.dtype), self.b_hh.to(x.dtype)
        d = self.w_hh.shape[1]
        h = x.new_zeros(d)
        out = []
        for t in range(x.shape[0]):
            gh = torch.addmv(b_hh, w_hh, h)
            r, z = torch.sigmoid(gi[t, :2 * d] + gh[:2 * d]).chunk(2)
            n = torch.tanh(gi[t, 2 * d:] + r * gh[2 * d:])
            h = (1 - z) * n + z * h
            out.append(h)
        return torch.stack(out)


class Hadamard(nn.Module):
    """The bimodal head's gated sum ``tanh(a * kernel1 + b * kernel2 +
    bias)`` (the reference's ``Hadamard2``; kernels N(0, 1), bias 0)."""

    def __init__(self, d: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel1 = nn.Parameter(torch.randn(d, generator=generator))
        self.kernel2 = nn.Parameter(torch.randn(d, generator=generator))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, a, b):
        return torch.tanh(a * self.kernel1 + b * self.kernel2 + self.bias)


# ---------------------------------------------------------------------------
# regularization (train mode only)
# ---------------------------------------------------------------------------


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: each element kept with probability 1 - rate and
    scaled by 1 / (1 - rate). Identity when rate <= 0 or without a
    generator (eval)."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = rand_rows(x.shape, generator, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


class HFDropout:
    """Site-ordered encoder-internal dropout (``--hf_internal_dropout``):
    the HF text towers' own p = 0.1 hidden / attention dropout, which the
    reference leaves active while it trains.

    Identity when made without a key or called with ``p <= 0``, and then no
    site is consumed. With a key, the n-th site folds the counter n into
    it, so every site has its own reproducible mask. Inverted dropout (kept
    elements divided by 1 - p)."""

    __slots__ = ("key", "_n")

    def __init__(self, key: Optional[Key] = None):
        self.key = key
        self._n = 0

    @property
    def active(self) -> bool:
        return self.key is not None

    def site_key(self, p: float) -> Optional[Key]:
        """Consume one site and return its key (None when inactive or
        ``p <= 0``, and then nothing is consumed). For a site whose mask
        is applied elsewhere: the flash training attention draws
        ``key.keep_mask`` on the [B, H, N, N] weights, in its forward and
        again in its backward."""
        if self.key is None or p <= 0.0:
            return None
        self._n += 1
        return self.key.fold_in(self._n)

    def keep_mask(self, shape, p: float, device) -> Optional[torch.Tensor]:
        """Consume one site and return its bool keep mask of `shape` (None
        when ``site_key`` gives None)."""
        key = self.site_key(p)
        return None if key is None else key.keep_mask(shape, p, device)

    def __call__(self, x: torch.Tensor, p: float) -> torch.Tensor:
        mask = self.keep_mask(x.shape, p, x.device)
        if mask is None:
            return x
        return torch.where(mask, x / (1.0 - p), torch.zeros_like(x)).to(
            x.dtype)


def stochastic_depth(x: torch.Tensor, rate: float,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
    """torchvision stochastic_depth, mode='row': each sample's whole
    residual branch kept with probability 1 - rate, scaled by
    1 / (1 - rate)."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = rand_rows(shape, generator, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)
