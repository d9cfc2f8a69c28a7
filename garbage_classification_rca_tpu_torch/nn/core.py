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
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

import torch
import torch.nn.functional as F
from torch import nn


def _uniform(shape, fan_in: int, generator: Optional[torch.Generator]):
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


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
        return torch.rand(tuple(shape), generator=self.generator(device),
                          device=device) < 1.0 - rate


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
    """torch.nn.Linear's default init: U(+-1/sqrt(fan_in))."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w = nn.Parameter(_uniform((d_out, d_in), d_in, generator))
        self.b = (nn.Parameter(_uniform((d_out,), d_in, generator))
                  if bias else None)

    def forward(self, x):
        return linear(x, self.w, self.b)


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
    ``batchnorm`` semantics). Running stats are fp32 buffers.

    Eval normalizes with the running stats, in fp32. Train normalizes with
    the batch's biased variance and updates the running stats in place as
    ``new = (1 - m) * old + m * batch``, the variance taken unbiased —
    torch's and the JAX package's rule; it is PyTorch's own batch_norm,
    which accumulates in fp32 for bf16 inputs and returns the input's
    dtype."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x, eps: float, *, train: bool = False,
                momentum: float = 0.1):
        if train:
            return F.batch_norm(x, self.mean, self.var, self.scale.float(),
                                self.bias.float(), training=True,
                                momentum=momentum, eps=eps)
        inv = torch.rsqrt(self.var.float() + eps) * self.scale.float()
        shift = self.bias.float() - self.mean.float() * inv
        y = x.float() * inv[:, None, None] + shift[:, None, None]
        return y.to(x.dtype)


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
    mask = torch.rand(x.shape, generator=generator,
                      device=x.device) < keep
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
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)
