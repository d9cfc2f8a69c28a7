"""EfficientNet engine — MBConv / FusedMBConv.

The port of the JAX package's ``models/image/efficientnet_common.py``:
  * public functions take and return NHWC tensors (the JAX layout);
    internally the trunk runs NCHW in ``channels_last`` memory, which is the
    same bytes, so cuDNN gets its preferred layout with no copy;
  * convolutions are plain cuDNN calls (plain XLA in the JAX package,
    outside any Pallas kernel);
  * BN eps per config (1e-3 for v2); the SE squeeze width is
    ``max(1, c_in // 4)`` on the PRE-expansion channels;
  * train mode: BatchNorm on batch statistics with running-stat updates
    (momentum per config), and stochastic depth at rate
    ``sd_prob * idx / total`` on each residual block, each block drawing
    from its own key ``key.fold_in(si * 1000 + j)`` (the JAX package's
    ``fold_in`` sites). BN folding (``nn/fold.py``) is for eval only.

Module names follow the JAX parameter tree (``stem``, ``stages[i][j]``
with ``expand``/``project``/``single``/``dw``/``se``, ``head``), so
``checkpoint/from_jax.load_jax_tree`` fills a model from it directly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch import nn

from ...nn import core

# stage row: (block_type, expand, kernel, stride, c_in, c_out, n_blocks)
Stage = Tuple[str, int, int, int, int, int, int]


@dataclass(frozen=True)
class EffNetConfig:
    stages: Tuple[Stage, ...]
    stem_out: int
    head_out: int
    bn_eps: float
    bn_momentum: float = 0.1
    sd_prob: float = 0.2


class ConvBN(nn.Module):
    """conv + BatchNorm (``bn`` is None once folded)."""

    def __init__(self, k: int, c_in: int, c_out: int, *, groups: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = core.Conv2d(k, k, c_in, c_out, groups=groups,
                                generator=generator)
        self.bn = core.BatchNorm(c_out)


class SqueezeExcite(nn.Module):
    def __init__(self, c: int, squeeze: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = core.Conv2d(1, 1, c, squeeze, bias=True,
                               generator=generator)
        self.fc2 = core.Conv2d(1, 1, squeeze, c, bias=True,
                               generator=generator)


class Block(nn.Module):
    def __init__(self, btype: str, expand: int, kernel: int, c_in: int,
                 c_out: int, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        exp = c_in * expand
        g = generator
        if btype == "fused":
            if expand != 1:
                self.expand = ConvBN(kernel, c_in, exp, generator=g)
                self.project = ConvBN(1, exp, c_out, generator=g)
            else:
                self.single = ConvBN(kernel, c_in, c_out, generator=g)
        else:
            if expand != 1:
                self.expand = ConvBN(1, c_in, exp, generator=g)
            self.dw = ConvBN(kernel, exp, exp, groups=exp, generator=g)
            self.se = SqueezeExcite(exp, max(1, c_in // 4), generator=g)
            self.project = ConvBN(1, exp, c_out, generator=g)


class EffNet(nn.Module):
    """The trunk: stem, stages, head conv (no classifier)."""

    def __init__(self, cfg: EffNetConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.stem = ConvBN(3, 3, cfg.stem_out, generator=generator)
        self.stages = nn.ModuleList()
        for btype, expand, kernel, _, c_in, c_out, n in cfg.stages:
            self.stages.append(nn.ModuleList(
                Block(btype, expand, kernel, c_in if j == 0 else c_out,
                      c_out, generator=generator) for j in range(n)))
        self.head = ConvBN(1, cfg.stages[-1][5], cfg.head_out,
                           generator=generator)
        self.to(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# forward (functions over the modules, as the JAX code reads its tree)
# ---------------------------------------------------------------------------


def _cna(m: ConvBN, x, *, stride=1, groups=1, act=True, eps=1e-5,
         train=False, momentum=0.1):
    k = m.conv.w.shape[-1]
    y = m.conv(x, stride=stride, padding=(k - 1) // 2, groups=groups)
    if m.bn is not None:
        y = m.bn(y, eps, train=train, momentum=momentum)
    return core.silu(y) if act else y


def _se(m: SqueezeExcite, x):
    s = x.mean(dim=(2, 3), keepdim=True, dtype=torch.float32).to(x.dtype)
    s = core.silu(m.fc1(s))
    s = torch.sigmoid(m.fc2(s))
    return x * s


def _block(m: Block, x, row: Stage, first: bool, *, eps, train=False,
           momentum=0.1, sd_rate=0.0, generator=None):
    btype, expand, _, stride, _, c_out, _ = row
    stride = stride if first else 1
    use_res = stride == 1 and x.shape[1] == c_out
    bn = dict(eps=eps, train=train, momentum=momentum)
    h = x
    if btype == "fused":
        if expand != 1:
            h = _cna(m.expand, h, stride=stride, **bn)
            h = _cna(m.project, h, act=False, **bn)
        else:
            h = _cna(m.single, h, stride=stride, **bn)
    else:
        if hasattr(m, "expand"):
            h = _cna(m.expand, h, **bn)
        h = _cna(m.dw, h, stride=stride, groups=h.shape[1], **bn)
        h = _se(m.se, h)
        h = _cna(m.project, h, act=False, **bn)
    if not use_res:
        return h
    if train:
        h = core.stochastic_depth(h, sd_rate, generator)
    return h + x


def features_all_stages(model: EffNet, x_nhwc: torch.Tensor,
                        cfg: EffNetConfig, *, train: bool = False,
                        key: Optional[core.Key] = None
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Run the trunk on NHWC input; returns (per-stage outputs as NCHW
    channels_last tensors, pooled [B, head_out]). ``train`` uses batch
    statistics (updating the BN buffers in place) and, with a ``key``,
    stochastic depth."""
    bn = dict(eps=cfg.bn_eps, train=train, momentum=cfg.bn_momentum)
    total = sum(r[-1] for r in cfg.stages)
    h = _cna(model.stem, x_nhwc.permute(0, 3, 1, 2), stride=2, **bn)
    stage_outs = []
    idx = 0
    for si, row in enumerate(cfg.stages):
        for j, bm in enumerate(model.stages[si]):
            gen = None
            if train and key is not None:
                gen = key.fold_in(si * 1000 + j).generator(h.device)
            h = _block(bm, h, row, j == 0, sd_rate=cfg.sd_prob * idx / total,
                       generator=gen, **bn)
            idx += 1
        stage_outs.append(h)
    h = _cna(model.head, h, **bn)
    return stage_outs, core.global_avg_pool(h)
