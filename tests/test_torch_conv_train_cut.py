"""PyTorch port, the conv image backbones in train mode against the JAX
package, on cut depths at full widths: ConvNeXt-B, EfficientNet B0 / B5
(v1; B5 with BN eps 1e-3 and momentum 0.01) and EfficientNetV2-S
(Fused-MBConv and MBConv), 32 x 32 images. One optimizer step of each
side's train step from the same numpy weights, every random site at
rate 0: loss, norms, gradients and updated parameters within 5e-5, the
new running statistics within 1e-5 (``tests/test_torch_conv_train.py``
holds the comparison, the full-width towers and the random sites)."""

import pytest
import torch

from tests.test_torch_conv_train import NAMES, check_train_step

torch.set_num_threads(2)


@pytest.mark.parametrize("name", NAMES[3:])
def test_cut_train_step_matches_jax(name, monkeypatch):
    check_train_step(name, monkeypatch)
