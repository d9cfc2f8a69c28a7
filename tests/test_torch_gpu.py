"""PyTorch port on the card: each hand-written CUDA kernel against its
plain version on CUDA tensors, and the launch counters. Marked ``gpu``;
every test skips (with its reason) where no CUDA device is present. Run on
a machine with an NVIDIA H100:

    python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances as in chip_smoke.py: fp32 2e-5 (rca_fused) and 1e-5 (mha)."""

import types

import pytest
import torch

from garbage_classification_rca_tpu_torch.kernels import mha_fused, rca_fused
from garbage_classification_rca_tpu_torch.ops.attention import AttentionUnit

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        yield torch.device("cuda")


@pytest.mark.parametrize("b", [13, 128])
@pytest.mark.parametrize("reverse", [False, True])
def test_rca_fused_kernel_matches_plain(cuda, b, reverse):
    g = torch.Generator().manual_seed(b)
    p = types.SimpleNamespace(**{
        n: AttentionUnit(*geo, generator=g).to(cuda)
        for n, geo in zip(rca_fused.UNITS, rca_fused._GEOM)})
    t = torch.randn((b, 16, 48), generator=g).to(cuda)
    i = torch.randn((b, 16, 80), generator=g).to(cuda)
    before = rca_fused.rca_fused.launches
    got = rca_fused.rca_fused(p, t, i, reverse=reverse)
    torch.cuda.synchronize()
    assert rca_fused.rca_fused.launches == before + 1
    want = rca_fused.rca_fused_reference(p, t, i, reverse=reverse)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,n,causal", [(128, 64, False), (4, 512, False),
                                        (3, 100, True)])
def test_mha_kernel_matches_plain(cuda, b, n, causal):
    g = torch.Generator().manual_seed(n)
    q, k, v = (torch.randn((b, n, 768), generator=g).to(cuda)
               for _ in range(3))
    lens = torch.randint(1, n + 1, (b,), generator=g)
    m = (torch.arange(n)[None] < lens[:, None]).to(torch.int32).to(cuda)
    before = mha_fused.mha.launches
    got = mha_fused.mha(q, k, v, heads=12, mask=m, causal=causal)
    torch.cuda.synchronize()
    assert mha_fused.mha.launches == before + 1
    want = mha_fused.mha_reference(q, k, v, heads=12, mask=m, causal=causal)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
