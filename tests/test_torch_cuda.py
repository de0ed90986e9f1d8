"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``; each test asks its fixture whether a card is present and
skips if not, so every process collects the same tests.  On a machine with
an NVIDIA H100 and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.kernels import fused_conv as fc
from repro_torch.kernels import ops
from repro_torch.kernels.ref import fused_conv_ref

pytestmark = pytest.mark.cuda

RTOL = 1e-4   # max|kernel − plain| ≤ RTOL · max|plain|: f32 sums reordered


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, B, hw, cin, cout, k, s, p, residual):
    g = torch.Generator(device=dev).manual_seed(hw * 1000 + cin + k)
    x = torch.randn(B, hw, hw, cin, generator=g, device=dev)
    w = torch.randn(k, k, cin, cout, generator=g, device=dev) * 0.2
    scale = 1 + 0.1 * torch.randn(cout, generator=g, device=dev)
    shift = 0.1 * torch.randn(cout, generator=g, device=dev)
    oh = fc.out_hw(hw, hw, k, k, s, p)[0]
    res = (torch.randn(B, oh, oh, cout, generator=g, device=dev)
           if residual else None)
    return x, w, scale, shift, res


@pytest.mark.parametrize("B,hw,cin,cout,k,s,p,relu,residual", [
    (2, 32, 3, 64, 7, 2, 3, True, False),       # stem: Cin=3, K=147
    (2, 14, 64, 64, 3, 1, 1, True, True),       # ADD_RELU epilogue
    (2, 14, 64, 128, 3, 2, 1, True, False),     # 3x3/s2
    (2, 14, 64, 128, 1, 2, 0, False, False),    # 1x1/s2 downsample
    (1, 7, 96, 40, 3, 1, 1, True, True),        # 7x7 map, ragged Cout
    (3, 9, 5, 70, 3, 2, 1, False, True),        # ragged everything
])
def test_kernel_matches_plain(cuda, B, hw, cin, cout, k, s, p, relu,
                              residual):
    x, w, scale, shift, res = _inputs(cuda, B, hw, cin, cout, k, s, p,
                                      residual)
    kw = dict(stride=s, padding=p, relu=relu, residual=res)
    before = fc.launches
    out = ops.fused_conv(x, w, scale, shift, **kw)
    torch.cuda.synchronize()
    assert fc.launches == before + 1
    ref = fused_conv_ref(x, w, scale, shift, **kw)
    assert out.shape == ref.shape and out.is_cuda
    err = (out - ref).abs().max().item()
    assert err <= RTOL * ref.abs().max().item(), err


def test_kernel_refuses_what_it_cannot_take(cuda):
    x, w, scale, shift, _ = _inputs(cuda, 1, 8, 4, 8, 3, 1, 1, False)
    with pytest.raises(TypeError, match="float32"):
        ops.fused_conv(x.double(), w.double(), scale.double(), shift.double())
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_conv(x.transpose(1, 2), w, scale, shift)
    with pytest.raises(ValueError, match="shape"):
        ops.fused_conv(x, w, scale[:4], shift)
    with pytest.raises(ValueError, match="on cpu"):
        ops.fused_conv(x, w.cpu(), scale, shift)
