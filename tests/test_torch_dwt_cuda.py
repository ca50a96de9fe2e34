"""The Haar DWT CUDA kernel (kdip_tpu_torch/csrc/haar_dwt.cu) against its
plain PyTorch version, on the card. Imports no JAX, so that it runs where
only PyTorch is installed:

    python -m pytest tests/test_torch_dwt_cuda.py -m cuda

Without a card every test skips."""

import pytest
import torch

from kdip_tpu_torch.ops import dwt as D

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("shape", [(4, 3, 256, 256), (1, 2, 16, 24)])
def test_kernel_matches_plain(card, level, shape):
    """Forward and inverse within 1e-6 of the plain version: both round
    each butterfly's sum to float32, then its product with float32(1/sqrt2),
    so they should agree bit for bit."""
    g = torch.Generator(device=card).manual_seed(level)
    x = torch.randn(shape, generator=g, device=card)
    D.reset_launch_counts()
    y = D.haar_dwt2_cuda(x, level, inverse=False)
    xi = D.haar_dwt2_cuda(x, level, inverse=True)
    torch.cuda.synchronize()
    assert D.launch_counts == {"haar_dwt2": 1, "haar_idwt2": 1}
    assert (y - D.dwt2_plain(x, level)).abs().max().item() <= 1e-6
    assert (xi - D.idwt2_plain(x, level)).abs().max().item() <= 1e-6
    back = D.haar_dwt2_cuda(y, level, inverse=True)
    assert (back - x).abs().max().item() <= 2e-6


def test_kernel_autograd_backward_is_inverse(card):
    x = torch.randn(2, 3, 64, 64, device=card, requires_grad=True)
    ct = torch.randn(2, 3, 64, 64, device=card)
    g, = torch.autograd.grad(D.dwt2(x, 3), x, grad_outputs=ct)
    assert (g - D.idwt2_plain(ct, 3)).abs().max().item() <= 1e-6
    g, = torch.autograd.grad(D.idwt2(x, 3), x, grad_outputs=ct)
    assert (g - D.dwt2_plain(ct, 3)).abs().max().item() <= 1e-6


def test_kernel_rejects_what_it_cannot_take(card):
    x = torch.randn(1, 3, 32, 32, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        D.haar_dwt2_cuda(x.transpose(2, 3), 3, False)
    with pytest.raises(ValueError, match="level"):
        D.haar_dwt2_cuda(x, 4, False)
    with pytest.raises(ValueError, match="divisible"):
        D.haar_dwt2_cuda(x[..., :12].contiguous(), 3, False)
    y = D.haar_dwt2_cuda(x.to(torch.bfloat16), 2, False)
    assert y.dtype == torch.bfloat16
