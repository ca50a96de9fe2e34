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
    assert D.launch_counts == {"haar_dwt2": 1, "haar_idwt2": 1,
                               "haar_ot_matvec": 0}
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


def _matvec_inputs(card, shape, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    v = torch.randn(shape, generator=g, device=card)
    theta = 0.5 + torch.rand(shape, generator=g, device=card)
    mask = (torch.rand(shape, generator=g, device=card) < 0.5).float()
    return v, theta, mask


@pytest.mark.parametrize("form", ["masked", "repeating", "maskless"])
@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("shape", [(4, 3, 256, 256), (1, 3, 256, 256),
                                   (1, 2, 16, 24)])
def test_matvec_matches_plain(card, shape, level, form):
    """The fused matvec s2*v + mask * idwt2(theta * dwt2(v)) within 1e-6 of
    ot_matvec_plain and at least 99.9% bit-equal: the same roundings in
    the same order. theta and the mask per sample, repeating over the
    batch, or no mask; one launch."""
    v, theta, mask = _matvec_inputs(card, shape, level)
    s2 = 0.05 ** 2
    if form == "repeating":
        theta, mask = theta[:1].contiguous(), mask[:1].contiguous()
    if form == "maskless":
        mask, s2 = None, 0.0
    D.reset_launch_counts()
    got = D.ot_matvec(v, theta, mask, s2, level)
    torch.cuda.synchronize()
    assert D.launch_counts == {"haar_dwt2": 0, "haar_idwt2": 0,
                               "haar_ot_matvec": 1}
    want = D.ot_matvec_plain(v, theta, mask, s2, level)
    assert (got - want).abs().max().item() <= 1e-6
    assert (got == want).float().mean().item() >= 0.999


def test_matvec_unaligned_view_takes_8_byte_accesses(card):
    """A view that starts 8 bytes into its storage gets the launch with
    8-byte accesses, and the same result; one that starts 4 bytes in is
    refused."""
    v, theta, mask = _matvec_inputs(card, (1, 3, 64, 64), 0)
    store = torch.empty(v.numel() + 2, device=card)
    vs = store[2:].view(v.shape)
    vs.copy_(v)
    assert vs.data_ptr() % 16 == 8 and vs.is_contiguous()
    got = D.haar_ot_matvec_cuda(vs, theta, mask, 0.0025, 3)
    assert torch.equal(got, D.haar_ot_matvec_cuda(v, theta, mask, 0.0025, 3))
    assert torch.equal(got, D.ot_matvec_plain(v, theta, mask, 0.0025, 3))
    with pytest.raises(ValueError, match="aligned"):
        D.haar_ot_matvec_cuda(store[1:-1].view(v.shape), theta, mask, 0.0025)


def test_matvec_rejects_what_it_cannot_take(card):
    v, theta, mask = _matvec_inputs(card, (2, 3, 32, 32), 0)
    with pytest.raises(ValueError, match="CUDA"):
        D.haar_ot_matvec_cuda(v, theta.cpu(), mask)
    with pytest.raises(ValueError, match="differentiable"):
        D.haar_ot_matvec_cuda(v.requires_grad_(True), theta, mask)


@pytest.mark.parametrize("level", [4, 5, 6, 7, 8])
def test_chained_levels_match_plain(card, level):
    """dwt2 / idwt2 past the kernel's three levels (passes of up to 3
    levels on the approximation block) at [1, 3, 256, 256], one launch a
    pass each way, and the chained matvec with and without the mask:
    within 1e-6 of the plain version and at least 99.9% bit-equal, as
    above."""
    def held(got, want):
        assert (got - want).abs().max().item() <= 1e-6
        assert (got == want).float().mean().item() >= 0.999
    g = torch.Generator(device=card).manual_seed(level)
    x = torch.randn(1, 3, 256, 256, generator=g, device=card)
    D.reset_launch_counts()
    y, xi = D.dwt2(x, level), D.idwt2(x, level)
    torch.cuda.synchronize()
    n = len(D.passes(level))
    assert D.launch_counts == {"haar_dwt2": n, "haar_idwt2": n,
                               "haar_ot_matvec": 0}
    held(y, D.dwt2_plain(x, level))
    held(xi, D.idwt2_plain(x, level))
    assert (D.idwt2(y, level) - x).abs().max().item() <= 2e-6
    v, theta, mask = _matvec_inputs(card, (1, 3, 256, 256), level)
    for m, s2 in ((mask, 0.05 ** 2), (None, 0.0)):
        held(D.ot_matvec(v, theta, m, s2, level),
             D.ot_matvec_plain(v, theta, m, s2, level))
