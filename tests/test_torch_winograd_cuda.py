"""The Winograd F(2,3) CUDA kernel (kdip_tpu_torch/csrc/winograd_f23.cu)
against its plain PyTorch version, on the card: forward, with and without
the fused prologue, and through autograd. Imports no JAX, so that it runs
where only PyTorch is installed:

    python -m pytest tests/test_torch_winograd_cuda.py -m cuda

Without a card every test skips.

Tolerance, per element: |kernel - plain| <= 2^-7 |plain| + 2^-14 max|plain|.
Both sides round the same values at the same places; only the float32
summation order of the 16 products over C differs (tensor cores against a
float32 matmul), so an output may round to the neighbouring bf16 value (one
ulp, at most 2^-7 of it), and where heavy cancellation makes an output
tiny, the summation noise of the terms (far below 2^-14 of the largest
output) decides. A wrong rounding stage would move a share of the outputs
by a fraction of an ulp each, so at least 99% of them must also be equal
bit for bit."""

import pytest
import torch

from kdip_tpu_torch.ops import winograd as Wg

pytestmark = pytest.mark.cuda

# (B, C, F, H, W): the hottest FFHQ-256 shape, the deepest, C and F not
# multiples of 16 with H, W not multiples of 16, and B = 2; with the rest,
# every launch configuration `launch_config` can choose (both tilings, a C
# split of 1, 2, 4 and 8, CTAs with several F blocks, slices that U holds
# in rounds, V rows that are not 16-byte pieces; tests/
# test_torch_winograd_launch.py checks the list reaches all of them)
SHAPES = [(1, 128, 128, 256, 256), (1, 1024, 512, 8, 8),
          (2, 40, 24, 18, 22), (2, 3, 5, 6, 4),
          (1, 64, 64, 256, 256), (2, 64, 48, 128, 128),
          (1, 200, 60, 64, 64), (1, 768, 256, 32, 32),
          (1, 256, 256, 16, 16), (2, 32, 16, 8, 8), (2, 48, 40, 8, 8),
          (4, 256, 64, 8, 8), (16, 16, 128, 12, 12)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def inputs(card, B, C, F, H, W, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn(B, C, H, W, generator=g, device=card).to(dtype)
    w = (torch.randn(F, C, 3, 3, generator=g, device=card)
         / (9 * C) ** 0.5).to(dtype)
    a = 1 + 0.3 * torch.randn(B, C, generator=g, device=card)
    b = 0.3 * torch.randn(B, C, generator=g, device=card)
    return x, w, a, b


def check_close(got, want, what):
    """The module docstring's tolerance; returns the bit-equal share."""
    got, want = got.float(), want.float()
    tol = 2 ** -7 * want.abs() + 2 ** -14 * want.abs().max()
    bad = ((got - want).abs() > tol).sum().item()
    equal = (got == want).float().mean().item()
    assert bad == 0, f"{what}: {bad} elements out of tolerance"
    assert equal >= 0.99, f"{what}: only {equal:.4f} bit-equal"
    return equal


@pytest.mark.parametrize("prologue", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain(card, shape, prologue):
    x, w, a, b = inputs(card, *shape)
    v = Wg.kernel_transform(w)
    pro = (a, b) if prologue else None
    Wg.reset_launch_counts()
    y = Wg.winograd_conv3x3_cuda(x, v, pro)
    torch.cuda.synchronize()
    name = "winograd_conv3x3_fused" if prologue else "winograd_conv3x3"
    assert Wg.launch_counts[name] == 1 and sum(Wg.launch_counts.values()) == 1
    assert y.shape == (shape[0], shape[2], shape[3], shape[4])
    check_close(y, Wg.winograd_conv3x3_plain(x, v, pro), "forward")


def test_kernel_float16(card):
    x, w, a, b = inputs(card, 1, 48, 32, 32, 32, dtype=torch.float16)
    v = Wg.kernel_transform(w)
    for pro in (None, (a, b)):
        check_close(Wg.winograd_conv3x3_cuda(x, v, pro),
                    Wg.winograd_conv3x3_plain(x, v, pro), "float16")


@pytest.mark.parametrize("prologue", [False, True], ids=["plain", "fused"])
def test_autograd_matches_plain(card, prologue):
    """dx (the kernel on the rotated weight), da and db against the plain
    version's autograd on the same inputs, at the same tolerance."""
    x, w, a, b = inputs(card, 2, 64, 32, 32, 32, seed=1)
    g = torch.Generator(device=card).manual_seed(2)
    ct = torch.randn(2, 32, 32, 32, generator=g, device=card).to(x.dtype)
    grads = []
    for conv in (None, Wg.winograd_conv3x3_plain):
        xs, as_, bs = (t.clone().requires_grad_(True) for t in (x, a, b))
        y = Wg.winograd_conv3x3(xs, w, prologue=(as_, bs) if prologue
                                else None, conv=conv)
        wrt = [xs, as_, bs] if prologue else [xs]
        grads.append(torch.autograd.grad(y, wrt, grad_outputs=ct))
    for got, want, what in zip(*grads, ("dx", "da", "db")):
        tol = 2 ** -7 * want.abs() + 2 ** -14 * want.abs().max()
        assert ((got.float() - want.float()).abs() <= tol).all(), what


def test_kernel_rejects_what_it_cannot_take(card):
    x, w, a, b = inputs(card, 1, 16, 16, 8, 8)
    v = Wg.kernel_transform(w)
    with pytest.raises(ValueError, match="contiguous"):
        Wg.winograd_conv3x3_cuda(x.transpose(2, 3), v)
    with pytest.raises(ValueError, match="even"):
        Wg.winograd_conv3x3_cuda(x[..., :7].contiguous(), v)
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        Wg.winograd_conv3x3_cuda(x.float(), v.float())
    with pytest.raises(ValueError, match="prologue"):
        Wg.winograd_conv3x3_cuda(x, v, (a.double(), b))
