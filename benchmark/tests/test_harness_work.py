"""The work counted from shapes: each kernel's FLOPs and bytes against hand
counts, the trace's reductions against a hand-made trace, the UNet's
FLOPs against torch's own counter on the program's direct-conv torso
(the count is the architecture's, the same for the Winograd torso, which
that counter cannot see), and the Winograd launch list against the
launches recorded from the program's model."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import tiny
from families import adm as fam
from harness import work


def _cfg(name):
    with open(os.path.join(tiny.BENCH, "configs", name)) as f:
        return json.load(f)


FFHQ = "ffhq256_adm_dwt_var.json"
IMAGENET = "imagenet256_adm_winograd_convert.json"


def test_direct_conv_work_by_hand():
    # 2 x (1 x 2 x 3 x 9 x 4 x 4) FLOPs; bytes: x 1x2x4x4, w 9x2x3,
    # y 1x3x4x4, bfloat16, + a and b [1, 2] float32 when fused
    assert work.direct_conv_work("winograd_conv3x3", 1, 2, 3, 4, 4) == (
        1728, 2 * (32 + 54 + 48))
    assert work.direct_conv_work("winograd_conv3x3_fused", 1, 2, 3, 4, 4) \
        == (1728, 2 * (32 + 54 + 48) + 16)


def test_trace_busy_gaps_and_haar_time_by_hand():
    from harness import spec, trace

    def reader(name):
        return spec.load_reader(os.path.join(tiny.BENCH, "metrics",
                                             name + ".py"))
    # us: two overlapping kernels, a host read, a gap, two Haar launches
    t = trace.Trace([("elementwise_kernel<AddFunctor>", 10, 20),
                     ("gemm_bf16", 15, 30),
                     ("Memcpy DtoH (Device -> Pageable)", 30, 32),
                     ("void haar_dwt2_matvec<2>", 42, 46),
                     ("void haar_dwt2_matvec<2>", 50, 52)], 0.0, 52.0)
    assert t.window_s == 52e-6
    assert abs(t.busy_s() - 28e-6) < 1e-12
    assert [g[:2] for g in t.gaps()] == [(0.0, 10), (32, 42), (46, 50)]
    idle = dict(t.idle_by_neighbours())
    assert idle == {"slice start -> elementwise": 10e-6,
                    "host_read -> haar_dwt": 10e-6,
                    "haar_dwt -> haar_dwt": 4e-6}
    assert abs(dict(t.seconds_by_kind())["haar_dwt"] - 6e-6) < 1e-12

    class Run:
        pass
    run = Run()
    run.trace, run.traced_nfes = t, 2
    run.nfe_seconds = [20e-6, 36e-6]
    assert abs(reader("haar_dwt_us_per_launch")(run) - 3.0) < 1e-9
    # busy 14 us an NFE against 28 us an NFE outside the slice
    assert abs(reader("device_idle_share")(run) - 50.0) < 1e-9
    run.nfe_seconds = []
    assert reader("device_idle_share")(run) is None
    run.trace = trace.Trace([("gemm_bf16", 0, 1)], 0.0, 1.0)
    assert reader("haar_dwt_us_per_launch")(run) is None


def test_unet_flops_by_hand_on_one_attention_block():
    # 1 x 64 x 4 x 4, one head of 64: q.k and w.v 2 x (2 x 16 x 16 x 64)
    from reference import adm
    blk = adm.AttentionBlock(64, 64, False, None)
    qkv = 2 * 64 * 192 * 16
    proj = 2 * 64 * 64 * 16
    att = 2 * 2 * 16 * 16 * 64
    with FlopCounterMode(display=False) as fc:
        blk(torch.zeros(1, 64, 4, 4))
    assert fc.get_total_flops() == qkv + proj + att


@pytest.mark.parametrize("cfg_name", [FFHQ, IMAGENET])
def test_unet_flops_match_torchs_counter_on_the_direct_conv_torso(cfg_name):
    """forward + vjp to x at B=2, 32 px, the program's float32 model with
    its convs on torch (what torch.utils.flop_counter can see)."""
    cfg = _cfg(cfg_name)
    cfg["model"]["openai"].update(image_size=32, num_channels=64,
                                  channel_mult="1,2")
    from kdip_tpu_torch import config
    from kdip_tpu_torch.models import adm
    model, _ = config.make_openai_model({"openai": cfg["model"]["openai"]},
                                        device="cpu")
    if cfg["model"].get("v2"):
        model = adm.ADMUNetV2(model)
    model.requires_grad_(False)
    x = torch.zeros(2, 3, 32, 32, requires_grad=True)
    t = torch.full((2,), 10.0)
    with FlopCounterMode(display=False) as fc:
        out = model(x, t)
        head = out[0] if isinstance(out, tuple) else out[:, :3]
        head.backward(torch.ones_like(head))
    want = work.unet_flops(fam.reference_model(cfg), 2, 32)["total"]
    assert fc.get_total_flops() == want


def test_the_count_is_the_architectures():
    """A Winograd torso and a direct one of the same shapes count alike
    (the count reads the architecture alone), and the Winograd launches'
    direct-conv FLOPs are the ResBlocks' 3x3 convs, forward and dx."""
    cfg = _cfg(IMAGENET)
    other = json.loads(json.dumps(cfg))
    other["winograd"] = False
    m1, m2 = fam.reference_model(cfg), fam.reference_model(other)
    assert work.unet_flops(m1, 2, 256) == work.unet_flops(m2, 2, 256)
    from reference import adm
    res3 = 0
    convs, _, _, _ = work._shapes(m1, 2, 256)
    for name, m, _, out in convs:
        if isinstance(m, adm.Conv) and ".in_layers.2" in name \
                or ".out_layers.3" in name:
            res3 += 2 * m.weight[0].numel() * out.numel()
    launched = sum(n * work.direct_conv_work(*k)[0] for k, n in
                   work.winograd_launches(m1, 2, 256).items())
    assert launched == 2 * res3


def _recorded_launches(cfg):
    """{(entry point, B, C, F, H, W): launches} of one forward and vjp of
    the program's Winograd torso at B=1 on the meta device, each conv's
    `conv_fn` a recorder (chip_smoke.py's `winograd_launch_shapes`)."""
    from kdip_tpu_torch import config
    from kdip_tpu_torch.models.layers import Conv2d
    model, _ = config.make_openai_model({"openai": cfg["model"]["openai"]},
                                        winograd=True, device="meta")
    model.to(torch.bfloat16)
    cases = {}

    def record(x, v, prologue=None):
        entry = ("winograd_conv3x3" if prologue is None
                 else "winograd_conv3x3_fused")
        key = (entry, x.shape[0], x.shape[1], v.shape[2], *x.shape[2:])
        cases[key] = cases.get(key, 0) + 1
        return x.new_empty(x.shape[0], v.shape[2], *x.shape[2:])
    for m in model.modules():
        if isinstance(m, Conv2d):
            m.conv_fn = record
    model.eval()
    x = torch.zeros(1, 3, 256, 256, device="meta", requires_grad=True)
    y = model(x, torch.full((1,), 20, device="meta"))
    torch.autograd.grad(y, x, grad_outputs=torch.ones_like(y))
    return cases


@pytest.mark.parametrize("cfg_name,plain,fused", [(FFHQ, 65, 55),
                                                   (IMAGENET, 89, 79)])
def test_winograd_launch_list_at_256px(cfg_name, plain, fused):
    cfg = _cfg(cfg_name)
    launches = work.winograd_launches(fam.reference_model(cfg), 1, 256)
    by_entry = {}
    for (entry, *_), n in launches.items():
        by_entry[entry] = by_entry.get(entry, 0) + n
    assert by_entry == {"winograd_conv3x3": plain,
                        "winograd_conv3x3_fused": fused}
    assert launches == _recorded_launches(cfg)
