"""The Winograd kernel's launch configuration, on the CPU:
`ops.winograd.launch_config` (tiling, C split and slice, F groups), with
the CTAs laid out as the kernel reads its block index (`launch_grid`).
For every launch of one guided NFE of the FFHQ-256 model (its shapes
recorded from the model on the meta device by chip_smoke's own recorder),
for seeded random shapes, and for the card tests' shapes, the CTAs must
cover every (sample, tile, output channel, input channel) exactly once
and keep the cluster within the portable size; the NFE's launches must
reach MIN_CTAS CTAs; and the card tests' shapes together must reach every
configuration the function can choose."""

import numpy as np
import pytest
import torch

import chip_smoke
from kdip_tpu_torch import config
from kdip_tpu_torch.ops import winograd as Wg
from test_torch_winograd_cuda import SHAPES


def cdiv(a, b):
    return -(-a // b)


def launch_grid(B, C, F, H, W, cfg):
    """The CTAs of one launch as `winograd_f23_kernel`
    (kdip_tpu_torch/csrc/winograd_f23.cu) reads its block index and the
    configuration it is given, one tuple each: (sample, tile rows, tile
    columns, output channels, input channels) as ranges; the tile ranges
    may run past the image, whose tiles the kernel computes from zeros and
    does not store."""
    TH, TW, FB, _ = Wg.TILINGS[cfg.tiling]
    cs, fper, nfb = cfg.cs, cfg.fper, cdiv(F, FB)
    nbw = cdiv(W // 2, TW)
    for n in range(B):
        for by in range(cdiv(H // 2, TH) * nbw):
            ty0, tx0 = (by // nbw) * TH, (by % nbw) * TW
            for bx in range(cfg.csplit * cfg.fgroups):
                rank, group = bx % cfg.csplit, bx // cfg.csplit
                fb_lo = group * fper
                f_hi = min(nfb, fb_lo + fper) * FB
                yield (n, range(ty0, ty0 + TH), range(tx0, tx0 + TW),
                       range(fb_lo * FB, min(F, f_hi)),
                       range(rank * cs, min(C, rank * cs + cs)))


def nfe_shapes(config_file: str):
    """{(entry point, B, C, F, H, W): launches} of one UNet forward and vjp
    of a config's Winograd torso on the meta device, recorded by the
    function that chip_smoke's per-shape phases take their shapes from."""
    cfg = config.load_config(config_file)
    model, _ = config.make_openai_model(cfg["model"], winograd=True,
                                        device="meta")
    model.to(torch.bfloat16)
    return chip_smoke.winograd_launch_shapes(model, torch.device("meta"))


@pytest.fixture(scope="module")
def ffhq_nfe():
    """The FFHQ-256 torso's (configs/test_ffhq.json)."""
    return nfe_shapes("configs/test_ffhq.json")


@pytest.fixture(scope="module")
def imagenet_nfe():
    """The ImageNet-256 torso's (configs/test_imagenet.json)."""
    return nfe_shapes("configs/test_imagenet.json")


def check_grid(B, C, F, H, W):
    """Asserts that launch_config's CTAs cover the conv exactly once;
    returns (config, number of CTAs)."""
    cfg = Wg.launch_config(B, C, F, H, W)
    assert 1 <= cfg.csplit <= Wg.MAX_CLUSTER and cfg.fgroups >= 1
    assert cfg.cs % 16 == 0 and cfg.fper >= 1
    ctas = list(launch_grid(B, C, F, H, W, cfg))
    blocks = {}
    for n, rows, cols, fs, cs in ctas:
        assert len(fs) > 0 and cs.start % 16 == 0
        key = (n, rows.start, cols.start, len(rows), len(cols))
        blocks.setdefault(key, []).append(((fs.start, fs.stop),
                                           (cs.start, cs.stop)))
    tiles = np.zeros((B, H // 2, W // 2), np.int64)
    for (n, r0, c0, nr, nc), work in blocks.items():
        tiles[n, r0:r0 + nr, c0:c0 + nc] += 1
        fr = sorted({f for f, _ in work})
        cr = sorted({c for _, c in work})
        # every F range with every C slice, once
        assert sorted(work) == sorted((f, c) for f in fr for c in cr)
        for ranges, total, empty_ok in ((fr, F, False), (cr, C, True)):
            used = [r for r in ranges if r[1] > r[0]]
            assert empty_ok or len(used) == len(ranges)
            assert used[0][0] == 0 and used[-1][1] == total
            assert all(a[1] == b[0] for a, b in zip(used, used[1:]))
    assert (tiles == 1).all()
    return cfg, len(ctas)


def test_launch_covers_the_ffhq_nfe(ffhq_nfe):
    """44 shapes, 120 launches (65 plain + 55 fused per guided NFE); each
    covered exactly once, in at least MIN_CTAS CTAs."""
    assert len(ffhq_nfe) == 44 and sum(ffhq_nfe.values()) == 120
    for _, *shape in ffhq_nfe:
        cfg, ctas = check_grid(*shape)
        assert ctas >= Wg.MIN_CTAS, (shape, cfg, ctas)


def test_launch_covers_the_imagenet_nfe(imagenet_nfe):
    """168 launches (89 plain + 79 fused per guided NFE) over the
    ImageNet-256 torso's shapes, whose decoder concatenations reach C =
    2048 at 8 px and 1536 at 16 and 32 px, where a CTA's slice outgrows U
    and is rebuilt for every F block; each covered exactly once, in at
    least MIN_CTAS CTAs."""
    per_entry = {}
    for (entry, *_), n in imagenet_nfe.items():
        per_entry[entry] = per_entry.get(entry, 0) + n
    assert per_entry == {"winograd_conv3x3": 89,
                         "winograd_conv3x3_fused": 79}
    shapes = {tuple(k[1:]) for k in imagenet_nfe}
    assert {(1, 2048, 1024, 8, 8), (1, 1536, 1024, 16, 16),
            (1, 1536, 512, 32, 32), (1, 768, 256, 128, 128),
            (1, 512, 256, 256, 256), (1, 256, 256, 256, 256),
            (1, 1024, 2048, 8, 8)} <= shapes
    rounds = 0
    for _, *shape in imagenet_nfe:
        cfg, ctas = check_grid(*shape)
        assert ctas >= Wg.MIN_CTAS, (shape, cfg, ctas)
        rounds += cfg.cs > Wg.TILINGS[cfg.tiling][3]
    assert rounds > 0


def test_launch_covers_random_shapes():
    rng = np.random.default_rng(0)
    for _ in range(300):
        B = int(rng.integers(1, 4))
        C, F = (int(v) for v in rng.integers(1, 1100, 2))
        H, W = (2 * int(v) for v in rng.integers(1, 40, 2))
        check_grid(B, C, F, H, W)


def test_card_shapes_reach_every_configuration():
    """The card tests' SHAPES and chip_smoke's WINO_SHAPES together reach
    both tilings with a C split of 1, 2, 4 and 8, CTAs with several F
    blocks, slices that U holds in rounds, V rows that are not whole
    16-byte pieces (F % 8 != 0), C not a multiple of 16, B = 2, and 8 px
    and 16 px images."""
    seen = set()
    for shape in set(SHAPES) | set(chip_smoke.WINO_SHAPES):
        B, C, F, H, W = shape
        cfg, _ = check_grid(*shape)
        tiling, US = cfg.tiling, Wg.TILINGS[cfg.tiling][3]
        seen.add(("split", tiling, cfg.csplit))
        seen.add(("several F blocks", tiling, cfg.fper > 1))
        seen.add(("rounds", tiling, cfg.cs > US))
        seen.add(("F % 8", tiling, F % 8 != 0))
        seen |= {("C % 16", C % 16 != 0), ("B", B), ("H", H)}
    for tiling in (0, 1):
        for csplit in (1, 2, 4, 8):
            assert ("split", tiling, csplit) in seen
        for what in ("several F blocks", "rounds", "F % 8"):
            assert (what, tiling, True) in seen
    assert {("C % 16", True), ("B", 2), ("H", 8), ("H", 16)} <= seen
