"""The port's unconditional-sampling CLI on the card. Imports no JAX, so
that it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_uncond_cuda.py -m cuda

Without a card every test skips."""

import json
import os

import pytest
import torch

from kdip_tpu_torch import config, data, weights
from kdip_tpu_torch.cli import sample_uncond

pytestmark = pytest.mark.cuda

S = 32
MODEL_CFG = {
    "type": "openai_ffhq", "input_channels": 3, "input_size": [S, S],
    "sigma_min": 1e-2, "sigma_max": 80,
    "openai": {"num_channels": 32, "num_res_blocks": 1,
               "attention_resolutions": "16", "image_size": S,
               "num_head_channels": 16, "channel_mult": "1,2",
               "dropout": 0.0}}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CLI runs on the card by default")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("sampler", ["dpmpp_sde", "ddim"])
def test_cli_on_the_card_matches_the_cpu(card, tmp_path, sampler):
    """The CLI at its default device, float32, 4 steps (ddim over a
    respacing of 4), -n 2: finite samples on the card and their PNGs; the
    same run on the CPU, handed the card's initial x and (dpmpp_sde) the
    card's Brownian tree, within 1e-3 of the largest |x|."""
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({"model": MODEL_CFG}))
    unet = config.make_openai_model(MODEL_CFG, device="cpu")[0]
    pt = tmp_path / "model.pt"
    torch.save(weights.randomize_(unet, 0, std=0.05).state_dict(), pt)
    argv = ["--checkpoint", str(pt), "--config", str(cfg), "-n", "2",
            "--sampler", sampler, "--steps", "4", "--respacing", "4",
            "--dtype", "float32", "--seed", "1"]
    init = torch.randn(2, 3, S, S, generator=torch.Generator().manual_seed(2))
    kw = {"init_noise": init.to(card)}
    steps = [torch.randn(2, 3, S, S,
                         generator=torch.Generator().manual_seed(3 + i))
             for i in range(4)]
    if sampler == "dpmpp_sde":
        from kdip_tpu_torch.brownian import BrownianTreeNoiseSampler
        sig = 80.0, 1e-2
        tree = BrownianTreeNoiseSampler((2, 3, S, S), sig[1], sig[0], 7,
                                        device=card)
        kw["noise_sampler"] = tree
    else:
        kw["noise_fn"] = lambda i: steps[i].to(card)
    got = sample_uncond.main(argv + ["--logdir", str(tmp_path / "card")],
                             **kw)
    assert got.device.type == "cuda" and torch.isfinite(got).all()
    for i in range(2):
        png = data.read_png(os.path.join(tmp_path / "card", f"sample_{i}.png"))
        assert png.shape == (S, S, 3)
    cpu_kw = {"init_noise": init}
    if sampler == "dpmpp_sde":
        cpu_kw["noise_sampler"] = lambda s, sn: tree(s, sn).cpu()
    else:
        cpu_kw["noise_fn"] = steps.__getitem__
    want = sample_uncond.main(argv + ["--logdir", str(tmp_path / "cpu"),
                                      "--device", "cpu"], **cpu_kw)
    err = (got.cpu() - want).abs().max() / want.abs().max()
    assert err <= 1e-3, err
