"""kdip_tpu_torch: the PyTorch/CUDA port of `kdip_tpu` for NVIDIA Hopper.

Module names mirror `kdip_tpu`'s. The package imports torch and numpy only,
never JAX or `kdip_tpu`; layout is NCHW. Entry points run on the card
(`device="cuda"`) unless the caller passes `device="cpu"`. Hand-written
CUDA kernels live under `csrc/` and are built with nvcc at first use
(`ops/_build.py`).
"""

from . import (autoi, brownian, ckpt, config, data,  # noqa: F401
               ddpm_sampling, diffusion, evaluation, gns, guidance, logger,
               metrics, operators, precond, profiling, resample, samplers,
               sampling_api, schedules, script_util, tfevents, train,
               train_loop, utils, weights)
from .models import adm, inception, kdiff, layers  # noqa: F401
from .ops import (dwt, fft, kernels, resize, transforms,  # noqa: F401
                  winograd)
